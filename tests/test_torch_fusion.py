"""The port's fusion classifier against the JAX ``MultiModalEmotionClassifier``
(feat dims 32/24, H=16, masked, ragged), and checkpoint interchange with the
JAX ``FusionEngine``. f32 logits max-abs <= 1e-5 (same math, other
summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.fusion import MultiModalEmotionClassifier as JaxFusion
from interspeech_ser_tpu_torch.models.convert import fusion_params_from_flax
from interspeech_ser_tpu_torch.models.fusion import MultiModalEmotionClassifier
from interspeech_ser_tpu_torch.ops.attention import TorchMultiheadAttention, attention_pool

torch.set_num_threads(2)

DIMS, HID = (32, 24), 16
B, T1, T2 = 4, 13, 9


def _inputs(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, T1, DIMS[0])).astype(np.float32),
             rng.standard_normal((B, T2, DIMS[1])).astype(np.float32)]
    l1, l2 = np.array([13, 9, 4, 1]), np.array([9, 2, 7, 5])
    masks = [(np.arange(T1)[None] < l1[:, None]).astype(np.float32),
             (np.arange(T2)[None] < l2[:, None]).astype(np.float32)]
    return feats, masks


def _jax_params(seed=0):
    feats = [jnp.zeros((2, 8, d)) for d in DIMS]
    masks = [jnp.ones((2, 8)) for _ in DIMS]
    return JaxFusion(feat_dims=DIMS, fusion_hidden_dim=HID).init(
        jax.random.PRNGKey(seed), feats, masks=masks, deterministic=True
    )["params"]


def test_logits_match_jax_masked_ragged():
    params = _jax_params()
    feats, masks = _inputs(1)
    ref = JaxFusion(feat_dims=DIMS, fusion_hidden_dim=HID).apply(
        {"params": params}, [jnp.asarray(f) for f in feats], masks=[jnp.asarray(m) for m in masks],
        deterministic=True,
    )
    model = MultiModalEmotionClassifier(DIMS, HID).eval()
    model.load_state_dict(fusion_params_from_flax(jax.tree.map(np.asarray, params), 2), strict=True)
    with torch.no_grad():
        out = model([torch.from_numpy(f) for f in feats], [torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_masked_batch_equals_batch1():
    torch.manual_seed(3)
    model = MultiModalEmotionClassifier(DIMS, HID).eval()
    feats, masks = _inputs(2)
    with torch.no_grad():
        batched = model([torch.from_numpy(f) for f in feats], [torch.from_numpy(m) for m in masks])
        for i in range(B):
            n1, n2 = int(masks[0][i].sum()), int(masks[1][i].sum())
            single = model([torch.from_numpy(feats[0][i : i + 1, :n1]),
                            torch.from_numpy(feats[1][i : i + 1, :n2])])
            torch.testing.assert_close(batched[i : i + 1], single, atol=1e-5, rtol=0)


def test_jax_engine_checkpoint_loads_strict(tmp_path):
    from interspeech_ser_tpu.train.engine import FusionEngine as JaxEngine
    from interspeech_ser_tpu.utils.config import FusionConfig as JaxFusionConfig

    cfg = JaxFusionConfig(
        wav_dir="", txt_dir="", lazy_dir1="", lazy_dir2="", label_path="", feat1_dim=DIMS[0],
        feat2_dim=DIMS[1], epochs=1, lr=1e-3, model_path=str(tmp_path), batch_size=4,
        accum_step=1, fusion_hidden_dim=HID,
    )
    engine = JaxEngine(cfg, seed=5)
    engine.init_params()
    path = str(tmp_path / "multimodal_ser.pt")
    engine.save_torch_checkpoint(path)

    model = MultiModalEmotionClassifier(DIMS, HID).eval()
    model.load_state_dict(torch.load(path, weights_only=True), strict=True)
    feats, masks = _inputs(4)
    ref = engine.model.apply(
        {"params": engine.params}, [jnp.asarray(f) for f in feats],
        masks=[jnp.asarray(m) for m in masks], deterministic=True,
    )
    with torch.no_grad():
        out = model([torch.from_numpy(f) for f in feats], [torch.from_numpy(m) for m in masks])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("heads", [1, 2])
def test_multihead_attention_matches_torch_module(heads):
    """Same keys and numbers as ``torch.nn.MultiheadAttention`` (batch_first,
    eval), with the key mask as its ``key_padding_mask``."""
    torch.manual_seed(heads)
    E = 8
    ours = TorchMultiheadAttention(E, heads)
    ref = torch.nn.MultiheadAttention(E, heads, batch_first=True).eval()
    ref.load_state_dict(ours.state_dict(), strict=True)
    q, kv = torch.randn(3, 5, E), torch.randn(3, 7, E)
    mask = (torch.arange(7)[None] < torch.tensor([7, 3, 1])[:, None]).float()
    with torch.no_grad():
        want, _ = ref(q, kv, kv, key_padding_mask=mask == 0, need_weights=False)
        got = ours(q, kv, kv, key_mask=mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_attention_pool_ignores_padding():
    feats = torch.randn(2, 6, 3)
    scores = torch.randn(2, 6, 1)
    mask = torch.tensor([[1, 1, 1, 1, 1, 1], [1, 1, 0, 0, 0, 0]], dtype=torch.float32)
    pooled = attention_pool(feats, scores, mask)
    w = torch.softmax(scores[1, :2, 0], dim=0)
    torch.testing.assert_close(pooled[1], (feats[1, :2] * w[:, None]).sum(0), atol=1e-6, rtol=0)
