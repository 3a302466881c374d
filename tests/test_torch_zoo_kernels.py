"""K5 (fused FFN), K8 (grouped positional conv) and K9 (one-direction GRU):
the port's plain versions against the JAX package's Pallas kernels in
interpret mode, and K8 at the zoo's other group widths against the JAX
``PositionalConvEmbedding``. Inputs from numpy seeds, the same for both.

Tolerances: f32 max-abs <= 1e-5 x max(1, max|ref|) (the same products in
another summation order); bf16 cosine >= 0.999 (bf16 rounds the inputs and
the FFN's intermediate at the same places in both, but an f32 sum that lands
on the other side of a rounding boundary moves a value by one bf16 ulp).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.speech import PositionalConvEmbedding as JaxPositionalConvEmbedding
from interspeech_ser_tpu.models.speech import SpeechConfig as JaxSpeechConfig
from interspeech_ser_tpu.ops.pallas.ffn_fused import ffn_fused as jax_ffn_fused
from interspeech_ser_tpu.ops.pallas.gru_kernel import gru_sequence as jax_gru_sequence
from interspeech_ser_tpu.ops.pallas.pos_conv import pos_conv_grouped as jax_pos_conv_grouped
from interspeech_ser_tpu_torch.models.speech import PositionalConvEmbedding, SpeechConfig
from interspeech_ser_tpu_torch.ops.kernels import ffn_fused as k_ffn
from interspeech_ser_tpu_torch.ops.kernels import gru as k_gru
from interspeech_ser_tpu_torch.ops.kernels import pos_conv as k_pos

torch.set_num_threads(2)


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


def _close_f32(out, ref):
    np.testing.assert_allclose(out, ref, atol=1e-5 * max(1.0, float(np.abs(ref).max())), rtol=0)


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_fused_plain_matches_pallas_interpret(dtype, approx):
    """M = 37 rows (off the Pallas kernel's 8-row tiles), K = N = 48, F = 192."""
    rng = np.random.default_rng(11)
    M, K, Fd, N = 37, 48, 192, 48
    x = rng.standard_normal((M, K)).astype(np.float32)
    w_up = (rng.standard_normal((K, Fd)) / np.sqrt(K)).astype(np.float32)  # flax [in, out]
    b_up = (0.1 * rng.standard_normal(Fd)).astype(np.float32)
    w_down = (rng.standard_normal((Fd, N)) / np.sqrt(Fd)).astype(np.float32)
    b_down = (0.1 * rng.standard_normal(N)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jax_ffn_fused(jnp.asarray(x, jdt), jnp.asarray(w_up, jdt), jnp.asarray(b_up), jnp.asarray(w_down, jdt),
                        jnp.asarray(b_down), approx_gelu=approx, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    args = (torch.from_numpy(x).to(tdt), torch.from_numpy(w_up.T.copy()), torch.from_numpy(b_up),
            torch.from_numpy(w_down.T.copy()), torch.from_numpy(b_down), approx)
    before = k_ffn.LAUNCHES
    out = k_ffn.ffn_fused(*args)  # a CPU tensor: the plain version, no launch
    assert k_ffn.LAUNCHES == before
    torch.testing.assert_close(out, k_ffn.ffn_fused_plain(*args), atol=0, rtol=0)
    assert out.dtype == tdt and tuple(out.shape) == (M, N)
    if dtype == "float32":
        _close_f32(out.numpy(), ref)
    else:
        assert _cosine(out.float().numpy(), ref) >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pos_conv_plain_matches_pallas_interpret(dtype):
    """The TPU kernel's only width: 16 groups of 64 channels, K = 128 taps."""
    rng = np.random.default_rng(12)
    B, T, G, C, K = 2, 37, 16, 64, 128
    D = G * C
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((K, C, D)) / np.sqrt(C * K)).astype(np.float32)  # flax [K, C_in, D]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = np.asarray(jax_pos_conv_grouped(jnp.asarray(x, jdt), jnp.asarray(w), groups=G).astype(jnp.float32))
    weight = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 1, 0)))  # [D, C_in, K]
    out = k_pos.pos_conv(torch.from_numpy(x).to(tdt), weight, G)
    assert out.dtype == tdt and tuple(out.shape) == (B, T + 1, D) == ref.shape
    if dtype == "float32":
        _close_f32(out.numpy(), ref)
    else:
        assert _cosine(out.float().numpy(), ref) >= 0.999


@pytest.mark.parametrize("C", [48, 80, 120])
def test_positional_conv_through_k8_matches_jax_module(C):
    """The port's ``PositionalConvEmbedding`` with ``inference_kernels`` (K8's
    plain version on the CPU, bias and GELU outside) against the JAX
    module (``nn.Conv`` with feature groups), 16 groups of C channels: the
    base, XL and XLS-R-2B widths, which the TPU kernel never took. f32."""
    rng = np.random.default_rng(C)
    B, T, G, K = 2, 29, 16, 128
    D = G * C
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    kernel = (rng.standard_normal((K, C, D)) / np.sqrt(C * K)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    jcfg = JaxSpeechConfig(hidden_size=D, num_heads=G, num_conv_pos_embeddings=K, conv_pos_groups=G)
    ref = JaxPositionalConvEmbedding(jcfg).apply({"params": {"conv": {"kernel": kernel, "bias": bias}}},
                                                 jnp.asarray(x))
    cfg = SpeechConfig(hidden_size=D, num_heads=G, num_conv_pos_embeddings=K, conv_pos_groups=G,
                       inference_kernels=True)
    mod = PositionalConvEmbedding(cfg)
    mod.load_state_dict({"conv.weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 1, 0))),
                         "conv.bias": torch.from_numpy(bias)})
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    assert tuple(out.shape) == (B, T, D)
    _close_f32(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_sequence_plain_matches_pallas_interpret(reverse, masked):
    """B = 3, T = 11, H = 8; ragged prefix masks (3 of 11 steps on row 2) or
    none. Masked steps freeze the carry and emit 0."""
    rng = np.random.default_rng(13)
    B, T, H = 3, 11, 8
    x_proj = rng.standard_normal((B, T, 3 * H)).astype(np.float32)
    w_hh = rng.uniform(-0.35, 0.35, (H, 3 * H)).astype(np.float32)
    b_hh = rng.uniform(-0.35, 0.35, 3 * H).astype(np.float32)
    mask = (np.arange(T)[None] < np.array([11, 7, 3])[:, None]).astype(np.float32) if masked else None
    ref = np.asarray(jax_gru_sequence(jnp.asarray(x_proj), jnp.asarray(w_hh), jnp.asarray(b_hh),
                                      None if mask is None else jnp.asarray(mask), reverse, interpret=True))
    args = (torch.from_numpy(x_proj), torch.from_numpy(w_hh), torch.from_numpy(b_hh),
            None if mask is None else torch.from_numpy(mask), reverse)
    before = k_gru.SEQ_LAUNCHES
    out = k_gru.gru_sequence(*args)
    assert k_gru.SEQ_LAUNCHES == before
    assert tuple(out.shape) == (B, T, H)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    if masked:
        assert float(out[2, 3:].abs().max()) == 0.0
