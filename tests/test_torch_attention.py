"""K1 (attention on [B, T, D] panels): the port's plain version against the
JAX package's Pallas kernel in interpret mode and its XLA attention.

Inputs come from numpy with a seed and go to both frameworks. Tolerances:
f32 max-abs <= 1e-5 (same math, other summation order); bf16 max-abs <=
3e-2 and cosine >= 0.999, because q*scale, the bias and P are rounded to
bf16 at points where the two frameworks' float32 sums then differ by a few
bf16 ulps.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.ops.attention_core import dot_product_attention as jax_dpa
from interspeech_ser_tpu.ops.pallas.flash_attention_short import attention_btd as jax_attention_btd
from interspeech_ser_tpu_torch.ops.attention_core import dot_product_attention, dot_product_attention_btd
from interspeech_ser_tpu_torch.ops.kernels.attention import attention_btd, attention_btd_plain, padded_tk

torch.set_num_threads(2)

B, D, H = 2, 64, 4


def _inputs(seed, T, with_bias, with_mask):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(3))
    mask = None
    if with_mask:  # ragged: row 1 keeps 19 of T keys (for T=130 the last two 64-key tiles are all masked)
        mask = (np.arange(T)[None] < np.array([T, 19])[:, None]).astype(np.float32)
    gate = bias = None
    if with_bias:
        gate = rng.uniform(0.5, 2.0, (B, H, T)).astype(np.float32)
        bias = rng.standard_normal((H, T, T)).astype(np.float32)
    return q, k, v, mask, gate, bias


def _torch(x, dt=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dt)


def _jax(x, dt=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dt)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("T", [37, 130])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(T, with_bias, with_mask, dtype):
    q, k, v, mask, gate, bias = _inputs(T + 2 * with_bias + with_mask, T, with_bias, with_mask)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_attention_btd(
        _jax(q, jdt), _jax(k, jdt), _jax(v, jdt), H, key_mask=_jax(mask),
        gate=_jax(gate), pos_bias=_jax(bias), interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    out = attention_btd_plain(
        _torch(q, tdt), _torch(k, tdt), _torch(v, tdt), H, key_mask=_torch(mask),
        gate=_torch(gate), pos_bias=_torch(bias),
    )
    assert out.dtype == tdt and out.shape == (B, T, D)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        assert np.abs(out - ref).max() <= 3e-2
        assert _cos(out, ref) >= 0.999


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("with_mask", [True, False])
def test_plain_matches_xla_attention_f32(with_bias, with_mask):
    T = 37
    q, k, v, mask, gate, bias = _inputs(11, T, with_bias, with_mask)
    bhtd = lambda x: jnp.asarray(x).reshape(B, T, H, D // H).transpose(0, 2, 1, 3)  # noqa: E731
    ref = jax_dpa(bhtd(q), bhtd(k), bhtd(v), key_mask=_jax(mask), gate=_jax(gate), shared_bias=_jax(bias))
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(B, T, D)
    out = dot_product_attention_btd(
        _torch(q), _torch(k), _torch(v), H, key_mask=_torch(mask), gate=_torch(gate),
        shared_bias=_torch(bias),
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_bhtd_form_matches_xla_attention_f32():
    T = 37
    q, k, v, mask, gate, bias = _inputs(12, T, True, True)
    bhtd = lambda x: x.reshape(B, T, H, D // H).transpose(0, 2, 1, 3)  # noqa: E731
    ref = jax_dpa(*(jnp.asarray(bhtd(x)) for x in (q, k, v)), key_mask=_jax(mask),
                  gate=_jax(gate), shared_bias=_jax(bias))
    out = dot_product_attention(*(_torch(np.ascontiguousarray(bhtd(x))) for x in (q, k, v)),
                                key_mask=_torch(mask), gate=_torch(gate), shared_bias=_torch(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("tk", [100, 130])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_counts_padded_keys(tk, with_bias, dtype):
    """Row 1's keys all masked at a Tk off the 128-key tile (H=2, D=128: head
    dim 64): the plain version against the Pallas kernel in interpret mode,
    the dead row equal to sum(V) / Tk_p with Tk_p = Tk rounded up to 128."""
    Hh, Dd, Tq = 2, 128, 40
    rng = np.random.default_rng(tk + with_bias)
    q = rng.standard_normal((B, Tq, Dd)).astype(np.float32)
    k, v = (rng.standard_normal((B, tk, Dd)).astype(np.float32) for _ in range(2))
    mask = (np.arange(tk)[None] < np.array([tk - 5, 0])[:, None]).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (B, Hh, Tq)).astype(np.float32) if with_bias else None
    bias = rng.standard_normal((Hh, Tq, tk)).astype(np.float32) if with_bias else None
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_attention_btd(_jax(q, jdt), _jax(k, jdt), _jax(v, jdt), Hh, key_mask=_jax(mask), gate=_jax(gate),
                            pos_bias=_jax(bias), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = attention_btd_plain(_torch(q, tdt), _torch(k, tdt), _torch(v, tdt), Hh, key_mask=_torch(mask),
                              gate=_torch(gate), pos_bias=_torch(bias)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        want = v[1].sum(axis=0) / padded_tk(tk)
        np.testing.assert_allclose(out[1], np.broadcast_to(want, out[1].shape), atol=1e-5, rtol=0)
    else:
        assert np.abs(out - ref).max() <= 3e-2
        assert _cos(out, ref) >= 0.999


def test_all_negative_scores_stay_exact():
    """Every real score far below 0 (anti-aligned q and k) and no mask: the
    softmax must still normalise over the real keys only."""
    T = 37
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, T, D)).astype(np.float32)
    k = -3.0 * q
    v = rng.standard_normal((1, T, D)).astype(np.float32)
    ref = np.asarray(jax_attention_btd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, interpret=True))
    out = attention_btd_plain(_torch(q), _torch(k), _torch(v), H).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v, mask, gate, bias = _inputs(5, 37, True, True)
    args = (_torch(q), _torch(k), _torch(v), H)
    kw = dict(key_mask=_torch(mask), gate=_torch(gate), pos_bias=_torch(bias))
    from interspeech_ser_tpu_torch.ops.kernels import attention as mod

    before = mod.LAUNCHES
    torch.testing.assert_close(attention_btd(*args, **kw), attention_btd_plain(*args, **kw), rtol=0, atol=0)
    assert mod.LAUNCHES == before  # the CPU path launches nothing


# the f32 kernels' streamed tile (keys for fwd and dq, queries for dkdv) per
# (kind, head dim, bias): the longest of 64 / 32 / 16 whose 128-row block fits 227 KB
F32_TILES = {
    ("fwd", 64, False): 64, ("fwd", 64, True): 64, ("fwd", 80, False): 64, ("fwd", 80, True): 64,
    ("fwd", 120, False): 64, ("fwd", 120, True): 32,
    ("dkdv", 64, False): 64, ("dkdv", 64, True): 32, ("dkdv", 80, False): 32, ("dkdv", 80, True): 32,
    ("dkdv", 120, False): 32, ("dkdv", 120, True): 16,
    ("dq", 64, False): 64, ("dq", 64, True): 64, ("dq", 80, False): 64, ("dq", 80, True): 32,
    ("dq", 120, False): 32, ("dq", 120, True): 32,
}


@pytest.mark.parametrize("kind,hd,bias", sorted(F32_TILES))
def test_f32_plan_per_head_dim(kind, hd, bias):
    """attention_f32_plan: the tile per head dim; its shared memory within the
    227 KB a block may opt into (which a tile twice as long would not be), one
    block of 256 threads an SM; 8 x tile/16 score micro-tiles, double-buffered."""
    from interspeech_ser_tpu_torch.ops.kernels import attention as mod

    plan = mod.attention_f32_plan(hd, bias, kind)
    assert plan.tile == F32_TILES[(kind, hd, bias)]
    assert (plan.stages, plan.micro_tile) == (2, (8, plan.tile // 16))
    assert plan.smem_bytes == 4 * mod._f32_smem_floats(kind, hd, bias, plan.tile)
    assert plan.smem_bytes <= mod.SMEM_LIMIT == 232448
    assert plan.blocks_per_sm == 1 and plan.smem_bytes + 1024 <= mod.SM_SMEM
    if plan.tile < 64:
        assert 4 * mod._f32_smem_floats(kind, hd, bias, 2 * plan.tile) > mod.SMEM_LIMIT
    s = hd + 4  # padded rows: 16-byte aligned, an odd number of 16-byte units
    assert s % 4 == 0 and (s // 4) % 2 == 1


def test_f32_plan_refuses_what_the_kernels_do_not_take():
    from interspeech_ser_tpu_torch.ops.kernels import attention as mod

    with pytest.raises(ValueError):
        mod.attention_f32_plan(96, False)
    with pytest.raises(ValueError):
        mod.attention_f32_plan(64, False, "bwd")
