"""K6 and K7 (attention on [B, H, T, hd] heads): the port's plain versions
against the JAX package's Pallas kernels in interpret mode, and the
[B, H, T, hd] dispatcher.

Inputs come from numpy with a seed and go to both frameworks. Tolerances:
f32 max-abs <= 1e-5 (same math, other summation order); bf16 cosine >=
0.999, because P is rounded to bf16 before P.V and the two frameworks' f32
sums then differ by a few bf16 ulps. A fully masked query row gets
``sum(V) / Tk_p``: the TPU kernels count their zero-padded keys in that
mean, K7 padding Tk to a multiple of 128 and K6 to a multiple of
``min(256, max(128, Tk))``. The case at Tk = 128 pads neither; the cases
at Tk = 100 (both pad to 128) and Tk = 2100 (K6 pads to 2304) hold the
padded count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from interspeech_ser_tpu.ops.pallas.flash_attention_short import attention_bhtd as jax_oneshot
from interspeech_ser_tpu_torch.ops import attention as fusion_attention
from interspeech_ser_tpu_torch.ops import attention_core
from interspeech_ser_tpu_torch.ops.kernels import attention_bhtd as kb
from interspeech_ser_tpu_torch.ops.kernels.attention import padded_tk

torch.set_num_threads(2)

B, H, HD = 2, 2, 64
KERNELS = {  # name -> (JAX Pallas kernel, port wrapper, port plain version, counter)
    "oneshot": (jax_oneshot, kb.attention_bhtd, kb.attention_bhtd_plain, "LAUNCHES"),
    "flash": (jax_flash, kb.flash_attention, kb.flash_attention_plain, "FLASH_LAUNCHES"),
}
CASES = {  # name -> (Tq, Tk, key lengths or None, bias)
    "unmasked": (80, 80, None, False),
    "masked": (80, 80, [80, 23], False),
    "bias_masked": (80, 80, [80, 51], True),
    "bias_unmasked": (37, 37, None, True),
    "unaligned": (37, 130, [130, 66], False),
    "fully_masked_row": (40, 128, [128, 0], True),
    "longest_oneshot": (24, 2048, [2048, 1337], True),  # K7's MAX_ONESHOT_TK: its two-pass route on the card
}


def _inputs(seed, Tq, Tk, lengths, bias):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Tq, HD)).astype(np.float32)
    k, v = (rng.standard_normal((B, H, Tk, HD)).astype(np.float32) for _ in range(2))
    mask = None if lengths is None else (np.arange(Tk)[None] < np.array(lengths)[:, None]).astype(np.float32)
    gate = pb = None
    if bias:
        gate = rng.uniform(0.5, 2.0, (B, H, Tq)).astype(np.float32)
        pb = rng.standard_normal((H, Tq, Tk)).astype(np.float32)
    return q, k, v, mask, gate, pb


def _t(x, dt=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dt)


def _j(x, dt=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dt)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(kernel, case, dtype):
    jax_fn, _, plain, _ = KERNELS[kernel]
    Tq, Tk, lengths, bias = CASES[case]
    q, k, v, mask, gate, pb = _inputs(Tq + Tk + bias, Tq, Tk, lengths, bias)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    ref = jax_fn(_j(q, jdt), _j(k, jdt), _j(v, jdt), key_mask=_j(mask), gate=_j(gate), pos_bias=_j(pb),
                 interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = plain(_t(q, tdt), _t(k, tdt), _t(v, tdt), key_mask=_t(mask), gate=_t(gate), pos_bias=_t(pb))
    assert out.dtype == tdt and out.shape == (B, H, Tq, HD)
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    else:
        assert _cos(out, ref) >= 0.999
    if case == "fully_masked_row":  # the uniform mean of the row's values
        want = v[1].mean(axis=1, keepdims=True) if dtype == "float32" else None
        if want is not None:
            np.testing.assert_allclose(out[1], np.broadcast_to(want, out[1].shape), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel,tk", [("oneshot", 100), ("flash", 100), ("flash", 2100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_row_counts_padded_keys(kernel, tk, dtype):
    """Row 1's keys all masked at a Tk off the TPU kernels' tiles: the plain
    version against the Pallas kernel in interpret mode, the dead row equal
    to sum(V) / Tk_p, row 0 (live keys) as before."""
    jax_fn, _, plain, _ = KERNELS[kernel]
    q, k, v, mask, gate, pb = _inputs(tk + 1, 40, tk, [tk - 3, 0], True)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    ref = jax_fn(_j(q, jdt), _j(k, jdt), _j(v, jdt), key_mask=_j(mask), gate=_j(gate), pos_bias=_j(pb),
                 interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    out = plain(_t(q, tdt), _t(k, tdt), _t(v, tdt), key_mask=_t(mask), gate=_t(gate), pos_bias=_t(pb))
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        tk_p = padded_tk(tk) if kernel == "oneshot" else kb.flash_padded_tk(tk)
        assert tk_p == (128 if tk == 100 else 2304)
        want = v[1].sum(axis=1, keepdims=True) / tk_p
        np.testing.assert_allclose(out[1], np.broadcast_to(want, out[1].shape), atol=1e-5, rtol=0)
    else:
        assert _cos(out, ref) >= 0.999
    # a live row does not see the padded count: the one-pass softmax over its Tk keys
    live = plain(*(_t(x[:1], tdt) for x in (q, k, v)), key_mask=_t(mask[:1]), gate=_t(gate[:1]), pos_bias=_t(pb))
    np.testing.assert_array_equal(out[:1], live.float().numpy())


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrapper_runs_plain_version_on_cpu(kernel, monkeypatch):
    _, wrapper, plain, counter = KERNELS[kernel]
    q, k, v, mask, gate, pb = _inputs(3, 40, 40, [40, 17], True)
    args = [_t(x) for x in (q, k, v)]
    kw = dict(key_mask=_t(mask), gate=_t(gate), pos_bias=_t(pb))
    monkeypatch.setattr(kb, counter, 0)
    torch.testing.assert_close(wrapper(*args, **kw), plain(*args, **kw), rtol=0, atol=0)
    assert getattr(kb, counter) == 0  # the CPU path launches nothing


SMEM_LIMIT = 232448  # the most shared memory a block may opt into on an H100 (227 KB)


@pytest.mark.parametrize("kernel,max_tk", [("attention_bhtd", kb.MAX_ONESHOT_TK), ("flash_attention", 4096)])
@pytest.mark.parametrize("bias", [False, True])
def test_bhtd_f32_plan_rule(kernel, max_tk, bias):
    """The f32 launchers' rule at every Tk up to K7's limit (2048) and to 4096
    for K6, at Tq on both sides of each block size. Block rows: 64 up to Tq =
    64, 80 up to 80, 128 above; 64-key tiles. K6: the online softmax in one
    fixed amount of shared memory. K7: its scores on chip in blocks of the
    most rows (128, 80, 64; at most the rule's) whose [rows][Tk_r + 4] score
    rows, q and two [64][68] tiles fit in 227 KB (Tk_r = Tk rounded up to
    64): Tk <= 256 in 128 rows, 512 in 80, 640 in 64; two passes above, in
    one fixed amount. Every plan fits."""
    for tq in (1, 64, 65, 80, 81, 1500):
        rows = 64 if tq <= 64 else 80 if tq <= 80 else 128

        def fixed(r):  # q, K, V x 2, bias / P x 2 (one without a bias), key flags x 2
            return 4 * (r * 68 + 4 * 64 * 68 + (2 if bias else 1) * r * 68 + 128)

        for tk in range(1, max_tk + 1):
            plan = kb.bhtd_f32_plan(kernel, tq, tk, bias)
            assert (plan.kernel, plan.tile) == (kernel, 64)
            assert plan.smem_bytes <= SMEM_LIMIT
            if kernel == "flash_attention":
                assert (plan.route, plan.rows, plan.smem_bytes) == ("online", rows, fixed(rows)), (tq, tk)
                continue
            tkr = -(-tk // 64) * 64
            fits = [r for r in (128, 80, 64) if r <= rows and 4 * (r * 68 + 2 * 64 * 68 + r * (tkr + 4) + tkr) <= SMEM_LIMIT]
            assert bool(fits) == (tk <= 640), (tq, tk)
            if fits:
                r = fits[0]
                on_chip = 4 * (r * 68 + 2 * 64 * 68 + r * (tkr + 4) + tkr)
                assert (plan.route, plan.rows, plan.smem_bytes) == ("scores_on_chip", r, on_chip), (tq, tk)
                assert r == (rows if tk <= {64: 640, 80: 512, 128: 256}[rows] else 80 if tk <= 512 else 64)
            else:
                assert (plan.route, plan.rows, plan.smem_bytes) == ("two_pass", rows, fixed(rows)), (tq, tk)


@pytest.mark.parametrize("bias", [False, True])
def test_bhtd_f32_plan_roberta_keeps_scores_on_chip(bias):
    """RoBERTa-large's text attention (Tq = Tk = 80, max_len 80) takes K7's
    scores-on-chip route in 80-row blocks, its 80 queries filling them; at
    80 keys the block sizes it was measured against (128 rows above Tq = 80,
    64 up to 64) keep the same route. The WavLM shape (Tq = Tk = 499, bias)
    keeps its scores on chip in 80-row blocks; above 640 keys 128 rows take
    two passes."""
    assert kb.bhtd_f32_rows(80) == 80
    plan = kb.bhtd_f32_plan("attention_bhtd", 80, 80, bias)
    assert (plan.route, plan.rows, plan.smem_bytes) == ("scores_on_chip", 80, 99328)
    for tq, rows, nbytes in ((150, 128, 137728), (64, 64, 86528)):
        other = kb.bhtd_f32_plan("attention_bhtd", tq, 80, bias)
        assert (other.route, other.rows, other.smem_bytes) == ("scores_on_chip", rows, nbytes)
    assert kb.bhtd_f32_plan("flash_attention", 80, 80, bias).rows == 80
    wavlm = kb.bhtd_f32_plan("attention_bhtd", 499, 499, bias)
    assert (wavlm.route, wavlm.rows) == ("scores_on_chip", 80)
    assert (kb.bhtd_f32_plan("attention_bhtd", 1500, 641, bias).route,
            kb.bhtd_f32_plan("attention_bhtd", 1500, 641, bias).rows) == ("two_pass", 128)


@pytest.mark.parametrize("args", [
    dict(kernel="oneshot", tq=80, tk=80),  # the wrappers' names, not the test's
    dict(kernel="attention_btd", tq=80, tk=80),
    dict(kernel="attention_bhtd", tq=80, tk=80, hd=80),
    dict(kernel="flash_attention", tq=80, tk=80, hd=32),
    dict(kernel="attention_bhtd", tq=80, tk=kb.MAX_ONESHOT_TK + 1),
    dict(kernel="attention_bhtd", tq=80, tk=0),
    dict(kernel="flash_attention", tq=0, tk=80),
    dict(kernel="attention_bhtd", tq=0, tk=80),
    dict(kernel="flash_attention", tq=80, tk=0),
])
def test_bhtd_f32_plan_refuses_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        kb.bhtd_f32_plan(bias=False, **args)


def test_oneshot_refuses_long_keys():
    q = torch.zeros(1, 1, 4, HD)
    k = torch.zeros(1, 1, kb.MAX_ONESHOT_TK + 1, HD)
    with pytest.raises(ValueError, match="flash_attention"):
        kb.attention_bhtd(q, k, k)


@pytest.mark.parametrize("tk,env,force,want", [
    (80, None, None, "oneshot"),
    (kb.MAX_ONESHOT_TK, None, None, "oneshot"),
    (kb.MAX_ONESHOT_TK + 1, None, None, "flash"),
    (80, "flash", None, "flash"),
    (3000, "oneshot", None, "oneshot"),
    (80, "flash", "oneshot", "oneshot"),
    (80, "oneshot", "plain", "plain"),
    (80, "xla", None, "plain"),  # the JAX package's XLA route
    (3000, "xla", None, "plain"),
    (80, "xla", "flash", "flash"),
])
def test_pick_impl(tk, env, force, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    else:
        monkeypatch.setenv("SER_TPU_ATTN_IMPL", env)
    assert attention_core.pick_impl(tk, force) == want


@pytest.mark.parametrize("env,force", [("oneshot2", None), ("XLA", None), (None, "xla")])
def test_pick_impl_raises_on_unknown_values(env, force, monkeypatch):
    if env is None:
        monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    else:
        monkeypatch.setenv("SER_TPU_ATTN_IMPL", env)
    with pytest.raises(ValueError, match="SER_TPU_ATTN_IMPL" if env else "force_impl"):
        attention_core.pick_impl(80, force)


@pytest.mark.parametrize("env,force,want", [(None, None, "oneshot"), ("flash", None, "flash"),
                                            (None, "plain", "plain"), ("xla", None, "plain")])
def test_dispatcher_routes(env, force, want, monkeypatch):
    """dot_product_attention hands the inputs to the chosen wrapper, which
    on these CPU tensors runs its plain version."""
    routes = []
    for name, fn in (("oneshot", "attention_bhtd"), ("flash", "flash_attention"),
                     ("plain", "dot_product_attention_plain")):
        real = getattr(attention_core, fn)
        monkeypatch.setattr(attention_core, fn, lambda *a, _n=name, _f=real, **kw: routes.append(_n) or _f(*a, **kw))
    if env is None:
        monkeypatch.delenv("SER_TPU_ATTN_IMPL", raising=False)
    else:
        monkeypatch.setenv("SER_TPU_ATTN_IMPL", env)
    q, k, v, mask, gate, pb = _inputs(9, 30, 30, [30, 11], True)
    args = [_t(x) for x in (q, k, v)]
    out = attention_core.dot_product_attention(*args, key_mask=_t(mask), gate=_t(gate), shared_bias=_t(pb),
                                               force_impl=force)
    assert routes == [want]
    ref = kb.attention_bhtd_plain(*args, key_mask=_t(mask), gate=_t(gate), pos_bias=_t(pb))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_fusion_attention_never_reaches_the_dispatcher(monkeypatch):
    """The fusion model's cross-attention (dropout, gradients) calls the plain
    function directly: an unknown SER_TPU_ATTN_IMPL, which the dispatcher
    refuses, leaves it working and differentiable."""
    monkeypatch.setenv("SER_TPU_ATTN_IMPL", "not-a-kernel")
    torch.manual_seed(0)
    mha = fusion_attention.TorchMultiheadAttention(16, num_heads=2, dropout=0.1).train()
    x = torch.randn(2, 7, 16, requires_grad=True)
    out = mha(x, x, x, key_mask=torch.ones(2, 7), generator=torch.Generator().manual_seed(1))
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
