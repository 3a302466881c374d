"""K4 (the attention backward) and the differentiable pair against the JAX
package: ``attention_bwd.attention_btd_bwd`` (the Pallas kernel, interpret
mode) and ``jax.grad`` of ``oneshot_attention_train`` (its custom VJP).

Inputs come from numpy with a seed. B=2, T=37 (the JAX kernel pads queries
and keys to 128, so padded queries are exercised), H=2 and D=128, 160 or
240, i.e. the three head dims the kernels take (64, 80, 120), a ragged
mask that keeps 19 of 37 keys in row 1, the scale given or left to its
default ``hd ** -0.5``. Bars: f32 max-abs <= 1e-5 (same math, other
summation order); bf16 cosine >= 0.999 per output, because q, k, v, g, P
and dS are rounded to bf16 at points where the float32 sums of the two
frameworks then differ by a few bf16 ulps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.ops.pallas.attention_bwd import attention_btd_bwd as jax_bwd
from interspeech_ser_tpu.ops.pallas.attention_bwd import oneshot_attention_train
from interspeech_ser_tpu_torch.ops import attention_core
from interspeech_ser_tpu_torch.ops.kernels import attention as ka

torch.set_num_threads(2)

B, T, D, H = 2, 37, 128, 2
HEAD_DIMS = (64, 80, 120)


def _inputs(seed, with_bias, with_mask, D=D):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(4))
    mask = (np.arange(T)[None] < np.array([T, 19])[:, None]).astype(np.float32) if with_mask else None
    gate = bias = None
    if with_bias:
        gate = rng.uniform(0.5, 2.0, (B, H, T)).astype(np.float32)
        bias = rng.standard_normal((H, T, T)).astype(np.float32)
    return q, k, v, g, mask, gate, bias


def _t(x, dt=torch.float32):
    return None if x is None else torch.from_numpy(x).to(dt)


def _j(x, dt=jnp.float32):
    return None if x is None else jnp.asarray(x).astype(dt)


def _cos(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.mark.parametrize("with_bias,with_mask", [(True, True), (True, False), (False, True), (False, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,scale", [(64, 0.125), (80, None), (80, 0.1), (120, None), (120, 0.125)])
def test_plain_backward_matches_pallas_interpret(with_bias, with_mask, dtype, hd, scale):
    q, k, v, g, mask, gate, bias = _inputs(3 + 2 * with_bias + with_mask, with_bias, with_mask, D=H * hd)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_bwd(*(_j(x, jdt) for x in (q, k, v, g)), H, _j(mask), hd ** -0.5 if scale is None else scale,
                   _j(gate), _j(bias, jdt), interpret=True)
    before = ka.BWD_LAUNCHES
    got = ka.attention_btd_bwd(*(_t(x, tdt) for x in (q, k, v, g)), H, _t(mask), scale, _t(gate), _t(bias, tdt))
    assert ka.BWD_LAUNCHES == before  # a CPU tensor runs the plain version
    for name, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, want):
        assert (a is None) == (b is None) == (not with_bias and name in ("dgate", "dbias")), name
        if a is None:
            continue
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
        else:
            assert _cos(a, b) >= 0.999, name
    if with_mask:  # masked keys get exactly no gradient
        for a in got[1:3]:
            assert float(a[1, 19:].abs().max()) == 0.0


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tk", [37, 100])
def test_plain_backward_fully_masked_row(with_bias, dtype, tk):
    """Row 1's keys all masked: the TPU kernel's P is 1 / Tk_p on every key
    there (Tk padded to 128), so the dead row's keys do get a gradient. The
    plain backward against the Pallas kernel in interpret mode, head dim 64."""
    rng = np.random.default_rng(tk + with_bias)
    q, g = (rng.standard_normal((B, T, D)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((B, tk, D)).astype(np.float32) for _ in range(2))
    mask = (np.arange(tk)[None] < np.array([tk - 4, 0])[:, None]).astype(np.float32)
    gate = rng.uniform(0.5, 2.0, (B, H, T)).astype(np.float32) if with_bias else None
    bias = rng.standard_normal((H, T, tk)).astype(np.float32) if with_bias else None
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_bwd(*(_j(x, jdt) for x in (q, k, v, g)), H, _j(mask), 0.125, _j(gate), _j(bias, jdt), interpret=True)
    got = ka.attention_btd_bwd(*(_t(x, tdt) for x in (q, k, v, g)), H, _t(mask), 0.125, _t(gate), _t(bias, tdt))
    for name, a, b in zip(("dq", "dk", "dv", "dgate", "dbias"), got, want):
        if b is None:
            assert a is None, name
            continue
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=0, err_msg=name)
        else:
            assert _cos(a, b) >= 0.999, name
    assert float(got[2][1].abs().max()) > 0  # dV of the dead row: sum over queries of g / Tk_p


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_autograd_pair_matches_jax_grad(with_bias, hd):
    """Torch autograd through AttentionBtdTrain on the CPU (plain forward and
    backward) against jax.grad of the JAX custom VJP in interpret mode, the
    scale left to its default on both sides."""
    q, k, v, _, mask, gate, bias = _inputs(11, with_bias, True, D=H * hd)
    wy = np.random.default_rng(12).standard_normal((B, T, H * hd)).astype(np.float32)
    diff = [q, k, v] + ([gate, bias] if with_bias else [])

    def loss(*xs):
        gt, pb = (xs[3], xs[4]) if with_bias else (None, None)
        out = oneshot_attention_train(*xs[:3], H, key_mask=_j(mask), gate=gt, pos_bias=pb, interpret=True)
        return jnp.sum(out * wy)

    want = jax.grad(loss, argnums=tuple(range(len(diff))))(*(_j(x) for x in diff))
    leaves = [_t(x).requires_grad_() for x in diff]
    gt, pb = (leaves[3], leaves[4]) if with_bias else (None, None)
    out = ka.AttentionBtdTrain.apply(*leaves[:3], H, _t(mask), None, gt, pb)
    (out * _t(wy)).sum().backward()
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=1e-5, rtol=0, err_msg=str(i))


def test_function_returns_none_for_inputs_without_grad(monkeypatch):
    """Only q and the gate need a gradient (WavLM under LoRA: the shared bias
    comes from a frozen embedding): k, v, the bias and the mask get None,
    and the backward is told to skip dbias but not dgate."""
    q, k, v, g, mask, gate, bias = (_t(x) for x in _inputs(5, True, True))
    asked = {}
    real = ka.attention_btd_bwd

    def spy(*args, **kw):
        asked.update(want_dgate=kw["want_dgate"], want_dbias=kw["want_dbias"])
        return real(*args, **kw)

    monkeypatch.setattr(ka, "attention_btd_bwd", spy)
    q.requires_grad_()
    gate.requires_grad_()
    out = ka.AttentionBtdTrain.apply(q, k, v, H, mask, None, gate, bias)
    grads = out.grad_fn.apply(g)
    assert asked == {"want_dgate": True, "want_dbias": False}
    assert [x is None for x in grads] == [False, True, True, True, True, True, False, True]
    ref = ka.attention_btd_bwd_plain(q.detach(), k, v, g, H, mask, None, gate.detach(), bias)
    torch.testing.assert_close(grads[0], ref[0], atol=0, rtol=0)
    torch.testing.assert_close(grads[6], ref[3], atol=0, rtol=0)


class _CudaLike(torch.Tensor):
    """A CPU tensor that says it lies on the card, to reach the launcher's
    checks without one (nothing is launched: the launch itself is mocked)."""

    @property
    def is_cuda(self):
        return True


class _FakeLibrary:
    """Stands in for the kernel library: records each K4 entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _keep_launch_counts(monkeypatch):
    """The fake library's launches go through the real wrappers, which count
    them: restore K1's and K4's counters after the test, so that a later test
    in the same process (chip_smoke's rehearsals) starts from its own counts."""
    for counter in ("LAUNCHES", "BWD_LAUNCHES"):
        monkeypatch.setattr(ka, counter, getattr(ka, counter))


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_launcher_passes_head_dim_and_default_scale(hd, dtype, monkeypatch):
    """On a card tensor K4 takes every head dim K1 takes; its kernel gets the
    real head dim and, with no scale given, hd ** -0.5, the scale K1 used
    (not 64 ** -0.5: at hd 80 that is another softmax, a wrong gradient);
    bf16 also gets a q*scale scratch. AttentionBtdTrain no longer refuses
    hd 80 / 120, and its backward hands K4 the forward's scale."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ka._build, "library", lambda: lib)
    monkeypatch.setattr(ka._build, "stream_ptr", lambda t: 0)
    _keep_launch_counts(monkeypatch)
    assert ka.K4_HEAD_DIMS == ka.K1_HEAD_DIMS
    Dh = H * hd

    def card(*shape):
        return torch.randn(*shape).to(dtype).as_subclass(_CudaLike)

    q, k, v, g, out = (card(B, T, Dh) for _ in range(5))
    lse = torch.zeros(B, H, T).as_subclass(_CudaLike)
    ka.attention_btd_bwd(q, k, v, g, H, out=out, lse=lse)
    name, args = lib.calls[-1]
    assert name == ("ser_attention_btd_bwd_bf16" if dtype == torch.bfloat16 else "ser_attention_btd_bwd_f32")
    assert args[21] == hd and args[22] == pytest.approx(hd ** -0.5)
    assert (args[10] is not None) == (dtype == torch.bfloat16)  # the q*scale scratch
    ka.attention_btd_bwd(q, k, v, g, H, scale=0.3, out=out, lse=lse)
    assert lib.calls[-1][1][22] == pytest.approx(0.3)

    monkeypatch.setattr(ka, "attention_btd_fwd", lambda q, *a, **kw: (q.detach().clone(), lse))
    leaf = q.detach().clone().requires_grad_()
    ka.AttentionBtdTrain.apply(leaf, k, v, H, None, None, None, None).backward(g)
    name, args = lib.calls[-1]
    assert name.startswith("ser_attention_btd_bwd") and args[21] == hd and args[22] == pytest.approx(hd ** -0.5)


def test_card_launchers_refuse_misaligned_bf16(monkeypatch):
    """The bf16 kernels stage rows by 16-byte copies: a bf16 panel that does
    not start on 16 bytes is refused before anything is launched."""
    monkeypatch.setattr(ka._build, "library", lambda: pytest.fail("launched"))
    flat = torch.randn(T * D + 1).to(torch.bfloat16)
    odd = flat[1:].view(1, T, D).as_subclass(_CudaLike)  # contiguous, 2 bytes past a boundary
    with pytest.raises(ValueError, match="16-byte"):
        ka.attention_btd(odd, odd, odd, H)
    lse = torch.zeros(1, H, T).as_subclass(_CudaLike)
    with pytest.raises(ValueError, match="16-byte"):
        ka.attention_btd_bwd(odd, odd, odd, odd, H, out=odd, lse=lse)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_card_launchers_route_f32_by_alignment(kernel, offset, monkeypatch):
    """The f32 kernels also stage rows by 16-byte cp.async: an f32 panel on a
    16-byte boundary goes to the f32 entry point, one ``offset`` floats past
    it (4, 8 or 12 bytes) is refused before anything is launched (no slower
    4-byte route)."""
    lib = _FakeLibrary()
    monkeypatch.setattr(ka._build, "library", lambda: lib)
    monkeypatch.setattr(ka._build, "stream_ptr", lambda t: 0)
    _keep_launch_counts(monkeypatch)
    flat = torch.randn(T * D + 8)
    base = (-flat.data_ptr() // 4) % 4  # floats to the first 16-byte boundary
    x = flat[base + offset:base + offset + T * D].view(1, T, D).as_subclass(_CudaLike)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    lse = torch.zeros(1, H, T).as_subclass(_CudaLike)
    call = (lambda: ka.attention_btd(x, x, x, H)) if kernel == "fwd" else \
        (lambda: ka.attention_btd_bwd(x, x, x, x, H, out=x, lse=lse))
    if offset:
        with pytest.raises(ValueError, match="f32 q must start on a 16-byte boundary"):
            call()
        assert lib.calls == []
    else:
        call()
        assert [name for name, _ in lib.calls] == ["ser_attention_btd_f32" if kernel == "fwd" else "ser_attention_btd_bwd_f32"]


def test_raw_k1_launcher_refuses_inputs_that_require_grad(monkeypatch):
    launched = []
    monkeypatch.setattr(ka, "_launch_forward", lambda *a, **kw: launched.append(a) or (a[0], None))
    q = torch.randn(1, 8, 64).as_subclass(_CudaLike)
    ka.attention_btd(q, q, q, 1)
    assert len(launched) == 1  # no grad anywhere: K1 launches
    with pytest.raises(RuntimeError, match="AttentionBtdTrain"):
        ka.attention_btd(q.clone().requires_grad_(), q, q, 1)
    with torch.no_grad():
        ka.attention_btd(q.clone().requires_grad_(), q, q, 1)  # grad disabled: K1 again
    assert len(launched) == 2


def test_dispatch_routes_card_training_to_the_pair(monkeypatch):
    """attention_core sends a card tensor that needs a gradient to
    AttentionBtdTrain, any other card tensor to K1, a CPU tensor to the plain
    version under ordinary autograd."""
    routes = []
    monkeypatch.setattr(attention_core.AttentionBtdTrain, "apply", lambda *a: routes.append("pair"))
    monkeypatch.setattr(attention_core, "attention_btd", lambda *a, **kw: routes.append("k1"))
    x = torch.randn(1, 8, 64)
    card = x.as_subclass(_CudaLike)
    attention_core.dot_product_attention_btd(card.clone().requires_grad_(), card, card, 1)
    attention_core.dot_product_attention_btd(card, card, card, 1)
    with torch.no_grad():
        attention_core.dot_product_attention_btd(card.clone().requires_grad_(), card, card, 1)
    attention_core.dot_product_attention_btd(x.clone().requires_grad_(), x, x, 1)
    assert routes == ["pair", "k1", "k1", "k1"]  # the CPU tensor: attention_btd, i.e. the plain version
    monkeypatch.undo()
    xg = x.clone().requires_grad_()
    out = attention_core.dot_product_attention_btd(xg, x, x, 1)
    assert type(out.grad_fn).__name__ != "AttentionBtdTrainBackward"
    torch.testing.assert_close(out, ka.attention_btd_plain(x, x, x, 1), atol=0, rtol=0)
    out.sum().backward()
    assert xg.grad is not None
