"""K3b (the BiGRU backward) and the port's BiGRU gradients against the JAX
package: ``_bidir_bwd_kernel_impl`` (the Pallas kernel, interpret mode) and
``_gru_bidir_bwd_scan``, and ``jax.grad`` of the JAX ``BiGRU(use_kernel=True)``
(the custom VJP). B=3, T=17, H=8, ragged masks. Bars: the backward alone
atol 1e-5 (same math, other summation order); gradients of a whole BiGRU
atol 5e-5, as tests/test_gru_kernel.py holds the JAX kernel to its scan.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.ops.gru import BiGRU as JaxBiGRU
from interspeech_ser_tpu.ops.pallas import gru_kernel as jk
from interspeech_ser_tpu_torch.ops.gru import BiGRU
from interspeech_ser_tpu_torch.ops.kernels import gru as kg

torch.set_num_threads(2)

B, T, H, I = 3, 17, 8, 10
LENGTHS = np.array([17, 11, 6])


def _mask():
    return (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)


def _residuals(seed):
    """(x_proj, w_hh2, b_hh2, mask, h, g): the saved forward state and a
    non-uniform cotangent, backward rows reversed in time."""
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((2 * B, T, 3 * H)).astype(np.float32)
    w_hh2 = rng.uniform(-0.35, 0.35, (2, H, 3 * H)).astype(np.float32)
    b_hh2 = rng.uniform(-0.35, 0.35, (2, 3 * H)).astype(np.float32)
    m = _mask()
    mask = np.concatenate([m, m[:, ::-1]]).copy()
    h = np.array(jk.gru_bidir_carries(*(jnp.asarray(a) for a in (x_proj, w_hh2, b_hh2, mask)), True))
    g = (rng.standard_normal((2 * B, T, H)) * rng.uniform(0.2, 2.0, (2 * B, T, 1))).astype(np.float32)
    return x_proj, w_hh2, b_hh2, mask, h, g


@pytest.mark.parametrize("reference", ["pallas_interpret", "scan"])
def test_plain_backward_matches_jax(reference):
    args = _residuals(0)
    jargs = [jnp.asarray(a) for a in args]
    if reference == "pallas_interpret":
        ref = jk._bidir_bwd_kernel_impl(*jargs, True)
    else:
        ref = jk._gru_bidir_bwd_scan(None, tuple(jargs[:5]), jargs[5])[:3]
    before = kg.BWD_LAUNCHES
    out = kg.gru_bidir_carries_bwd(*(torch.from_numpy(a) for a in args))
    assert kg.BWD_LAUNCHES == before  # a CPU tensor runs the plain version
    for name, got, want in zip(("dx_proj", "dW_hh2", "db_hh2"), out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("b,t,h", [(37, 9, 8), (3, 7, 100), (3, 7, 40), (2, 5, 640), (3, 1, 8)])
def test_plain_backward_matches_pallas_interpret_at_edges(b, t, h):
    """The plain backward (K3b's reference on the card) against the JAX Pallas
    backward in interpret mode at the cluster route's edges: 2B = 74 (a
    partial group of 16 rows), H not a multiple of 32, H = 640 (the row
    route), T = 1, and masks with holes, a row masked from step 0 and a step
    masked in every row. Bar: atol 1e-5 x max(1, max|ref|)."""
    rng = np.random.default_rng(b * 1000 + t * 10 + h)
    x_proj = rng.standard_normal((2 * b, t, 3 * h)).astype(np.float32)
    w_hh2 = (rng.uniform(-1, 1, (2, h, 3 * h)) * h ** -0.5).astype(np.float32)
    b_hh2 = (rng.uniform(-1, 1, (2, 3 * h)) * h ** -0.5).astype(np.float32)
    mask = (rng.random((2 * b, t)) > 0.3).astype(np.float32)
    mask[1, : max(1, t // 2)] = 0.0
    mask[:, t // 3] = 0.0
    h_all = np.array(jk.gru_bidir_carries(*(jnp.asarray(a) for a in (x_proj, w_hh2, b_hh2, mask)), True))
    g = rng.standard_normal((2 * b, t, h)).astype(np.float32)
    args = (x_proj, w_hh2, b_hh2, mask, h_all, g)
    ref = jk._bidir_bwd_kernel_impl(*(jnp.asarray(a) for a in args), True)
    out = kg.gru_bidir_carries_bwd(*(torch.from_numpy(a) for a in args))
    for name, got, want in zip(("dx_proj", "dW_hh2", "db_hh2"), out, ref):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * max(1.0, float(np.abs(want).max())), rtol=0,
                                   err_msg=name)
    assert float(np.abs(out[0].numpy()[mask == 0]).max()) == 0.0  # a masked step has no input gradient


def _port_bigru(params) -> BiGRU:
    m = BiGRU(I, H)
    sd = {}
    for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
        sd[f"weight_ih_l0{sfx}"] = np.asarray(params[f"w_ih_{d}"]).T
        sd[f"weight_hh_l0{sfx}"] = np.asarray(params[f"w_hh_{d}"]).T
        sd[f"bias_ih_l0{sfx}"] = np.asarray(params[f"b_ih_{d}"])
        sd[f"bias_hh_l0{sfx}"] = np.asarray(params[f"b_hh_{d}"])
    m.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    return m


@pytest.mark.parametrize("route", ["scan", "stacked"])
def test_bigru_grads_match_jax_kernel_vjp(route):
    """All 8 parameters and x. ``scan``: the CPU path (autograd through
    gru_scan); ``stacked``: the card's route (GruBidirCarries, here with the
    plain forward and backward)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    wy = rng.standard_normal((B, T, 2 * H)).astype(np.float32)
    mask = _mask()
    model = JaxBiGRU(H)
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss(p, x_):
        out = model.apply({"params": p}, x_, jnp.asarray(mask), use_kernel=True)
        return jnp.sum(out * wy) + jnp.sum(jnp.tanh(out))

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    port = _port_bigru(params)
    xt = torch.from_numpy(x).requires_grad_()
    fwd = port.forward_stacked if route == "stacked" else port.forward
    out = fwd(xt, torch.from_numpy(mask))
    (torch.sum(out * torch.from_numpy(wy)) + torch.sum(torch.tanh(out))).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=5e-5, rtol=0)
    for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
        for jname, tname, transpose in (("w_ih", "weight_ih_l0", True), ("w_hh", "weight_hh_l0", True),
                                        ("b_ih", "bias_ih_l0", False), ("b_hh", "bias_hh_l0", False)):
            want = np.asarray(g_params[f"{jname}_{d}"])
            got = getattr(port, tname + sfx).grad.numpy()
            np.testing.assert_allclose(got, want.T if transpose else want, atol=5e-5, rtol=0,
                                       err_msg=f"{tname}{sfx}")


@pytest.mark.parametrize("route", ["scan", "stacked"])
def test_no_input_gradient_beyond_mask(route):
    torch.manual_seed(2)
    model = BiGRU(I, H)
    x = torch.randn(B, T, I, requires_grad=True)
    fwd = model.forward_stacked if route == "stacked" else model.forward
    (fwd(x, torch.from_numpy(_mask())) ** 2).sum().backward()
    for i, n in enumerate(LENGTHS):
        assert x.grad[i, :n].abs().max() > 0.0
        if n < T:
            assert x.grad[i, n:].abs().max() == 0.0


def test_function_matches_autograd_through_plain_forward():
    x_proj, w_hh2, b_hh2, mask, _, g = (torch.from_numpy(a) for a in _residuals(3))
    grads = []
    for fn in (kg.GruBidirCarries.apply, kg.gru_bidir_carries_plain):
        leaves = [t.clone().requires_grad_() for t in (x_proj, w_hh2, b_hh2)]
        grads.append(torch.autograd.grad(fn(*leaves, mask), leaves, g))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def test_function_gradcheck_float64():
    """The hand-derived backward against numerical derivatives (the plain
    versions keep float64)."""
    rng = np.random.default_rng(4)
    b, t, h = 2, 6, 4
    x = torch.tensor(rng.standard_normal((2 * b, t, 3 * h)), requires_grad=True)
    w = torch.tensor(rng.uniform(-0.5, 0.5, (2, h, 3 * h)), requires_grad=True)
    bias = torch.tensor(rng.uniform(-0.5, 0.5, (2, 3 * h)), requires_grad=True)
    m = (torch.arange(t)[None] < torch.tensor([6, 3])[:, None]).double()
    mask = torch.cat([m, m.flip(1)])
    assert torch.autograd.gradcheck(lambda *a: kg.GruBidirCarries.apply(*a, mask), (x, w, bias))
