"""K3 (bidirectional GRU recurrence) and the port's BiGRU against the JAX
package: the Pallas kernel in interpret mode and the ``lax.scan`` BiGRU,
with the same weights. B=3, T=11, H=8, ragged masks; f32 max-abs <= 1e-5
(same math, other summation order). Also K3's edge shapes (masks with
holes, rows that are not a multiple of the cluster route's 16, H not a
multiple of its 32 units a CTA) and its launch planner, which is host code.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.ops.gru import BiGRU as JaxBiGRU
from interspeech_ser_tpu.ops.gru import gru_scan as jax_gru_scan
from interspeech_ser_tpu.ops.pallas.gru_kernel import gru_bidir_carries as jax_carries
from interspeech_ser_tpu.ops.pallas.gru_kernel import gru_sequence_bidir as jax_sequence_bidir
from interspeech_ser_tpu_torch.ops.gru import BiGRU, gru_scan
from interspeech_ser_tpu_torch.ops.kernels import gru as mod

torch.set_num_threads(2)

B, T, H, I = 3, 11, 8, 6
LENGTHS = np.array([11, 7, 3])


def _mask():
    return (np.arange(T)[None] < LENGTHS[:, None]).astype(np.float32)


def _stacked_inputs(seed):
    rng = np.random.default_rng(seed)
    x_proj = rng.standard_normal((2 * B, T, 3 * H)).astype(np.float32)
    w_hh2 = rng.uniform(-0.35, 0.35, (2, H, 3 * H)).astype(np.float32)
    b_hh2 = rng.uniform(-0.35, 0.35, (2, 3 * H)).astype(np.float32)
    m = _mask()
    mask = np.concatenate([m, m[:, ::-1]]).copy()  # backward rows reversed in time
    return x_proj, w_hh2, b_hh2, mask


def test_plain_carries_match_pallas_interpret():
    args = _stacked_inputs(0)
    ref = np.asarray(jax_carries(*(jnp.asarray(a) for a in args), True))
    out = mod.gru_bidir_carries(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_sequence_bidir_matches_pallas_interpret():
    args = _stacked_inputs(1)
    ref = np.asarray(jax_sequence_bidir(*(jnp.asarray(a) for a in args), B, interpret=True))
    before = mod.LAUNCHES
    out = mod.gru_sequence_bidir(*(torch.from_numpy(a) for a in args), B)
    assert mod.LAUNCHES == before  # the CPU path launches nothing
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        mod.gru_sequence_bidir(*(torch.from_numpy(a) for a in args), B + 1)


@pytest.mark.parametrize("b,t,h", [(5, 13, 40), (17, 9, 8), (2, 7, 100)])
def test_plain_carries_match_pallas_interpret_at_edges(b, t, h):
    """Masks with holes (not prefixes) and a row that starts late, 2B not a
    multiple of 16 rows, H not a multiple of 32 units."""
    rng = np.random.default_rng(b * 100 + h)
    x_proj = rng.standard_normal((2 * b, t, 3 * h)).astype(np.float32)
    w_hh2 = rng.uniform(-0.35, 0.35, (2, h, 3 * h)).astype(np.float32)
    b_hh2 = rng.uniform(-0.35, 0.35, (2, 3 * h)).astype(np.float32)
    mask = (rng.random((2 * b, t)) > 0.3).astype(np.float32)
    mask[1, : t // 2] = 0.0
    args = (x_proj, w_hh2, b_hh2, mask)
    ref = np.asarray(jax_carries(*(jnp.asarray(a) for a in args), True))
    out = mod.gru_bidir_carries(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    # a step whose mask is 0 leaves the carry as it was (the kernel may skip its product)
    held = mask[:, 1:] == 0
    np.testing.assert_array_equal(out.numpy()[:, 1:][held], out.numpy()[:, :-1][held])


def test_launch_planner_for_every_hidden_size():
    """Route, cluster size C, rows R and a block's shared memory for each H up
    to 4096: the cluster route while a CTA's 3 x 32 columns of w_hh (less
    the 128 depth rows kept in registers), two h buffers of 16 rows, two
    staging tiles and two mbarriers fit 227 KB (H <= 512), one block a row
    above; H > 4096 is refused."""
    for h in range(1, 4097):
        plan = mod.gru_bidir_plan(128, h)
        assert plan.smem_bytes <= mod.SMEM_LIMIT, (h, plan)
        if h <= 512:
            c = -(-h // 32)
            assert (plan.route, plan.cluster, plan.rows, plan.threads) == ("cluster", c, 16, 256), (h, plan)
            in_regs = 128 if c >= 4 else 0  # the first 128 depth rows of w_hh stay in registers
            assert plan.smem_bytes == 4 * (3 * 32 * (32 * c - in_regs) + 2 * 16 * 32 * c + 2 * 16 * 32) + 16
            assert plan.grid == (c, 4, 2)
        else:
            assert (plan.route, plan.rows, plan.grid) == ("row", 1, (128, 1, 1)), (h, plan)
            assert plan.threads % 32 == 0 and h <= 4 * plan.threads <= 4 * 1024
    assert mod.gru_bidir_plan(128, 512).smem_bytes == 217104
    assert mod.gru_bidir_plan(74, 512).grid == (16, 3, 2)  # 37 rows a direction: 3 groups of 16
    with pytest.raises(NotImplementedError):
        mod.gru_bidir_plan(128, 4097)


@pytest.mark.parametrize("kernel", ["gru_sequence", "gru_bidir_bwd"])
def test_k9_and_k3b_planners_for_every_hidden_size(kernel):
    """K9's and K3b's routes for each H up to 4096, at a batch of 64 rows a
    direction: the cluster route (C = ceil(H/32) CTAs of 256 threads, R = 16
    rows) for H <= 512, one block a row above; every plan fits 227 KB; H >
    4096 is refused. K9 is K3's kernel for one direction (K3's shared
    memory, a grid of depth 1); K3b keeps 72 of a CTA's 96 w_hh columns in
    shared memory beside two dhp tiles [16][96] and two receive buffers
    [C][16][32]."""
    plan_of = getattr(mod, f"{kernel}_plan")
    rows = 64 if kernel == "gru_sequence" else 128
    for h in range(1, 4097):
        plan = plan_of(rows, h)
        assert plan.smem_bytes <= mod.SMEM_LIMIT, (h, plan)
        if h <= 512:
            c = -(-h // 32)
            assert (plan.route, plan.cluster, plan.rows, plan.threads) == ("cluster", c, 16, 256), (h, plan)
            if kernel == "gru_sequence":
                assert plan.smem_bytes == mod.gru_bidir_plan(128, h).smem_bytes
                assert plan.grid == (c, 4, 1)
            else:
                assert plan.smem_bytes == 4 * (72 * 32 * c + 2 * 16 * 96 + 2 * c * 16 * 32) + 16
                assert plan.grid == (c, 4, 2)
        else:
            assert (plan.route, plan.rows) == ("row", 1), (h, plan)
            assert plan.grid == (rows, 1, 1)
            assert plan.threads % 32 == 0 and h <= 4 * plan.threads <= 4 * 1024
            assert plan.smem_bytes == (4 * h if kernel == "gru_sequence" else 24 * h)
    assert plan_of(rows, 512).smem_bytes == (217104 if kernel == "gru_sequence" else 225296)
    assert plan_of(74 if kernel == "gru_bidir_bwd" else 37, 512).grid[1] == 3  # 37 rows: 3 groups of 16
    with pytest.raises(NotImplementedError):
        plan_of(rows, 4097)


@pytest.mark.parametrize("b2,t,h,want", [(128, 512, 512, 11), (128, 512, 4096, 1), (74, 20, 512, 1),
                                         (74, 32, 512, 2), (2, 1, 8, 1), (512, 512, 64, 16)])
def test_dw_splits(b2, t, h, want):
    """K3b's dW product splits the row-steps into S chunks (at least 512
    row-steps each, at most 16) so that its blocks fill whole waves of two
    blocks on each of the card's 132 SMs: at H = 512, 96 tiles x 11 = 1056 =
    4 waves of 264; none from 4 waves of tiles on."""
    assert mod.dw_splits(b2, t, h) == want


def _edge_mask(rng, rows, t):
    """Holes anywhere, row 1 masked from step 0 to the middle, one step masked in every row."""
    mask = (rng.random((rows, t)) > 0.3).astype(np.float32)
    mask[1, : max(1, t // 2)] = 0.0
    mask[:, t // 3] = 0.0
    return mask


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("b,t,h", [(37, 9, 8), (3, 7, 100), (3, 7, 40), (2, 5, 640), (3, 1, 8)])
def test_gru_sequence_plain_matches_pallas_interpret_at_edges(b, t, h, reverse):
    """K9's plain version against the JAX ``gru_sequence`` (interpret mode)
    at its routes' edges: 37 rows (a partial group of 16), H not a multiple
    of 32, H = 640 (the row route), T = 1, and masks with holes, a row masked
    from step 0 and a step masked in every row."""
    rng = np.random.default_rng(b * 1000 + t * 10 + h)
    x_proj = rng.standard_normal((b, t, 3 * h)).astype(np.float32)
    w_hh = (rng.uniform(-1, 1, (h, 3 * h)) * h ** -0.5).astype(np.float32)
    b_hh = (rng.uniform(-1, 1, 3 * h) * h ** -0.5).astype(np.float32)
    mask = _edge_mask(rng, b, t)
    from interspeech_ser_tpu.ops.pallas.gru_kernel import gru_sequence as jax_gru_sequence

    ref = np.asarray(jax_gru_sequence(*(jnp.asarray(a) for a in (x_proj, w_hh, b_hh, mask)), reverse,
                                      interpret=True))
    out = mod.gru_sequence(*(torch.from_numpy(a) for a in (x_proj, w_hh, b_hh, mask)), reverse)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)
    assert float(np.abs(out.numpy()[mask == 0]).max()) == 0.0


def _jax_bigru_params(seed):
    x = jnp.zeros((B, T, I), jnp.float32)
    return JaxBiGRU(H).init(jax.random.PRNGKey(seed), x, jnp.ones((B, T)))["params"]


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


@pytest.mark.parametrize("masked", [True, False])
def test_bigru_matches_jax_scan(masked):
    params = _jax_bigru_params(2)
    x = np.random.default_rng(3).standard_normal((B, T, I)).astype(np.float32)
    mask = _mask() if masked else None
    ref = JaxBiGRU(H).apply({"params": params}, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    model = _port_bigru(params)
    with torch.no_grad():
        out = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        stacked = model.forward_stacked(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # the kernel route's stacking / reversal, run here through K3's plain version
    np.testing.assert_allclose(stacked.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_scan_matches_jax(reverse):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, I)).astype(np.float32)
    w_ih = rng.uniform(-0.35, 0.35, (I, 3 * H)).astype(np.float32)  # flax layout [in, 3H]
    w_hh = rng.uniform(-0.35, 0.35, (H, 3 * H)).astype(np.float32)
    b_ih, b_hh = (rng.uniform(-0.35, 0.35, 3 * H).astype(np.float32) for _ in range(2))
    h0 = np.zeros((B, H), np.float32)
    ref = jax_gru_scan(*(jnp.asarray(a) for a in (x, h0, w_ih, w_hh, b_ih, b_hh, _mask())), reverse=reverse)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = gru_scan(t(x), t(h0), t(w_ih.T), t(w_hh.T), t(b_ih), t(b_hh), t(_mask()), reverse=reverse)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
