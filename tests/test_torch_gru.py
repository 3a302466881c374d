"""K3 (bidirectional GRU recurrence) and the port's BiGRU against the JAX
package: the Pallas kernel in interpret mode and the ``lax.scan`` BiGRU,
with the same weights. B=3, T=11, H=8, ragged masks; f32 max-abs <= 1e-5
(same math, other summation order).
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
