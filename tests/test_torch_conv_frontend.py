"""K2 (conv0 + LayerNorm + GELU from the waveform): the port's plain version
against the JAX package's fused Pallas frontend in interpret mode, depth 1.

Tolerances: f32 max-abs <= 1e-5 (same math; the conv and norm sums run in
another order); bf16 cosine >= 0.999, because the LayerNorm output is rounded
to bf16 before the GELU and an f32 sum that lands on the other side of a
rounding boundary moves a value by one bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.ops.pallas.conv_frontend import fused_conv_frontend
from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as mod
from interspeech_ser_tpu_torch.ops.kernels.conv_frontend import conv_frontend, conv_frontend_plain

torch.set_num_threads(2)

C, K, S = 32, 10, 5
LENGTHS = (400, 1203, 16007)


def _params(seed, with_bias):
    rng = np.random.default_rng(seed)
    p = {
        "kernel": (rng.standard_normal((K, 1, C)) / np.sqrt(K)).astype(np.float32),  # flax [k, C_in, C]
        "ln_scale": (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        "ln_bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
    }
    if with_bias:
        p["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return p


def _port_args(p):
    weight = torch.from_numpy(np.ascontiguousarray(p["kernel"].transpose(2, 1, 0)))  # [C, 1, k]
    bias = torch.from_numpy(p["bias"]) if "bias" in p else None
    return weight, bias, torch.from_numpy(p["ln_scale"]), torch.from_numpy(p["ln_bias"])


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("approx_gelu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret(dtype, approx_gelu, with_bias):
    p = _params(3 + with_bias, with_bias)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    rng = np.random.default_rng(17)
    for L in LENGTHS:
        wav = rng.standard_normal((2, L)).astype(np.float32)
        ref = fused_conv_frontend(
            jnp.asarray(wav), [{k: jnp.asarray(v) for k, v in p.items()}], (K,), (S,), jdt,
            approx_gelu, eps=1e-5, interpret=True,
        )
        ref = np.asarray(ref.astype(jnp.float32))
        out = conv_frontend_plain(torch.from_numpy(wav), *_port_args(p), S, tdt, approx_gelu, 1e-5)
        assert out.dtype == tdt and tuple(out.shape) == (2, (L - K) // S + 1, C) == ref.shape
        out = out.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        else:
            a, b = out.ravel().astype(np.float64), ref.ravel().astype(np.float64)
            assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) >= 0.999


def test_wrapper_runs_plain_version_on_cpu():
    p = _params(9, True)
    wav = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 999)).astype(np.float32))
    args = (wav, *_port_args(p), S, torch.float32, False, 1e-5)
    before = mod.LAUNCHES
    torch.testing.assert_close(conv_frontend(*args), conv_frontend_plain(*args), rtol=0, atol=0)
    assert mod.LAUNCHES == before
