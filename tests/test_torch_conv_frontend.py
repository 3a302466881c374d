"""K2 (the frontend's first n layers, each conv + LayerNorm + GELU, from the
waveform): the port's plain version against the JAX package's fused Pallas
frontend in interpret mode, at depth 1 and at every depth 1-7.

Tolerances: f32 max-abs <= 1e-5 at depth 1 and <= 1e-4 at depths 2-7
(same math; the conv and norm sums run in another order, and each later
layer sums k * C products); bf16 cosine >= 0.999, because each LayerNorm
output is rounded to bf16 before the GELU and an f32 sum that lands on the
other side of a rounding boundary moves a value by one bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from interspeech_ser_tpu.ops.pallas.conv_frontend import fused_conv_frontend
from interspeech_ser_tpu_torch.ops.kernels import conv_frontend as mod
from interspeech_ser_tpu_torch.ops.kernels.conv_frontend import FrontendLayer, conv_frontend, conv_frontend_plain

torch.set_num_threads(2)

C, K, S = 32, 10, 5
LENGTHS = (400, 1203, 16007)
# the zoo's frontend geometry (conv0 then six 512 -> 512 layers), at C channels
KERNELS = (10, 3, 3, 3, 3, 2, 2)
STRIDES = (5, 2, 2, 2, 2, 2, 2)


def _params(seed, with_bias, k=K, c_in=1):
    rng = np.random.default_rng(seed)
    p = {
        "kernel": (rng.standard_normal((k, c_in, C)) / np.sqrt(k * c_in)).astype(np.float32),  # flax [k, C_in, C]
        "ln_scale": (1.0 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        "ln_bias": (0.1 * rng.standard_normal(C)).astype(np.float32),
    }
    if with_bias:
        p["bias"] = (0.1 * rng.standard_normal(C)).astype(np.float32)
    return p


def _port_layer(p, stride):
    weight = torch.from_numpy(np.ascontiguousarray(p["kernel"].transpose(2, 1, 0)))  # [C, C_in, k]
    bias = torch.from_numpy(p["bias"]) if "bias" in p else None
    return FrontendLayer(weight, bias, torch.from_numpy(p["ln_scale"]), torch.from_numpy(p["ln_bias"]), stride)


def _cosine(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


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
        out = conv_frontend_plain(torch.from_numpy(wav), [_port_layer(p, S)], tdt, approx_gelu, 1e-5)
        assert out.dtype == tdt and tuple(out.shape) == (2, (L - K) // S + 1, C) == ref.shape
        out = out.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        else:
            assert _cosine(out, ref) >= 0.999


@pytest.mark.parametrize("depth", range(1, 8))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_at_depth(dtype, depth):
    """Layers 0..depth-1 of the zoo's geometry (conv biases on, exact GELU in
    f32 and the tanh form in bf16, as the encoders run them)."""
    params = [_params(40 + i, True, KERNELS[i], 1 if i == 0 else C) for i in range(depth)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    approx = dtype == "bfloat16"
    wav = np.random.default_rng(23).standard_normal((2, 6007)).astype(np.float32)
    ref = fused_conv_frontend(
        jnp.asarray(wav), [{k: jnp.asarray(v) for k, v in p.items()} for p in params], KERNELS, STRIDES, jdt,
        approx, eps=1e-5, interpret=True,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    layers = [_port_layer(p, s) for p, s in zip(params, STRIDES)]
    out = conv_frontend_plain(torch.from_numpy(wav), layers, tdt, approx, 1e-5)
    t = 6007
    for k, s in zip(KERNELS[:depth], STRIDES[:depth]):
        t = (t - k) // s + 1
    assert out.dtype == tdt and tuple(out.shape) == (2, t, C) == ref.shape
    out = out.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, atol=1e-5 if depth == 1 else 1e-4, rtol=0)
    else:
        assert _cosine(out, ref) >= 0.999


def test_wrapper_runs_plain_version_on_cpu():
    layers = [_port_layer(_params(9, True), S), _port_layer(_params(10, False, 3, C), 2)]
    wav = torch.from_numpy(np.random.default_rng(1).standard_normal((3, 999)).astype(np.float32))
    args = (wav, layers, torch.float32, False, 1e-5)
    before = mod.LAUNCHES
    torch.testing.assert_close(conv_frontend(*args), conv_frontend_plain(*args), rtol=0, atol=0)
    assert mod.LAUNCHES == before
