"""The port's training losses against ``interspeech_ser_tpu/train/losses.py``
on the same logits and targets, with and without class weights, a sample
mask (padding rows) and dynamic alpha; values and logit gradients at f32
atol 1e-6 (same formulas, other summation order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.train import losses as jl
from interspeech_ser_tpu_torch.train import losses as tl

N, C = 12, 8


def _data(seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((N, C))).astype(np.float32)
    y = rng.integers(0, C, N)
    cw = rng.uniform(0.2, 3.0, C).astype(np.float32)
    smask = (np.arange(N) < N - 3).astype(np.float32)  # the last 3 rows pad the batch
    return logits, y, cw, smask


def _check(jfn, tfn, logits):
    want, jgrad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_weighted_cross_entropy(weighted, masked):
    logits, y, cw, smask = _data(0)
    jw, tw = (jnp.asarray(cw), torch.from_numpy(cw)) if weighted else (None, None)
    jm, tm = (jnp.asarray(smask), torch.from_numpy(smask)) if masked else (None, None)
    _check(lambda z: jl.weighted_cross_entropy(z, jnp.asarray(y), jw, jm),
           lambda z: tl.weighted_cross_entropy(z, torch.from_numpy(y), tw, tm), logits)


@pytest.mark.parametrize("dynamic_alpha", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_focal_loss(dynamic_alpha, masked):
    logits, y, _, smask = _data(1)
    jm, tm = (jnp.asarray(smask), torch.from_numpy(smask)) if masked else (None, None)
    _check(lambda z: jl.focal_loss(z, jnp.asarray(y), 1.0, 2.0, dynamic_alpha, jm),
           lambda z: tl.focal_loss(z, torch.from_numpy(y), 1.0, 2.0, dynamic_alpha, tm), logits)


@pytest.mark.parametrize("masked", [False, True])
def test_soft_margin_loss(masked):
    logits, y, _, smask = _data(2)
    neutral = logits[:, :1].copy()
    target = (2.0 * (y == C - 1) - 1.0).astype(np.float32)[:, None]
    jm, tm = (jnp.asarray(smask), torch.from_numpy(smask)) if masked else (None, None)
    _check(lambda z: jl.soft_margin_loss(z, jnp.asarray(target), jm),
           lambda z: tl.soft_margin_loss(z, torch.from_numpy(target), tm), neutral)


def test_soft_margin_matches_torch_module():
    x, t = torch.randn(9, 1), torch.tensor([1.0, -1.0] * 4 + [1.0])[:, None]
    torch.testing.assert_close(tl.soft_margin_loss(x, t), torch.nn.SoftMarginLoss()(x, t))


def test_weighted_ce_matches_torch_module():
    logits, y, cw, _ = _data(3)
    want = torch.nn.CrossEntropyLoss(weight=torch.from_numpy(cw))(torch.from_numpy(logits), torch.from_numpy(y))
    torch.testing.assert_close(tl.weighted_cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                                                         torch.from_numpy(cw)), want)
