"""The legacy trainers' losses and the gradient reversal against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``interspeech_ser_tpu/train/losses.py``
(``jax.value_and_grad``) and ``interspeech_ser_tpu_torch/train/losses.py``
(autograd): each value within 1e-6 and each input gradient within 1e-5
(f32, other summation order), with and without a sample mask that drops
padding rows; the masked value also against the unpadded rows alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interspeech_ser_tpu.ops.grl import gradient_reversal as jax_grl
from interspeech_ser_tpu.train import losses as J
from interspeech_ser_tpu_torch.ops.grl import gradient_reversal
from interspeech_ser_tpu_torch.train import losses as P

B, C, A, D = 10, 8, 3, 12


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    y = np.arange(B) % C
    rng.shuffle(y)
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0  # three padding rows
    pred = rng.standard_normal((B, A)).astype(np.float32)
    return {
        "logits": (2.0 * rng.standard_normal((B, C))).astype(np.float32),
        "y": y.astype(np.int64),
        "one_hot": np.eye(C, dtype=np.float32)[y],
        "class_w": rng.uniform(0.3, 3.0, C).astype(np.float32),
        "gender_logits": rng.standard_normal((B, 2)).astype(np.float32),
        "gender": (rng.random(B) < 0.5).astype(np.int64),
        # attributes near the predictions: a loss of order 1, so f32 rounding stays under 1e-6
        "pred": pred,
        "lab": (pred + 0.5 * rng.standard_normal((B, A))).astype(np.float32),
        "feat_a": rng.standard_normal((B, 2 * D)).astype(np.float32),
        "feat_b": (rng.standard_normal((B, 2 * D)) + 0.5).astype(np.float32),
        "mask": mask,
    }


# name -> (the differentiated inputs, the extra inputs, a call of either package's function)
CASES = {
    "smoothed_ce": (("logits",), ("y",), lambda L, x, k, m: L.smoothed_cross_entropy(
        x["logits"], k["y"], smoothing=0.1, sample_mask=m)),
    "smoothed_ce_class_w": (("logits",), ("y", "class_w"), lambda L, x, k, m: L.smoothed_cross_entropy(
        x["logits"], k["y"], smoothing=0.1, class_weights=k["class_w"], sample_mask=m)),
    "hierarchical": (("logits",), ("y",), lambda L, x, k, m: L.hierarchical_loss(
        x["logits"], k["y"], sample_mask=m)),
    "hierarchical_class_w": (("logits",), ("y", "class_w"), lambda L, x, k, m: L.hierarchical_loss(
        x["logits"], k["y"], k["class_w"], sample_mask=m)),
    "svm_ranking": (("gender_logits",), ("gender",), lambda L, x, k, m: L.svm_ranking_loss(
        x["gender_logits"], k["gender"], sample_mask=m)),
    "cka": (("feat_a", "feat_b"), (), lambda L, x, k, m: L.cka_loss(x["feat_a"], x["feat_b"], sample_mask=m)),
    "mse_emotion": (("pred",), ("lab",), lambda L, x, k, m: L.mse_emotion(x["pred"], k["lab"], sample_mask=m)),
}


def _jax_value_and_grads(case, inp, masked):
    diff, extra, call = CASES[case]
    k = {n: jnp.asarray(inp[n]) for n in extra}
    m = jnp.asarray(inp["mask"]) if masked else None
    fn = lambda *xs: call(J, dict(zip(diff, xs)), k, m)  # noqa: E731
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(diff))))(*[jnp.asarray(inp[n]) for n in diff])
    return float(value), [np.asarray(g) for g in grads]


def _port_value_and_grads(case, inp, masked, rows=slice(None)):
    diff, extra, call = CASES[case]
    xs = {n: torch.tensor(inp[n][rows], requires_grad=True) for n in diff}
    k = {n: torch.from_numpy(inp[n] if n == "class_w" else inp[n][rows]) for n in extra}
    m = torch.from_numpy(inp["mask"][rows]) if masked else None
    value = call(P, xs, k, m)
    value.backward()
    return value.item(), [xs[n].grad.numpy() for n in diff]


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_gradient_match_jax(case, masked):
    inp = _inputs(seed=sorted(CASES).index(case))
    want, want_grads = _jax_value_and_grads(case, inp, masked)
    got, got_grads = _port_value_and_grads(case, inp, masked)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    if masked:  # masked rows add nothing: the value of the valid rows alone
        alone, _ = _port_value_and_grads(case, inp, False, rows=slice(0, B - 3))
        np.testing.assert_allclose(got, alone, atol=1e-6, rtol=0)


def test_diff_f1_matches_jax():
    """diff-F1 takes no mask in either package: every row counts."""
    inp = _inputs(seed=11)
    want, want_grad = jax.value_and_grad(lambda z: J.diff_f1_loss(z, jnp.asarray(inp["one_hot"])))(
        jnp.asarray(inp["logits"]))
    logits = torch.tensor(inp["logits"], requires_grad=True)
    got = P.diff_f1_loss(logits, torch.from_numpy(inp["one_hot"]))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(want_grad), atol=1e-5, rtol=0)


def test_emotion_similarity_is_the_jax_prior():
    np.testing.assert_array_equal(P.EMOTION_SIMILARITY, J.EMOTION_SIMILARITY)


@pytest.mark.parametrize("lambda_", [1.0, 0.3])
def test_gradient_reversal(lambda_):
    """Forward the identity, backward -lambda x the incoming gradient, as the JAX custom_vjp."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    out = gradient_reversal(xt, lambda_)
    assert torch.equal(out, torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), -lambda_ * w, atol=0, rtol=0)
    want = jax.grad(lambda z: jnp.sum(jax_grl(z, lambda_) * w))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=0, rtol=0)
