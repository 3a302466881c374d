"""The port's information-encoder module against the JAX package's: the timbre
perturbation (the shift sampler, the spectral-envelope warp and its three
wrappers, on the same numpy seeds), flax's BatchNorm running statistics,
``ReferenceEncoderClassifier`` and ``train_reference_encoder``.

Weights go from the JAX nets to the port (``models/convert.py``). Bars: the
perturbed samples within 1e-6 (the same float64 scipy STFT on both sides);
forwards within 1e-5; running statistics within 1e-6; a train step's
checkpoint within 1e-5 of JAX's, its keys equal, but where Adam scales a
gradient at the rounding-noise floor to a step of +-lr (the tests say
which).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from interspeech_ser_tpu.train import information_encoder as jie
from interspeech_ser_tpu_torch.models.convert import reference_encoder_classifier_params_from_flax
from interspeech_ser_tpu_torch.ops.batch_norm import RunningBatchNorm
from interspeech_ser_tpu_torch.train import information_encoder as pie
from interspeech_ser_tpu_torch.utils.seeding import numpy_generator

torch.set_num_threads(2)


def voiced(n, f0=140.0, sr=16000, seed=0):
    """A vowel-like wave: harmonics of f0 under two formant peaks, a little noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = sum(np.sin(2 * np.pi * k * f0 * t) * (np.exp(-((k * f0 - 700) / 300) ** 2)
                                              + 0.6 * np.exp(-((k * f0 - 1800) / 400) ** 2) + 0.05)
            for k in range(1, 40))
    return (0.2 * x / np.abs(x).max() + 0.01 * rng.standard_normal(n)).astype(np.float32)


def test_formant_shift_sampler_draws_as_jax():
    a, b = numpy_generator(11), numpy_generator(11)
    got = [pie.formant_shift_sampler(1.4, a) for _ in range(50)]
    want = [jie.formant_shift_sampler(1.4, b) for _ in range(50)]
    assert got == want
    assert all(1 / 1.4 <= s <= 1.4 for s in got) and min(got) < 1 < max(got)


@pytest.mark.parametrize("shift", [0.8, 1.0005, 1.25, 1.4])
def test_formant_shift_dsp_matches_jax(shift):
    """The warp itself (a shift within 1e-3 of 1 returns the input; a wav under
    512 samples too)."""
    wav = voiced(9000, seed=1)
    got = pie._formant_shift_dsp(wav, 16000, shift)
    want = jie._formant_shift_dsp(wav, 16000, shift)
    assert got.dtype == np.float32 and got.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if abs(shift - 1) < 1e-3:
        np.testing.assert_array_equal(got, wav)
    else:
        assert np.abs(got - wav).max() > 1e-3  # the envelope moved
    short = wav[:400]
    np.testing.assert_array_equal(pie._formant_shift_dsp(short, 16000, shift), short)


@pytest.mark.parametrize("which", ["fixed", "sliced", "timbre"])
def test_perturbations_match_jax_for_a_seed(which):
    """The same seed draws the same shifts and yields the same samples; the
    generators are left in the same state."""
    wav = voiced(20000, f0=120.0, seed=2)
    a, b = numpy_generator(5), numpy_generator(5)
    if which == "fixed":
        got, want = pie.fixed_timbre_perturb(wav, rng=a), jie.fixed_timbre_perturb(wav, rng=b)
    elif which == "sliced":
        got, want = pie.sliced_timbre_perturb(wav, rng=a), jie.sliced_timbre_perturb(wav, rng=b)
    else:
        got, want = pie.timbre_perturb(wav, 16000, 1.3), jie.timbre_perturb(wav, 16000, 1.3)
    assert got.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert a.random() == b.random()


def test_running_batch_norm_keeps_flax_statistics():
    """A training forward moves ``running_var`` by flax's rule (the biased
    batch variance), which ``torch.nn.BatchNorm1d`` does not: on a [4, 3]
    batch torch's value is off by more than the bar, flax's and the port's
    agree within 1e-6; the outputs agree in training and eval mode."""
    x = np.random.default_rng(3).normal(size=(4, 3)).astype(np.float32) * 2 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_flax, upd = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    want_var = np.asarray(upd["batch_stats"]["var"])
    want_mean = np.asarray(upd["batch_stats"]["mean"])

    port = RunningBatchNorm(3).train()
    y_port = port(torch.from_numpy(x))
    np.testing.assert_allclose(y_port.detach().numpy(), np.asarray(y_flax), atol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), want_var, atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_mean.numpy(), want_mean, atol=1e-6, rtol=0)
    torch_bn = torch.nn.BatchNorm1d(3, momentum=0.1).train()
    torch_bn(torch.from_numpy(x))
    assert np.abs(torch_bn.running_var.numpy() - want_var).max() > 1e-3

    port.eval()
    y_eval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5).apply(
        {"params": variables["params"], "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(), np.asarray(y_eval), atol=1e-5)
    assert set(port.state_dict()) == {"weight", "bias", "running_mean", "running_var"}


def reference_pair(num_mel=16, emb=8, n_cls=4, proj=False, mel=None, seed=0):
    jnet = jie.ReferenceEncoderClassifier(num_mel, emb, n_cls, use_nonlinear_proj=proj)
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(mel[:1]), deterministic=False)
    pnet = pie.ReferenceEncoderClassifier(num_mel, emb, n_cls, use_nonlinear_proj=proj)
    pnet.load_state_dict(reference_encoder_classifier_params_from_flax(
        jax.tree.map(np.asarray, variables["params"]), jax.tree.map(np.asarray, variables["batch_stats"])))
    return jnet, variables, pnet


@pytest.mark.parametrize("proj", [False, True])
def test_reference_encoder_classifier_matches_jax(proj):
    """Eval forward within 1e-5; one training forward (batch moments, no
    dropout) within 1e-5 and the running statistics it leaves within 1e-6."""
    mel = np.random.default_rng(4).normal(size=(3, 70, 16)).astype(np.float32)
    jnet, variables, pnet = reference_pair(proj=proj, mel=mel)
    pnet.eval()
    with torch.no_grad():
        got = pnet(torch.from_numpy(mel)).numpy()
    want = np.asarray(jnet.apply(variables, jnp.asarray(mel)))
    assert got.shape == (3, 4)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    if not proj:  # the JAX net's training forward needs no dropout rng without the projection
        want_t, upd = jnet.apply(variables, jnp.asarray(mel), deterministic=False, mutable=["batch_stats"])
        pnet.train()
        with torch.no_grad():
            got_t = pnet(torch.from_numpy(mel)).numpy()
        np.testing.assert_allclose(got_t, np.asarray(want_t), atol=1e-5, rtol=0)
        for i, bn in enumerate(pnet.bn):
            for mine, theirs in (("running_mean", "mean"), ("running_var", "var")):
                np.testing.assert_allclose(getattr(bn, mine).numpy(), np.asarray(upd["batch_stats"][f"bn{i}"][theirs]),
                                           atol=1e-6, rtol=0, err_msg=f"bn{i} {mine}")


def flat_to_trees(flat):
    """A flat checkpoint (``conv0.kernel``, ``batch_stats.bn0.mean``) -> (params, batch_stats) trees."""
    params, stats = {}, {}
    for key, v in flat.items():
        node, parts = (stats, key.split(".")[1:]) if key.startswith("batch_stats.") else (params, key.split("."))
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(v)
    return params, stats


def train_batches(n, shape=(8, 128, 40), seed=6):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=shape).astype(np.float32) + 0.5 * rng.normal(), rng.integers(0, 4, shape[0]))
            for _ in range(n)]


def test_reference_encoder_train_step_matches_jax(tmp_path):
    """One step of each trainer from the same weights: ``checkpoint_1.pth``'s
    keys equal and its values within 1e-5, but where Adam's first step, lr *
    g / (|g| + eps), takes the sign of a gradient at the rounding-noise floor
    (below 1e-6: the conv biases, whose true gradient is 0 under a
    training-mode BatchNorm, and kernel elements whose gradient is 0 or
    nearly), where both packages move by at most lr."""
    train = train_batches(1)
    jnet, variables, pnet = reference_pair(num_mel=40, mel=train[0][0], seed=0)
    lr = 1e-3
    kw = dict(epochs=1, eval_epochs=5, lr=lr, checkpoint_every=1, seed=0, log=lambda *_: None)
    jie.train_reference_encoder(jnet, lambda: iter(train), lambda: iter([]), save_model_path=str(tmp_path / "j"), **kw)
    pie.train_reference_encoder(pnet, lambda: iter(train), lambda: iter([]), save_model_path=str(tmp_path / "p"), **kw)

    def loss_fn(p):
        logits, _ = jnet.apply({"params": p, "batch_stats": variables["batch_stats"]}, jnp.asarray(train[0][0]),
                               deterministic=False, mutable=["batch_stats"])
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(train[0][1])[:, None], -1))

    grads = jax.grad(loss_fn)(variables["params"])
    j = torch.load(tmp_path / "j" / "checkpoint_1.pth", weights_only=True)
    p = torch.load(tmp_path / "p" / "checkpoint_1.pth", weights_only=True)
    assert set(j) == set(p)
    for k in j:
        d = (p[k] - j[k]).abs().numpy()
        if k.startswith("batch_stats."):
            np.testing.assert_allclose(d, 0, atol=1e-5, err_msg=k)
            continue
        g = np.abs(np.asarray(grads[k.split(".")[0]][k.split(".")[1]] if "." in k else grads[k]))
        floor = g < 1e-6
        assert d[~floor].max(initial=0) <= 1e-5, k
        assert d[floor].max(initial=0) <= 2 * lr + 1e-6, k


def test_train_reference_encoder_matches_jax(tmp_path):
    """Two epochs of three batches from the same initial weights (the JAX
    trainer's own init, carried to the port): the same ``checkpoint_*`` /
    ``best_model_*`` files with the same keys; the first train loss within
    1e-6 and every later one within 1e-4 (the noise-floor steps of the test
    above add up); each value within 2 lr a step of JAX's; and the port's
    eval of JAX's ``best_model_3.pth`` gives JAX's val loss of those weights
    within 1e-5."""
    train, val = train_batches(3), train_batches(1, seed=7)
    jnet, _, pnet = reference_pair(num_mel=40, mel=train[0][0], seed=0)
    lr, steps = 1e-3, 6
    kw = dict(epochs=2, eval_epochs=1, lr=lr, checkpoint_every=4, seed=0, log=lambda *_: None)
    want = jie.train_reference_encoder(jnet, lambda: iter(train), lambda: iter(val),
                                       save_model_path=str(tmp_path / "jax"), **kw)
    got = pie.train_reference_encoder(pnet, lambda: iter(train), lambda: iter(val),
                                      save_model_path=str(tmp_path / "port"), **kw)
    assert got[0] is pnet and len(got[1]) == steps and len(got[2]) == 2 and got[4] == want[4]
    assert abs(got[1][0] - want[1][0]) <= 1e-6
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "checkpoint_4.pth" in names and any(n.startswith("best_model_") for n in names)
    for name in names:
        j = torch.load(tmp_path / "jax" / name, weights_only=True)
        p = torch.load(tmp_path / "port" / name, weights_only=True)
        assert set(j) == set(p), name
        for k in j:
            assert float((p[k] - j[k]).abs().max()) <= 2 * lr * steps, (name, k)

    assert "best_model_3.pth" in names  # the first eval, after epoch 0's three steps
    params, stats = flat_to_trees(torch.load(tmp_path / "jax" / "best_model_3.pth", weights_only=True))
    pnet.load_state_dict(reference_encoder_classifier_params_from_flax(params, stats))
    pnet.eval()
    with torch.no_grad():
        loss = float(torch.nn.functional.cross_entropy(pnet(torch.from_numpy(val[0][0])),
                                                       torch.from_numpy(val[0][1])))
    assert abs(loss - want[2][0]) <= 1e-5
