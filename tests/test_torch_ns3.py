"""The port's NS3 FACodec prosody path (``models/ns3/facodec.py``,
``ops/mel.py``'s NS3 mel, the FACodec loader and ``ns3_params_from_flax``)
against the JAX package's, on the same seeded numpy inputs and weights.

Weights reach both sides through ``ns3_params_from_flax`` (flax-initialised
small modules) or through both packages' checkpoint converters (the
full-width extractor, from ``chip_smoke.py``'s reference-named ``.bin``
state dicts). The JAX extractor runs under ``jax.jit`` (its ``fvq_forward``
indexes the codebook with traced indices, so its params go in as jnp
arrays). Bars: the resampling filter equal; the log-mel within 1e-4;
SnakeAct1d within 1e-5; the encoder stack within 3e-5 (small) and 1e-4 (full
width); the transformer within 3e-5; the VQ's indices equal wherever the
JAX top-2 distance gap exceeds 1e-5 and its outputs within 2e-5; the
extractor's pre-VQ prosody latents within 1e-4 and its outputs within 3e-4
(the JAX package's own batched bar), the VQ's codes and the prosody half on
the frames whose top-2 gap exceeds 1e-5 (``chip_smoke.VQ_MARGIN``). The
full-width weights' codebook is spread over the latents of voiced waves
(``chip_smoke.seeded_facodec``) and the inputs are such waves, so the
frames take many codes and a wrong latent shows in the codes too.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from interspeech_ser_tpu.models.ns3 import facodec as jns3
from interspeech_ser_tpu_torch.models import convert, loader
from interspeech_ser_tpu_torch.models.ns3 import facodec as ns3
from interspeech_ser_tpu_torch.ops import mel

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomise_snake(params, rng):
    """flax initialises SnakeBeta's log-scale alpha / beta to 0: draw them."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("alpha", "beta"):
                node[k] = (0.3 * rng.standard_normal(np.shape(v))).astype(np.float32)
    params = _np(params)
    walk(params)
    return params


@pytest.mark.parametrize("kernel_size", [12, 11])
def test_kaiser_sinc_filter_equals_jax(kernel_size):
    np.testing.assert_array_equal(ns3.kaiser_sinc_filter1d(0.25, 0.3, kernel_size),
                                  jns3.kaiser_sinc_filter1d(0.25, 0.3, kernel_size))


@pytest.mark.parametrize("pre_padded", [False, True])
def test_ns3_log_mel_matches_jax(pre_padded):
    rng = np.random.default_rng(1)
    lengths = (2000, 3400)
    Lb = 3400
    wav = np.zeros((2, Lb), np.float32)
    refl = np.zeros((2, Lb + 824), np.float32)
    for i, n in enumerate(lengths):
        w = (0.1 * rng.standard_normal(n)).astype(np.float32)
        wav[i, :n] = w
        refl[i, : n + 824] = np.pad(w, (412, 412), mode="reflect")
    x = refl if pre_padded else wav
    got = mel.ns3_mel_spectrogram(torch.from_numpy(x), pre_padded).numpy()
    want = np.asarray(jns3.ns3_mel_spectrogram(jnp.asarray(x), pre_padded))
    assert got.shape == want.shape == (2, 80, Lb // 200)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(mel.get_prosody_feature(torch.from_numpy(x), pre_padded).numpy(), got[:, :20])
    if pre_padded:  # each utterance's frames are its batch-1 mel's
        for i, n in enumerate(lengths):
            one = mel.ns3_mel_spectrogram(torch.from_numpy(wav[i:i + 1, :n])).numpy()[0]
            np.testing.assert_allclose(got[i, :, : n // 200], one[:, : n // 200], atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [49, 50])
def test_snake_act_matches_jax(T):
    rng = np.random.default_rng(2)
    C = 6
    params = {"alpha": rng.standard_normal(C).astype(np.float32),
              "beta": rng.standard_normal(C).astype(np.float32)}
    x = rng.standard_normal((2, C, T)).astype(np.float32)
    want = np.asarray(jns3.SnakeAct1d(C).apply({"params": params}, jnp.asarray(x.transpose(0, 2, 1))))
    act = ns3.SnakeAct1d(C)
    act.load_state_dict({"act.alpha": torch.from_numpy(params["alpha"]),
                         "act.beta": torch.from_numpy(params["beta"])}, strict=True)
    with torch.no_grad():
        got = act(torch.from_numpy(x)).numpy()
    assert got.shape == (2, C, T)
    np.testing.assert_allclose(got, want.transpose(0, 2, 1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("length", [400, 360])
def test_encoder_stack_small_matches_jax(length):
    """ngf 8, up ratios (2, 4), 16 channels out, flax-initialised."""
    rng = np.random.default_rng(3)
    kw = dict(ngf=8, up_ratios=(2, 4), out_channels=16)
    jmodel = jns3.FACodecEncoderV2Model(**kw)
    params = _randomise_snake(jmodel.init(jax.random.PRNGKey(3), jnp.zeros((1, 16)))["params"], rng)
    wav = (0.1 * rng.standard_normal((2, length))).astype(np.float32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, jnp.asarray(wav)))
    model = ns3.FACodecEncoderV2Model(**kw)
    model.load_state_dict(convert.facodec_encoder_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, length // 8, 16)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)


@pytest.mark.parametrize("hidden", [32, 256])
@pytest.mark.parametrize("pe_batch1", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_transformer_matches_jax(hidden, pe_batch1, masked):
    rng = np.random.default_rng(4)
    filt = 64 if hidden == 32 else 1024
    jmodel = jns3.NS3TransformerEncoder(hidden=hidden, heads=4, layers=2, filter_size=filt, pe_batch1=pe_batch1)
    params = _np(jmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, 8, hidden)))["params"])
    x = rng.standard_normal((3, 20, hidden)).astype(np.float32)
    mask = None
    if masked:
        mask = (np.arange(20)[None] < np.array([20, 13, 7])[:, None]).astype(np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x),
                                   key_mask=None if mask is None else jnp.asarray(mask)))
    model = ns3.NS3TransformerEncoder(hidden=hidden, heads=4, layers=2, filter_size=filt)
    model.load_state_dict(convert.ns3_transformer_params_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask), pe_batch1=pe_batch1)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)


def test_fvq_matches_jax():
    rng = np.random.default_rng(5)
    D, d, N = 256, 8, 1024
    z = rng.standard_normal((2, 50, D)).astype(np.float32)
    w = dict(in_kernel=0.1 * rng.standard_normal((D, d)), in_bias=0.1 * rng.standard_normal(d),
             out_kernel=0.1 * rng.standard_normal((d, D)), out_bias=0.1 * rng.standard_normal(D),
             codebook=rng.standard_normal((N, d)))
    w = {k: v.astype(np.float32) for k, v in w.items()}
    want, want_idx = (np.asarray(a) for a in jns3.fvq_forward(jnp.asarray(z), *(jnp.asarray(w[k]) for k in (
        "in_kernel", "in_bias", "out_kernel", "out_bias", "codebook"))))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got, idx = ns3.fvq_forward(t(z), t(w["in_kernel"].T), t(w["in_bias"]), t(w["out_kernel"].T), t(w["out_bias"]),
                               t(w["codebook"]))
    # the JAX distances' top-2 gap, in float64: a gap under 1e-5 may flip between summation orders
    z_e = z.astype(np.float64) @ w["in_kernel"] + w["in_bias"]
    e = z_e / np.linalg.norm(z_e, axis=-1, keepdims=True)
    c = w["codebook"] / np.linalg.norm(w["codebook"], axis=-1, keepdims=True)
    top2 = np.sort(-(e @ c.T), axis=-1)[..., :2]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-5
    assert clear.all()  # no near-tie at this seed, so every index must agree
    np.testing.assert_array_equal(idx.numpy()[clear], want_idx[clear])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_fold_weight_norm_dim0():
    """FACodec's weight norm is dim=0 (the norm over each output channel's
    (in, k)); the wav2vec2 positional conv's is dim=2 (over (out, in))."""
    torch.manual_seed(6)
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 6, 5), dim=0)
    lin = torch.nn.utils.parametrizations.weight_norm(torch.nn.Linear(7, 3), dim=0)
    with torch.no_grad():
        conv.weight_g.mul_(1.5)
        lin.parametrizations.weight.original0.mul_(0.7)
    sd = {f"c.{k}": v.detach() for k, v in conv.state_dict().items()}
    sd.update({f"l.{k}": v.detach() for k, v in lin.state_dict().items()})
    folded = loader.fold_weight_norm(loader.fold_weight_norm(sd, "c", dim=0), "l", dim=0)
    assert set(folded) == {"c.weight", "c.bias", "l.weight", "l.bias"}
    conv_w = torch._weight_norm(conv.weight_v, conv.weight_g, 0).detach()  # torch's own fold
    np.testing.assert_allclose(folded["c.weight"].numpy(), conv_w.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(folded["l.weight"].numpy(), lin.weight.detach().numpy(), atol=1e-6, rtol=0)
    # the JAX package's FACodec folds agree; the dim=2 fold gives another weight here
    jw, _ = jns3._fold_wn_conv({k: v.numpy() for k, v in sd.items() if k.startswith("c.")}, "c")
    np.testing.assert_allclose(folded["c.weight"].numpy(), np.transpose(jw, (2, 1, 0)), atol=1e-6, rtol=0)
    wrong = loader.fold_weight_norm({"c.weight_g": sd["c.weight_g"], "c.weight_v": sd["c.weight_v"]}, "c")
    assert np.abs(wrong["c.weight"].numpy() - conv_w.numpy()).max() > 1e-2


# -- the extractor at production widths -------------------------------------------------


@pytest.fixture(scope="module")
def extractors():
    """The port's and the JAX package's speaker extractors on the same
    weights: a seeded full-width model written in the reference's naming,
    read by each package's own converter."""
    import chip_smoke

    model, g = chip_smoke.seeded_facodec(8)
    enc, dec = chip_smoke.facodec_reference_state_dicts(model, g)
    out = {}
    for speaker in (False, True):
        port = ns3.ProsodyExtractor(with_speaker=speaker)
        port.load_state_dict(loader.ns3_state_dict_from_reference(dec, enc, speaker), strict=True)
        params = jns3.ns3_decoder_prosody_params_from_torch({k: v.numpy() for k, v in dec.items()}, speaker)
        if speaker:
            params["encoder"] = jns3.ns3_encoder_params_from_torch({k: v.numpy() for k, v in enc.items()})
        params = jax.tree_util.tree_map(jnp.asarray, params)
        out[speaker] = (port.eval(), params)
    return out


@pytest.mark.parametrize("speaker", [False, True])
def test_ns3_params_from_flax_equals_the_loader(extractors, speaker):
    """The JAX extractor's param tree through ``ns3_params_from_flax`` gives
    the port's state dict that its own loader reads from the reference's
    ``.bin`` files: the same keys, the same values (both fold the weight
    norms, in numpy and in torch)."""
    port, params = extractors[speaker]
    sd = convert.ns3_params_from_flax(jax.tree_util.tree_map(np.asarray, params), with_speaker=speaker)
    want = port.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), atol=1e-6, rtol=1e-6, err_msg=k)


def _batch(lengths, seed):
    """Voiced waves of ``lengths`` samples, each padded to a multiple of 200,
    in one zero-padded batch with its host reflect pads and frame mask."""
    import chip_smoke

    rng = np.random.default_rng(seed)
    padded = [chip_smoke.prosody_wave(n, rng, rng.uniform(90, 250)).astype(np.float32) for n in lengths]
    padded = [np.pad(w, (0, (200 - len(w) % 200) % 200)) for w in padded]
    Lb = max(len(w) for w in padded)
    wav = np.zeros((len(padded), Lb), np.float32)
    for i, w in enumerate(padded):
        wav[i, : len(w)] = w
    from interspeech_ser_tpu_torch.extract.pipeline import ns3_batch_inputs

    refl, fmask = ns3_batch_inputs(wav, [len(w) for w in padded])
    return padded, wav, refl, fmask


def _clear(latents, port):
    """Frames whose VQ top-2 gap (from ``latents``) exceeds the margin: their code must agree."""
    import chip_smoke

    return chip_smoke.vq_top2_gap(torch.from_numpy(np.array(latents)), port.fvq) > chip_smoke.VQ_MARGIN


def _jax_latents(jex, pre_padded=False, batch1=False):
    """The JAX extractor's pre-VQ prosody latents (its ``_prosody_branch``
    before ``fvq_forward``), jitted: (wav, key_mask or None) -> [B, T, 256]."""
    p = jex.params
    encoder = jex._mel_encoder_b1 if batch1 else jex._mel_encoder

    def run(wav, key_mask=None):
        f0 = jnp.transpose(jns3.get_prosody_feature(wav, pre_padded=pre_padded), (0, 2, 1))
        f0 = f0 @ p["melspec_linear"]["kernel"] + p["melspec_linear"]["bias"]
        return encoder.apply({"params": p["melspec_encoder"]}, f0, key_mask=key_mask)

    return jax.jit(run)


def test_encoder_stack_full_width_matches_jax(extractors):
    """The production stack (ngf 32, up ratios (2, 4, 5, 5), 256 out) on one
    4000-sample wav, weights through both packages' converters."""
    port, params = extractors[True]
    wav = (0.1 * np.random.default_rng(7).standard_normal((1, 4000))).astype(np.float32)
    want = np.asarray(jax.jit(jns3.FACodecEncoderV2Model().apply)({"params": params["encoder"]}, jnp.asarray(wav)))
    with torch.no_grad():
        got = port.encoder(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (1, 20, 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("speaker,lengths", [(False, (1800, 3000)), (True, (20000, 21400))])
def test_prosody_extractor_matches_jax(extractors, speaker, lengths):
    """forward (per utterance), extract_batched and codes of the port and
    the JAX package on the same weights, the JAX package's test lengths; the
    pre-VQ latents of each path apart (extract_batched's with its reflect
    pads, frame mask and ``pe[0]`` rows), on every valid frame."""
    port, params = extractors[speaker]
    jex = jns3.ProsodyExtractor(params, with_speaker=speaker)
    padded, wav, refl, fmask = _batch(lengths, 9)
    dim = 512 if speaker else 256
    literal, batched = _jax_latents(jex), _jax_latents(jex, pre_padded=True, batch1=True)
    n_frames, n_near, codes_seen = 0, 0, set()
    with torch.no_grad():
        for w in padded:
            lat = port.prosody_latents(torch.from_numpy(w[None])).numpy()
            want_lat = np.asarray(literal(jnp.asarray(w[None])))
            np.testing.assert_allclose(lat, want_lat, atol=1e-4, rtol=0)
            clear = _clear(want_lat, port)[0]
            n_frames, n_near = n_frames + clear.size, n_near + int((~clear).sum())
            got = port(torch.from_numpy(w[None])).numpy()
            want = np.asarray(jax.jit(jex.__call__)(jnp.asarray(w[None])))
            assert got.shape == want.shape == (1, len(w) // 200, dim)
            np.testing.assert_allclose(got[0, clear], want[0, clear], atol=3e-4, rtol=0)
            np.testing.assert_allclose(got[..., 256:], want[..., 256:], atol=3e-4, rtol=0)
            codes_seen.update(port.fvq(torch.from_numpy(lat))[1].flatten().tolist())
        lat = port.prosody_latents(torch.from_numpy(refl), pre_padded=True, key_mask=torch.from_numpy(fmask),
                                   pe_batch1=True).numpy()
        want_lat = np.asarray(batched(jnp.asarray(refl), jnp.asarray(fmask)))
        got = port.extract_batched(*(torch.from_numpy(a) for a in (wav, refl, fmask))).numpy()
        want = np.asarray(jax.jit(jex.extract_batched)(jnp.asarray(wav), jnp.asarray(refl), jnp.asarray(fmask)))
        for i, w in enumerate(padded):
            n = len(w) // 200
            np.testing.assert_allclose(lat[i, :n], want_lat[i, :n], atol=1e-4, rtol=0)
            clear = _clear(want_lat[i, :n], port)
            n_frames, n_near = n_frames + n, n_near + int((~clear).sum())
            np.testing.assert_allclose(got[i, :n][clear], want[i, :n][clear], atol=3e-4, rtol=0)
            np.testing.assert_allclose(got[i, :n, 256:], want[i, :n, 256:], atol=3e-4, rtol=0)
        codes = port.codes(torch.from_numpy(wav))
    want_codes = np.asarray(jax.jit(jex.codes)(jnp.asarray(wav)))
    assert codes.dtype == torch.int32 and want_codes.dtype == np.int32
    clear = _clear(literal(jnp.asarray(wav)), port)
    np.testing.assert_array_equal(codes.numpy()[clear], want_codes[clear])
    n_frames, n_near = n_frames + clear.size, n_near + int((~clear).sum())
    # the check is not vacuous: the codes spread (12 of 24 frames, 71 of 207 at this seed), near-ties are rare
    assert len(codes_seen) >= (32 if speaker else 8), sorted(codes_seen)
    assert n_near <= max(2, n_frames // 100), (n_near, n_frames)



def test_speaker_batched_equals_batch1(extractors):
    """The port's own property: extract_batched equals the batch-1 forward
    on every frame (the tail window repairs the bucket edge; the prosody
    half on the frames clear of a VQ near-tie, its pre-VQ latents on every
    frame), and without the repair the last frames do deviate, so the check
    is not vacuous. A zero row (batch padding, no valid frame) stays
    finite."""
    port, _ = extractors[True]
    lengths = (20000, 21400, 9000)
    padded, wav, refl, fmask = _batch(lengths, 10)
    wav, refl, fmask = (np.concatenate([a, np.zeros_like(a[:1])]) for a in (wav, refl, fmask))
    args = [torch.from_numpy(a) for a in (wav, refl, fmask)]
    with torch.no_grad():
        singles = [port(torch.from_numpy(w[None])).numpy()[0] for w in padded]
        single_lat = [port.prosody_latents(torch.from_numpy(w[None]))[0] for w in padded]
        lat = port.prosody_latents(args[1], pre_padded=True, key_mask=args[2], pe_batch1=True).numpy()
        batched = port.extract_batched(*args).numpy()
        port.tail_exact = False
        try:
            off = port.extract_batched(*args).numpy()
        finally:
            port.tail_exact = True
    assert np.isfinite(batched).all()
    for i, w in enumerate(padded):
        n = len(w) // 200
        np.testing.assert_allclose(lat[i, :n], single_lat[i].numpy(), atol=1e-4, rtol=0)
        clear = _clear(single_lat[i], port)
        assert (~clear).sum() <= 1
        np.testing.assert_allclose(batched[i, :n, :256][clear], singles[i][clear, :256], atol=3e-4, rtol=0)
        if i < 2:  # utterances of >= 96 frames: the speaker half exact on every frame too
            np.testing.assert_allclose(batched[i, :n, 256:], singles[i][:, 256:], atol=3e-4, rtol=0)
    n0 = len(padded[0]) // 200
    assert np.abs(off[0, n0 - 3: n0] - singles[0][-3:]).max() > 3e-4
