"""The port's FACodec full decoder and redecoder (``models/ns3/facodec_decoder.py``)
against the JAX package's, at small widths (C = 8, one HiFiGAN block of 8
channels at ratio 2, or of 16 at ratio 5; 16-row codebooks of dim 4).

One flax init feeds both packages through ``facodec_decoder_params_from_flax`` /
``facodec_redecoder_params_from_flax``. Tolerances: f32 forward outputs within
5e-5 max abs (the two run the same math in other summation orders; the
HiFiGAN stacks 6 convolutions and 5 resampled SnakeBetas a block); codes equal; VQ
losses within 1e-6 relative; straight-through gradients within 1e-4 relative
to the largest entry; a folded weight norm within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from interspeech_ser_tpu.models.ns3 import facodec_decoder as J
from interspeech_ser_tpu_torch.models import convert, loader
from interspeech_ser_tpu_torch.models.ns3 import facodec_decoder as P

torch.set_num_threads(2)

SMALL = dict(in_channels=8, upsample_initial_channel=8, up_ratios=(2,), codebook_size=16, codebook_dim=4)
RNG = np.random.default_rng(19)
ATOL = 5e-5


def _np(x):
    return np.asarray(x.detach()) if isinstance(x, torch.Tensor) else np.asarray(x)


def _bank_state(params, n):
    """A flax ``ResidualVQBank``'s params -> the port bank's state dict."""
    sd = {}
    convert._vq_bank_pairs(sd, params, "")
    assert len(sd) == 5 * n
    return convert._to_torch(sd)


@pytest.fixture(scope="module")
def decoder():
    """(jax module, flax params, port module) of a decoder with the predictor heads."""
    jdec = J.FACodecDecoderFull(**SMALL, with_predictors=True)
    x = jnp.asarray(RNG.normal(size=(2, 7, 8)).astype(np.float32))
    params = jax.tree.map(np.asarray, jax.jit(jdec.init)(jax.random.PRNGKey(0), x)["params"])
    # the SnakeBeta parameters start at 0 in both packages: draw them, so that a swapped alpha / beta shows
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.2 * RNG.standard_normal(v.shape)).astype(np.float32)
        if path[-1].key in ("alpha", "beta") else v, params)
    dec = P.FACodecDecoderFull(**SMALL, with_predictors=True).eval()
    dec.load_state_dict(convert.facodec_decoder_params_from_flax(params, with_predictors=True), strict=True)
    return jdec, params, dec


@pytest.fixture(scope="module")
def redecoder():
    jred = J.FACodecRedecoder(in_channels=8, upsample_initial_channel=8, up_ratios=(2,), codebook_size=16)
    codes = jnp.zeros((6, 2, 7), jnp.int32)
    spk = jnp.zeros((2, 8), jnp.float32)
    params = jax.tree.map(np.asarray, jax.jit(jred.init)(jax.random.PRNGKey(1), codes, spk)["params"])
    # code embeddings at std 1e-5 vanish under the style norm's eps: widen them so that each code shows
    params = {k: (v * 1e4 if "_emb" in k else v) for k, v in params.items()}
    red = P.FACodecRedecoder(in_channels=8, upsample_initial_channel=8, up_ratios=(2,), codebook_size=16).eval()
    red.load_state_dict(convert.facodec_redecoder_params_from_flax(params), strict=True)
    return jred, params, red


@pytest.mark.parametrize("stride,style", [(2, "weight_g"), (4, "param"), (5, "weight_g")])
def test_conv_transpose_fold_and_length(stride, style):
    """A weight-normed ConvTranspose1d (g per input channel, [in, 1, 1]): the
    port's fold equals the JAX ``_fold_wn_convtranspose``, and the block's
    transposed conv gives exactly T * s samples, equal to torch's module."""
    tconv = torch.nn.ConvTranspose1d(6, 4, 2 * stride, stride=stride, padding=P.conv_transpose_padding(stride)[0],
                                     output_padding=P.conv_transpose_padding(stride)[1])
    if style == "weight_g":
        tconv = torch.nn.utils.weight_norm(tconv)
    else:
        tconv = torch.nn.utils.parametrizations.weight_norm(tconv)
    sd = {f"x.{k}": v.detach() for k, v in tconv.state_dict().items()}
    assert any(v.shape == (6, 1, 1) for v in sd.values())  # g is per input channel
    folded = loader.fold_weight_norm(sd, "x", dim=0)["x.weight"]
    w_jax, _ = J._fold_wn_convtranspose({k: v.numpy() for k, v in sd.items()}, "x")
    np.testing.assert_allclose(folded.numpy(), w_jax, atol=1e-6, rtol=0)
    x = torch.from_numpy(RNG.normal(size=(2, 6, 13)).astype(np.float32))
    block = P.DecoderBlock(6, 4, stride)
    with torch.no_grad():
        y = torch.nn.functional.conv_transpose1d(x, folded, sd["x.bias"], stride=stride,
                                                 padding=block.block[1].padding, output_padding=block.block[1].output_padding)
        ref = tconv(x)
    assert y.shape[-1] == 13 * stride
    np.testing.assert_allclose(y.numpy(), ref.numpy(), atol=1e-5, rtol=0)


def test_residual_vq_eval_and_vq2emb():
    bank = J.ResidualVQBank(3, 8, 4, 16)
    x = RNG.normal(size=(2, 9, 8)).astype(np.float32)
    params = jax.tree.map(np.asarray, bank.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
    ours = P.ResidualVQBank(3, 8, 4, 16)
    ours.load_state_dict(_bank_state(params, 3), strict=True)
    out, codes, losses, each = bank.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        o, c, l, e = ours(torch.from_numpy(x))
        emb = ours.vq2emb(c)
    np.testing.assert_array_equal(c.numpy(), np.asarray(codes))
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=1e-5, rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(each), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(l.numpy(), np.zeros(3, np.float32))
    np.testing.assert_allclose(emb.numpy(), o.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dropout_type", ["linear", "exp"])
def test_vq_train_path_fixed_counts(dropout_type, monkeypatch):
    """Training with quantizer dropout 0.5: the JAX bank's drawn counts (its
    own formula on its rng) stand in for the port's draw; codes, outputs,
    losses and the straight-through gradients of x and every parameter."""
    n, B = 3, 4
    bank = J.ResidualVQBank(n, 8, 4, 16, quantizer_dropout=0.5, dropout_type=dropout_type)
    x = RNG.normal(size=(B, 6, 8)).astype(np.float32)
    params = jax.tree.map(np.asarray, bank.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    rng = jax.random.PRNGKey(4)
    hi = max(int(np.log2(n)), 2)
    drop = (2 ** jax.random.randint(rng, (B,), 1, hi) if dropout_type == "exp"
            else jax.random.randint(rng, (B,), 1, n + 1))
    counts = np.full(B, n + 1, np.float32)
    counts[: int(B * 0.5)] = np.asarray(drop)[: int(B * 0.5)]

    def jloss(p, xx):
        out, codes, losses, _ = bank.apply({"params": p}, xx, train=True, rng=rng)
        return jnp.sum(out ** 2) + jnp.sum(losses), (codes, losses)

    (jl, (jcodes, jlosses)), (gp, gx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    ours = P.ResidualVQBank(n, 8, 4, 16, quantizer_dropout=0.5, dropout_type=dropout_type)
    ours.load_state_dict(_bank_state(params, n), strict=True)
    monkeypatch.setattr(ours, "draw_counts", lambda batch, generator: torch.from_numpy(counts))
    xt = torch.from_numpy(x).requires_grad_()
    out, codes, losses, _ = ours(xt, train=True)
    loss = out.square().sum() + losses.sum()
    loss.backward()
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jlosses), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)

    def close(g, ref):
        ref = np.asarray(ref)
        assert np.abs(_np(g) - ref).max() <= 1e-4 * np.abs(ref).max(), (np.abs(_np(g) - ref).max(), np.abs(ref).max())

    close(xt.grad, gx)
    for i in range(n):
        vq, g = ours.layers[i], gp[f"vq{i}"]
        close(vq.in_proj.weight.grad.t(), g["in_kernel"])
        close(vq.out_proj.weight.grad.t(), g["out_kernel"])
        close(vq._codebook.weight.grad, g["codebook"])
        close(vq.in_proj.bias.grad, g["in_bias"])


@pytest.mark.parametrize("dropout_type,n,support", [("linear", 3, {1, 2, 3}), ("linear", 1, {1}), ("exp", 8, {2, 4}),
                                                    ("exp", 16, {2, 4, 8}), ("exp", 3, {2}), ("exp", 1, {2})])
def test_dropout_count_support(dropout_type, n, support):
    """The counts quantizer dropout can draw (the reference's formula: 'exp'
    never draws n itself, and n <= 3 is clamped to 2); only the first
    int(B * p) rows drop; the same generator seed draws the same counts."""
    bank = P.ResidualVQBank(n, 8, 4, 16, quantizer_dropout=0.5, dropout_type=dropout_type)
    counts = bank.draw_counts(4000, torch.Generator().manual_seed(0))
    assert set(counts[:2000].long().tolist()) == support
    assert set(counts[2000:].tolist()) == {float(n + 1)}
    again = bank.draw_counts(4000, torch.Generator().manual_seed(0))
    assert torch.equal(counts, again)


def test_hifigan_decoder_and_batch_rows():
    """``HiFiGANDecoder`` alone (ratio 5, odd) against JAX, and a batch of
    equal-length rows against each row's batch-1 run (no PE quirk here)."""
    jdec = J.HiFiGANDecoder(6, 16, (5,))
    x = (0.5 * RNG.normal(size=(3, 11, 6))).astype(np.float32)
    params = jax.tree.map(np.asarray, jax.jit(jdec.init)(jax.random.PRNGKey(5), jnp.asarray(x))["params"])
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: (0.2 * RNG.standard_normal(v.shape)).astype(np.float32)
        if path[-1].key in ("alpha", "beta") else np.ascontiguousarray(v), params)
    sd = {}
    convert._hifigan_pairs(sd, params, "m")
    dec = P.HiFiGANDecoder(6, 16, (5,)).eval()
    dec.load_state_dict({k[2:]: v for k, v in convert._to_torch(sd).items()}, strict=True)
    ref = np.asarray(jax.jit(jdec.apply)({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        out = dec(torch.from_numpy(x).transpose(1, 2))
        single = torch.cat([dec(torch.from_numpy(x[i:i + 1]).transpose(1, 2)) for i in range(3)])
    assert out.shape == (3, 11 * 5)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(single.numpy(), out.numpy(), atol=1e-5, rtol=0)  # f32, other conv algorithms


def test_full_decoder_forward_codes_and_predictors(decoder):
    jdec, params, dec = decoder
    x = RNG.normal(size=(2, 7, 8)).astype(np.float32)
    wav, codes, losses, pred = jax.jit(jdec.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        w, c, l, p = dec(torch.from_numpy(x))
        spk = dec.speaker_embedding(torch.from_numpy(x))
        w2 = dec.codes_to_wav(c, spk)
        w_nores = dec.codes_to_wav(c, spk, use_residual=False)
    jspk = jdec.apply({"params": params}, jnp.asarray(x), method=J.FACodecDecoderFull.speaker_embedding)
    jw_nores = jdec.apply({"params": params}, params, codes, jspk, False, method=J.FACodecDecoderFull.codes_to_wav)
    assert w.shape == (2, 7 * 2) and c.shape == (6, 2, 7)
    np.testing.assert_array_equal(c.numpy(), np.asarray(codes))
    np.testing.assert_allclose(spk.numpy(), np.asarray(jspk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w.numpy(), np.asarray(wav), atol=ATOL, rtol=0)
    np.testing.assert_allclose(w2.numpy(), w.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(w_nores.numpy(), np.asarray(jw_nores), atol=ATOL, rtol=0)
    assert float((w_nores - w).abs().max()) > 1e-6
    np.testing.assert_array_equal(l.numpy(), np.asarray(losses))
    assert p["f0"].shape == (2, 7) and p["uv"].shape == (2, 7) and p["phone"].shape == (2, 7, P.PHONE_CLASSES)
    for k in ("f0", "uv", "phone"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(pred[k]), atol=ATOL, rtol=0)


def test_quantize_v2_and_train_autoencode(decoder):
    """quantize_v2 (the prosody bank on the prosody latents), and a train-mode
    autoencode at dropout 0 (every row keeps every quantizer) with the
    gradient of the input through the straight-through estimators."""
    jdec, params, dec = decoder
    x = RNG.normal(size=(2, 7, 8)).astype(np.float32)
    pros = RNG.normal(size=(2, 7, 8)).astype(np.float32)
    (jq, jcodes, jlosses) = jdec.apply({"params": params}, jnp.asarray(x), jnp.asarray(pros),
                                       method=J.FACodecDecoderFull.quantize_v2)
    with torch.no_grad():
        q, codes, losses = dec.quantize_v2(torch.from_numpy(x), torch.from_numpy(pros))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    for a, b in zip(q, jq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)

    jparams = jax.tree.map(jnp.asarray, params)  # the train path indexes the codebook with traced codes

    def jloss(xx):
        wav, codes, losses, _ = jdec.apply({"params": jparams}, xx, train=True, rng=jax.random.PRNGKey(0))
        return jnp.sum(wav ** 2) + jnp.sum(losses), losses

    (_, jl), gx = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    wav, _, l, _ = dec(xt, train=True)
    (wav.square().sum() + l.sum()).backward()
    np.testing.assert_allclose(l.detach().numpy(), np.asarray(jl), rtol=1e-6, atol=0)
    ref = np.asarray(gx)
    assert np.abs(xt.grad.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("use_residual", [False, True])
def test_redecoder(redecoder, use_residual):
    jred, params, red = redecoder
    codes = RNG.integers(0, 16, size=(6, 2, 7)).astype(np.int32)
    spk = RNG.normal(size=(2, 8)).astype(np.float32)
    ref = np.asarray(jax.jit(jred.apply, static_argnums=3)({"params": params}, jnp.asarray(codes), jnp.asarray(spk),
                                                           use_residual))
    with torch.no_grad():
        out = red(torch.from_numpy(codes), torch.from_numpy(spk), use_residual)
        other = red(torch.from_numpy(codes), torch.from_numpy(spk[::-1].copy()), use_residual)
    assert out.shape == (2, 7 * 2)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)
    assert float((out - other).abs().max()) > 1e-6  # the speaker embedding conditions the output


def _reference_layout(sd, wn, seed):
    """A port state dict in the reference's ``.bin`` layout: each weight whose
    key ``wn`` accepts weight-normed (g over every dim but 0, v = w times a
    positive factor per dim-0 slice), alternating the two key styles."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for n, (k, w) in enumerate(sd.items()):
        if not (k.endswith(".weight") and wn(k)):
            out[k] = w.clone()
            continue
        shape = (w.shape[0],) + (1,) * (w.dim() - 1)
        v = w * (0.5 + torch.rand(shape, generator=g))
        names = ("weight_g", "weight_v") if n % 2 else ("parametrizations.weight.original0",
                                                        "parametrizations.weight.original1")
        out[f"{k[:-7]}.{names[0]}"] = w.flatten(1).norm(dim=1).view(shape)
        out[f"{k[:-7]}.{names[1]}"] = v
    return out


def test_reference_loaders_match_jax_converters(decoder, redecoder, tmp_path):
    """The reference-layout ``.bin`` dict -> the port's loader, against the same
    dict -> the JAX converter -> flax params -> the port's converter; the
    ``.bin`` file -> ``build_facodec_decoder`` / ``build_facodec_redecoder``."""
    _, _, dec = decoder
    _, _, red = redecoder
    wn_dec = lambda k: (k.startswith(("model.", "f0_predictor.model.", "phone_predictor.model."))
                        or k.startswith("quantizer.") and "_proj." in k)
    ref = _reference_layout(dec.state_dict(), wn_dec, 0)
    ref["quantizer.1.extra_buffer"] = torch.zeros(3)  # a key the decoder does not read
    ours = loader.ns3_decoder_full_state_dict_from_reference(ref, up_ratios=(2,), with_predictors=True)
    theirs = convert.facodec_decoder_params_from_flax(
        J.ns3_decoder_full_params_from_torch({k: v.numpy() for k, v in ref.items()}, (2,), True), True)
    assert set(ours) == set(theirs) == set(dec.state_dict())
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
        np.testing.assert_allclose(ours[k].numpy(), dec.state_dict()[k].numpy(), atol=1e-6, rtol=1e-6, err_msg=k)
    ref_r = _reference_layout(red.state_dict(), lambda k: k.startswith("model."), 1)
    ours_r = loader.ns3_redecoder_state_dict_from_reference(ref_r, up_ratios=(2,))
    theirs_r = convert.facodec_redecoder_params_from_flax(
        J.ns3_redecoder_params_from_torch({k: v.numpy() for k, v in ref_r.items()}, (2,)))
    assert set(ours_r) == set(theirs_r) == set(red.state_dict())
    for k in ours_r:
        np.testing.assert_allclose(ours_r[k].numpy(), theirs_r[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    torch.save(ref, tmp_path / "dec.bin")
    torch.save(ref_r, tmp_path / "red.bin")
    built = loader.build_facodec_decoder(str(tmp_path / "dec.bin"), **SMALL, with_predictors=True)
    built_r = loader.build_facodec_redecoder(str(tmp_path / "red.bin"), in_channels=8, upsample_initial_channel=8,
                                             up_ratios=(2,), codebook_size=16)
    x = torch.from_numpy(RNG.normal(size=(2, 7, 8)).astype(np.float32))
    codes = torch.from_numpy(RNG.integers(0, 16, size=(6, 2, 7)))
    with torch.no_grad():
        np.testing.assert_allclose(built(x)[0].numpy(), dec(x)[0].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(built_r(codes, x[:, 0]).numpy(), red(codes, x[:, 0]).numpy(), atol=1e-5, rtol=0)
    del ref["timbre_linear.bias"]
    with pytest.raises(KeyError):
        loader.ns3_decoder_full_state_dict_from_reference(ref, up_ratios=(2,))
