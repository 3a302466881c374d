"""The port's multi-device surface on the CPU: gloo ranks against one rank and
against the JAX package's multi-device runs on the 8 virtual CPU devices.

One spawn of 2 ranks (and one of 4, the 2 x 2 mesh) runs every task of
``tests/torch_parallel_workers.py`` that this file checks; the one-rank port
results come from the same task functions in this process, the JAX ones from
the JAX package here. Tolerances, stated per test:

- the gather's gradient (CKA, diff-F1, dynamic-alpha focal, CCC): 2 ranks
  equal one to 1e-6 (f32, another summation order);
- synchronised BatchNorm: the x-vector's and the reference encoder's
  outputs, running statistics and gradients within 1e-5 relative of one
  rank's (sum / sum-of-squares moments against ``var_mean``);
- extraction: data-parallel files equal the one-rank files to 1e-6 (the
  same batches; BLAS thread counts differ between processes); tensor
  parallelism (non-zero biases, so a bias added twice shows) within 2e-4 of
  the JAX package's ``model_parallel=2`` files, the JAX test's bar, and of
  one rank's; the 2 x 2 mesh likewise;
- fusion: the 2-rank fit's dev macro-F1 equal to the JAX ``n_devices=2``
  fit's and the parameters within 1e-5 (the zero-gradient pooling biases
  within Adam's step budget, as ``test_torch_train`` says); with dropout,
  CKA, focal's dynamic alpha and diff-F1 on, 2 ranks equal one rank the same
  way and every micro-batch loss within 1e-5;
- the audit: every data-parallel all-reduce carries the whole trainable
  parameter count, tensor parallelism 2 all-reduces a layer a batch, one
  rank reads ``NONE``.
"""

import csv
import dataclasses
import json
import os
import wave

import numpy as np
import pytest
import torch

import jax

import torch_parallel_workers as W
from interspeech_ser_tpu_torch.models.convert import fusion_params_from_flax
from interspeech_ser_tpu_torch.parallel import audit, mesh as M, tp
from interspeech_ser_tpu_torch.train.engine import cosine_epoch_lr
from interspeech_ser_tpu_torch.utils import labels as L

DIMS = (24, 16)
HID = 16
N_TRAIN, N_DEV = 40, 16


def write_wav(path, x):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())


def write_models(root):
    """A 2-layer WavLM with 4 heads and every parameter moved off its init
    (the biases are non-zero), a 2-layer Whisper encoder, a 2-layer RoBERTa,
    7 wavs of 0.3-1.4 s and a transcript CSV."""
    from transformers import RobertaConfig, RobertaModel, WavLMConfig, WavLMModel, WhisperConfig, WhisperModel

    torch.manual_seed(11)
    wavlm = WavLMModel(WavLMConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
        conv_dim=[16, 16], conv_kernel=[10, 3], conv_stride=[5, 2], num_feat_extract_layers=2,
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, num_buckets=32, max_bucket_distance=64,
        do_stable_layer_norm=True, feat_extract_norm="layer", conv_bias=True, layerdrop=0.0,
    ))
    with torch.no_grad():
        for p in wavlm.parameters():
            p.add_(0.05 * torch.randn_like(p))
    wavlm.save_pretrained(str(root / "wavlm"))
    WhisperModel(WhisperConfig(
        num_mel_bins=16, d_model=32, encoder_layers=2, encoder_attention_heads=2, encoder_ffn_dim=64,
        decoder_layers=1, decoder_attention_heads=2, decoder_ffn_dim=32, max_source_positions=1500,
    )).encoder.save_pretrained(str(root / "whisper"))
    RobertaModel(RobertaConfig(vocab_size=64, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                               intermediate_size=32, max_position_embeddings=40)).save_pretrained(str(root / "roberta"))
    (root / "wavs").mkdir()
    rng = np.random.default_rng(3)
    for i in range(7):
        n = int(16000 * rng.uniform(0.3, 1.4))
        write_wav(root / "wavs" / f"u{i}.wav", 0.3 * np.sin(np.arange(n) * (0.02 + 0.01 * i))
                  + 0.02 * rng.standard_normal(n))
    with open(root / "transcripts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]]
                                + [[f"t{i}.wav", " ".join(f"w{j}" for j in range(i % 9))] for i in range(11)])
    return wavlm


def write_fusion_corpus(root):
    """Two lazy feature dirs (dims 24 / 16), separable by class, a label and a
    transcript CSV, and a config at batch 14 with 2 accumulation steps (a
    batch pads to 16 rows on 2 ranks)."""
    rng = np.random.default_rng(7)
    dirs = [root / f"lazy{m + 1}" for m in range(2)]
    for d in dirs:
        d.mkdir()
    means = rng.normal(scale=2.0, size=(8, DIMS[0]))
    rows = []
    for i in range(N_TRAIN + N_DEV):
        cls = i % 8
        name = f"MSP-PODCAST_{i:04d}.wav"
        # up to 64 frames: one bucket, so the JAX engine compiles one train and one eval step
        for m, (d, t) in enumerate(zip(dirs, (int(rng.integers(20, 64)), int(rng.integers(5, 30))))):
            f = rng.normal(size=(t, DIMS[m])).astype(np.float32) + (means[cls] if m == 0 else 0.0)
            torch.save(torch.from_numpy(f), str(d / name.replace(".wav", ".pt")))
        rows.append([name] + [float(c == cls) for c in range(8)] + ["Train" if i < N_TRAIN else "Development"])
    with open(root / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName"] + L.CLASSES + ["Split_Set"]] + rows)
    with open(root / "transcripts.csv", "w", newline="") as f:
        csv.writer(f).writerows([["FileName", "transcription"]] + [[r[0], "hi"] for r in rows])
    cfg = {"wav_dir": str(root), "txt_dir": str(root / "transcripts.csv"), "lazy_dir1": str(dirs[0]),
           "lazy_dir2": str(dirs[1]), "label_path": str(root / "labels.csv"), "feat1_dim": DIMS[0],
           "feat2_dim": DIMS[1], "use_balanced_batch": False, "use_focalloss": False, "epochs": 2, "lr": 5e-3,
           "model_path": str(root / "exp"), "batch_size": 14, "accum_step": 2, "fusion_hidden_dim": HID}
    for name, over in (("jax", {"dropout": 0.0, "accum_step": 1, "batch_size": 16}), ("drop", {"dropout": 0.5})):
        with open(root / f"{name}.json", "w") as f:
            json.dump({**cfg, **over}, f)


def jax_fusion(root):
    """The JAX ``FusionEngine(n_devices=2)`` of ``jax.json`` with its initial
    params -> (the engine, those params in the port's names)."""
    from interspeech_ser_tpu.train.engine import EngineOptions, FusionEngine
    from interspeech_ser_tpu.utils.config import load_fusion_config

    cfg = dataclasses.replace(load_fusion_config(str(root / "jax.json")), model_path=str(root / "exp_jax"))
    eng = FusionEngine(cfg, seed=7, options=EngineOptions(n_devices=2))
    eng.init_params()
    return eng, fusion_params_from_flax(jax.tree.map(np.asarray, eng.params), 2)


def jax_fusion_fit(eng):
    """The engine's fit -> (per-epoch dev macro-F1, final params in the port's names)."""
    from interspeech_ser_tpu.utils import labels as JL

    f1s = []
    evaluate = eng.evaluate
    eng.evaluate = lambda *a, **kw: (lambda r: f1s.append(r["macro_f1"]) or r)(evaluate(*a, **kw))
    df = JL.load_merged(eng.cfg.label_path, eng.cfg.txt_dir)
    eng.fit(JL.split(df, "Train"), JL.split(df, "Development"))
    return f1s, fusion_params_from_flax(jax.tree.map(np.asarray, eng.params), 2)


def jax_tp(root, hf_wavlm):
    """The JAX ``SpeechExtractionPipeline(model_parallel=2)`` files of the WavLM."""
    from transformers import AutoConfig

    from interspeech_ser_tpu.extract.pipeline import SpeechExtractionPipeline
    from interspeech_ser_tpu.models.convert_hf import speech_hf_to_flax
    from interspeech_ser_tpu.models.speech import SpeechConfig, SpeechEncoderModel

    cfg = SpeechConfig.from_hf(AutoConfig.from_pretrained(str(root / "wavlm")))
    params = speech_hf_to_flax({k: v.numpy() for k, v in hf_wavlm.state_dict().items()}, cfg)
    SpeechExtractionPipeline(SpeechEncoderModel(cfg), params, cfg, model_parallel=2).run(
        str(root / "wavs"), str(root / "jax_tp"))
    return root / "jax_tp"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel")
    hf_wavlm = write_models(root)
    write_fusion_corpus(root)
    jeng, init = jax_fusion(root)
    torch.save(init, root / "init.pt")
    budget = 16000 * 2  # several batches of whole utterances
    wavlm, wavs = str(root / "wavlm"), str(root / "wavs")
    drop = dict(config_path=str(root / "drop.json"), loss_type="focal", focal_dynamic_alpha=True, cka_weight=0.1,
                ranking=True)
    f1 = dict(config_path=str(root / "drop.json"), init_path=str(root / "init.pt"), loss_type="f1", cka_weight=0.1)

    def tasks(tag):
        return {
            "gather": ("gather_losses", {}),
            "bn": ("sync_bn", {}),
            "dp": ("extract_speech", dict(model_dir=wavlm, wav_dir=wavs, save_path=str(root / f"dp_{tag}"),
                                          token_budget=budget)),
            "dp16": ("extract_speech", dict(model_dir=wavlm, wav_dir=wavs, save_path=str(root / f"dp16_{tag}"),
                                            token_budget=budget, dtype="bfloat16")),
            "whisper": ("extract_whisper", dict(model_dir=str(root / "whisper"), wav_dir=wavs,
                                                save_path=str(root / f"whisper_{tag}"))),
            "text": ("extract_text", dict(model_dir=str(root / "roberta"), csv_path=str(root / "transcripts.csv"),
                                          save_path=str(root / f"text_{tag}"))),
            "fusion_jax": ("fusion_fit", dict(config_path=str(root / "jax.json"), init_path=str(root / "init.pt"),
                                              model_path=str(root / f"fj_{tag}"))),
            "fusion_drop": ("fusion_fit", dict(drop, model_path=str(root / f"fd_{tag}"))),
            "fusion_f1": ("fusion_fit", dict(f1, model_path=str(root / f"ff_{tag}"))),
        }

    two_tasks = tasks("two")
    two_tasks["tp"] = ("extract_speech", dict(model_dir=wavlm, wav_dir=wavs, save_path=str(root / "tp_two"),
                                              token_budget=budget, model_parallel=2))
    two_tasks["cli_tp"] = ("preprocess", dict(argv=["speech", "--ssl_type", wavlm, "--wav_dir", wavs,
                                                    "--save_path", str(root / "cli_tp"), "--model_parallel", "2"]))
    four_tasks = {"tp": ("extract_speech", dict(model_dir=wavlm, wav_dir=wavs, save_path=str(root / "tp_four"),
                                                token_budget=budget, model_parallel=2))}

    def here():  # the JAX references and the one-rank runs, while the ranks work
        jax_f1, jax_params = jax_fusion_fit(jeng)
        return dict(one=W.run_tasks(tasks("one")), jax_f1=jax_f1, jax_params=jax_params,
                    jax_tp=jax_tp(root, hf_wavlm))

    two, rest = W.spawn(2, two_tasks, str(root / "ranks2"), meanwhile=here)
    four = W.spawn(4, four_tasks, str(root / "ranks4"))
    return dict(root=root, two=two, four=four, **rest)


def _files(d):
    return {f: torch.load(os.path.join(d, f), weights_only=True) for f in sorted(os.listdir(d)) if f.endswith(".pt")}


def _assert_same_files(got_dir, want_dir, atol):
    got, want = _files(got_dir), _files(want_dir)
    assert got.keys() == want.keys() and len(got) > 0
    for f in want:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_allclose(got[f].float().numpy(), want[f].float().numpy(), atol=atol, rtol=0, err_msg=f)


# -- mesh, audit, tensor-parallel units ----------------------------------------


def test_one_rank_mesh_is_the_identity():
    m = M.make_mesh()
    assert (m.size, m.data, m.model, m.rank, m.is_main) == (1, 1, 1, 0, True)
    x = torch.randn(5, 3)
    with audit.collective_audit() as rec:
        assert M.shard_batch(m, x) is x
        assert M.gather_rows(m, x, 5) is not None
        M.all_reduce_grads(m, [torch.nn.Parameter(x)])
        M.replicate(m, torch.nn.Linear(2, 2))
    assert audit.audit_line(rec) == "collectives: NONE"
    with pytest.raises(ValueError, match="n_devices=2, but this run has 1 rank"):
        M.make_mesh(2)
    with pytest.raises(ValueError, match="model_parallel=2 does not divide"):
        M.make_mesh(model_parallel=2)


def test_audit_line_format():
    rec = audit.empty_audit()
    rec["all-reduce"] = {"count": 2, "elements": 1234}
    rec["all-gather"] = {"count": 1, "elements": 8}
    assert audit.audit_line(rec) == "collectives: all-reduce×2 (1234 elems), all-gather×1 (8 elems)"
    assert audit.param_elements(torch.nn.Linear(3, 2)) == 8


def test_shard_speech_state_dict_splits_as_megatron():
    from interspeech_ser_tpu_torch.models.speech import SpeechConfig, SpeechEncoderModel

    cfg = SpeechConfig(hidden_size=32, num_layers=1, num_heads=4, intermediate_size=64, conv_dim=(16, 16),
                       conv_kernel=(10, 3), conv_stride=(5, 2), num_conv_pos_embeddings=16, conv_pos_groups=4,
                       num_buckets=32, attention_type="wavlm", feat_extract_norm="layer", do_stable_layer_norm=True)
    sd = SpeechEncoderModel(cfg).state_dict()
    pre = "encoder.layers.0."
    for rank in (0, 1):
        sh = tp.shard_speech_state_dict(sd, rank, 2, num_heads=4)
        assert sh.keys() == sd.keys()
        for name in ("q_proj", "k_proj", "v_proj"):
            w = sd[pre + f"attention.{name}.weight"]
            assert torch.equal(sh[pre + f"attention.{name}.weight"], w[16 * rank: 16 * (rank + 1)])
            assert torch.equal(sh[pre + f"attention.{name}.bias"], sd[pre + f"attention.{name}.bias"][16 * rank:][:16])
        assert torch.equal(sh[pre + "attention.out_proj.weight"], sd[pre + "attention.out_proj.weight"][:, 16 * rank:][:, :16])
        assert torch.equal(sh[pre + "feed_forward.output_dense.weight"],
                           sd[pre + "feed_forward.output_dense.weight"][:, 32 * rank:][:, :32])
        # the row-parallel biases stay whole: added once, after the all-reduce
        for key in ("attention.out_proj.bias", "feed_forward.output_dense.bias", "attention.gru_rel_pos_linear.weight"):
            assert torch.equal(sh[pre + key], sd[pre + key]), key
        assert torch.equal(sh[pre + "attention.rel_attn_embed.weight"],
                           sd[pre + "attention.rel_attn_embed.weight"][:, 2 * rank: 2 * rank + 2])
        assert sh[pre + "attention.gru_rel_pos_const"].shape == (1, 2, 1, 1)
    with pytest.raises(ValueError, match="does not divide the encoder's 4 heads"):
        tp.shard_speech_state_dict(sd, 0, 3, num_heads=4)


# -- the gather's gradient, synchronised BatchNorm ------------------------------


def test_gather_gradient_is_the_one_device_gradient(runs):
    """CKA, diff-F1, dynamic-alpha focal and CCC on the gathered rows: the
    loss and each rank's slice of the gradient equal one rank's, 1e-6; the
    gathers are the audit's only collectives (three tensors a loss)."""
    one = runs["one"]["gather"]
    for r, res in enumerate(runs["two"]):
        got = res["gather"]
        sl = got["rows"]
        for name in ("cka", "diff_f1", "focal", "ccc"):
            assert abs(got[name]["loss"] - one[name]["loss"]) <= 1e-6, name
            for g, want in zip(got[name]["grads"], one[name]["grads"]):
                want = torch.cat([want, torch.zeros(8 - 7, *want.shape[1:])])[sl]
                np.testing.assert_allclose(g.numpy(), want.numpy(), atol=1e-6, rtol=0, err_msg=f"{name} rank {r}")
        assert got["audit"]["all-gather"]["count"] == 12 and got["audit"]["all-reduce"]["count"] == 0
    assert audit.audit_line(one["audit"]) == "collectives: NONE"


@pytest.mark.parametrize("net", ["xvector", "reference"])
def test_sync_batch_norm_takes_the_global_moments(runs, net):
    """The x-vector's and the reference encoder's BatchNorm in training mode
    on 2 ranks: outputs, running statistics and gradients within 1e-5
    (relative to each tensor's largest magnitude above 1) of one rank's;
    every BatchNorm all-reduces its moments once forward, once backward,
    and each net its gradients once."""
    one = runs["one"]["bn"][net]
    for res in runs["two"]:
        got = res["bn"][net]
        for part in ("state", "grads"):
            assert got[part].keys() == one[part].keys()
            for k in one[part]:
                w = one[part][k].double()
                tol = 1e-5 * max(1.0, float(w.abs().max()))
                assert float((got[part][k].double() - w).abs().max()) <= tol, (part, k)
        np.testing.assert_allclose(got["emb"].numpy(), one["emb"].numpy(), atol=1e-5, rtol=0)
    n_bn = {"xvector": 5, "reference": 6}
    rec = runs["two"][0]["bn"]["audit"]
    assert rec["all-reduce"]["count"] == 2 * sum(n_bn.values()) + len(n_bn)


# -- extraction ------------------------------------------------------------------


@pytest.mark.parametrize("what", ["dp", "dp16", "whisper", "text"])
def test_data_parallel_extraction_writes_the_one_rank_files(runs, what):
    """Each data rank extracts whole batches of the one-device plan: every
    ``.pt`` file within 1e-6 of one rank's (bf16: the same bf16 values), the
    stats summed by one all-reduce of 4 numbers."""
    root = runs["root"]
    _assert_same_files(root / f"{what}_two", root / f"{what}_one", 1e-6)
    one = runs["one"][what]
    for res in runs["two"]:
        got = res[what]
        for k in ("n_utts", "n_failed", "n_batches"):
            assert got["stats"][k] == one["stats"][k], k
        assert audit.audit_line(got["audit"]) == "collectives: all-reduce×1 (4 elems)"
    assert one["stats"]["n_batches"] >= 3
    assert audit.audit_line(one["audit"]) == "collectives: NONE"


def test_tensor_parallel_extraction_matches_jax_and_one_rank(runs):
    """``model_parallel=2`` on 2 ranks (H / 2 = 2 heads a rank) and through
    ``preprocess_cli speech --model_parallel 2``: the files within 2e-4 of the
    JAX package's ``model_parallel=2`` run (its test's bar) and of one rank's
    files; two all-reduces a layer a batch, nothing else."""
    root = runs["root"]
    _assert_same_files(root / "tp_two", runs["jax_tp"], 2e-4)
    _assert_same_files(root / "tp_two", root / "dp_one", 2e-4)
    _assert_same_files(root / "cli_tp", root / "dp_one", 2e-4)
    for res in runs["two"]:
        got = res["tp"]
        assert got["mesh"] == {"data": 1, "model": 2}
        assert got["audit"]["all-reduce"]["count"] == 2 * got["layers"] * got["stats"]["n_batches"]
        assert sum(r["count"] for op, r in got["audit"].items() if op != "all-reduce") == 0
        assert res["cli_tp"]["audit"]["all-reduce"]["count"] == 2 * got["layers"]  # the CLI's one 320-s batch


def test_two_by_two_mesh(runs):
    """World 4 as data 2 x model 2: the files within 2e-4 of one rank's; each
    rank's all-reduces are its model group's 2 a layer a batch plus the
    stats' one over the data axis."""
    root = runs["root"]
    _assert_same_files(root / "tp_four", root / "dp_one", 2e-4)
    batches = [res["tp"]["stats"]["n_batches"] for res in runs["four"]]
    assert batches == [runs["one"]["dp"]["stats"]["n_batches"]] * 4
    for r, res in enumerate(runs["four"]):
        got = res["tp"]
        assert got["mesh"] == {"data": 2, "model": 2}
        mine = len(range(r // 2, got["stats"]["n_batches"], 2))
        assert got["audit"]["all-reduce"]["count"] == 2 * got["layers"] * mine + 1, r


# -- fusion training ---------------------------------------------------------------


def _assert_fusion_params(got, want, cfg_path, atol=1e-5):
    with open(cfg_path) as f:
        cfg = json.load(f)
    steps = -(-N_TRAIN // cfg["batch_size"])
    budget = steps * sum(cosine_epoch_lr(cfg["lr"], e, cfg["epochs"]) for e in range(cfg["epochs"]))
    E = 2 * HID
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith("_attn.bias"):
            np.testing.assert_allclose(g, w, atol=budget, rtol=0, err_msg=name)
            continue
        if name.endswith("in_proj_bias"):
            np.testing.assert_allclose(g[E: 2 * E], w[E: 2 * E], atol=budget, rtol=0, err_msg=name)
            g, w = np.delete(g, np.s_[E: 2 * E]), np.delete(w, np.s_[E: 2 * E])
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=name)


def test_fusion_two_ranks_match_jax_two_devices(runs):
    """The same initial params, batches and (no) dropout as the JAX
    ``FusionEngine(n_devices=2)`` fit: equal dev macro-F1 each epoch, the
    parameters within 1e-5 (Adam's budget for the zero-gradient biases)."""
    root = runs["root"]
    for res in runs["two"]:
        got = res["fusion_jax"]
        assert got["f1"] == runs["jax_f1"] and len(got["f1"]) == 2
        _assert_fusion_params(got["params"], runs["jax_params"], root / "jax.json")


@pytest.mark.parametrize("run", ["fusion_drop", "fusion_f1"])
def test_fusion_two_ranks_match_one_rank_with_dropout(runs, run):
    """Dropout 0.5 (each rank keeps its rows of the global batch's mask),
    batches of 14 padded to 16 rows, 2 accumulation steps, CKA + focal with
    dynamic alpha + ranking, or CKA + diff-F1: the dev macro-F1 equal, each
    micro-batch loss within 1e-5 and the parameters as above of one rank's;
    the two ranks end bit-identical; every all-reduce carries all trainable
    parameters, one an optimizer step."""
    root = runs["root"]
    one = runs["one"][run]
    r0, r1 = (res[run] for res in runs["two"])
    assert r0["f1"] == one["f1"]
    np.testing.assert_allclose(r0["losses"], one["losses"], atol=1e-5, rtol=0)
    _assert_fusion_params(r0["params"], one["params"], root / "drop.json")
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])
    rec = r0["audit"]["all-reduce"]
    micro = -(-N_TRAIN // 14)  # micro-batches an epoch, 2 a step
    steps = 2 * -(-micro // 2)
    assert rec["count"] == steps and rec["elements"] == steps * r0["trainable"]
    assert r0["audit"]["all-gather"]["count"] > 0
    assert audit.audit_line(one["audit"]) == "collectives: NONE"
