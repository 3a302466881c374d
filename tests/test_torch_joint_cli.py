"""``joint_cli`` end to end on the CPU: ``main`` for every ``bin/old``
stem (the files, the log lines, ``--device cpu``; the default device raises
without a card), the saved files against what the JAX engines write for
the same weights, strict reloads, batched eval against batch-1, the JAX
engine reading the port's ``final_ser.pt``, and the BPE tokenize function
against the JAX CLI's transformers tokenizer.

The corpus is ``tests/test_torch_joint_engine.py``'s, with a RoBERTa of
320 ids and 130 positions (the CLI tokenizes to 128 tokens with the
synthetic byte-level BPE files ``chip_smoke.py`` writes). Bars: reloaded
dev logits equal to the run's, batches of 8 within 1e-5 of batch-1, the
JAX engine's logits from the port's file within 1e-5; the files' keys
equal and values bit for bit the JAX writers' output (the positional
conv's weight-norm g within 1e-6 relative).
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from interspeech_ser_tpu.models import convert_hf
from interspeech_ser_tpu.train import joint_engine as jje
from interspeech_ser_tpu_torch import joint_cli
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.baseline.podcast import load_cat_emo_label
from interspeech_ser_tpu_torch.models.convert import joint_params_to_flax
from interspeech_ser_tpu_torch.models.loader import speech_state_dict_from_hf
from interspeech_ser_tpu_torch.train.joint_engine import VARIANTS, JointEngine
from interspeech_ser_tpu_torch.utils import labels as L
from test_torch_joint_engine import HEAD_DIM, head_kw, write_config, write_joint_corpus

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)
torch.set_num_threads(2)
STEM_FILES = {None: ["text_ser.pt"], "ftall": ["final_ser.pt", "final_text_model.pt", "final_ssl.pt"]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The joint corpus, a RoBERTa of 320 ids with BPE files, and one
    ``main`` run of every stem (1 epoch, batch 4, 2 accumulation steps)."""
    from transformers import RobertaConfig, RobertaModel

    import chip_smoke

    root = write_joint_corpus(tmp_path_factory.mktemp("joint_cli"))
    torch.manual_seed(6)
    RobertaModel(RobertaConfig(vocab_size=320, hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                               intermediate_size=32, max_position_embeddings=130, type_vocab_size=1,
                               pad_token_id=1)).save_pretrained(str(root / "roberta_bpe"))
    words = ["sample", "text"] + [str(c) for c in range(8)]
    assert chip_smoke.write_bpe_files(str(root / "roberta_bpe"), words, 320) <= 320
    runs = {}
    for stem, variant in joint_cli.STEMS.items():
        cfg = write_config(root, stem, text_type=str(root / "roberta_bpe"))
        best = joint_cli.main([stem, "--config_path", cfg, "--seed", "3", "--device", "cpu"])
        runs[stem] = (variant, cfg, best)
    return root, runs


def test_every_stem_trains_and_logs(corpus):
    root, runs = corpus
    assert set(runs) == {os.path.splitext(f)[0] for f in os.listdir(os.path.join(ROOT, "bin", "old"))
                         if f.startswith("train_cat_roberta")}
    for stem, (variant, _, best) in runs.items():
        out = root / stem
        assert best["epoch"] == 0 and np.isfinite(best["loss"]), stem
        for name in STEM_FILES.get(variant, ["final_ser.pt"]):
            assert (out / name).exists(), (stem, name)
        assert not (out / "final_ssl.pt").exists() or variant == "ftall"
        (log,) = [f for f in os.listdir(out) if f.startswith("loggingtxt-")]
        text = (out / log).read_text()
        assert "|VALIDATION| Epoch (1/1): eval_loss = " in text and "New best model at epoch 1" in text, stem
        if variant is not None:
            assert (out / "train_norm_stat.pkl").exists()
            assert f"Starting an experimento in model path = {out}" in text
            assert ("eval_cka = " in text) == (VARIANTS[variant].cka != "none"), stem
        else:
            assert "eval acc = " in text


def test_wrappers_map_to_the_stems():
    """Each ``bin/old/train_cat_roberta*.py`` calls the runner ``STEMS`` maps it to."""
    for stem, variant in joint_cli.STEMS.items():
        tree = ast.parse(open(os.path.join(ROOT, "bin", "old", f"{stem}.py")).read())
        calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                 and n.func.id in ("train_main", "train_text_main")]
        assert len(calls) == 1, stem
        if variant is None:
            assert calls[0].func.id == "train_text_main"
        else:
            assert calls[0].func.id == "train_main" and calls[0].args[0].value == variant


def test_default_device_raises_without_a_card(corpus):
    root, runs = corpus
    _, cfg, _ = runs["train_cat_roberta_wavlm"]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        joint_cli.main(["train_cat_roberta_wavlm", "--config_path", cfg])
    with pytest.raises(SystemExit):
        joint_cli.main(["train_cat_roberta_wavlm_nope", "--config_path", cfg])


def port_engine(root, variant, model_path):
    pe = JointEngine(str(root / "hf_wavlm"), str(root / "roberta_bpe"),
                     joint_cli.make_bpe_tokenize(str(root / "roberta_bpe")), VARIANTS[variant], head_dim=HEAD_DIM,
                     device="cpu")
    pe.load_head(str(model_path))
    return pe


def dev_split(root, model_path, tokenize):
    rows = L.split(L.load_merged(str(root / "labels.csv"), str(root / "transcripts.csv")), "Development")
    utts, labs = load_cat_emo_label(str(root / "labels.csv"), "dev")
    mean, std = bdata.load_norm_stat(str(model_path / "train_norm_stat.pkl"))
    return (bdata.WavDataset(bdata.load_audio(str(root / "audio"), utts), labs, utts, mean, std),
            bdata.TxtDataset(L.transcripts(rows), tokenize))


@pytest.mark.parametrize("stem", ["train_cat_roberta_wavlm", "train_cat_roberta_wavlm_large_ckainv"])
def test_reload_batch1_and_jax_reads_the_file(corpus, stem):
    """``load_head`` strictly reloads ``final_ser.pt``: the dev logits equal
    the run's; batches of 8 equal batch-1; the JAX engine, given the same
    encoders and the port's file (its ``load_head``), predicts the same."""
    root, runs = corpus
    variant, _, best = runs[stem]
    pe = port_engine(root, variant, root / stem)
    wav_set, txt_set = dev_split(root, root / stem, pe.tokenize)
    logits, fw, fr = pe.predict(wav_set, txt_set)
    np.testing.assert_array_equal(logits, best["dev_logits"])
    single, fw1, _ = pe.predict(wav_set, txt_set, batch_size=1)
    np.testing.assert_allclose(single, logits, atol=1e-5, rtol=0)
    if fw is not None:
        np.testing.assert_allclose(fw1, fw, atol=1e-5, rtol=0)
    je = jje.JointEngine(str(root / "hf_wavlm"), str(root / "roberta_bpe"), pe.tokenize, VARIANTS[variant],
                         head_dim=HEAD_DIM, n_devices=1)
    je.params["ssl"], je.params["txt"] = speech_tree(pe.ssl, je.ssl_cfg), roberta_tree(pe.txt, je.txt_cfg)
    je.load_head(str(root / stem))
    from interspeech_ser_tpu.baseline import data as jdata

    jw = jdata.WavDataset(wav_set.wav_list, wav_set.labels, wav_set.utts, wav_set.wav_mean, wav_set.wav_std)
    want, _, _ = je.predict(jw, jdata.TxtDataset(txt_set.texts, pe.tokenize))
    np.testing.assert_allclose(logits, want, atol=1e-5, rtol=0)


def speech_tree(ssl, cfg):
    """The JAX param tree of a port speech encoder's weights."""
    return convert_hf.speech_hf_to_flax({k: v.numpy() for k, v in ssl.state_dict().items()}, cfg)


def roberta_tree(txt, cfg):
    return convert_hf.roberta_hf_to_flax({k: v.numpy() for k, v in txt.state_dict().items()}, cfg)


def assert_same_files(a, b, names):
    """Same keys, values bit for bit; but the positional conv's weight-norm
    g (``original0``, a root of a sum of squares that torch sums in another
    order than numpy) within 1e-6 relative, the bar of the baseline's
    ``final_ssl.pt`` test."""
    for name in names:
        x, y = (torch.load(d / name, weights_only=True) for d in (a, b))
        assert set(x) == set(y), name
        for k in x:
            if k.endswith("parametrizations.weight.original0"):
                np.testing.assert_allclose(np.asarray(x[k]), np.asarray(y[k]), rtol=1e-6, atol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(x[k]), np.asarray(y[k]), err_msg=f"{name} {k}")


@pytest.mark.parametrize("stem", ["train_cat_roberta_wavlm_ftall", "train_cat_roberta_wavlm_small_cka"])
def test_checkpoints_equal_the_jax_writers(corpus, tmp_path, stem):
    """``final_ser.pt`` (and for ``ftall`` ``final_text_model.pt`` /
    ``final_ssl.pt``): the JAX ``save_checkpoints`` of an engine holding the
    port's saved weights writes the same keys and values."""
    root, runs = corpus
    variant, _, _ = runs[stem]
    pe = port_engine(root, variant, root / stem)
    if variant == "ftall":
        pe.ssl.load_state_dict(speech_state_dict_from_hf(torch.load(root / stem / "final_ssl.pt", weights_only=True)))
        pe.txt.load_state_dict(torch.load(root / stem / "final_text_model.pt", weights_only=True))
    je = jje.JointEngine(str(root / "hf_wavlm"), str(root / "roberta_bpe"), pe.tokenize, VARIANTS[variant],
                         head_dim=HEAD_DIM, n_devices=1)
    je.params["ssl"], je.params["txt"] = speech_tree(pe.ssl, pe.ssl_cfg), roberta_tree(pe.txt, pe.txt_cfg)
    je.params["head"] = joint_params_to_flax(pe.head.state_dict(), **head_kw(variant))
    je.save_checkpoints(str(tmp_path))
    names = ["final_ser.pt"] + (["final_text_model.pt", "final_ssl.pt"] if variant == "ftall" else [])
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".pt")) == sorted(names)
    assert_same_files(tmp_path, root / stem, names)


def test_text_checkpoint_equals_the_jax_writer(corpus, tmp_path):
    """``text_ser.pt``: the JAX ``TextOnlyEngine.save_checkpoint`` of the
    port's saved weights writes the same keys and values; the port's
    engine predicts the run's dev logits from them."""
    from interspeech_ser_tpu_torch.train.joint_engine import TextOnlyEngine

    root, runs = corpus
    _, _, best = runs["train_cat_roberta"]
    sd = torch.load(root / "train_cat_roberta" / "text_ser.pt", weights_only=True)
    tokenize = joint_cli.make_bpe_tokenize(str(root / "roberta_bpe"))
    pe = TextOnlyEngine(str(root / "roberta_bpe"), tokenize, device="cpu")
    pe.txt.load_state_dict({k[len("roberta."):]: v for k, v in sd.items() if k.startswith("roberta.")})
    pe.cls_head.load_state_dict({k[len("classifier."):]: v for k, v in sd.items() if k.startswith("classifier.")})
    je = jje.TextOnlyEngine(str(root / "roberta_bpe"), tokenize, n_devices=1)
    je.params["txt"] = roberta_tree(pe.txt, pe.txt_cfg)
    je.params["head"] = {m: {"kernel": sd[f"classifier.{m}.weight"].numpy().T,
                             "bias": sd[f"classifier.{m}.bias"].numpy()} for m in ("dense", "out_proj")}
    je.save_checkpoint(str(tmp_path))
    assert_same_files(tmp_path, root / "train_cat_roberta", ["text_ser.pt"])
    rows = L.split(L.load_merged(str(root / "labels.csv"), str(root / "transcripts.csv")), "Development")
    toks = tokenize(L.transcripts(rows))
    np.testing.assert_array_equal(pe.predict(toks["input_ids"], toks["attention_mask"]), best["dev_logits"])
    np.testing.assert_allclose(pe.predict(toks["input_ids"], toks["attention_mask"], batch_size=1),
                               best["dev_logits"], atol=1e-5, rtol=0)


def test_bpe_tokenize_matches_the_jax_tokenize(corpus):
    """``make_bpe_tokenize`` against the JAX CLI's ``make_hf_tokenize``
    (transformers' tokenizer of the same files): ids and masks at 128, a
    missing text the empty one."""
    from interspeech_ser_tpu.joint_cli import make_hf_tokenize

    root, _ = corpus
    texts = ["sample text 3 sample", "", None, "Unknown Words, here!", " ".join(["sample text"] * 80)]
    got = joint_cli.make_bpe_tokenize(str(root / "roberta_bpe"))(texts)
    want = make_hf_tokenize(str(root / "roberta_bpe"))(texts)
    for key in ("input_ids", "attention_mask"):
        assert got[key].shape == (len(texts), 128) and got[key].dtype == np.int64
        np.testing.assert_array_equal(got[key], np.asarray(want[key]))
