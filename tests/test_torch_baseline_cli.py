"""The port's challenge-baseline CLIs (``baseline/cli.py``): train and eval
for ``cat`` and ``dim`` on the CPU, the files they write, the checkpoint
files in both directions with the JAX package's ``eval_main``, and the
card as the default device.

The corpus is ``tests/test_torch_baseline.py``'s (a tiny WavLM written by
transformers, wavs under 1 s). Bars: ``cat`` CSVs byte for byte, ``dim``
values within 1e-5, ``final_ssl.pt`` values within 1e-6 of the JAX
package's file for the same encoder.
"""

import csv
import os

import numpy as np
import pytest
import torch

from interspeech_ser_tpu.baseline import cli as jcli
from interspeech_ser_tpu.baseline.engine import BaselineEngine as JaxEngine
from interspeech_ser_tpu_torch.baseline import cli
from interspeech_ser_tpu_torch.baseline import data as bdata
from interspeech_ser_tpu_torch.baseline.engine import BaselineEngine
from test_torch_baseline import write_corpus

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("baseline_cli"))


def flags(corpus, model_path, *extra):
    return ["--ssl_type", str(corpus / "hf"), "--head_dim", "16", "--model_path", str(model_path),
            "--config_path", str(corpus / "configs" / "config_cat.json"), *extra]


def read(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_train_and_eval_on_the_cpu(corpus, tmp_path):
    """``train`` then ``eval`` (dev, test3) for ``cat`` (f32) and ``dim``
    (bf16) through the module's command dispatcher: the JAX package's file
    contract, the test3 rows, and a ``final_ssl.pt`` that loads into HF's
    ``WavLMModel`` with nothing unexpected."""
    from transformers import WavLMModel

    for task in ("cat", "dim"):
        out = tmp_path / task
        best = cli.main(["train", "--task", task] + flags(corpus, out, "--batch_size", "4", "--accumulation_steps",
                                                          "2", "--epochs", "2", "--lr", "1e-3", "--device", "cpu"))
        assert best["epoch"] in (0, 1) and len(best["dev_losses"]) == 2 and np.isfinite(best["dev_losses"]).all()
        assert best["dev_preds"].shape == (4, 8 if task == "cat" else 3)
        for name in ("final_ser.pt", "final_pool.pt", "final_ssl.pt", "train_norm_stat.pkl"):
            assert (out / name).exists(), name
        dev = cli.main(["eval", "--task", task, "--dev"] + flags(corpus, out, "--device", "cpu"))
        test3 = cli.main(["eval", "--task", task] + flags(corpus, out, "--device", "cpu",
                                                          "--store_path", str(tmp_path / "stored.txt")))
        assert (tmp_path / "stored.txt").read_text() == test3 + "\n"
        header = ["FileName", "EmoClass"] if task == "cat" else ["FileName", "EmoAct", "EmoVal", "EmoDom"]
        for path, n, word in ((dev, 4, "MSP-PODCAST_"), (test3, 3, "test3")):
            rows = read(path)
            assert rows[0] == header and len(rows) == n + 1 and all(word in r[0] for r in rows[1:])
            assert [r[0] for r in rows[1:]] == sorted(r[0] for r in rows[1:])
            if task == "dim":
                assert all(1.0 <= float(v) <= 7.0 for r in rows[1:] for v in r[1:])
    hf = WavLMModel.from_pretrained(str(corpus / "hf"))
    missing, unexpected = hf.load_state_dict(torch.load(tmp_path / "cat" / "final_ssl.pt", weights_only=True),
                                             strict=False)
    assert not unexpected and missing == ["masked_spec_embed"]


def test_checkpoints_load_both_ways(corpus, tmp_path):
    """Each package's engine, as built (no training), writes its checkpoint
    files; the JAX ``eval_main`` on the port's files and the port's on the
    JAX package's give the CSVs that the files' own package gives. The
    port's ``final_ssl.pt`` has the keys of ``speech_flax_to_hf`` and its
    values within 1e-6."""
    wavs = bdata.load_audio(str(corpus / "wavs"), sorted(os.listdir(corpus / "wavs"))[:4])
    dirs = {}
    for task in ("cat", "dim"):
        for pkg, engine in (("port", BaselineEngine(str(corpus / "hf"), task=task, head_dim=16, seed=3, device="cpu")),
                            ("jax", JaxEngine(str(corpus / "hf"), task=task, head_dim=16, seed=3))):
            d = tmp_path / f"{pkg}_{task}"
            d.mkdir()
            engine.save_checkpoints(str(d))
            bdata.save_norm_stat(str(d / "train_norm_stat.pkl"), *bdata.get_norm_stat_for_wav(wavs))
            dirs[pkg, task] = d
    ours = torch.load(dirs["port", "cat"] / "final_ssl.pt", weights_only=True)
    theirs = torch.load(dirs["jax", "cat"] / "final_ssl.pt", weights_only=True)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        torch.testing.assert_close(ours[k], theirs[k], atol=1e-6, rtol=0, msg=k)

    def run(main, task, d, dev):
        """One eval CLI over ``d`` -> the CSV's bytes (it is overwritten by the next run)."""
        path = main(task, dev, flags(corpus, d) + (["--device", "cpu"] if main is cli.eval_main else []))
        with open(path, "rb") as f:
            return f.read()

    for task, dev in (("cat", True), ("dim", False)):  # both tasks, both splits' code paths
        for d in (dirs["port", task], dirs["jax", task]):
            got, want = run(cli.eval_main, task, d, dev), run(jcli.eval_main, task, d, dev)
            if task == "cat":
                assert got == want, (d, dev)
            else:
                g, w = [list(csv.reader(x.decode().splitlines())) for x in (got, want)]
                assert g[0] == w[0] and [r[0] for r in g] == [r[0] for r in w]
                np.testing.assert_allclose(np.asarray([r[1:] for r in g[1:]], float),
                                           np.asarray([r[1:] for r in w[1:]], float), atol=1e-5, rtol=0)


def test_the_card_is_the_default(corpus, tmp_path):
    """Without ``--device`` the CLIs run on the card, and raise on a machine
    with none."""
    if torch.cuda.is_available():
        assert cli._train_parser().parse_args([]).device == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.train_main("cat", flags(corpus, tmp_path / "m", "--epochs", "1"))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["eval", "--task", "dim"] + flags(corpus, tmp_path / "m"))


def test_timbre_perturbation_is_refused(corpus, tmp_path):
    """The perturbation is no longer refused (the port has
    ``train/information_encoder.py``): ``fit`` takes ``use_timbre_perturb``
    with ``tp_prob`` and trains with it (the JAX comparison is
    ``tests/test_torch_legacy_baseline.py``)."""
    engine = BaselineEngine(str(corpus / "hf"), head_dim=16, device="cpu")
    best = engine.fit(str(corpus / "labels.csv"), str(corpus / "wavs"), str(tmp_path), batch_size=4,
                      accumulation_steps=2, epochs=1, lr=1e-3, use_timbre_perturb=True, tp_prob=0.8)
    assert best["epoch"] == 0 and np.isfinite(best["loss"]) and (tmp_path / "final_ser.pt").exists()


def test_an_f32_engine_turns_tf32_off_on_the_card(monkeypatch):
    """An f32 engine on the card turns TF32 off when it is built, so ``eval_main``
    runs in f32 in a fresh process too; a bf16 engine and a CPU engine leave
    the flags as they are."""
    from interspeech_ser_tpu_torch.baseline.engine import set_precision

    for device, dtype, want in (("cuda", "float32", False), ("cuda", "bfloat16", True), ("cpu", "float32", True)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        set_precision(torch.device(device), dtype)
        assert torch.backends.cuda.matmul.allow_tf32 is want and torch.backends.cudnn.allow_tf32 is want, device
