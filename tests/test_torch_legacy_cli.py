"""The port's legacy CLI surface on the CPU: ``cli.LEGACY`` against the
``bin/old`` wrappers, every wrapper's runner through the port's CLI, the dim
runners' CSVs against the JAX runners', the gender CSV and the old configs.

- ``LEGACY`` equals the keyword arguments of every ``bin/old/*.py`` that
  imports ``interspeech_ser_tpu.cli`` (read with ``ast``, nothing imported),
  and covers all 36;
- each entry runs through ``python -m interspeech_ser_tpu_torch.cli <runner>
  --legacy <stem> --device cpu`` on a small corpus (one epoch; the scoring
  runners on a checkpoint of the matching model);
- ``eval_dim`` / ``test_dim`` write the JAX runners' CSVs on the same
  checkpoint: the same header and names, each value within 1e-4;
- a gender trainer without a gender CSV raises a ``ValueError`` naming it;
- every ``configs/old/config_dim_*.json`` loads, ``raw`` keeping ``pretrained_path``.
"""

import ast
import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

from interspeech_ser_tpu_torch import cli
from interspeech_ser_tpu_torch.train.engine import EngineOptions, FusionEngine
from interspeech_ser_tpu_torch.utils.config import load_fusion_config
from test_torch_legacy_engine import config, write_legacy_corpus

torch.set_num_threads(2)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
RUNNER_OF = {"train_main": "train", "eval_main": "eval", "test_main": "test", "extract_train_main": "extract_train",
             "eval_dim_main": "eval_dim", "test_dim_main": "test_dim"}


def wrapper_calls() -> dict:
    """stem -> (runner, literal keyword arguments) of each bin/old wrapper over
    ``interspeech_ser_tpu.cli``; ``gender_labels_csv`` must be
    ``os.environ.get('GENDER_LABELS_CSV')`` and is left out."""
    calls = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "bin", "old", "*.py"))):
        tree = ast.parse(open(path).read())
        if not any(isinstance(n, ast.ImportFrom) and n.module == "interspeech_ser_tpu.cli" for n in ast.walk(tree)):
            continue
        (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and getattr(n.func, "id", None) in RUNNER_OF]
        assert not call.args, path
        kwargs = {}
        for kw in call.keywords:
            if kw.arg == "gender_labels_csv":
                assert ast.unparse(kw.value).replace('"', "'") == "os.environ.get('GENDER_LABELS_CSV')", path
                continue
            kwargs[kw.arg] = ast.literal_eval(kw.value)
        calls[os.path.basename(path)[:-3]] = (RUNNER_OF[call.func.id], kwargs)
    return calls


def test_legacy_table_equals_the_bin_old_wrappers():
    calls = wrapper_calls()
    assert len(calls) == 36
    assert cli.LEGACY == calls


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("legacy_cli")
    write_legacy_corpus(root)
    cat = config(root, "cat_for_fromcat")  # the fromcat trainer's pretrained cat checkpoint
    FusionEngine(load_fusion_config(cat), device="cpu").save_torch_checkpoint(str(root / "cat.pt"))
    return root


def _checkpoint_for(cfg_path: str, overrides: dict) -> None:
    """A ``multimodal_ser.pt`` of the model the scoring runner builds."""
    ov = dict(overrides)
    trimodal = ov.pop("trimodal", False)
    cfg = load_fusion_config(cfg_path, trimodal=trimodal or None)
    engine = FusionEngine(cfg, seed=5, device="cpu", options=EngineOptions(**ov))
    os.makedirs(cfg.model_path, exist_ok=True)
    engine.save_torch_checkpoint(os.path.join(cfg.model_path, "multimodal_ser.pt"))


@pytest.mark.parametrize("stem", sorted(cli.LEGACY))
def test_every_legacy_wrapper_runs_on_the_cpu(corpus, stem, monkeypatch, capsys):
    runner, overrides = cli.LEGACY[stem]
    monkeypatch.setenv("GENDER_LABELS_CSV", str(corpus / "gender.csv"))
    cfg_path = config(corpus, stem, trimodal=overrides.get("trimodal", False),
                      pretrained_path=str(corpus / "cat.pt"))
    model_path = load_fusion_config(cfg_path).model_path
    argv = [runner, "--legacy", stem, "--config_path", cfg_path, "--device", "cpu"]
    if runner == "train":
        cli.main(argv)
        assert os.path.exists(os.path.join(model_path, "multimodal_ser.pt"))
        logs = "".join(open(os.path.join(model_path, f)).read() for f in os.listdir(model_path)
                       if f.startswith("loggingtxt-"))
        assert "|VALIDATION| Epoch (1/1)" in logs
        if overrides.get("init_from_pretrained"):
            assert "skipped ['classifier.3.weight', 'classifier.3.bias']" in logs
        return
    if runner != "extract_train":
        task = {"task": "dim"} if runner.endswith("_dim") else {}
        _checkpoint_for(cfg_path, {**overrides, **task})
    if runner.startswith("test"):
        argv += ["--test_df", str(corpus / "test.csv")]
    if runner == "extract_train":
        _checkpoint_for(cfg_path, overrides)
        argv += ["--train_df", str(corpus / "train_stacking_sample.csv")]
    cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    with open(out, newline="") as f:
        table = list(csv.reader(f))
    assert len(table) > 1 and all(np.isfinite(float(v)) for r in table[1:] for v in r[2 if "_dim" not in runner
                                                                                        else 1:])


def test_legacy_runner_mismatch_raises():
    with pytest.raises(SystemExit, match="runs `eval`"):
        cli.main(["train", "--legacy", "eval_cat_bimodal_lazy_moe"])


@pytest.mark.parametrize("runner", ["eval_dim", "test_dim"])
def test_dim_csvs_match_the_jax_runners(corpus, runner, tmp_path):
    """The same dim checkpoint scored by the port's and the JAX package's runner."""
    from interspeech_ser_tpu import cli as jax_cli

    cfg_path = config(corpus, f"dimcsv_{runner}")
    _checkpoint_for(cfg_path, {"task": "dim"})
    argv = ["--config_path", cfg_path] + (["--test_df", str(corpus / "test.csv")] if runner == "test_dim" else [])
    jax_out = getattr(jax_cli, f"{runner}_main")(argv=argv)
    with open(jax_out, newline="") as f:
        want = list(csv.reader(f))
    os.remove(jax_out)
    port_out = cli.RUNNERS[runner](argv + ["--device", "cpu"])
    with open(port_out, newline="") as f:
        got = list(csv.reader(f))
    assert got[0] == want[0] == [("Filename" if runner == "eval_dim" else "FileName"), "EmoAct", "EmoDom", "EmoVal"]
    assert [r[0] for r in got] == [r[0] for r in want] and len(got) > 1
    for g, w in zip(got[1:], want[1:]):
        assert all(len(v.split(".")[1]) == 4 for v in g[1:])
        np.testing.assert_allclose(np.asarray(g[1:], float), np.asarray(w[1:], float), atol=1e-4, rtol=0)


def test_gender_trainer_without_a_gender_csv_names_it(corpus, monkeypatch):
    monkeypatch.delenv("GENDER_LABELS_CSV", raising=False)
    with pytest.raises(ValueError, match="gender labels CSV"):
        cli.main(["train", "--legacy", "train_cat_bimodal_lazy_grlgender", "--config_path",
                  config(corpus, "no_gender"), "--device", "cpu"])


def test_old_dim_configs_load():
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "old", "config_dim_*.json")))
    assert len(paths) >= 10
    for path in paths:
        cfg = load_fusion_config(path)
        assert cfg.raw == json.load(open(path)) and cfg.feat_dims
        assert "raw" not in repr(cfg)
    fromcat = load_fusion_config(os.path.join(ROOT, "configs", "old", "config_dim_bimodal_lazy_lr1e4_fromcat.json"))
    assert fromcat.raw["pretrained_path"].endswith("multimodal_ser.pt")
