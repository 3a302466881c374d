"""The port's RF stacking ensemble (``interspeech_ser_tpu_torch/stacking.py``)
against ``test/stacking.py`` (loaded by path) on the same synthetic
experiments with ``--n_estimators 50``: the parsed feature matrices bit for
bit (``pandas_float`` against pandas' C parser),
the joins with ``pd.merge``'s row order, the bootstrap's draws against
``DataFrame.sample``, the printed metric lines equal, each fold's
``predict_proba`` equal, and the submission CSV byte-equal.

The experiments: two with 4-decimal logits as the eval CLIs write them,
one with unrounded ones (17 significant digits), a dev row that one
experiment lacks and a train name twice in another.
"""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from interspeech_ser_tpu_torch import stacking
from interspeech_ser_tpu_torch.utils.labels import CLASS_LETTERS

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def reference():
    spec = importlib.util.spec_from_file_location("reference_stacking", os.path.join(ROOT, "test", "stacking.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def experiments(tmp_path):
    rng = np.random.default_rng(17)
    n = {"train": 120, "dev": 60, "test": 20}
    names = {"train": [f"tr{i:03d}.wav" for i in range(n["train"])], "dev": [f"dv{i:03d}.wav" for i in range(n["dev"])],
             "test": [f"te{i:03d}.wav" for i in range(n["test"])]}
    y = {s: rng.integers(0, 8, n[s]) for s in ("train", "dev")}
    exps = []
    for e, decimals in enumerate((4, 4, None)):
        d = tmp_path / f"exp{e}" / "results"
        d.mkdir(parents=True)
        for split in ("train", "dev", "test"):
            logits = rng.normal(size=(n[split], 8)) + (3.0 * np.eye(8)[y[split]] if split in y else 0.0)
            header = "FileName" if split == "test" else "Filename"
            df = pd.DataFrame({header: names[split]})
            df["Prediction"] = [CLASS_LETTERS[i] for i in np.argmax(logits, 1)]
            for c in range(8):
                df[f"class_{c}_prob"] = logits[:, c] if decimals is None else np.round(logits[:, c], decimals)
            if e == 1 and split == "dev":
                df = df.drop(index=7)  # a dev row one experiment lacks
            if e == 2 and split == "train":
                df = pd.concat([df, df.iloc[[5]]])  # a train name twice
            df.to_csv(d / f"{split}.csv", index=False)
        exps.append(str(tmp_path / f"exp{e}"))
    labels = pd.DataFrame({
        "FileName": names["train"] + names["dev"],
        "EmoClass": [CLASS_LETTERS[i] for i in np.concatenate([y["train"], y["dev"]])],
        "Gender": (["Female", "Male", "Male"] * 100)[: n["train"] + n["dev"]],
    })
    labels.to_csv(tmp_path / "labels_consensus.csv", index=False)
    pd.DataFrame({"FileName": [f"te{i:03d}.wav" for i in reversed(range(n["test"]))]}).to_csv(
        tmp_path / "baseline_order.csv", index=False)
    return tmp_path, exps


def test_frames_parse_and_join_as_pandas(experiments):
    tmp, exps = experiments
    ref = reference()
    for split in ("train", "dev", "test"):
        rows, feats = stacking._load_experiment_frame(exps, split, "FileName")
        frame, want_feats = ref._load_experiment_frame(exps, split, "FileName")
        assert feats == want_feats
        assert [r["FileName"] for r in rows] == frame["FileName"].tolist()
        got, want = stacking._matrix(rows, feats), frame[feats].values
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
    left = [{"k": k, "a": i} for i, k in enumerate("xyzxw")]
    right = [{"k": k, "b": i} for i, k in enumerate("wxxvy")]
    want = pd.merge(pd.DataFrame(left), pd.DataFrame(right), on="k")
    assert [(r["k"], r["a"], r["b"]) for r in stacking.inner_join(left, right, "k")] == \
        list(want.itertuples(index=False, name=None))


def test_bootstrap_draws_as_dataframe_sample(experiments):
    ref = reference()
    rng = np.random.default_rng(3)
    rows = [{"EmoClass": CLASS_LETTERS[int(c)], "i": i} for i, c in enumerate(rng.integers(0, 8, 90))]
    rows += [{"EmoClass": "Z", "i": 90}]  # a class of one row
    df = pd.DataFrame(rows)
    for seed in (0, 1, 42):
        for n in (200, 5):
            got = [r["i"] for r in stacking.get_stratified_subset(rows, "EmoClass", n, seed)]
            assert got == ref.get_stratified_subset(df, "EmoClass", n, seed)["i"].tolist()


def test_train_and_test_match_the_reference_script(experiments, capsys):
    tmp, exps = experiments
    ref = reference()
    outs = {}
    for name, mod in (("ref", ref), ("port", stacking)):
        models = str(tmp / f"models_{name}")
        macro = mod.train_main(["--experiments"] + exps + ["--label_path", str(tmp / "labels_consensus.csv"),
                                                            "--out_dir", models, "--n_estimators", "50"])
        printed = capsys.readouterr().out
        csv_path = str(tmp / f"sub_{name}.csv")
        mod.test_main(["--experiments"] + exps + ["--models_dir", models, "--baseline_csv",
                                                  str(tmp / "baseline_order.csv"), "--out", csv_path])
        outs[name] = dict(macro=macro, printed=printed, models=models, csv=csv_path,
                          test_printed=capsys.readouterr().out.replace(csv_path, "OUT"))
    assert outs["port"]["macro"] == outs["ref"]["macro"] > 0.5
    assert outs["port"]["printed"] == outs["ref"]["printed"]
    assert "bootstrap" in outs["port"]["printed"] and "(Female)" in outs["port"]["printed"]
    assert outs["port"]["test_printed"] == outs["ref"]["test_printed"] == "wrote OUT (20 rows)\n"
    with open(outs["port"]["csv"], "rb") as a, open(outs["ref"]["csv"], "rb") as b:
        assert a.read() == b.read()
    import pickle

    frame, feats = ref._load_experiment_frame(exps, "dev", "FileName")
    for fold in range(5):
        probas = []
        for name in ("ref", "port"):
            with open(os.path.join(outs[name]["models"], f"rf_model_stackingv3_{fold}.pkl"), "rb") as f:
                probas.append(pickle.load(f).predict_proba(frame[feats].values))
        np.testing.assert_array_equal(probas[0], probas[1])


def test_missing_baseline_name_and_duplicate_experiments_raise(experiments):
    tmp, exps = experiments
    with pytest.raises(ValueError, match="two experiments"):
        stacking._load_experiment_frame([exps[0], exps[0]], "dev", "FileName")
    pd.DataFrame({"FileName": ["te000.wav", "nope.wav"]}).to_csv(tmp / "bad_order.csv", index=False)
    stacking.train_main(["--experiments"] + exps + ["--label_path", str(tmp / "labels_consensus.csv"), "--out_dir",
                                                    str(tmp / "m"), "--n_estimators", "5", "--k", "2"])
    with pytest.raises(KeyError):
        stacking.test_main(["--experiments"] + exps + ["--models_dir", str(tmp / "m"), "--k", "2", "--baseline_csv",
                                                       str(tmp / "bad_order.csv"), "--out", str(tmp / "x.csv")])


def test_pandas_float_reads_as_read_csv(tmp_path):
    """``pandas_float`` bit for bit against ``pd.read_csv`` on shortest
    reprs, 17-digit and 20-digit strings, exponents and 4-decimal values."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=400) * 10.0 ** rng.integers(-30, 30, 400)
    texts = ([repr(float(v)) for v in x] + [f"{v:.16e}" for v in x[:100]] + [f"{v:.4f}" for v in x[:100]]
             + ["12345678901234567890.123", "-0.0", "+3.25", "7", "1E5", "2.5e-3", ".5", "0.000000000000000000123"])
    (tmp_path / "v.csv").write_text("v\n" + "\n".join(texts) + "\n")
    want = pd.read_csv(tmp_path / "v.csv", dtype={"v": np.float64})["v"].to_numpy()
    got = np.asarray([stacking.pandas_float(t) for t in texts], np.float64)
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))
