"""The RF stacking ensemble: the submission pipeline's last step.

    python -m interspeech_ser_tpu_torch.stacking train --experiments EXP [EXP ...] \\
        --label_path labels_consensus.csv [--out_dir ./stacking_models] [--k 5] [--seed 42] [--n_estimators 500]
    python -m interspeech_ser_tpu_torch.stacking test --experiments EXP [EXP ...] \\
        [--models_dir ./stacking_models] [--k 5] [--baseline_csv order.csv] [--out bimodal_ensemble_vfinal.csv]

Port of ``test/stacking.py`` with the same flags, files and printed lines,
read with ``csv`` instead of pandas: each experiment's
``results/{train,dev,test}.csv`` logit columns (``class_{i}_prob``, renamed
``<experiment dir name>_c{i}``, keyed by ``Filename`` or ``FileName``,
parsed as pandas' C parser parses them, ``pandas_float``) are
inner-joined on the file name in the left table's row order, as
``pd.merge`` joins them; ``train`` fits a RandomForest on each of ``--k``
stratified folds of the train rows (``rf_model_stackingv3_{i}.pkl``),
prints the dev macro / micro F1 of the folds' mean ``predict_proba``, a
stratified bootstrap of it and its F1 by gender; ``test`` averages the
folds' probabilities over the test rows and writes ``FileName,EmoClass``
in ``--baseline_csv``'s order. The bootstrap draws what pandas'
``DataFrame.sample(n, random_state=seed, replace=True)`` draws, class by
class in sorted order.

It runs on the host: scikit-learn, imported inside ``train_main`` /
``test_main`` (so the package imports where it is absent, as on the card's
machine, where nothing of this runs), and no card. Two experiment
directories of the same name raise (pandas would suffix their columns).
"""

from __future__ import annotations

import argparse
import csv
import os
import pickle
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

N_CLASSES = 8
Row = Dict[str, object]
_POW10 = [float(f"1e{k}") for k in range(309)]  # the parser's table of powers of ten


def pandas_float(text: str) -> float:
    """A decimal string as ``pd.read_csv``'s default (``float_precision=None``,
    "high") C parser reads it: up to 17 significant digits gathered into a
    double as ``number * 10 + digit``, the rest dropped, then one multiply by
    or divide by a power of ten. That can sit a few ulps from ``float(text)``
    (correctly rounded) when the string carries 16-17 digits; with the eval
    CLIs' 4 decimals both are exact. Strings outside ``[+-]digits[.digits]
    [e[+-]digits]`` go to ``float``."""
    t = text.strip()
    i, n = 0, len(t)
    negative = i < n and t[i] == "-"
    i += i < n and t[i] in "+-"
    number, exponent, digits, decimals = 0.0, 0, 0, 0
    while i < n and t[i].isdigit() and t[i].isascii():
        if digits < 17:
            number, digits = number * 10.0 + (ord(t[i]) - 48), digits + 1
        else:
            exponent += 1
        i += 1
    if i < n and t[i] == ".":
        i += 1
        while i < n and digits < 17 and t[i].isdigit() and t[i].isascii():
            number, digits, decimals = number * 10.0 + (ord(t[i]) - 48), digits + 1, decimals + 1
            i += 1
        while i < n and t[i].isdigit() and t[i].isascii():
            i += 1
        exponent -= decimals
    if digits == 0:
        return float(text)
    if negative:
        number = -number
    if i < n and t[i] in "eE":
        rest = t[i + 1:]
        if not rest.lstrip("+-").isdigit():
            return float(text)
        exponent += int(rest)
        i = n
    if i != n:
        return float(text)
    if exponent > 308:
        return float(text)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -308:
        return 0.0 * number if exponent < -616 else number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _read_csv(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def inner_join(left: List[Row], right: List[Row], key: str) -> List[Row]:
    """``pd.merge(left, right, on=key)`` (inner): each left row, in order, with
    each right row of the same key, in order; the right rows' other columns
    added."""
    by_key: Dict[object, List[Row]] = {}
    for r in right:
        by_key.setdefault(r[key], []).append(r)
    return [{**r, **m} for r in left for m in by_key.get(r[key], [])]


def _load_experiment_frame(experiments: Sequence[str], split: str, filename_col: str) -> Tuple[List[Row], List[str]]:
    """The experiments' logit columns of ``split``, joined on the file name
    -> (rows, feature column names)."""
    merged, names = None, []
    for exp in experiments:
        name = os.path.basename(os.path.normpath(exp))
        if name in names:
            raise ValueError(f"two experiments named {name!r}: their columns would collide")
        names.append(name)
        rows = _read_csv(os.path.join(exp, "results", f"{split}.csv"))
        src = "Filename" if rows and "Filename" in rows[0] else "FileName"
        table = [{filename_col: r[src], **{f"{name}_c{i}": pandas_float(r[f"class_{i}_prob"])
                                           for i in range(N_CLASSES)}}
                 for r in rows]
        merged = table if merged is None else inner_join(merged, table, filename_col)
    feats = [f"{n}_c{i}" for n in names for i in range(N_CLASSES)]
    return merged, feats


def _matrix(rows: List[Row], feats: List[str]) -> np.ndarray:
    return np.asarray([[r[f] for f in feats] for r in rows], dtype=np.float64).reshape(len(rows), len(feats))


def get_stratified_subset(rows: List[Row], target: str, n_per_class: int, seed: int) -> List[Row]:
    """Per class of ``target`` in sorted order, ``min(n, class size)`` of its
    rows drawn with replacement by ``RandomState(seed).choice`` (what
    ``DataFrame.sample(random_state=seed, replace=True)`` draws)."""
    parts: List[Row] = []
    for cls in sorted({r[target] for r in rows}):
        group = [r for r in rows if r[target] == cls]
        idx = np.random.RandomState(seed).choice(len(group), size=min(n_per_class, len(group)), replace=True)
        parts.extend(group[i] for i in idx)
    return parts


def _column(rows: List[Row], name: str) -> np.ndarray:
    return np.asarray([r[name] for r in rows], dtype=object)


def _parser(train: bool) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    if train:
        p.add_argument("--experiments", nargs="+", required=True,
                       help="experiment dirs containing results/{train,dev}.csv")
        p.add_argument("--label_path", required=True,
                       help="labels CSV with FileName + EmoClass (labels_consensus.csv)")
        p.add_argument("--out_dir", default="./stacking_models")
        p.add_argument("--k", type=int, default=5)
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--n_estimators", type=int, default=500)
    else:
        p.add_argument("--experiments", nargs="+", required=True)
        p.add_argument("--models_dir", default="./stacking_models")
        p.add_argument("--k", type=int, default=5)
        p.add_argument("--baseline_csv", default=None, help="submission CSV whose FileName order to follow")
        p.add_argument("--out", default="bimodal_ensemble_vfinal.csv")
    return p


def train_main(argv=None) -> float:
    """Fit and save the fold models, print the dev metrics -> dev macro-F1."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.metrics import f1_score
    from sklearn.model_selection import StratifiedKFold

    args = _parser(True).parse_args(argv)
    labels = _read_csv(args.label_path)
    train_rows, feats = _load_experiment_frame(args.experiments, "train", "FileName")
    dev_rows, _ = _load_experiment_frame(args.experiments, "dev", "FileName")
    train_rows = inner_join(train_rows, [{"FileName": r["FileName"], "EmoClass": r["EmoClass"]} for r in labels],
                            "FileName")
    keep = [c for c in ("EmoClass", "Gender") if labels and c in labels[0]]
    dev_rows = inner_join(dev_rows, [{c: r[c] for c in ["FileName"] + keep} for r in labels], "FileName")

    np.random.seed(args.seed)
    X, y = _matrix(train_rows, feats), _column(train_rows, "EmoClass")
    skf = StratifiedKFold(n_splits=args.k, shuffle=True, random_state=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    models = []
    for fold, (tr_idx, _) in enumerate(skf.split(X, y)):
        rf = RandomForestClassifier(random_state=42, n_estimators=args.n_estimators, max_depth=8, criterion="gini",
                                    min_samples_leaf=10, min_samples_split=10)
        rf.fit(X[tr_idx], y[tr_idx])
        models.append(rf)
        with open(os.path.join(args.out_dir, f"rf_model_stackingv3_{fold}.pkl"), "wb") as f:
            pickle.dump(rf, f)

    # dev: the folds' mean predict_proba
    proba = np.mean([m.predict_proba(_matrix(dev_rows, feats)) for m in models], axis=0)
    pred = models[0].classes_[np.argmax(proba, axis=1)]
    for r, p in zip(dev_rows, pred):
        r["Prediction"] = p
    truth = _column(dev_rows, "EmoClass")
    macro = f1_score(truth, pred, average="macro")
    micro = f1_score(truth, pred, average="micro")
    print(f"dev macro-F1 = {macro:.4f}")
    print(f"dev micro-F1 = {micro:.4f}")
    boot = []
    for i in range(100):
        s = get_stratified_subset(dev_rows, "EmoClass", 200, i)
        boot.append(f1_score(_column(s, "EmoClass"), _column(s, "Prediction"), average="macro"))
    boot = np.asarray(boot)
    print(f"dev bootstrap macro-F1 = {boot.mean():.4f} ± {boot.std():.4f} "
          f"(min {boot.min():.4f}, max {boot.max():.4f})")
    if "Gender" in keep:
        for g in ("Female", "Male"):
            sel = [r for r in dev_rows if r["Gender"] == g]
            if sel:
                print(f"dev macro-F1 ({g}) = "
                      f"{f1_score(_column(sel, 'EmoClass'), _column(sel, 'Prediction'), average='macro'):.4f}")
    return macro


def test_main(argv=None) -> str:
    """The fold models' mean probabilities over the test rows -> the path of
    the submission CSV written."""
    args = _parser(False).parse_args(argv)
    test_rows, feats = _load_experiment_frame(args.experiments, "test", "FileName")
    models = []
    for fold in range(args.k):
        with open(os.path.join(args.models_dir, f"rf_model_stackingv3_{fold}.pkl"), "rb") as f:
            models.append(pickle.load(f))
    proba = np.mean([m.predict_proba(_matrix(test_rows, feats)) for m in models], axis=0)
    out = [[r["FileName"], c] for r, c in zip(test_rows, models[0].classes_[np.argmax(proba, axis=1)])]
    if args.baseline_csv:  # set_index("FileName").loc[order]: every row of each name, in the given order
        by_name: Dict[object, List[list]] = {}
        for row in out:
            by_name.setdefault(row[0], []).append(row)
        order = [r["FileName"] for r in _read_csv(args.baseline_csv)]
        missing = [n for n in order if n not in by_name]
        if missing:
            raise KeyError(f"{len(missing)} baseline file names have no test row, e.g. {missing[:3]}")
        out = [row for n in order for row in by_name[n]]
    with open(args.out, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([["FileName", "EmoClass"]] + out)
    print(f"wrote {args.out} ({len(out)} rows)")
    return args.out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    cmd = argv[0] if argv else "train"
    if cmd == "train":
        return train_main(argv[1:])
    if cmd == "test":
        return test_main(argv[1:])
    print("usage: stacking.py {train|test} ...")
    sys.exit(1)


if __name__ == "__main__":
    main()
