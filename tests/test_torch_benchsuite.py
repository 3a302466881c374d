"""The port's suite comparator (``interspeech_ser_tpu_torch/utils/benchsuite.py``)
against the JAX package's: every case of ``tests/test_benchsuite.py`` run
through both modules with equal outputs, the repo's suite artifacts, a
``load_suite`` round trip and random suites."""

import json
import os

import pytest
from hypothesis import given, settings, strategies as st

from interspeech_ser_tpu.utils import benchsuite as ref
from interspeech_ser_tpu_torch.utils import benchsuite as port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _suite(**metrics):
    return {"metrics": metrics}


# each case builds its inputs through a module, runs it and checks the JAX test's claims
def band_from_samples(bs):
    m = bs.metric_entry(297.4, "utt/s", [290.1, 297.4, 294.0])
    assert m["value"] == 297.4 and m["lo"] == 290.1 and m["hi"] == 297.4 and m["higher_is_better"]
    return m


def lower_is_better(bs):
    m = bs.metric_entry(25.99, "ms/step", [25.99, 26.4], higher_is_better=False)
    assert not m["higher_is_better"]
    return m


def within_band_is_quiet(bs):
    out = bs.compare_suites(_suite(x=bs.metric_entry(100.0, "u/s", [98.0, 100.0])),
                            _suite(x=bs.metric_entry(98.5, "u/s", [97.0, 98.5])))
    assert out[0] == [] and len(out[1]) == 1
    return out


def throughput_drop_fails(bs):
    out = bs.compare_suites(_suite(x=bs.metric_entry(100.0, "u/s", [99.5, 100.0])),
                            _suite(x=bs.metric_entry(85.0, "u/s", [84.0, 85.0])))
    assert len(out[0]) == 1 and "x:" in out[0][0]
    return out


def latency_rise_fails_lower_is_better(bs):
    out = bs.compare_suites(_suite(t=bs.metric_entry(26.0, "ms/step", [26.0, 26.2], higher_is_better=False)),
                            _suite(t=bs.metric_entry(30.0, "ms/step", [30.0, 30.1], higher_is_better=False)))
    assert len(out[0]) == 1
    return out


def latency_drop_is_improvement(bs):
    out = bs.compare_suites(_suite(t=bs.metric_entry(30.0, "ms/step", higher_is_better=False)),
                            _suite(t=bs.metric_entry(26.0, "ms/step", higher_is_better=False)))
    assert out[0] == []
    return out


def wide_band_raises_tolerance(bs):
    out = bs.compare_suites(_suite(x=bs.metric_entry(100.0, "u/s", [90.0, 100.0])),
                            _suite(x=bs.metric_entry(92.0, "u/s", [91.5, 92.0])))
    assert out[0] == []
    return out


def added_and_dropped_metrics_are_notes(bs):
    out = bs.compare_suites(_suite(a=bs.metric_entry(1.0, "x"), b=bs.metric_entry(2.0, "x")),
                            _suite(b=bs.metric_entry(2.0, "x"), c=bs.metric_entry(3.0, "x")))
    assert out[0] == [] and any("DROPPED" in n for n in out[1]) and any("NEW metric c" in n for n in out[1])
    return out


def improvement_is_note_not_regression(bs):
    out = bs.compare_suites(_suite(x=bs.metric_entry(100.0, "u/s")), _suite(x=bs.metric_entry(120.0, "u/s")))
    assert out[0] == [] and "+20.0%" in out[1][0]
    return out


def format_table_contains_all_metrics(bs):
    t = bs.format_table(_suite(a=bs.metric_entry(1.5, "u/s", [1.4, 1.5], config="B=8"),
                               b=bs.metric_entry(2.0, "ms", higher_is_better=False)))
    assert "| a |" in t and "| b |" in t and "1.4-1.5" in t and "B=8" in t
    return t


CASES = [band_from_samples, lower_is_better, within_band_is_quiet, throughput_drop_fails,
         latency_rise_fails_lower_is_better, latency_drop_is_improvement, wide_band_raises_tolerance,
         added_and_dropped_metrics_are_notes, improvement_is_note_not_regression, format_table_contains_all_metrics]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_equals_jax(case):
    assert case(port) == case(ref)


def test_min_tolerance_equals_jax():
    assert port.MIN_TOLERANCE == ref.MIN_TOLERANCE


@pytest.mark.parametrize("old,new", [("r04", "r05"), ("r05", "r04")])
def test_repo_suites_equal_jax(old, new):
    a, b = (port.load_suite(os.path.join(ROOT, f"BENCH_SUITE_{r}.json")) for r in (old, new))
    assert len(a["metrics"]) == len(b["metrics"]) == 9
    assert port.compare_suites(a, b) == ref.compare_suites(a, b)
    assert port.format_table(b) == ref.format_table(b)


def test_load_suite_round_trip(tmp_path):
    suite = {"device": "card", "metrics": {"m": port.metric_entry(12.345, "ms", [12.3, 12.5], False, "B=4")}}
    path = tmp_path / "suite.json"
    path.write_text(json.dumps(suite))
    assert port.load_suite(str(path)) == ref.load_suite(str(path)) == suite


_metric = st.builds(
    lambda v, lo, hi, hib: {"value": v, "unit": "u", "lo": min(lo, hi), "hi": max(lo, hi), "higher_is_better": hib,
                            "config": ""},
    st.floats(-1e4, 1e4), st.floats(-1e4, 1e4), st.floats(-1e4, 1e4), st.booleans())
_suites = st.dictionaries(st.sampled_from("abcdef"), _metric, max_size=6).map(lambda m: {"metrics": m})


@settings(max_examples=50, deadline=None)
@given(_suites, _suites)
def test_random_suites_equal_jax(old, new):
    assert port.compare_suites(old, new) == ref.compare_suites(old, new)
    assert port.format_table(new) == ref.format_table(new)
