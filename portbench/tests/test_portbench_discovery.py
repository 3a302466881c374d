"""A new traffic mix, configuration or metric is files and entries, found by name."""

import json

import pytest

from portbench import bench

from .tiny import run


def test_new_workload_config_and_metric(tiny_root, tmp_path):
    root = tmp_path
    (root / "portbench").mkdir()
    for d in ("configs", "traffic", "limits", "metrics"):
        src, dst = tiny_root / "portbench" / d, root / "portbench" / d
        dst.mkdir()
        for f in src.iterdir():
            (dst / f.name).write_bytes(f.read_bytes())
    b = json.loads((tiny_root / "BENCHMARK.json").read_text())
    pb = root / "portbench"
    # a new configuration, a new traffic mix, a new cell's limits and a new metric: new files only
    cfg = json.loads((pb / "configs/tiny_wavlm.json").read_text())
    (pb / "configs/tiny_wavlm_3l.json").write_text(json.dumps(dict(cfg, num_hidden_layers=3)))
    traffic = json.loads((pb / "traffic/tiny_wavs.json").read_text())
    (pb / "traffic/tiny_wavs_short.json").write_text(json.dumps(dict(traffic, corpus={"utterances": 4,
                                                                                          "seconds": [0.4, 0.8]})))
    (pb / "limits/tiny_wavlm_3l.short.json").write_text((pb / "limits/tiny_wavlm.extract.json").read_text())
    (pb / "metrics/window_steps.extract.py").write_text("def read(ctx):\n    return float(ctx.window['items'])\n")
    b["configs"].append({"name": "tiny_wavlm_3l", "source": "test", "file": "portbench/configs/tiny_wavlm_3l.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny_wavlm_3l.short", "config": "tiny_wavlm_3l", "traffic": "tiny_wavs_short",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if "extract_utt_per_s" == m["name"]:
            m["workloads"].append("tiny_wavlm_3l.short")
    b["per_layer"].append({"name": "window_steps.extract", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "host I/O", "moves": "extract_utt_per_s",
                           "workloads": ["tiny_wavlm_3l.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = bench.load_cell("tiny_wavlm_3l.short", root)
    assert cell.config["num_hidden_layers"] == 3 and cell.traffic["corpus"]["utterances"] == 4
    assert [m["name"] for m in cell.per_layer] == ["window_steps.extract"]
    result = run(root, "tiny_wavlm_3l.short", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["window_steps.extract"]["value"] >= 1
    assert set(result["metrics"]) == {"window_steps.extract"}  # the trace's readers find no trace on the CPU


def test_a_metric_that_reads_nothing_on_the_card_gives_no_result(tiny_root):
    """Off the card a trace's metric is left out; on the card the run fails."""
    cell = bench.load_cell("tiny_wavlm.extract", tiny_root)
    some = {cell.per_layer[0]["name"]: {"value": 1.0, "unit": cell.per_layer[0]["unit"]}}
    bench.require_read(cell, some, on_card=False)
    bench.require_read(cell, {m["name"]: {} for m in cell.per_layer}, on_card=True)
    with pytest.raises(bench.MetricUnread, match=cell.per_layer[1]["name"]):
        bench.require_read(cell, some, on_card=True)
