"""The one generator's length grid: the published range and mean, the same set for every seed."""

import json

import pytest

from portbench import corpus
from portbench.bench import ROOT


@pytest.mark.parametrize("mean", [3.5, 5.648, 6.875, 9.0])
def test_grid_has_the_traffic_mean_and_range(mean):
    grid = corpus.length_grid(512, [2.75, 11.0], mean)
    assert sum(grid) / len(grid) / corpus.SR == pytest.approx(mean, abs=2e-3)
    assert 2.75 * corpus.SR <= min(grid) and max(grid) <= 11.0 * corpus.SR
    assert grid == sorted(grid)


def test_a_mean_below_the_midpoint_skews_to_short_segments():
    grid = corpus.length_grid(512, [2.75, 11.0], 5.648)
    median = grid[len(grid) // 2] / corpus.SR
    assert median < 5.648 and sum(g < 6.875 * corpus.SR for g in grid) > 0.6 * len(grid)


def test_without_a_mean_lengths_spread_evenly():
    assert corpus.length_grid(4, [1.0, 2.0]) == [18000, 22000, 26000, 30000]


@pytest.mark.parametrize("traffic", ["wavlm_f32_512wavs", "whisper_f32_256wavs", "fusion_f32_512rows"])
def test_every_seed_gets_the_same_lengths(traffic):
    c = json.loads((ROOT / "portbench/traffic" / f"{traffic}.json").read_text())["corpus"]
    a = corpus.seeded_lengths(c["utterances"], c, 2 ** 31 + 5)
    b = corpus.seeded_lengths(c["utterances"], c, 2 ** 33 + 1)
    assert a != b and sorted(a) == sorted(b) == corpus.length_grid(c["utterances"], c["seconds"], c["mean_s"])
