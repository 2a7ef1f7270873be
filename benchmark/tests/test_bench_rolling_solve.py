"""The rolling-band polish cell, `direct300k_rolling.solve`: its entries
in `BENCHMARK.json`, the cell end to end on the CPU at a tiny size
(`conftest.tiny_copy`: 3000 points, 300 iterations) on the port's plain
versions, and a polish that drops its lowest pair refused in the timed
path. On the card: the tiny cell's traced run reads every metric listed
for it, and at the cell's own size the port's polish with TF32 on, and
its pairs without the lowest, read over the cell's limits."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, tiny_copy
from test_bench_harness import lowest_mode_dropped

import harness

CELL = "direct300k_rolling.solve"
LIKE = "direct1m_bsr.solve"
# Limits for the tiny cell (3000 points; on the CPU), those of the
# harness's tests for the 1M polish: the sound runs read under a quarter
# of each (resid 0.46e-3 to 1.2e-3, orth 0.16e-3 to 0.84e-3, eig_gap
# 0.6e-6 to 2.8e-5 over eight seeds), the planted fault far above.
TINY_LIMITS = {"resid": 5e-3, "orth": 5e-3, "eig_gap": 1e-3}
SEED = 2**31 + 41


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")),
                     {CELL: TINY_LIMITS})


def run(root, plant=None, trace=False, device="cpu"):
    return harness.run_cell(CELL, SEED, 0.0, trace, root=root,
                            device=device, plant=plant, port_root=REPO)


def listed_metrics(root: str, kind: str) -> dict:
    """{name: entry} of the metrics of `kind` that `root`'s
    BENCHMARK.json lists for the cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    return {m["name"]: m for m in bench[kind]
            if CELL in m.get("workloads", [CELL])}


def test_cell_is_in_the_benchmark():
    """The configuration, the one-chip cell on the `solve` mix and its
    limits are in the benchmark, and the cell reports what the 1M polish
    cell reports."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    config = next(c for c in bench["configs"]
                  if c["name"] == "direct300k_rolling")
    assert config["file"] == "benchmark/configs/direct300k_rolling.json"
    assert config["reduced"] == []
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == \
        ("direct300k_rolling", "solve", 1)
    with open(os.path.join(BENCH, "limits", f"{CELL}.json")) as fh:
        assert set(json.load(fh)) == set(TINY_LIMITS)
    for kind in ("end_to_end", "per_layer"):
        like = {m["name"] for m in bench[kind]
                if LIKE in m.get("workloads", [])}
        assert like and like <= set(listed_metrics(REPO, kind)), kind


def test_rolling_polish_runs_and_is_correct(tiny):
    result = run(tiny)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "solve_s"}
    assert set(result["checks"]) == set(TINY_LIMITS)


def test_dropped_lowest_pair_is_refused(tiny, monkeypatch):
    result = run(tiny, plant=lowest_mode_dropped(monkeypatch))
    assert result["correct"] is False and result["failed"] >= 1
    over = {k for k, c in result["checks"].items()
            if c["value"] > c["limit"]}
    assert over == {"eig_gap"}


@pytest.mark.cuda
def test_traced_cell_reads_every_listed_metric_on_card(card, tmp_path):
    from eigenpinns_torch.utils import profiling

    # The tracer keeps its records until reset, and a run reads them all:
    # spans an earlier test closed on the CPU carry no device time.
    profiling.reset()
    root = tiny_copy(str(tmp_path), {CELL: TINY_LIMITS})
    result = run(root, trace=True, device="cuda")
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == set(listed_metrics(root, "per_layer"))
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_card(card):
    """At the cell's own size and limits, on three seeds: the port's
    polish stays under every limit, with TF32 on it reads over at least
    one, and its pairs without the lowest read over `eig_gap`."""
    spec = harness.load_cell(REPO, CELL)
    readings = harness.load_jobs("polish", spec["bench_dir"]).readings
    inp = harness.config_inputs(spec["config"], REPO)
    lim = spec["limits"]
    for seed in (5, 6, SEED):
        out = readings(spec, seed, inp, card, REPO, True)
        assert all(out["program"][k] <= v for k, v in lim.items())
        assert any(out["tf32"][k] > v for k, v in lim.items())
        assert out["lowest_dropped"]["eig_gap"] > lim["eig_gap"]
        harness.free(card)
