"""Shared set-up of the benchmark's tests: the benchmark's modules and the
checkout's root on the path, tiny copies of the benchmark, and the card
fixture."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
for path in (BENCH, REPO):
    if path not in sys.path:
        sys.path.insert(0, path)

# The cells at a size a CPU test holds: points, epochs and chunk of the
# training, iterations of the polish.
TINY = {"n_points": 3000, "epochs": 8, "scan_chunk": 4, "max_iter": 300}

# The rolling-band cell, whose files the benchmark keeps and whose entries
# BENCHMARK.json leaves out (its rate is paced by the host): the tiny
# copies add them, as a later change would, so that K1's route stays
# covered.
ROLLING_CONFIG = {"name": "direct300k_rolling", "source": "test",
                  "file": "benchmark/configs/direct300k_rolling.json",
                  "reduced": [], "why": "test"}
ROLLING_CELL = {"name": "direct300k_rolling.train",
                "config": "direct300k_rolling", "traffic": "train",
                "chips": 1, "why": "test"}


def add_cell(bench: dict, config: dict, cell: dict, like: str) -> dict:
    """`bench` with `config` and `cell` added, and `cell` in the
    `workloads` of every metric that lists the cell `like`."""
    if config["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append(config)
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell["name"])
    return bench


def tiny_copy(dest: str, limits: dict | None = None) -> str:
    """A copy of BENCHMARK.json (with the rolling-band cell) and the
    benchmark's folder under `dest`, every configuration cut to TINY, and
    `limits` ({cell: {number:
    limit}}) written over the cells' limits. Returns the copy's root."""
    root = os.path.join(dest, "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = add_cell(json.load(fh), ROLLING_CONFIG, ROLLING_CELL,
                         "direct1m_bsr.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    configs = os.path.join(root, "benchmark", "configs")
    for name in os.listdir(configs):
        path = os.path.join(configs, name)
        with open(path) as fh:
            cfg = json.load(fh)
        cfg["n_points"] = TINY["n_points"]
        cfg["train"].update(epochs=TINY["epochs"],
                            scan_chunk=TINY["scan_chunk"])
        cfg["polish"]["max_iter"] = TINY["max_iter"]
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for cell, lim in (limits or {}).items():
        with open(os.path.join(root, "benchmark", "limits",
                               f"{cell}.json"), "w") as fh:
            json.dump(lim, fh)
    return root


@pytest.fixture
def card():
    """The CUDA device; skips the test on a machine without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")
