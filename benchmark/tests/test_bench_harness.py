"""The harness end to end on the CPU at a tiny size, on the port's plain
versions: every cell's run and its result line, files that a later change
adds found by name, the modules a run loads, and faults planted in the
timed path, each of which the correctness check must catch."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO, add_cell, tiny_copy

import control
import harness
import inputs

CELLS = ["direct1m_bsr.train", "direct1m_bsr.solve",
         "direct300k_rolling.train"]
# Limits for the tiny cells (3000 points; on the CPU): the sound runs
# here read under a fifth of each, the planted faults far above.
TINY_LIMITS = {
    "train": {"loss_gap": 5e-3, "res_gap": 40.0, "lam_gap": 0.5,
              "grad_gap": 2e-2, "change_gap": 0.1},
    "polish": {"resid": 5e-3, "orth": 5e-3, "eig_gap": 1e-3},
}
SEED = 2**31 + 17


def cell_limits() -> dict:
    return {c: TINY_LIMITS["polish" if c.endswith("solve") else "train"]
            for c in CELLS}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")), cell_limits())


def run(root, cell, plant=None, trace=False, seed=SEED):
    return harness.run_cell(cell, seed, 0.0, trace, root=root,
                            device="cpu", plant=plant, port_root=REPO)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(tiny, cell):
    result = run(tiny, cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    want = {"setup_s",
            "solve_s" if cell.endswith("solve") else "train_steps_per_s"}
    assert set(result["metrics"]) == want      # no peak without a card
    for m in result["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert set(result["checks"]) == set(cell_limits()[cell])
    json.loads(json.dumps(result))


def test_traced_run_reports_per_layer_metrics(tiny):
    result = run(tiny, "direct1m_bsr.train", trace=True)
    # On the CPU there is no device trace: only the host's readings.
    assert set(result["metrics"]) == {"operator_build_s", "train_step_mfu"}
    assert "breakdown" not in result


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "direct1m_bsr.train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_without_the_port_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder only."""
    root = tiny_copy(str(tmp_path))
    proc = subprocess.run(
        [sys.executable, os.path.join(root, "benchmark", "run.py"),
         "--workload", "direct1m_bsr.train", "--seed", "3", "--seconds",
         "1", "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


# A surface and a job that a later change could add as files.
FIB_SPHERE = """
import numpy as np
from scipy.spatial import ConvexHull

import inputs

KEYS = ("n_points",)


def make(cfg):
    n = cfg["n_points"]
    i = np.arange(n) + 0.5
    phi, theta = np.arccos(1 - 2 * i / n), np.pi * (1 + 5 ** 0.5) * i
    X = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                  np.cos(phi)], 1)
    K, m = inputs.cotangent_operators(X, ConvexHull(X).simplices)
    return X, K, m
"""
SHORT_TRAIN = """
import os

import harness

TRAIN = harness.load_jobs("train", os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
readings = TRAIN.readings


class Jobs(TRAIN.Jobs):
    def __init__(self, cfg, *args):
        super().__init__({**cfg, "train": {**cfg["train"], "epochs": 4}},
                         *args)
"""


def test_files_added_later_are_found_by_name(tmp_path):
    """A configuration on a new surface, a mix of a new job, its cell and
    a metric, added as files and entries only."""
    root = tiny_copy(str(tmp_path), cell_limits())
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "direct300k_rolling.json")) as fh:
        cfg = json.load(fh)
    cfg.update(n_points=2000, surface="fib_sphere")
    files = {
        "surfaces/fib_sphere.py": FIB_SPHERE,
        "jobs/short_train.py": SHORT_TRAIN,
        "configs/sphere_rolling.json": json.dumps(cfg),
        "traffic/short_jobs.json": json.dumps(
            {"job": "short_train", "loop": "closed", "clients": 1}),
        "limits/sphere_rolling.short_jobs.json": json.dumps(
            TINY_LIMITS["train"]),
        "metrics/steps_seen.py":
            "def read(ctx):\n    return float(ctx['work']['steps'])\n",
    }
    for name, text in files.items():
        with open(os.path.join(b, name), "w") as fh:
            fh.write(text)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    add_cell(bench, {"name": "sphere_rolling", "source": "test",
                     "file": "benchmark/configs/sphere_rolling.json",
                     "reduced": ["n_points"], "why": "test"},
             {"name": "sphere_rolling.short_jobs", "config": "sphere_rolling",
              "traffic": "short_jobs", "chips": 1, "why": "test"},
             "direct1m_bsr.train")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "training step",
                               "moves": "train_steps_per_s",
                               "workloads": ["sphere_rolling.short_jobs"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    result = run(root, "sphere_rolling.short_jobs", trace=True)
    assert result["correct"] is True
    assert result["metrics"]["steps_seen"]["value"] == \
        result["attempted"] * 4
    assert os.listdir(os.path.join(root, "build", "bench_inputs"))[0] \
        .startswith("fib_sphere-2000-")


def test_no_forbidden_module_after_a_run(tiny):
    run(tiny, "direct300k_rolling.train")
    assert harness.forbidden_modules() == []


def imported(path: str) -> set:
    """The top-level names of the modules a source file imports."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    return mods


def test_no_source_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                assert not imported(path) & set(harness.FORBIDDEN), path


def test_reference_imports_nothing_of_the_port():
    for name in ("reference.py", "inputs.py", "yardstick.py"):
        assert not imported(os.path.join(BENCH, name)) & {
            "eigenpinns_torch", "harness", "control"}, name
    code = ("import sys; sys.path.insert(0, %r); import reference; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'eigenpinns_torch', 'jax', 'eigenpinns_tpu'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]"


# ---- faults planted in the timed path -----------------------------------

def frozen_adam(mp):
    def plant(port):
        from eigenpinns_torch.train import optim

        mp.setattr(optim.Adam, "step", lambda self: None)
    return plant


def half_batch_loss(mp):
    """The loss over the first half of the rows, the mean taken over them."""
    def plant(port):
        from eigenpinns_torch.solvers import direct
        from eigenpinns_torch.sparse.ops import spmm

        def half(U, K, M, eps=1e-12):
            h = U.shape[0] // 2
            Ku, Mu, Uh = spmm(K, U)[:h], spmm(M, U)[:h], U[:h]
            Gk, Gm = Uh.T @ Ku, Uh.T @ Mu
            lam = torch.diagonal(Gk) / (torch.diagonal(Gm) + eps)
            k = U.shape[1]
            orth = ((Gm - torch.eye(k)) ** 2).sum() / k
            return lam, ((Ku - Mu * lam) ** 2).mean(), orth

        mp.setattr(direct, "rayleigh_residual_orth", half)
    return plant


def zeroed_mode(mp):
    """The network's first output column set to zero where it is made."""
    def plant(port):
        from eigenpinns_torch.models.eigennet import JointEigenNet

        forward = JointEigenNet.forward

        def broken(self, x):
            U = forward(self, x)
            return torch.cat([torch.zeros_like(U[:, :1]), U[:, 1:]], 1)

        mp.setattr(JointEigenNet, "forward", broken)
    return plant


def unpolished(mp):
    """The polish returns its start, orthonormalized, without iterating."""
    def plant(port):
        import eigenpinns_torch.solvers as solvers

        lobpcg = solvers.lobpcg
        mp.setattr(solvers, "lobpcg",
                   lambda K, M, X0, **kw: lobpcg(K, M, X0, max_iter=0))
    return plant


def half_batch_polish(mp):
    """K X with the second half of its rows left out."""
    def plant(port):
        import importlib

        from eigenpinns_torch.sparse import Diagonal

        # The package's `lobpcg` is the function; its module by name.
        module = importlib.import_module("eigenpinns_torch.solvers.lobpcg")

        spmm = module.spmm

        def broken(A, U):
            W = spmm(A, U)
            if not isinstance(A, Diagonal):
                W = W.clone()
                W[W.shape[0] // 2:] = 0
            return W

        mp.setattr(module, "spmm", broken)
    return plant


def altered_eigenvalue(mp):
    """One returned eigenvalue altered by a part in a hundred."""
    def plant(port):
        import eigenpinns_torch.solvers as solvers

        lobpcg = solvers.lobpcg

        def broken(*args, **kw):
            res = lobpcg(*args, **kw)
            lam = res.eigenvalues.clone()
            lam[1:] *= 1.01
            return res._replace(eigenvalues=lam)

        mp.setattr(solvers, "lobpcg", broken)
    return plant


def lowest_mode_dropped(mp):
    """The polish returns its pairs without the lowest one: every pair it
    returns is an eigenpair, but not of the lowest modes."""
    def plant(port):
        import eigenpinns_torch.solvers as solvers

        lobpcg = solvers.lobpcg

        def broken(*args, **kw):
            res = lobpcg(*args, **kw)
            low = int(res.eigenvalues.argmin())
            keep = [i for i in range(res.eigenvalues.shape[0]) if i != low]
            return res._replace(eigenvalues=res.eigenvalues[keep],
                                eigenvectors=res.eigenvectors[:, keep])

        mp.setattr(solvers, "lobpcg", broken)
    return plant


@pytest.mark.parametrize("cell, fault", [
    ("direct1m_bsr.train", frozen_adam),
    ("direct1m_bsr.train", half_batch_loss),
    ("direct1m_bsr.train", zeroed_mode),
    ("direct300k_rolling.train", frozen_adam),
    ("direct300k_rolling.train", half_batch_loss),
    ("direct300k_rolling.train", zeroed_mode),
    ("direct1m_bsr.solve", unpolished),
    ("direct1m_bsr.solve", half_batch_polish),
    ("direct1m_bsr.solve", altered_eigenvalue),
    ("direct1m_bsr.solve", lowest_mode_dropped),
])
def test_planted_fault_is_not_correct(tiny, cell, fault, monkeypatch):
    result = run(tiny, cell, plant=fault(monkeypatch))
    assert result["correct"] is False
    assert result["failed"] >= 1


def test_only_the_eigenvalues_catch_a_dropped_mode(tiny, monkeypatch):
    checks = run(tiny, "direct1m_bsr.solve",
                 plant=lowest_mode_dropped(monkeypatch))["checks"]
    assert {k for k, c in checks.items() if c["value"] > c["limit"]} == \
        {"eig_gap"}


# ---- the control ----------------------------------------------------------

def test_fp8_control_is_not_correct(tiny):
    """The reference in float8 in the program's place reads over a limit
    on every seed; the program's own readings stay under them."""
    spec = harness.load_cell(tiny, "direct1m_bsr.train")
    readings = harness.load_jobs("train", spec["bench_dir"]).readings
    for seed in (3, 4, SEED):
        inp = inputs.load({**spec["config"], "cloud_seed": seed}, None)
        out = readings(spec, seed, inp, torch.device("cpu"), REPO, True)
        lim = spec["limits"]
        assert all(out["program"][k] <= v for k, v in lim.items())
        assert any(out["fp8"][k] > v for k, v in lim.items())
        for fault in ("half_rows", "zeroed_mode", "frozen"):
            assert any(out[fault][k] > v for k, v in lim.items()), fault
        assert set(out["bf16_witness"]) == set(lim)


def test_polish_readings_catch_a_dropped_mode(tiny):
    spec = harness.load_cell(tiny, "direct1m_bsr.solve")
    readings = harness.load_jobs("polish", spec["bench_dir"]).readings
    inp = harness.config_inputs(spec["config"], tiny)
    out = readings(spec, SEED, inp, torch.device("cpu"), REPO, True)
    lim = spec["limits"]
    assert all(out["program"][k] <= v for k, v in lim.items())
    assert out["lowest_dropped"]["eig_gap"] > 100 * lim["eig_gap"]
    assert out["lowest_dropped"]["resid"] <= 2 * out["program"]["resid"]


def test_summary_takes_the_worst_of_each_side():
    rows = [{"readings": {"program": {"a": 1.0}, "fp8": {"a": 9.0}}},
            {"readings": {"program": {"a": 2.0}, "fp8": {"a": 7.0}}}]
    assert control.summary(rows) == {"a": {"program": 2.0, "fp8": 7.0}}


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_tf32_control_is_not_correct_on_card(card):
    """The port's polish with TF32 on reads over the solve cell's limits at
    the cell's own size, on three seeds; its TF32-off runs stay under
    them."""
    spec = harness.load_cell(REPO, "direct1m_bsr.solve")
    readings = harness.load_jobs("polish", spec["bench_dir"]).readings
    inp = harness.config_inputs(spec["config"], REPO)
    for seed in (5, 6, SEED):
        out = readings(spec, seed, inp, card, REPO, True)
        lim = spec["limits"]
        assert all(out["program"][k] <= v for k, v in lim.items())
        assert any(out["tf32"][k] > v for k, v in lim.items())
        assert out["lowest_dropped"]["eig_gap"] > lim["eig_gap"]
        harness.free(card)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(card, tmp_path, cell):
    root = tiny_copy(str(tmp_path), cell_limits())
    result = harness.run_cell(cell, SEED, 0.0, True, root=root,
                              device="cuda", port_root=REPO)
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()
