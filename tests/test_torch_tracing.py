"""The port's tracer (`utils/profiling.py`) and its spans and counters at
the eigensolver's and the training job's call sites, on the CPU.

Tracing is off without a profiler: `span` hands out one shared no-op and
nothing is recorded, counted, or made (no CUDA event, no profiler range).
Under a profiler, spans nest and carry host times on `time.time_ns()`'s
clock, a LOBPCG iteration counts its three eigensolves and its host syncs
by site, a training job its preparation, chunks and finish; the results
are the bits of the untraced run.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.solvers import lobpcg, train_joint
from eigenpinns_torch.solvers.lobpcg import _CHECK_EVERY
from eigenpinns_torch.sparse import BSRTile, Diagonal, spmm, spmm_gram
from eigenpinns_torch.utils import profiling
from eigenpinns_torch.utils.fixtures import make_cloud

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

TRAIN = dict(n_modes=5, hidden=(16, 16), epochs=6, scan_chunk=2,
             w_res=1.0, w_orth=10.0, w_trace=0.05, lr_start=1e-2,
             lr_end=1e-3, seed=0)


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


@pytest.fixture(scope="module")
def cloud():
    """A 642-point cloud's strip-BSR K (a format with a hand kernel, run
    by its plain version here), lumped M, RCM-ordered X and a start."""
    X = make_cloud(642, seed=1)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    K, perm = BSRTile.from_scipy(L, device="cpu")
    m = np.asarray(M.diagonal())[perm]
    X0 = torch.randn((642, 6), generator=torch.Generator().manual_seed(3))
    return {"K": K, "M": Diagonal(torch.as_tensor(m, dtype=torch.float32)),
            "X": X[perm], "X0": X0}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def names(recs) -> list:
    return [r["name"] for r in recs]


# ---- off --------------------------------------------------------------------

def test_off_span_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    spans = [profiling.span(n) for n in ("a", "lobpcg.eigh", "sparse.spmm")]
    assert all(s is spans[0] for s in spans)
    with spans[0] as inner:
        assert inner is spans[0]
        with profiling.span("b"):
            profiling.count("sync.eigh", 3)
    assert profiling.records() == [] and profiling.counters() == {}


def test_off_path_makes_no_event_and_enters_no_range(cloud, monkeypatch):
    """With CUDA reported initialised, an entered span would make CUDA
    events; off, a whole polish makes none and opens no range."""
    def refuse(*args, **kwargs):
        raise AssertionError("the off path made an event or a range")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch._C, "_CudaEventBase", refuse, raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    res = lobpcg(cloud["K"], cloud["M"], cloud["X0"], max_iter=12, tol=0.0)
    assert int(res.iterations) == 12
    assert profiling.records() == [] and profiling.counters() == {}


# ---- on -------------------------------------------------------------------

def test_nested_spans_record_parents_and_host_times():
    lo = time.time_ns()
    with cpu_profile():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
            with profiling.span("inner2"):
                with profiling.span("leaf"):
                    pass
    hi = time.time_ns()
    recs = {r["name"]: r for r in profiling.records()}
    assert names(profiling.records()) == ["inner", "leaf", "inner2", "outer"]
    assert recs["outer"]["parent"] is None
    assert recs["inner"]["parent"] == recs["inner2"]["parent"] == "outer"
    assert recs["leaf"]["parent"] == "inner2"
    for r in recs.values():
        assert lo <= r["start_ns"] <= r["end_ns"] <= hi
        assert r["device_ms"] is None          # no CUDA here
    o, i = recs["outer"], recs["inner"]
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= o["end_ns"]


def test_counters_and_reset():
    with cpu_profile():
        profiling.count("sync.eigh")
        profiling.count("sync.eigh", 2)
        profiling.count("sync.select")
        with profiling.span("a"):
            pass
    profiling.count("sync.eigh")               # off again: not counted
    assert profiling.counters() == {"sync.eigh": 3, "sync.select": 1}
    assert names(profiling.records()) == ["a"]
    profiling.reset()
    assert profiling.records() == [] and profiling.counters() == {}


def test_ranges_only_inside_trace(tmp_path):
    """Inside the tracer's own `trace()` a span is a range of the Chrome
    trace it writes; under another profiler it opens none."""
    with cpu_profile() as prof:
        with profiling.span("outside.trace"):
            torch.ones(3).sum()
    assert "outside.trace" not in {e.name for e in prof.events()}
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("inside.trace"):
            torch.ones(3).sum()
    assert "inside.trace" in {e.name for e in prof.events()}
    (path,) = tmp_path.iterdir()
    with open(path) as fh:
        assert "inside.trace" in {e.get("name") for e in
                                  json.load(fh)["traceEvents"]}
    assert names(profiling.records()) == ["outside.trace", "inside.trace"]


def test_hand_format_products_are_spans(cloud):
    U = torch.randn((642, 4), generator=torch.Generator().manual_seed(0))
    with cpu_profile():
        spmm(cloud["K"], U)
        spmm_gram(cloud["K"], U)
        spmm(cloud["M"], U)                    # Diagonal: no hand kernel
    assert names(profiling.records()) == ["sparse.spmm", "sparse.spmm"]


# ---- the eigensolver -------------------------------------------------------

@pytest.mark.parametrize("iters", [12, 25])
def test_lobpcg_spans_and_syncs_per_iteration(cloud, iters):
    """Every loop iteration: 3 eigensolves (the Rayleigh-Ritz step's and
    two whitenings'; on the CPU each on `torch.linalg.eigh`, a counted
    sync), 9 Grams, K X and K S, the good Ritz vectors' masked sum (its
    site counted with 0 syncs); the stop check every `_CHECK_EVERY`. Each
    run also whitens its start (one Gram, one eigensolve) and closes with
    K X."""
    with cpu_profile():
        res = lobpcg(cloud["K"], cloud["M"], cloud["X0"], max_iter=iters,
                     tol=0.0)
    assert int(res.iterations) == iters
    recs = profiling.records()
    n = {name: names(recs).count(name) for name in set(names(recs))}
    assert n == {"lobpcg": 1, "lobpcg.eigh": 3 * iters + 1,
                 "lobpcg.gram": 9 * iters + 1,
                 "sparse.spmm": 2 * iters + 1}
    assert profiling.counters() == {"sync.eigh": 3 * iters + 1,
                                    "sync.select": 0,
                                    "sync.stop_check": iters // _CHECK_EVERY}
    assert {r["parent"] for r in recs if r["name"] != "lobpcg"} == {"lobpcg"}


def test_lobpcg_traced_is_bit_identical(cloud):
    args = (cloud["K"], cloud["M"], cloud["X0"])
    off = lobpcg(*args, max_iter=25, tol=1e-6)
    with cpu_profile():
        on = lobpcg(*args, max_iter=25, tol=1e-6)
    assert profiling.records()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


# ---- the training job -------------------------------------------------------

def test_train_joint_spans(cloud):
    with cpu_profile():
        res = train_joint(cloud["K"], cloud["M"], cloud["X"], **TRAIN)
    recs = profiling.records()
    top = [r for r in recs if r["parent"] is None]
    chunks = TRAIN["epochs"] // TRAIN["scan_chunk"]
    assert names(top) == ["train.prepare"] + ["train.chunk"] * chunks + [
        "train.finish"]
    assert len(res.chunk_times) == chunks
    # The phases follow one another on the host's clock.
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(top, top[1:]))
    # The loss's product each step, the finish's products, Grams and
    # eigensolves inside their phases.
    by_parent = {r["name"]: r["parent"] for r in recs}
    assert by_parent["sparse.spmm"] in {"train.chunk", "train.finish"}
    assert by_parent["lobpcg.eigh"] == "train.finish"


def test_train_joint_traced_is_bit_identical(cloud):
    args = (cloud["K"], cloud["M"], cloud["X"])
    off = train_joint(*args, **TRAIN)
    with cpu_profile():
        on = train_joint(*args, **TRAIN)
    assert profiling.records()
    assert off.history.keys() == on.history.keys()
    for key in off.history:
        np.testing.assert_array_equal(off.history[key], on.history[key])
    np.testing.assert_array_equal(off.eigenvalues, on.eigenvalues)
    np.testing.assert_array_equal(off.eigenvectors, on.eigenvectors)
