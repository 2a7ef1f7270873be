"""The readers of the port's own spans and counters (`program_spans.py`,
`metrics/solve_*_ms_per_iter.py`, `solve_*_syncs_per_iter.py`,
`train_job_overhead_ms.py`): each against hand arithmetic on canned
tracer records, each reading nothing where nothing was recorded, and the
cells' traced runs on the CPU, where no profiler runs, reading none of
them and raising nothing."""

import types

import pytest

from conftest import BENCH, REPO, tiny_copy

import harness
import program_spans

SOLVE = {"spmm": "solve_spmm_ms_per_iter", "gram": "solve_gram_ms_per_iter",
         "eigh": "solve_eigh_ms_per_iter",
         "rest": "solve_lobpcg_rest_ms_per_iter",
         "eigh_syncs": "solve_eigh_syncs_per_iter",
         "select_syncs": "solve_select_syncs_per_iter",
         "stop_check_syncs": "solve_stop_check_syncs_per_iter"}
NEW = set(SOLVE.values()) | {"train_job_overhead_ms"}
# Limits for the tiny cells (3000 points, the CPU), as the harness's
# tests set them.
TINY_LIMITS = {
    "direct1m_bsr.train": {"loss_gap": 5e-3, "res_gap": 40.0,
                           "lam_gap": 0.5, "grad_gap": 2e-2,
                           "change_gap": 0.1},
    "direct1m_bsr.solve": {"resid": 5e-3, "orth": 5e-3, "eig_gap": 1e-3},
}


def reader(name):
    return harness.load_reader(BENCH, name)


def span(name, ms, parent=None):
    return {"name": name, "parent": parent, "start_ns": 0, "end_ns": 1,
            "device_ms": ms}


def canned(monkeypatch, records, counters):
    """The port's tracer replaced by one holding `records`, `counters`."""
    fake = types.SimpleNamespace(records=lambda: list(records),
                                 counters=lambda: dict(counters))
    monkeypatch.setattr(program_spans, "tracer", lambda: fake)


POLISH = [span("lobpcg", 100.0), span("lobpcg.gram", 1.5, "lobpcg"),
          span("lobpcg.gram", 2.5, "lobpcg"),
          span("lobpcg.eigh", 3.0, "lobpcg"),
          span("lobpcg.eigh", 4.0, "lobpcg"),
          span("sparse.spmm", 0.25, "lobpcg"),
          span("sparse.spmm", 0.75, "lobpcg"),
          span("sparse.spmm", 0.5, "lobpcg"),
          # A product inside a Gram (a fused product-and-Gram) is part of
          # the Gram's time, not the iteration's rest.
          span("sparse.spmm", 0.125, "lobpcg.gram"),
          # A run's closing product after the eigensolver.
          span("sparse.spmm", 0.0625)]
POLISH_SYNCS = {"sync.eigh": 25, "sync.select": 8, "sync.stop_check": 1,
                "other": 1000}
TRAIN = [span("train.prepare", 40.0), span("train.chunk", 200.0),
         span("sparse.spmm", 1.0, "train.chunk"), span("train.finish", 20.0),
         span("train.prepare", 30.0), span("train.finish", 10.0)]


def polish_ctx(iterations=8):
    return {"job": "polish", "work": {"jobs": 2, "iterations": iterations}}


def train_ctx(jobs=2):
    return {"job": "train", "work": {"jobs": jobs, "steps": 300}}


@pytest.mark.parametrize("which,want", [
    ("spmm", (0.25 + 0.75 + 0.5 + 0.125 + 0.0625) / 8),
    ("gram", (1.5 + 2.5) / 8), ("eigh", (3.0 + 4.0) / 8),
    ("rest", (100.0 - 1.5 - 2.5 - 3.0 - 4.0 - 0.25 - 0.75 - 0.5) / 8),
    ("eigh_syncs", 25 / 8), ("select_syncs", 8 / 8),
    ("stop_check_syncs", 1 / 8)])
def test_polish_readers_on_canned_records(monkeypatch, which, want):
    canned(monkeypatch, POLISH, POLISH_SYNCS)
    assert reader(SOLVE[which])(polish_ctx()) == pytest.approx(want)
    # Another job's window reads nothing.
    assert reader(SOLVE[which])(train_ctx()) is None


def test_train_job_overhead_on_canned_records(monkeypatch):
    canned(monkeypatch, TRAIN, {})
    read = reader("train_job_overhead_ms")
    assert read(train_ctx()) == pytest.approx((40 + 20 + 30 + 10) / 2)
    assert read(polish_ctx()) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_nothing_recorded_reads_nothing(monkeypatch, name):
    ctx = train_ctx() if name.startswith("train") else polish_ctx()
    canned(monkeypatch, [], {})
    assert reader(name)(ctx) is None
    # Off CUDA a span has no device time: nothing to read either.
    canned(monkeypatch, [dict(r, device_ms=None) for r in POLISH + TRAIN],
           {} if name.endswith("syncs_per_iter") else POLISH_SYNCS)
    assert reader(name)(ctx) is None
    # A port without the tracer.
    monkeypatch.setattr(program_spans, "tracer", lambda: None)
    assert reader(name)(ctx) is None


def test_tracer_is_the_ports_and_absent_without_records(monkeypatch):
    from eigenpinns_torch.utils import profiling

    assert program_spans.tracer() is profiling
    monkeypatch.delattr(profiling, "records")
    assert program_spans.tracer() is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")), TINY_LIMITS)


@pytest.mark.parametrize("cell", sorted(TINY_LIMITS))
def test_traced_cpu_run_reads_no_program_metric(tiny, cell):
    from eigenpinns_torch.utils import profiling

    profiling.reset()
    result = harness.run_cell(cell, 2**31 + 29, 0.0, True, root=tiny,
                              device="cpu", port_root=REPO)
    assert result["correct"] is True
    assert not set(result["metrics"]) & NEW
    assert set(result["metrics"]) >= {"operator_build_s"}
