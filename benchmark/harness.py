"""Run one cell of the benchmark once and build its result line.

A cell `<config>.<mix>` of BENCHMARK.json names a configuration
(`configs/<config>.json`: its surface, `surfaces/<surface>.py`, the
operator's format, the published training and polish), a traffic mix
(`traffic/<mix>.json`: the job the closed loop runs, `jobs/<job>.py`)
and its correctness limits (`limits/<cell>.json`). Each metric is a
reader in `metrics/<name>.py`. Each of these is found by its name.

A run: the configuration's inputs (`inputs.py`: the surface, the same for
every seed; cached in the checkout; not timed); set-up, timed
as `setup_s` from the port's import to the window's start (the operator
build from the handed K, a warm job, and for a polish mix the training
that makes its start); the window, a closed loop of whole jobs that ends
on a synchronise after the job in flight once `seconds` have passed;
then the memory peak, the port's state freed, and the plain reference
(`reference.py`) judging what the window's jobs produced.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import warnings

import numpy as np
import torch

import inputs

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PORT = "eigenpinns_torch"
# Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "eigenpinns_tpu")


# ---- the benchmark's files ----------------------------------------------

def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(root: str, workload: str) -> dict:
    """The cell `workload` of `root`/BENCHMARK.json with its
    configuration, traffic mix, limits and metrics (each metric's entry
    with its reader, for the cells it applies to)."""
    bench = read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench_dir = os.path.join(root, os.path.basename(BENCH_DIR))

    def metrics(kind: str) -> list:
        return [dict(m, reader=load_reader(bench_dir, m["name"]))
                for m in bench[kind]
                if workload in m.get("workloads", [workload])]

    return {"cell": cell, "bench_dir": bench_dir,
            "config": read_json(os.path.join(root,
                                                           config["file"])),
            "traffic": read_json(os.path.join(bench_dir, "traffic",
                                              f"{cell['traffic']}.json")),
            "limits": read_json(os.path.join(bench_dir, "limits",
                                             f"{workload}.json")),
            "end_to_end": metrics("end_to_end"),
            "per_layer": metrics("per_layer")}


def load_reader(bench_dir: str, name: str):
    """`metrics/<name>.py`'s `read(ctx)`."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_jobs(job: str, bench_dir: str = BENCH_DIR):
    """`jobs/<job>.py`: its `Jobs` class (the closed loop's job), its
    `readings` (control.py's), and optionally its own `build_operator`."""
    spec = importlib.util.spec_from_file_location(
        "job_" + job.replace(".", "_").replace("-", "_"),
        os.path.join(bench_dir, "jobs", f"{job}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_inputs(cfg: dict, root: str) -> inputs.Inputs:
    """The configuration's surface (X, K, m), the same for every seed (the
    seed draws the jobs' parameters and guard columns), cached under the
    checkout's `build/bench_inputs/`."""
    return inputs.load(cfg, os.path.join(root, "build", "bench_inputs"),
                       os.path.join(root, os.path.basename(BENCH_DIR)))


def job_seed(seed: int, *stream) -> int:
    """A 63-bit seed for the stream `stream` (strings and whole numbers)
    of the run seeded `seed`."""
    words = [seed % 2**64] + [s if isinstance(s, int) else
                              int.from_bytes(s.encode(), "little")
                              for s in stream]
    a, b = np.random.SeedSequence(words).generate_state(2, dtype=np.uint32)
    return (int(a) << 31) ^ int(b)


def init_params(seed: int, stream: tuple, dims: list, device) -> dict:
    """A fresh joint eigen-network's parameters, made on `device` from the
    seed in one draw: flax's Dense defaults (LeCun-normal kernels, a unit
    normal truncated to [-2, 2] scaled to variance 1 / fan_in; zero
    biases). Keys and (out, in) layout of the port's state_dict."""
    gen = torch.Generator(device).manual_seed(job_seed(seed, *stream))
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params, start = {}, 0
    last = len(dims) - 2
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        name = "mlp.out" if i == last else f"mlp.hidden.{i}"
        std = (1.0 / a) ** 0.5 / 0.87962566103423978
        params[f"{name}.weight"] = flat[start:start + a * b].view(b, a) * std
        params[f"{name}.bias"] = torch.zeros(b, device=device)
        start += a * b
    return params


def _layers(params: dict) -> list:
    """The layers of a state_dict in order: the hidden ones, then the head."""
    return sorted({key.rsplit(".", 1)[0] for key in params},
                  key=lambda s: (s == "mlp.out", s))


def reference_leaves(params: dict) -> dict:
    """The port's state_dict as the reference's leaves: w{i} (in, out),
    b{i}."""
    leaves = {}
    for i, name in enumerate(_layers(params)):
        leaves[f"w{i}"] = params[f"{name}.weight"].T.contiguous()
        leaves[f"b{i}"] = params[f"{name}.bias"]
    return leaves


def leaf_of(state_key: str, params: dict) -> str:
    """The reference's leaf name of the port's state_dict key."""
    name, kind = state_key.rsplit(".", 1)
    return ("w" if kind == "weight" else "b") + str(
        _layers(params).index(name))


# ---- the port ------------------------------------------------------------

def import_port(root: str):
    """The port's package from the checkout at `root`; raises
    SystemExit when it is missing there."""
    if root not in sys.path:
        sys.path.insert(0, root)
    try:
        import eigenpinns_torch
    except ImportError as err:
        raise SystemExit(f"the port {PORT} is not in {root}: {err}")
    where = os.path.dirname(os.path.abspath(eigenpinns_torch.__file__))
    if os.path.dirname(where) != os.path.abspath(root):
        raise SystemExit(f"{PORT} was imported from {where}, not from the "
                         f"checkout {root}")
    return eigenpinns_torch


def launch_count() -> int:
    """All launches of the port's hand kernels in this process so far."""
    from eigenpinns_torch.sparse import banded, bsr, rolling

    b = banded.banded_kernel_launches
    return (rolling.rolling_kernel_launches
            + bsr.bsr_kernel_launches["grouped"]
            + bsr.bsr_kernel_launches["burst"]
            + b["spmm"] + b["spmm_rect"] + b["spmm_gram"])


def nan_to_inf(x) -> float:
    """x as a float, a NaN as infinity: a number that cannot be read is
    over every limit."""
    x = float(x)
    return float("inf") if np.isnan(x) else x


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    """Returns the memory of freed tensors to the card."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Spans:
    """The benchmark's own spans around its calls into the port: name,
    start and end in Unix nanoseconds (the profiler's clock)."""

    def __init__(self):
        self.items: list = []

    @contextlib.contextmanager
    def __call__(self, name: str, device=None):
        start = time.time_ns()
        try:
            yield
        finally:
            if device is not None:
                sync(device)
            self.items.append((name, start, time.time_ns()))

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.items if n == name) / 1e9


# ---- the device trace ----------------------------------------------------

def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every device activity of a profiler run
    (kernels, copies, sets), Unix nanoseconds."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.name(), start, start + e.duration_ns()))
    return out


def busy_seconds(events: list) -> float:
    """The length of the union of the events' intervals."""
    busy, end = 0, None
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e9


def breakdown(events: list, spans: list, lo: int, hi: int) -> dict:
    """The device operations that took most time, and the idle gaps of the
    window summed by the benchmark span the host was in and the operation
    that ended the gap, the ten largest of each."""
    ops = collections.Counter()
    for name, s, e in events:
        ops[name[:160]] += (e - s) / 1e9
    gaps = collections.Counter()
    last = lo
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        if s > last:
            mid = (s + last) // 2
            where = next((n for n, a, b in spans if a <= mid <= b),
                         "between jobs")
            gaps[f"{where} / before {name[:100]}"] += (s - last) / 1e9
        last = max(last, e)
    if hi > last:
        gaps["window end"] += (hi - last) / 1e9
    return {"device_ops": [[n, t] for n, t in ops.most_common(10)],
            "idle_gaps": [[n, t] for n, t in gaps.most_common(10)]}


# ---- one run --------------------------------------------------------------

def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def build_operator(cfg: dict, inp: inputs.Inputs, dev):
    """(op, M, perm): the configuration's operator format of
    `eigenpinns_torch.sparse` built from the handed K by its `from_scipy`,
    which orders the rows (perm), and the lumped mass in that order. A job
    module may bring its own."""
    from eigenpinns_torch import sparse

    op_cls = getattr(sparse, cfg["operator"]["class"])
    op, perm = op_cls.from_scipy(inp.K, device=dev,
                                 **cfg["operator"]["kwargs"])
    perm = np.asarray(perm)
    M = sparse.Diagonal(torch.as_tensor(inp.m[perm], dtype=torch.float32,
                                        device=dev))
    return op, M, perm


def setup(spec: dict, seed: int, inp: inputs.Inputs, device,
          port_root: str, plant=None):
    """The timed set-up: the port's import, the operator build from the
    handed K and the lumped mass (span 'operator_build'), the jobs' warm-up.
    Returns (jobs, setup_s, spans)."""
    cfg, traffic = spec["config"], spec["traffic"]
    if (traffic.get("loop"), traffic.get("clients")) != ("closed", 1):
        raise ValueError("the generator runs a closed loop of one client")
    spans = Spans()
    t_setup = time.perf_counter()
    port = import_port(port_root)
    if plant is not None:
        plant(port)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    module = load_jobs(traffic["job"], spec["bench_dir"])
    with spans("operator_build", dev):
        op, M, perm = getattr(module, "build_operator", build_operator)(
            cfg, inp, dev)
    jobs = module.Jobs(cfg, op, M, inp.X[perm], perm, seed, dev)
    jobs.warm()
    sync(dev)
    return jobs, time.perf_counter() - t_setup, spans


def check(worst: dict, per_job: list, limits: dict) -> tuple:
    """(correct, failed, checks): every number against its limit; a job
    fails when one of its numbers is over its limit."""
    checks = {key: {"value": worst.get(key, float("inf")), "limit": lim}
              for key, lim in limits.items()}
    failed = sum(any(nums.get(key, float("inf")) > lim
                     for key, lim in limits.items() if key in nums)
                 for nums in per_job)
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    return correct, failed, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, device: str = "cuda", plant=None,
             port_root: str | None = None) -> dict:
    """One run of `workload` of the benchmark at `root`; returns the result
    line as a dict. Tests give `port_root`, where the port is, when it
    differs from `root`, and `plant`, called with the port's package after
    its import, to break the timed path underneath."""
    spec = load_cell(root, workload)
    cfg = spec["config"]
    port_root = root if port_root is None else port_root
    if not os.path.isfile(os.path.join(port_root, PORT, "__init__.py")):
        raise SystemExit(f"the port {PORT} is not in {port_root}")
    t0 = time.time()
    inp = config_inputs(cfg, root)
    log(f"inputs: {inp.X.shape[0]} points, nnz {inp.K.nnz}, in "
        f"{time.time() - t0:.3f} s (not timed)")

    dev = torch.device(device)
    jobs, setup_s, spans = setup(spec, seed, inp, dev, port_root, plant)
    log(f"set-up {setup_s:.3f} s (operator build "
        f"{spans.seconds('operator_build'):.3f} s)")

    records, window = run_window(jobs, seconds, trace, spans, dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    work = jobs.work(records)
    log(f"window {window['window_s']:.3f} s: {work}; job seconds "
        f"{[round((e - s) / 1e9, 4) for n, s, e in spans.items if n == jobs.kind]}")
    jobs.release(records)

    t_ref = time.time()
    correct, failed, checks = check(*jobs.judge(records, inp),
                                    spec["limits"])
    log(f"reference {time.time() - t_ref:.3f} s")

    ctx = {"cell": workload, "config": cfg, "traffic": spec["traffic"],
           "job": jobs.kind, "n": inp.X.shape[0], "nnz": int(inp.K.nnz),
           "setup_s": setup_s, "memory_peak_bytes": int(peak),
           "spans": {"operator_build": spans.seconds("operator_build")},
           "work": work, **window}
    metrics = {}
    for entry in spec["per_layer" if trace else "end_to_end"]:
        value = entry["reader"](ctx)
        if value is None:
            log(f"metric {entry['name']}: nothing to read")
            continue
        metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    result = {"correct": bool(correct), "attempted": len(records),
              "failed": int(failed), "metrics": metrics,
              "device": device_info(dev, peak, window, trace)}
    if trace and window.get("breakdown") is not None:
        result["breakdown"] = window["breakdown"]
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    """The modules of FORBIDDEN in this process, by whole top-level name."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def device_info(dev, peak: int, window: dict, trace: bool) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if trace and window.get("busy_s") is not None:
        info["busy_s"] = window["busy_s"]
        info["window_s"] = window["window_s"]
    return info


def run_window(jobs, seconds: float, trace: bool, spans: Spans, dev):
    """The closed loop: jobs back to back until `seconds` have passed,
    ending on a synchronise after the job in flight. With `trace`, under
    the profiler (CUDA activity only) and, for polish jobs, CUDA's sync
    debug mode. Returns (records, window facts)."""
    traced = trace and dev.type == "cuda"
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    count_syncs = traced and jobs.kind == "polish"
    seen = []
    launches0 = launch_count()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        if count_syncs:
            torch.cuda.set_sync_debug_mode("warn")
        sync(dev)
        lo = time.time_ns()
        t0 = time.perf_counter()
        records = []
        try:
            while True:
                with spans(jobs.kind):
                    records.append(jobs.job(len(records)))
                if time.perf_counter() - t0 >= seconds:
                    break
            sync(dev)
        finally:
            if count_syncs:
                torch.cuda.set_sync_debug_mode("default")
        window_s = time.perf_counter() - t0
        hi = time.time_ns()
    facts = {"window_s": window_s, "launches": launch_count() - launches0,
             "host_syncs": (sum("synchroniz" in str(w.message) for w in seen)
                            if count_syncs else None),
             "busy_s": None, "kernel_seconds": None, "breakdown": None}
    if prof is not None:
        prof.stop()
        events = [ev for ev in device_events(prof) if lo <= ev[1] <= hi]
        kernels = collections.Counter()
        for name, s, e in events:
            kernels[name] += (e - s) / 1e9
        facts.update(busy_s=busy_seconds(events), kernel_seconds=kernels,
                     breakdown=breakdown(events, spans.items, lo, hi))
    return records, facts


# ---- the command ----------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    spec = load_cell(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell {args.workload} needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules loaded that no run may load: {found}",
              file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
