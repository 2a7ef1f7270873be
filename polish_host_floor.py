#!/usr/bin/env python3
"""How far the host paces the rolling-band polish on the card.

The benchmark's `direct300k_rolling` polish (`lobpcg` on 20 + 8 columns,
the fp32 `RollingBanded` K of the bench's star cloud) launches the same
kernels an iteration at any size of the cloud, while the card's work
grows with the points. For each size this script times an iteration of
the polish from a seeded start (tol 0, so every iteration runs):

  untraced  the host clock around whole polishes, between synchronises,
            no profiler in the process (the benchmark's untraced window);
  kernels   the union of the card's activity over one polish under
            torch.profiler (CUDA activity only), its launches and the
            traced wall, in a second pass after the untraced ones (a
            profiler session leaves a process's later launches slower).

At a size where the kernels take far less than the untraced iteration,
the untraced time is the host's floor: what it takes to launch one
iteration. Where the floor comes near the kernels' time, the host sets
the pace and its speed moves the polish's wall. "idle, untraced" is
1 - kernels / untraced: an estimate, the kernels timed in another pass.

  python3 polish_host_floor.py [--points 30000 300000] [--iters 400]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "benchmark")
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

import harness  # noqa: E402

CONFIG = os.path.join(BENCH, "configs", "direct300k_rolling.json")
UNTRACED_POLISHES = 3


def polish_once(op, M, X0, iters: int) -> float:
    """Wall seconds of one polish of `iters` iterations."""
    from eigenpinns_torch.solvers import lobpcg

    harness.sync(X0.device)
    t0 = time.perf_counter()
    pol = lobpcg(op, M, X0, max_iter=iters, tol=0.0)
    harness.sync(X0.device)
    wall = time.perf_counter() - t0
    assert int(pol.iterations) == iters, int(pol.iterations)
    return wall


def size_row(n: int, iters: int, seed: int, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from eigenpinns_torch.solvers import lobpcg

    with open(CONFIG) as fh:
        cfg = dict(json.load(fh), n_points=n)
    inp = harness.config_inputs(cfg, ROOT)
    op, M, _ = harness.build_operator(cfg, inp, dev)
    op = op.with_precision("highest")
    k = cfg["train"]["n_modes"] + cfg["polish"]["guard"]
    gen = torch.Generator(dev).manual_seed(seed)
    X0 = torch.randn((op.n, k), generator=gen, device=dev)
    lobpcg(op, M, X0, max_iter=10, tol=0.0)
    untraced = [polish_once(op, M, X0, iters) / iters * 1e3
                for _ in range(UNTRACED_POLISHES)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        harness.sync(dev)
        lo = time.time_ns()
        traced = polish_once(op, M, X0, iters) / iters * 1e3
        hi = time.time_ns()
    events = [ev for ev in harness.device_events(prof) if lo <= ev[1] <= hi]
    kernels = harness.busy_seconds(events) / iters * 1e3
    row = {"n": n, "iters": iters, "untraced_ms": untraced,
           "kernels_ms": kernels, "launches": len(events) / iters,
           "traced_ms": traced,
           "idle_untraced_estimate": [1 - kernels / u for u in untraced]}
    del op, M, X0
    harness.free(dev)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, nargs="+", default=[30000, 300000])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--seed", type=int, default=2147483659)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("polish_host_floor: no CUDA device", file=sys.stderr)
        return 1
    harness.import_port(ROOT)
    dev = torch.device("cuda:0")
    print(f"device {torch.cuda.get_device_name(dev)}", flush=True)
    for n in args.points:
        r = size_row(n, args.iters, args.seed, dev)
        print(f"[floor] n {r['n']}: an iteration untraced "
              + " / ".join(f"{u:.3f}" for u in r["untraced_ms"])
              + f" ms, kernels {r['kernels_ms']:.3f} ms "
              f"({r['launches']:.1f} device operations), traced "
              f"{r['traced_ms']:.3f} ms; idle, untraced (estimate) "
              + " / ".join(f"{100 * i:.1f}%"
                           for i in r["idle_untraced_estimate"]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
