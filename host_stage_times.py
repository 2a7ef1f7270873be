#!/usr/bin/env python3
"""Host-stage times of the PyTorch port (`eigenpinns_torch`): the
point-cloud Laplacian on the native path against the numpy triangulation.

Run from the root of a checkout:

    python3 host_stage_times.py [--sizes 60000,300000,1000000]

It builds the native library (`geometry/native.py`, printing the build's
wall), then, for each size, makes `make_cloud(n)` and times
`point_cloud_laplacian(X, n_neighbors=15)` with use_native=True and with
use_native=False (the numpy/scipy triangulation; the flips still run in
C++ once the library loads), printing each one's nnz and
max |L_numpy - L_native| / max |L_native|. Nothing else runs meanwhile,
so the times are the host's own. The machine (cores, CPU model and, where
nvidia-smi answers, the card's name and power limit) is printed first; the
last line is a JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown"


def card() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="60000,300000,1000000",
                    help="comma-separated cloud sizes")
    args = ap.parse_args()

    from eigenpinns_torch.geometry import native, point_cloud_laplacian
    from eigenpinns_torch.utils.fixtures import make_cloud

    host = {"cpus": os.cpu_count(), "cpu": cpu_model(), "card": card()}
    print(f"[host] {host['cpus']} cpus, {host['cpu']}; card {host['card']}",
          flush=True)
    t0 = time.time()
    native.require()
    build_s = time.time() - t0
    print(f"[host] native library loaded in {build_s:.2f} s", flush=True)

    rows = []
    for n in (int(s) for s in args.sizes.split(",")):
        t0 = time.time()
        X = make_cloud(n)
        cloud_s = time.time() - t0
        t0 = time.time()
        L, _ = point_cloud_laplacian(X, n_neighbors=15, use_native=True)
        native_s = time.time() - t0
        t0 = time.time()
        L_np, _ = point_cloud_laplacian(X, n_neighbors=15, use_native=False)
        numpy_s = time.time() - t0
        diff = abs(L_np - L).max() / abs(L).max()
        rows.append(dict(n=n, cloud_s=cloud_s, native_s=native_s,
                         native_nnz=int(L.nnz), numpy_s=numpy_s,
                         numpy_nnz=int(L_np.nnz), rel_diff=float(diff)))
        print(f"[host] {n} points: cloud {cloud_s:.2f} s, native Laplacian "
              f"{native_s:.2f} s (nnz {L.nnz}), numpy triangulation "
              f"{numpy_s:.2f} s (nnz {L_np.nnz}), max |L_numpy - L_native| "
              f"/ max |L_native| {diff:.3e}", flush=True)
        del X, L, L_np
    print(json.dumps({"host": host, "build_s": build_s, "sizes": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
