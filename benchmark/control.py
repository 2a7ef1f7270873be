"""The readings that the correctness limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,... \\
        --controls 3 --out build/readings.json

For each seed, in one process, on the configuration's inputs: the
port's set-up and `--jobs` jobs of the cell, judged as a run judges them:
the program's readings. For the first `--controls` seeds also the
control, put in the program's place in the nearest precision below the
configuration's, and planted faults. The cell's job module
(`jobs/<job>.py`) reads them with its `readings`:

  * `train`: the reference with its bf16 parts (the MLP's and the loss
    operator's products) in float8 e4m3, the reference with each fault of
    `reference.FAULTS` planted, and the reference with those parts in
    bf16 (the witness of the configuration's own rounding), each read
    against the float32 reference by the same numbers;
  * `polish`: the port's polish with TF32 on for its float32 dense
    products (the port turns TF32 off).

The benchmark's own runs never run this. Prints one JSON line a seed and
the summary (the largest program reading and the smallest control reading
of each number) last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

import harness


def summary(rows: list) -> dict:
    """For each number: the largest program reading (the lower reading)
    and, for each control or fault, its smallest reading."""
    out = {}
    for row in rows:
        for source, nums in row["readings"].items():
            if source.endswith("_jobs"):
                continue
            for key, v in nums.items():
                slot = out.setdefault(key, {})
                pick = max if source == "program" else min
                slot[source] = pick(slot.get(source, v), v)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated seeds")
    parser.add_argument("--controls", type=int, default=3,
                        help="seeds (the first ones) that also read the "
                             "control")
    parser.add_argument("--jobs", type=int, default=1,
                        help="jobs of the program a seed, as many as a "
                             "run's window holds")
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    root = harness.ROOT
    spec = harness.load_cell(root, args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    inp = harness.config_inputs(spec["config"], root)
    read = harness.load_jobs(spec["traffic"]["job"],
                             spec["bench_dir"]).readings
    rows = []
    for i, seed in enumerate(seeds):
        row = {"seed": seed, "readings": read(
            spec, seed, inp, torch.device(args.device), root,
            i < args.controls, args.jobs)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        harness.free(args.device)
    result = {"workload": args.workload, "seeds": seeds,
              "summary": summary(rows), "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, harness.ROOT)
    sys.exit(main())
