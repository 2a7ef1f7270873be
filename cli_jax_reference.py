#!/usr/bin/env python3
"""The JAX package's own figures at the CLI runs of `chip_smoke.py`, on
the CPU.

    python3 cli_jax_reference.py   (~4 min on 8 cores)

Runs `eigenpinns_tpu.main.cli` on the smoke's inputs (the bunny
stand-in, perturbed_icosphere(4), written as an .obj; run B's
sectioned YAML of Config()) with the smoke's settings, and prints for
run A (the mesh path: graph_coarsening, connectivity edges, the LOBPCG
coarse solve, k = 10) and run B (the reference defaults, k = 64, cut to
2000 epochs) the max rel err of modes 1+ of the exported vectors'
Rayleigh quotients against eigsh (`chip_smoke.cli_error`), which is
`CLI_JAX_ERR` in `chip_smoke.py`, and the wall time of each run.

With `solver_family_jax_reference.py`, one of the two root scripts that
run the JAX package; the port and `chip_smoke.py` never import it.
"""

import os
import sys
import tempfile
import time

import jax

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from eigenpinns_tpu.main import cli  # noqa: E402


def main() -> int:
    with tempfile.TemporaryDirectory() as work:
        runs = chip_smoke.cli_inputs(work)
        errs = {}
        for run in sys.argv[1:] or ["A", "B"]:
            argv, vtu, k = runs[run]
            t0 = time.time()
            cli(argv)
            wall = time.time() - t0
            err, n_points, fields = chip_smoke.cli_error(run, vtu,
                                                         runs["obj"], k)
            errs[run] = err
            print(f"[cli {run}] JAX package on the CPU: {wall:.1f} s, "
                  f"{n_points} points, fields {fields[0]}..{fields[-1]}, "
                  f"max rel err (modes 1+) {err!r}", flush=True)
        print(f"CLI_JAX_ERR = {errs!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
