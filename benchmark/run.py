"""Run one cell of the eigenpinns_torch benchmark once, on this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints the result as one JSON line, last on standard output, and each
number the correctness check compared, beside its limit, last on
standard error. Exits 2, printing no result, without the CUDA devices
the cell needs.

The run keeps OpenMP and the BLAS to one thread each.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# Every build and kernel cache in fixed directories of the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
sys.path.insert(0, HERE)

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main())
