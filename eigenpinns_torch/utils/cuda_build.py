"""Build a CUDA source of the package into a shared library, on first use.

`nvcc` compiles the file into `build/eigenpinns_torch/<name>-<hash>.so`
at the root of the checkout, with a plain C interface that the caller
binds with ctypes (no PyTorch headers: seconds to build, not minutes).
The hash covers the source bytes, the headers (`csrc/*.cuh`) and the
flags, so an edited source is rebuilt; the compiler writes to a process-unique temp name that is
`os.replace`d into place, so concurrent processes never load a
half-written library. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build",
                         "eigenpinns_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> the compiler's -Xptxas -v report (register and shared-memory
# use per kernel) of the build this process made
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    target = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.build{os.getpid()}"
        try:
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True,
                                  timeout=600, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n"
                                   f"{proc.stderr[-4000:]}")
            build_logs[name] = proc.stderr
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(target)
