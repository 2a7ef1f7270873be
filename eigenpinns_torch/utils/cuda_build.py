"""Build a C++ or CUDA source of the package into a shared library, on
first use.

`load_library` compiles `csrc/<name>.cu` with `nvcc` for the card and
`load_host_library` compiles `csrc/<name>.cpp` with the host C++ compiler
(the flags of the JAX package's `csrc/Makefile`, with OpenMP where the
compiler takes it). Both write `build/eigenpinns_torch/<name>-<hash>.so`
at the root of the checkout, with a plain C interface that the caller
binds with ctypes (no PyTorch headers: seconds to build, not minutes).
The hash covers the source bytes, the headers (`csrc/*.cuh`, for the CUDA
sources), the flags and, for the host build, the instruction-set macros
that `-march=native` turns on, so an edited source, or a checkout copied
to another host, is rebuilt. The compiler writes to a process-unique
temp name that is `os.replace`d into place, so concurrent processes
never load a half-written library. Nothing is built when a module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
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
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

# name -> the compiler's stderr of the build this process made (for a
# CUDA source, the -Xptxas -v report: registers and shared memory per
# kernel)
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


def _cxx() -> str:
    found = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if found is None:
        raise RuntimeError("no C++ compiler found: set CXX or put g++ on "
                           "PATH to build the host geometry kernels")
    return found


def _build(name: str, paths: list[str], key: str, compile_cmd) -> str:
    """The path of `build/eigenpinns_torch/<name>-<hash>.so`, the hash
    taken over `key` and the bytes of `paths`; built first, by
    `compile_cmd(output_path)` (an argument list), when it is missing."""
    digest = hashlib.sha256(key.encode())
    for path in paths:
        with open(path, "rb") as fh:
            digest.update(fh.read())
    target = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(target):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{target}.build{os.getpid()}"
        try:
            proc = subprocess.run(compile_cmd(tmp), capture_output=True,
                                  text=True, timeout=600, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"the build of {paths[0]} failed:\n"
                                   f"{proc.stderr[-4000:]}")
            build_logs[name] = proc.stderr
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return target


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu` as a ctypes library."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    target = _build(
        name, [src] + [os.path.join(CSRC_DIR, h) for h in headers],
        " ".join(NVCC_FLAGS),
        lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out, src])
    return ctypes.CDLL(target)


@functools.cache
def host_cxx_flags() -> tuple[str, list[str], str]:
    """(compiler, flags, the macros `-march=native` defines): CXX_FLAGS
    plus `-fopenmp` when the compiler links an empty program with it (the
    probe of the JAX package's `csrc/Makefile`)."""
    cxx = _cxx()
    probe = subprocess.run([cxx, "-fopenmp", "-x", "c++", "-", "-o",
                            os.devnull], input="int main(){}",
                           capture_output=True, text=True, timeout=120,
                           check=False)
    flags = CXX_FLAGS + (["-fopenmp"] if probe.returncode == 0 else [])
    macros = subprocess.run([cxx, "-march=native", "-dM", "-E", "-x", "c++",
                             os.devnull], capture_output=True, text=True,
                            timeout=120, check=False).stdout
    return cxx, flags, macros


def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cpp`, compiled for the host
    CPU, as a ctypes library. Raises RuntimeError with the compiler's
    stderr when the build fails."""
    src = os.path.join(CSRC_DIR, f"{name}.cpp")
    cxx, flags, macros = host_cxx_flags()
    target = _build(name, [src], " ".join(flags) + "\n" + macros,
                    lambda out: [cxx, *flags, src, "-o", out])
    return ctypes.CDLL(target)
