"""A small symmetric eigensolver on the card that never waits for the host.

`small_eigh_cuda` launches `csrc/small_eigh.cu`: one thread block runs a
parallel two-sided cyclic Jacobi on one n x n matrix (n <= 84, fp32 or
fp64, read from its lower triangle, arithmetic in the input's type) and
writes the eigenvalues ascending and the eigenvectors as columns, as
`torch.linalg.eigh` does. Unlike the library's CUDA eigh it does not
check its result on the host: on failure (a nonfinite input, or no
convergence within `MAX_SWEEPS` sweeps) it fills both outputs with NaN and
writes 1 into a caller's int32 status word on the device. The kernel
chooses its own launch grid (`grid` reads it).

`kernel_route` is the routing rule of `rayleigh_ritz.eigh`, a pure
function of what the input shows: the kernel for a 2-D CUDA fp32/fp64
matrix of n <= 84 that autograd is not recording, `torch.linalg.eigh`
for everything else. Past n = 84 a row of V no longer fits 16 positions
a thread and the kernel's registers spill, so it does not take those
sizes (a version with 32 positions took 6.2 ms at n = 128 in fp64 on an
H100, the library 1.7).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_N = 84           # the largest matrix the kernel takes
MAX_SWEEPS = 50      # a solve that has not converged by then fails

# Launches of the kernel in this process.
small_eigh_launches = 0


def kernel_route(device_type: str, shape: tuple, dtype: torch.dtype,
                 grad: bool) -> bool:
    """Whether `rayleigh_ritz.eigh` takes the kernel for an input on
    `device_type` of `shape` and `dtype`, with `grad` True when autograd
    records it; `torch.linalg.eigh` otherwise."""
    return (device_type == "cuda" and len(shape) == 2
            and shape[0] == shape[1] and 1 <= shape[0] <= MAX_N
            and dtype in (torch.float32, torch.float64) and not grad)


@functools.cache
def build_kernel() -> ctypes.CDLL:
    """Compile csrc/small_eigh.cu (once per source hash), load it and
    declare its C interface."""
    from eigenpinns_torch.utils.cuda_build import load_library

    lib = load_library("small_eigh")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.epk_small_eigh.restype = i
    lib.epk_small_eigh.argtypes = [p, p, p, p, i, i, i, p]
    lib.epk_small_eigh_grid.restype = i
    lib.epk_small_eigh_grid.argtypes = [i, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
    lib.epk_small_eigh_error_string.restype = ctypes.c_char_p
    lib.epk_small_eigh_error_string.argtypes = [i]
    return lib


def grid(n: int) -> tuple:
    """The kernel's launch grid for n x n: (S positions of a row of V a
    thread, P threads a row, the block's threads)."""
    S, P = ctypes.c_int(), ctypes.c_int()
    threads = build_kernel().epk_small_eigh_grid(n, S, P)
    if threads == 0:
        raise ValueError(f"the kernel takes 1 <= n <= {MAX_N}, got {n}")
    return S.value, P.value, threads


def small_eigh_cuda(A: torch.Tensor, status: torch.Tensor):
    """(eigenvalues ascending (n,), eigenvectors (n, n)) of the symmetric
    A on its CUDA device, read from its lower triangle, in A's dtype. One
    launch on the current stream; `status`, an int32 scalar on A's device,
    is set to 1 when the solve fails (the outputs are then NaN) and is
    never cleared. Raises on anything the kernel does not take."""
    global small_eigh_launches
    if not kernel_route(A.device.type, tuple(A.shape), A.dtype, False):
        raise ValueError("the kernel takes a CUDA fp32/fp64 (n, n) matrix, "
                         f"1 <= n <= {MAX_N}; got {A.dtype} "
                         f"{tuple(A.shape)} on {A.device}")
    if (status.dtype != torch.int32 or status.numel() != 1
            or status.device != A.device):
        raise ValueError("status must be one int32 on A's device")
    n = A.shape[0]
    A = A.contiguous()
    w = torch.empty((n,), dtype=A.dtype, device=A.device)
    V = torch.empty((n, n), dtype=A.dtype, device=A.device)
    lib = build_kernel()
    err = lib.epk_small_eigh(
        A.data_ptr(), w.data_ptr(), V.data_ptr(), status.data_ptr(), n,
        int(A.dtype == torch.float64), MAX_SWEEPS,
        torch._C._cuda_getCurrentRawStream(A.device.index))
    if err != 0:
        raise RuntimeError("small_eigh kernel launch failed: "
                           + lib.epk_small_eigh_error_string(err).decode())
    small_eigh_launches += 1
    return w, V
