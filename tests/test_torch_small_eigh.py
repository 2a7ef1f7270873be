"""The small symmetric eigensolver (`solvers/small_eigh.py`) on the CPU.

The CUDA kernel has no CPU mode (its card tests, against
`torch.linalg.eigh`, are in `test_torch_cuda.py`); here: the routing rule
of `rayleigh_ritz.eigh` as a pure function of device type, shape, dtype
and grad; the CPU's eigensolves on `torch.linalg.eigh`; the launcher's
refusal of a CPU input; and the polish's stop check that reads the
kernel's failure word.
"""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eigenpinns_torch.solvers import small_eigh as se
from eigenpinns_torch.utils import profiling

torch.set_num_threads(2)


def _sym(n, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn((n, n), generator=g, dtype=torch.float64)
    return (X + X.T).to(dtype)


@pytest.mark.parametrize("device, shape, dtype, grad, kernel", [
    ("cuda", (84, 84), torch.float64, False, True),
    ("cuda", (28, 28), torch.float32, False, True),
    ("cuda", (1, 1), torch.float32, False, True),
    ("cuda", (85, 85), torch.float64, False, False),
    ("cuda", (85, 85), torch.float32, False, False),
    ("cuda", (127, 127), torch.float32, False, False),
    ("cuda", (127, 127), torch.float64, False, False),
    ("cuda", (128, 128), torch.float32, False, False),
    ("cuda", (128, 128), torch.float64, False, False),
    ("cpu", (84, 84), torch.float64, False, False),
    ("cpu", (28, 28), torch.float32, False, False),
    ("cuda", (129, 129), torch.float64, False, False),
    ("cuda", (28, 28), torch.float16, False, False),
    ("cuda", (28, 28), torch.bfloat16, False, False),
    ("cuda", (28, 28), torch.float32, True, False),
    ("cuda", (2, 28, 28), torch.float32, False, False),
    ("cuda", (28, 27), torch.float32, False, False),
    ("cuda", (0, 0), torch.float32, False, False),
])
def test_kernel_route(device, shape, dtype, grad, kernel):
    """The kernel for a 2-D CUDA fp32/fp64 n x n, 1 <= n <= 84, that
    autograd does not record; the library for the CPU, n past 84 (which
    the kernel does not take), fp16, bf16, a gradient, a batch, a
    non-square or an empty input."""
    assert se.kernel_route(device, shape, dtype, grad) is kernel


@pytest.mark.parametrize("n, dtype, grad", [
    (84, torch.float64, False), (28, torch.float32, False),
    (1, torch.float32, False), (128, torch.float64, False),
    (129, torch.float32, False), (28, torch.float64, True)])
def test_eigh_takes_the_library_on_the_cpu(n, dtype, grad):
    """On the CPU `rayleigh_ritz.eigh` is `torch.linalg.eigh` bit for bit,
    counted as one sync and no kernel solve; a recorded input keeps its
    gradient."""
    rr = sys.modules["eigenpinns_torch.solvers.rayleigh_ritz"]
    A = _sym(n, dtype, n).requires_grad_(grad)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        w, V = rr.eigh(A)
    assert profiling.counters() == {"sync.eigh": 1}
    profiling.reset()
    wl, Vl = torch.linalg.eigh(A)
    assert torch.equal(w, wl) and torch.equal(V, Vl)
    assert w.requires_grad is grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_launcher_refuses_a_cpu_input(dtype):
    """`small_eigh_cuda` checks its input before it builds or launches
    anything: a CPU matrix is refused."""
    status = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        se.small_eigh_cuda(_sym(28, dtype, 1), status)


def test_stop_check_reads_the_failure_word():
    """`lobpcg`'s stop check reads the stop flag and the eigensolves'
    status word in one transfer; a set word raises LinAlgError, so a
    failed solve's NaN residuals never read as converged."""
    lob = sys.modules["eigenpinns_torch.solvers.lobpcg"]
    res = torch.tensor([1e-3, 2e-7])
    ok = torch.zeros((), dtype=torch.int32)
    assert lob._keep_going(res, 1e-6, ok) is True
    assert lob._keep_going(res, 1e-2, ok) is False
    assert lob._keep_going(res, 1e-2, None) is False
    with pytest.raises(torch.linalg.LinAlgError):
        lob._keep_going(torch.full((2,), float("nan")), 1e-6,
                        torch.ones((), dtype=torch.int32))
