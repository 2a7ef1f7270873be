"""Tracing / profiling utilities.

Port of `eigenpinns_tpu/utils/profiling.py`: a lightweight phase timer
the pipeline uses to report its build/train/export breakdown, a
`torch.profiler` trace around any code block, written to a directory as
a Chrome trace (viewable in Perfetto or chrome://tracing), and named
regions inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import OrderedDict


class PhaseTimer:
    """Accumulating named-phase wall timer.

    with timer.phase("assemble"): ...
    print(timer.report())
    """

    def __init__(self):
        self.times: OrderedDict[str, float] = OrderedDict()
        self.counts: OrderedDict[str, int] = OrderedDict()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{'phase':<24} {'secs':>9} {'calls':>6} {'%':>6}"]
        for name, t in self.times.items():
            lines.append(
                f"{name:<24} {t:>9.3f} {self.counts[name]:>6} "
                f"{100 * t / max(total, 1e-12):>5.1f}%")
        lines.append(f"{'TOTAL':<24} {total:>9.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU activity, and the
    card's when CUDA is available) and write it to
    `<log_dir>/trace_<pid>_<time>.json` as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a profiler trace (record_function)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
