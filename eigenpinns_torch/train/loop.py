"""Chunked training loop with on-device early-stop bookkeeping.

Port of `eigenpinns_tpu/train/loop.py::run_scan_loop`. The JAX loop fuses
`chunk` epochs into one compiled `lax.scan`; here the epochs of a chunk
are enqueued eagerly and the host waits on the device once per chunk, to
read that chunk's metrics and the early-stop counter. The best-loss
counter and the optional best-parameter snapshot live on the device.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch


class LoopResult(NamedTuple):
    history: dict            # metric name -> np array over epochs run
    epochs_run: int
    wall_time: float
    stopped_early: bool
    chunk_times: list        # [(n_epochs, seconds)] per chunk
    best_params: list | None = None  # snapshot at the best loss


def run_chunked_loop(
    step_fn: Callable,        # epoch:int -> metrics dict of 0-dim tensors
    n_epochs: int,
    chunk: int = 100,
    early_stop_patience: int | None = None,
    early_stop_metric: str = "loss",
    early_stop_mode: str = "improve",
    early_stop_tol: float = 0.0,
    log_every: int = 0,
    log_fn: Callable | None = None,
    track_params: list | None = None,
    device=None,
    start_epoch: int = 0,
    chunk_callback: Callable | None = None,
) -> LoopResult:
    """Run `step_fn` for up to n_epochs, syncing once per chunk.

    Early stopping follows the reference (src/multigrid_model.py:262-272):
    a counter increments whenever `early_stop_metric` fails to improve on
    its best, resets when it does, and the loop stops after the chunk in
    which the counter exceeds the patience. `early_stop_mode="below_tol"`
    is the notebook's EMA-slope monitor (iterative_eigenvalues cell
    1:233-237): the counter increments while |metric| < early_stop_tol
    and resets otherwise, and the best (for `track_params`) follows the
    loss. `track_params` (tensors updated in place by `step_fn`) are
    snapshotted after every step whose loss was the best so far, as the
    JAX loop's `best_state`.

    `start_epoch` offsets the epoch `step_fn` sees (a resumed run's
    ramps and schedules continue rather than replay); `epochs_run` and
    the history count this call's epochs. `chunk_callback(epochs_run)`
    (optional) runs on the host after every chunk, after its sync.
    """
    if early_stop_mode not in ("improve", "below_tol"):
        raise ValueError(f"early_stop_mode must be 'improve' or "
                         f"'below_tol', got '{early_stop_mode}'")
    best = torch.full((), float("inf"), device=device)
    patience = torch.zeros((), dtype=torch.int64, device=device)
    best_params = (None if track_params is None
                   else [p.detach().clone() for p in track_params])
    history: dict[str, list] = {}
    chunk_times = []
    epochs_run = 0
    stopped = False
    t0 = time.time()
    while epochs_run < n_epochs:
        t_chunk = time.time()
        length = min(chunk, n_epochs - epochs_run)
        rows = []
        for i in range(length):
            metrics = step_fn(start_epoch + epochs_run + i)
            val = metrics[early_stop_metric].detach()
            if early_stop_mode == "below_tol":
                loss_val = metrics.get("loss", val).detach()
                improved = loss_val < best
                best = torch.where(improved, loss_val, best)
                flat = val.abs() < early_stop_tol
                patience = torch.where(flat, patience + 1,
                                       torch.zeros_like(patience))
            else:
                improved = val < best
                best = torch.where(improved, val, best)
                patience = torch.where(improved, torch.zeros_like(patience),
                                       patience + 1)
            if best_params is not None:
                with torch.no_grad():
                    for b, p in zip(best_params, track_params):
                        b.copy_(torch.where(improved, p, b))
            rows.append(torch.stack([v.detach().float()
                                     for v in metrics.values()]))
        names = list(metrics)
        block = torch.stack(rows).cpu().numpy()   # the chunk's one sync
        chunk_times.append((length, time.time() - t_chunk))
        for j, name in enumerate(names):
            history.setdefault(name, []).append(block[:, j])
        epochs_run += length
        if chunk_callback is not None:
            chunk_callback(epochs_run)
        if log_every and log_fn is not None:
            for e in range(epochs_run - length, epochs_run):
                if e % log_every == 0 or e == n_epochs - 1:
                    log_fn(e, {name: float(block[e - (epochs_run - length), j])
                               for j, name in enumerate(names)})
        if (early_stop_patience is not None
                and int(patience) > early_stop_patience):
            stopped = True
            break
    wall = time.time() - t0
    history = {k: np.concatenate(v) for k, v in history.items()}
    return LoopResult(history, epochs_run, wall, stopped, chunk_times,
                      best_params)
