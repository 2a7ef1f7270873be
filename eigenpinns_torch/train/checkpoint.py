"""Checkpoint / resume on `torch.save`.

Port of `eigenpinns_tpu/train/checkpoint.py` (the reference checkpoints
from notebooks only: `torch.save({model_state, lambda_refined},
checkpoints/level_{l}_ckpt.pt)`, iterative_downsampling_continued.ipynb
cell 0:318-324). A tree of nested dicts, lists and tuples whose leaves
are tensors, numpy arrays or Python scalars is saved as ONE file at
`path`: every array leaf is written as a CPU tensor to a temporary file
in the same directory, which then replaces `path` (`os.replace`), so a
reader sees the old checkpoint or the new one, never a torn file.
Loading unpickles tensors and primitives only (`weights_only=True`).

Deviation: orbax's on-disk layout (a directory per checkpoint) is not
reproduced. The machine with the card has no orbax, and nothing reads a
checkpoint of one package with the other.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable

import numpy as np
import torch


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _tree_map(fn, value, *(r[key] for r in rest))
                for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, value, *(r[i] for r in rest))
                          for i, value in enumerate(tree))
    return fn(tree, *rest)


def _to_saved(leaf: Any) -> Any:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone()
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, np.generic):
        return torch.as_tensor(np.array(leaf))
    return leaf


def _like(saved: Any, target: Any) -> Any:
    """A restored leaf with the dtype, shape and kind of `target`."""
    if isinstance(target, torch.Tensor):
        value = torch.as_tensor(saved)
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"checkpoint leaf {tuple(value.shape)} does "
                             f"not match the target {tuple(target.shape)}")
        return value.to(dtype=target.dtype, device=target.device)
    if isinstance(target, np.ndarray):
        value = torch.as_tensor(saved).numpy()
        if value.shape != target.shape:
            raise ValueError(f"checkpoint leaf {value.shape} does not match "
                             f"the target {target.shape}")
        return value.astype(target.dtype)
    if isinstance(target, np.generic):
        return target.dtype.type(torch.as_tensor(saved).item())
    return type(target)(saved) if isinstance(target, (int, float)) else saved


def save_checkpoint(path: str, tree: Any) -> str:
    """Save a tree atomically at `path`; returns the absolute path."""
    path = os.path.abspath(path)
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_tree_map(_to_saved, tree), f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def restore_checkpoint(path: str, target: Any | None = None) -> Any:
    """Restore a tree; `target` (a tree of the same structure) fixes each
    leaf's kind, dtype, shape and device, else array leaves come back as
    CPU tensors."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    if target is None:
        return saved
    return _tree_map(lambda t, s: _like(s, t), target, saved)


def latest_checkpoint(directory: str, prefix: str = "step_") -> str | None:
    """Most recent `<prefix><n>` checkpoint under `directory`."""
    if not os.path.isdir(directory):
        return None
    best, best_n = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix):
            try:
                n = int(name[len(prefix):])
            except ValueError:
                continue
            if n > best_n:
                best, best_n = os.path.join(directory, name), n
    return best


class TrainCheckpointer:
    """Step-indexed checkpoint/resume for training loops.

    save(step, tree) writes `<dir>/step_<n>`; restore_latest() returns
    (step, tree) of the newest checkpoint or (None, None).
    """

    def __init__(self, directory: str, prefix: str = "step_"):
        self.directory = os.path.abspath(directory)
        self.prefix = prefix
        os.makedirs(self.directory, exist_ok=True)

    def save(self, step: int, tree: Any) -> str:
        return save_checkpoint(
            os.path.join(self.directory, f"{self.prefix}{step}"), tree)

    def restore_latest(self, target: Any | None = None):
        path = latest_checkpoint(self.directory, self.prefix)
        if path is None:
            return None, None
        step = int(os.path.basename(path)[len(self.prefix):])
        return step, restore_checkpoint(path, target)
