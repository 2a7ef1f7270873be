"""Parameter surgery: partial weight copy across architecture changes.

Port of `eigenpinns_tpu/models/surgery.py`
(iterative_downsampling_continued.ipynb cell 0:283-296) on `state_dict`s:
when a network is re-instantiated with another input or output width,
the overlapping slice of every leaf with a matching name is copied so
training resumes from the transferred weights. A torch Linear weight is
(out, in) and a flax kernel (in, out), so the overlap is the same block,
transposed.
"""

from __future__ import annotations

import torch


def partial_weight_copy(old_params: dict, new_params: dict) -> dict:
    """Copy the overlapping hyper-rectangle of every leaf of `old_params`
    into the leaf of the same name in `new_params` (same number of
    dimensions; the new values stay elsewhere). Returns a new dict; the
    arguments are not modified."""
    out = {}
    for name, leaf in new_params.items():
        src = old_params.get(name)
        if src is None or src.dim() != leaf.dim():
            out[name] = leaf
            continue
        slices = tuple(slice(0, min(a, b))
                       for a, b in zip(src.shape, leaf.shape))
        merged = leaf.detach().clone()
        merged[slices] = src.detach()[slices].to(merged)
        out[name] = merged
    return out
