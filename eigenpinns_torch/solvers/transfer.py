"""Per-level transfer-learning eigen refinement.

Port of `eigenpinns_tpu/solvers/transfer.py` (the mesh_downsampling /
transfer_learning / iterative_downsampling notebook family):
level-by-level training over a `Hierarchy` (against the joint multigrid
trainer) with

  * ONE shared `SimpleCorrector` carried across levels;
  * a learning rate of lr * decay**level, a fresh Adam per level;
  * layer FREEZING at finer levels (`freeze_schedule`, e.g. {2: 1, 3: 2}
    freezes the first 1, then 2, hidden layers): the frozen parameters
    are left out of the level's optimizer (`train.optim.adam_frozen`),
    as `optax.multi_transform` with `set_to_zero` leaves them;
  * the projection loss ||P^T U_f - U_c||^2 anchoring each level to the
    one below;
  * `level_<l>` checkpoints (`train.checkpoint.save_checkpoint`).

The loss reads the hierarchy's own operators: at k <= 32 the
`build_hierarchy(operator_format="auto")` levels are `RollingBanded`, and
`rayleigh_residual_orth` runs the rolling-band kernel with its fused Gram
forward and the kernel again backward. `TransferResult.level_params`
and `chunk_times` are additions: a CPU copy of the corrector's
state_dict after each level (what each `level_<l>` checkpoint saved) and
each level's chunk timings.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from eigenpinns_torch.losses.losses import projection, rayleigh_residual_orth
from eigenpinns_torch.models.correctors import SimpleCorrector
from eigenpinns_torch.solvers.multigrid import _level_features
from eigenpinns_torch.solvers.rayleigh_ritz import (
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_torch.sparse.ops import (
    m_normalize_columns,
    neighbor_mean_operator,
)
from eigenpinns_torch.train.checkpoint import save_checkpoint
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import adam_frozen


@dataclasses.dataclass
class TransferResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    level_eigenvalues: list
    histories: list
    level_params: list      # state_dict (CPU) after each trained level
    chunk_times: list       # [(n_epochs, seconds)] per chunk, per level


def train_per_level(
    h,                      # Hierarchy
    n_modes: int,
    hidden=(64, 64, 64),
    epochs_per_level: int = 1500,
    scan_chunk: int = 250,
    lr: float = 1e-3,
    lr_level_decay: float = 0.7,
    corrector_scale: float = 1.0,
    w_res: float = 100.0,
    w_orth: float = 10.0,
    w_proj: float = 1.0,
    freeze_schedule: dict | None = None,
    checkpoint_dir: str = "",
    seed: int = 0,
    init_params: dict | None = None,
) -> TransferResult:
    """Refine eigenvectors level by level with a shared corrector, on the
    hierarchy's device. `init_params` (a `SimpleCorrector` state_dict)
    replaces the seeded initialization."""
    freeze_schedule = freeze_schedule or {}
    device = h.device
    model = None

    U_prev = h.U_list[0]
    with torch.no_grad():
        lam_prev, _ = rayleigh_ritz(U_prev, h.K_ops[0], h.M_ops[0])
    level_lams = [lam_prev.cpu().numpy()]
    histories, level_params, chunk_times = [], [], []

    for level in range(1, h.n_levels):
        K, M = h.K_ops[level], h.M_ops[level]
        Pt = h.Pt_ops[level - 1]
        with torch.no_grad():
            U_init = m_normalize_columns(h.U_list[level], M)
            U_coarse = m_normalize_columns(U_prev, h.M_ops[level - 1])
            feats = _level_features(
                h.X_list[level], U_init, lam_prev, h.edge_index_list[level],
                K, M, level, h.n_levels)
        edges = neighbor_mean_operator(h.edge_index_list[level],
                                       h.actual_hierarchy[level], device)
        if model is None:
            # The feature width (9 + k) is the same at every level, so
            # the shared weights carry over without partial-copy surgery.
            model = SimpleCorrector(feats.shape[1], tuple(hidden),
                                    n_modes).to(device)
            if init_params is not None:
                model.load_state_dict(init_params)
            else:
                model.reset_parameters(
                    torch.Generator(device).manual_seed(seed))
        params = list(model.parameters())
        opt = adam_frozen(model.named_parameters(),
                          lr * (lr_level_decay ** level),
                          int(freeze_schedule.get(level, 0)))

        def step(epoch: int):
            corr = model(feats, edges)
            U_pred = U_init + corrector_scale * corr
            lam, res, orth = rayleigh_residual_orth(U_pred, K, M)
            proj = projection(U_pred, Pt, U_coarse)
            total = w_res * res + w_orth * orth + w_proj * proj
            for p in params:
                p.grad = None
            total.backward()
            opt.step()
            return {"loss": total.detach(), "res": res.detach(),
                    "orth": orth.detach(), "proj": proj.detach()}

        result = run_chunked_loop(step, n_epochs=epochs_per_level,
                                  chunk=scan_chunk, device=device)
        histories.append(result.history)
        chunk_times.append(result.chunk_times)

        with torch.no_grad():
            U_pred = m_normalize_columns(
                U_init + corrector_scale * model(feats, edges), M)
            lam_prev, U_prev = rayleigh_ritz(U_pred, K, M)
        level_lams.append(lam_prev.cpu().numpy())
        state = {name: t.detach().cpu().clone()
                 for name, t in model.state_dict().items()}
        level_params.append(state)
        if checkpoint_dir:
            save_checkpoint(os.path.join(checkpoint_dir, f"level_{level}"),
                            {"params": state,
                             "lambda_refined": level_lams[-1]})

    with torch.no_grad():
        vals, U = rayleigh_ritz_robust(U_prev, h.K_ops[-1], h.M_ops[-1])
    return TransferResult(
        eigenvalues=vals[:n_modes].cpu().numpy(),
        eigenvectors=U[:, :n_modes].cpu().numpy(),
        level_eigenvalues=level_lams,
        histories=histories,
        level_params=level_params,
        chunk_times=chunk_times,
    )
