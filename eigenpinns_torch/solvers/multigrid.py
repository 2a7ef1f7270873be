"""Multigrid GNN eigen-refinement trainer — the production pipeline.

Port of the single-device path of `eigenpinns_tpu/solvers/multigrid.py`
(capability parity with `MultigridGNN.train_multiresolution`,
src/multigrid_model.py:42-92):

CGC init -> M-normalize -> physics features -> corrector training
(residual + Gram + spectral-structure losses, with all levels fused
into one block-diagonal rolling-band SpMM) -> per-level normalization
-> finest-level robust Rayleigh-Ritz -> optional guarded LOBPCG polish.

Everything runs on the hierarchy's device. The hooks of the JAX
trainer: `cfg.checkpoint_dir` resumes from the newest checkpoint there
(parameters, Adam and plateau state; the epoch counter continues, so the
corrector-scale ramp does not replay) and saves one after the run;
`cfg.profile_dir` writes a torch.profiler trace of the training loop;
`eval_callback(epochs_run, U_finest)` sees the M-normalized finest-level
prediction after every chunk; `cfg.timing_chunks` runs the loop's
throughput probe (`steady_steps_per_sec`). `mesh` / `n_devices` (or a
nonempty `cfg.mesh_shape`) run the training loop node-sharded
(`solvers/multigrid_sharded.py`) on every rank of an initialized
`torch.distributed` group; pre- and postprocessing stay on the
single-device layout on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings

import numpy as np
import torch

from eigenpinns_torch.losses.losses import (
    eigenvalue_target,
    ordering,
    projection,
    rayleigh_residual_orth,
    trace_loss,
    zero_mean,
)
from eigenpinns_torch.models.correctors import make_corrector
from eigenpinns_torch.solvers.lobpcg import lobpcg
from eigenpinns_torch.solvers.rayleigh_ritz import (
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_torch.solvers.smoothers import coarse_grid_correction
from eigenpinns_torch.sparse.ops import (
    gcn_normalized_adjacency,
    m_normalize_columns,
    neighbor_mean_operator,
    spmm,
)
from eigenpinns_torch.train.checkpoint import TrainCheckpointer
from eigenpinns_torch.train.loop import module_state_fns, run_chunked_loop
from eigenpinns_torch.train.optim import AdamPlateau
from eigenpinns_torch.utils.profiling import trace


@dataclasses.dataclass
class MultigridResult:
    eigenvalues: np.ndarray       # (k,) refined finest-level eigenvalues
    eigenvectors: np.ndarray      # (N_finest, k) refined
    U_all: np.ndarray             # (sum N_l, k) normalized predictions
    history: dict
    epochs_run: int
    wall_time: float              # training loop wall time (s)
    level_eigenvalues: list[np.ndarray]
    chunk_times: list
    polish_time: float = 0.0      # final extraction + polish wall (s)
    polish_iterations: int = 0
    steady_steps_per_sec: float | None = None  # cfg.timing_chunks probe


def _level_features(X, U_norm, lam, edge_index, K, M, level_idx, n_levels):
    """Physics-informed node features (src/multigrid_model.py:159-201):
    [xyz, level indicator, normalized degree, diag K, diag M, residual
    magnitude, per-node Rayleigh, U_norm] -> (N, 9 + k)."""
    n = X.shape[0]
    dt, dev = U_norm.dtype, U_norm.device
    X_t = torch.as_tensor(X, dtype=dt, device=dev)
    res_feat = torch.full((n, 1), float(n_levels - 1 - level_idx), dtype=dt,
                          device=dev)
    deg = np.bincount(np.asarray(edge_index[0]), minlength=n).astype(
        np.float64)
    deg_feat = torch.as_tensor(deg / (deg.max() + 1e-12), dtype=dt,
                               device=dev)[:, None]
    Ku = spmm(K, U_norm)
    Mu = spmm(M, U_norm)
    res_mag = torch.linalg.vector_norm(Ku - Mu * lam[None, :], dim=1,
                                       keepdim=True)
    res_mag = res_mag / (res_mag.max() + 1e-12)
    rayleigh = ((U_norm * Ku).sum(1, keepdim=True)
                / ((U_norm * Mu).sum(1, keepdim=True) + 1e-12))
    rayleigh = rayleigh / (lam.max() + 1e-12)
    return torch.cat([X_t, res_feat, deg_feat, K.diagonal()[:, None],
                      M.diagonal()[:, None], res_mag, rayleigh, U_norm],
                     dim=1)


def corrector_scale(cfg, epoch: int) -> float:
    """The ramped corrector scale at `epoch` (fp32, as the JAX trainer)."""
    ramp = min(np.float32(1.0),
               np.float32(epoch) / np.float32(cfg.scale_ramp_epochs))
    return float(np.float32(cfg.corrector_scale) * ramp)


def level_loss(cfg, U_l, K, M):
    """One level's terms of the per-level loss: (U_l, M-normalized with
    `normalize_in_loss`, lam, residual, orthogonality, the weighted
    zero-mean term or None). The sums over the level's rows come from the
    operators (`node_reduce`), so a sharded level takes the same code."""
    if cfg.normalize_in_loss:
        U_l = m_normalize_columns(U_l, M)
    lam, res, orth = rayleigh_residual_orth(U_l, K, M)
    zm = None
    if cfg.w_zero_mean > 0:
        zm = (cfg.w_zero_mean / cfg.weight_residual) * zero_mean(U_l, M)
    return U_l, lam, res, orth, zm


def loss_terms(cfg, loss_res, loss_orth, loss_proj, lam0, lam_target,
               scale: float, device):
    """(total, metrics) from the summed level terms and level 0's
    eigenvalues (src/multigrid_model.py:326-348)."""
    terms = {
        "res": cfg.weight_residual * loss_res,
        "orth": cfg.weight_orthogonal * loss_orth,
        "proj": cfg.weight_projection * loss_proj,
        "trace": cfg.weight_trace * trace_loss(lam0),
        "order": cfg.w_order * ordering(lam0),
        "eigen": cfg.w_eigen * eigenvalue_target(lam0, lam_target),
    }
    total = (terms["res"] + terms["orth"] + terms["proj"]
             + terms["trace"] + terms["order"] + terms["eigen"])
    return total, {"loss": total, **terms,
                   "scale": torch.full((), scale, device=device)}


class MultigridTrainer:
    """Drives corrector training over a preprocessed Hierarchy."""

    def __init__(self, config):
        self.cfg = config
        if config.model_type.lower() not in ("simple", "spectral",
                                             "adaptive"):
            raise ValueError(
                f"model_type must be 'simple', 'spectral' or 'adaptive', "
                f"got '{config.model_type}'")

    def _init_cgc(self, h):
        """CGC on every fine level + eigenvalue estimates
        (src/multigrid_model.py:99-118)."""
        U_cgc = [h.U_list[0]]
        lam_list = []
        for i in range(1, h.n_levels):
            U_c, lam_f = coarse_grid_correction(
                h.U_list[i], h.K_ops[i], h.M_ops[i], h.K_ops[i - 1],
                h.P_ops[i - 1], h.Pt_ops[i - 1])
            U_cgc.append(U_c)
            lam_list.append(lam_f)
        lam_list.insert(0, rayleigh_ritz(h.U_list[0], h.K_ops[0],
                                         h.M_ops[0])[0])
        return U_cgc, lam_list

    def _build_features(self, h, U_norm_list, lam_list):
        return torch.cat([
            _level_features(h.X_list[i], U_norm_list[i], lam_list[i],
                            h.edge_index_list[i], h.K_ops[i], h.M_ops[i],
                            i, h.n_levels)
            for i in range(h.n_levels)], dim=0)

    def train(self, h, log_fn=None, eval_callback=None, mesh=None,
              n_devices=None, init_params=None,
              guard_block=None) -> MultigridResult:
        """Train the corrector over the hierarchy, on its device.

        `init_params` (a state_dict of the corrector) replaces the seeded
        initialization and `guard_block` ((N_finest, polish_guard)
        array) the seeded polish guard vectors — the hooks that let a
        test feed both packages the same values. `mesh` / `n_devices`
        (or `cfg.mesh_shape`, its product the data axis) run the loop
        sharded; the hierarchy must then be on the mesh's device.
        """
        cfg = self.cfg
        k = cfg.n_modes
        device = h.device
        if mesh is None and n_devices is None and cfg.mesh_shape:
            n_devices = int(np.prod(cfg.mesh_shape))
        sharded = mesh is not None or n_devices is not None
        if sharded:
            from eigenpinns_torch.solvers.direct_sharded import resolve_mesh

            mesh = resolve_mesh(mesh, n_devices, device)
            if mesh.device != device:
                raise ValueError(f"the hierarchy is on {device}, the mesh "
                                 f"on {mesh.device}")

        with torch.no_grad():
            U_cgc, lam_list = self._init_cgc(h)
            U_norm_list = [m_normalize_columns(U, M)
                           for U, M in zip(U_cgc, h.M_ops)]
            U_base = torch.cat(U_norm_list, dim=0)
            feats = self._build_features(h, U_norm_list, lam_list)
        offsets, sizes = h.node_offsets, h.actual_hierarchy
        edges_np = np.concatenate(
            [np.asarray(e) + offsets[i]
             for i, e in enumerate(h.edge_index_list)], axis=1)
        n_total = feats.shape[0]

        model = make_corrector(cfg.model_type, feats.shape[1],
                               cfg.hidden_layers, k, cfg.dropout,
                               compute_dtype=(cfg.corrector_compute_dtype
                                              or None)).to(device)
        if init_params is not None:
            model.load_state_dict(init_params)
        else:
            model.reset_parameters(
                torch.Generator(device).manual_seed(cfg.seed))
        if cfg.model_type.lower() == "spectral":
            graph = gcn_normalized_adjacency(edges_np, n_total, device)
        else:
            graph = neighbor_mean_operator(edges_np, n_total, device)
        params = list(model.parameters())
        opt = AdamPlateau(params, cfg.learning_rate, cfg.weight_decay,
                          cfg.gradient_clipping, cfg.plateau_factor,
                          cfg.plateau_patience)

        def _loss_op(op):
            # The loss SpMMs use cfg.loss_mxu_precision; features, CGC,
            # Rayleigh-Ritz and the polish keep 'highest'.
            if hasattr(op, "with_precision"):
                return op.with_precision(cfg.loss_mxu_precision)
            return op

        if sharded and cfg.fuse_level_ops:
            # The sharded loss has no fused block-diagonal path: each
            # level rides its own layout and halo-banded SpMM.
            warnings.warn(
                "fuse_level_ops=True: the sharded multigrid trainer has "
                "no fused block-diagonal path; training proceeds with "
                "per-level halo-banded dispatches (numerically identical "
                "loss)", stacklevel=2)
        use_fused = (not sharded and cfg.fuse_level_ops is not False
                     and h.n_levels > 1)
        if sharded:
            from eigenpinns_torch.parallel.sharded import (
                average_gradients,
                broadcast_,
            )
            from eigenpinns_torch.solvers.multigrid_sharded import (
                build_sharded_multigrid_loop,
            )

            broadcast_(params, mesh)
            sharded_loss = build_sharded_multigrid_loop(
                h, cfg, mesh, model, feats, U_base, lam_list[0],
                graph_kind=cfg.model_type.lower())
        elif use_fused:
            K_blk, M_blk = h.fused_level_ops(dtype=U_base.dtype)
            K_blk, M_blk = _loss_op(K_blk), _loss_op(M_blk)
        else:
            K_loss = [_loss_op(o) for o in h.K_ops]
            M_loss = [_loss_op(o) for o in h.M_ops]
        eye = torch.eye(k, dtype=U_base.dtype, device=device)
        lam_target = lam_list[0]

        def loss_fn(epoch: int):
            corr_raw = model(feats, graph)
            scale = corrector_scale(cfg, epoch)
            U_pred = U_base + scale * corr_raw
            zero = U_pred.new_zeros(())
            loss_res, loss_orth, loss_proj = zero, zero, zero
            lam_levels, U_slices = [], []
            if use_fused:
                Ku_all = spmm(K_blk, U_pred)
                Mu_all = spmm(M_blk, U_pred)
            for i, (off, n) in enumerate(zip(offsets, sizes)):
                U_l = U_pred[off:off + n]
                if use_fused:
                    Ku, Mu = Ku_all[off:off + n], Mu_all[off:off + n]
                    if cfg.normalize_in_loss:
                        # m_normalize_columns by linearity: K(U/c) = (KU)/c
                        c = torch.sqrt((U_l * Mu).sum(0) + 1e-12)
                        U_l, Ku, Mu = U_l / c, Ku / c, Mu / c
                    U_slices.append(U_l)
                    Gm = U_l.T @ Mu
                    lam_l = (U_l * Ku).sum(0) / (torch.diagonal(Gm) + 1e-12)
                    res = Ku - Mu * lam_l[None, :]
                    loss_res = loss_res + (res**2).mean()
                    loss_orth = loss_orth + ((Gm - eye) ** 2).sum() / k
                    lam_levels.append(lam_l)
                    if cfg.w_zero_mean > 0:
                        # zero_mean by symmetry: (M 1)^T U = 1^T (M U)
                        moments = Mu.sum(0)[1:]
                        loss_res = loss_res + (cfg.w_zero_mean
                                               / cfg.weight_residual
                                               ) * (moments**2).sum()
                else:
                    U_l, lam_l, res_l, orth_l, zm = level_loss(
                        cfg, U_l, K_loss[i], M_loss[i])
                    U_slices.append(U_l)
                    lam_levels.append(lam_l)
                    loss_res = loss_res + res_l
                    loss_orth = loss_orth + orth_l
                    if zm is not None:
                        loss_res = loss_res + zm
                if cfg.weight_projection > 0 and i >= 1:
                    loss_proj = loss_proj + projection(
                        U_l, h.Pt_ops[i - 1], U_slices[i - 1])
            return loss_terms(cfg, loss_res, loss_orth, loss_proj,
                              lam_levels[0], lam_target, scale, device)

        def step(epoch: int):
            for p in params:
                p.grad = None
            total, metrics = (sharded_loss if sharded else loss_fn)(epoch)
            total.backward()
            if sharded:
                average_gradients(params, mesh)
            opt.step(total)
            return metrics

        # Resume from the newest checkpoint when a checkpoint_dir is set;
        # the epoch counter continues so that the corrector-scale ramp
        # does not replay.
        ckptr, epoch0 = None, 0
        if cfg.checkpoint_dir:
            ckptr = TrainCheckpointer(cfg.checkpoint_dir)
            prev_step, prev = ckptr.restore_latest(
                target=self._train_state(model, opt))
            if prev is not None:
                with torch.no_grad():
                    for p, v in zip(params, prev["params"]):
                        p.copy_(v)
                opt.load_state_dict(prev["opt"])
                epoch0 = int(prev_step)

        chunk_cb = None
        if eval_callback is not None:
            off_f, n_f = offsets[-1], sizes[-1]

            def chunk_cb(epochs_run):
                with torch.no_grad():
                    U_f = (U_base + cfg.corrector_scale
                           * model(feats, graph))[off_f:off_f + n_f]
                    eval_callback(epochs_run,
                                  m_normalize_columns(U_f, h.M_ops[-1]))

        with (trace(cfg.profile_dir) if cfg.profile_dir
              else contextlib.nullcontext()):
            result = run_chunked_loop(
                step, n_epochs=cfg.epochs, chunk=cfg.scan_chunk,
                early_stop_patience=cfg.early_stop_patience,
                log_every=cfg.log_every,
                log_fn=log_fn or (self._default_log if cfg.verbose
                                  else None),
                track_params=params if cfg.track_best else None,
                device=device, start_epoch=epoch0,
                chunk_callback=chunk_cb, timing_chunks=cfg.timing_chunks,
                state_fns=module_state_fns(params, opt))
        if ckptr is not None:
            # Replicated parameters: one writer, and the checkpoint does
            # not depend on the mesh.
            if not sharded or torch.distributed.get_rank() == 0:
                ckptr.save(epoch0 + result.epochs_run,
                           self._train_state(model, opt))
            if sharded:
                torch.distributed.barrier()
        t_polish = time.time()
        with torch.no_grad():
            if cfg.track_best:
                for p, b in zip(params, result.best_params):
                    p.copy_(b)
            U_pred = U_base + cfg.corrector_scale * model(feats, graph)
            U_levels, lam_levels = [], []
            for off, n, K, M in zip(offsets, sizes, h.K_ops, h.M_ops):
                U_l = m_normalize_columns(U_pred[off:off + n], M)
                U_levels.append(U_l)
                lam_levels.append(rayleigh_ritz(U_l, K, M)[0].cpu().numpy())
            U_all = torch.cat(U_levels, dim=0)

            # Finest-level extraction + Rayleigh-Ritz
            # (src/multigrid_model.py:452-475).
            vals, U_ref = rayleigh_ritz_robust(U_levels[-1], h.K_ops[-1],
                                               h.M_ops[-1])
            vals, U_ref = vals[:k], U_ref[:, :k]
            iters = 0
            if cfg.polish_iters > 0:
                # A few LOBPCG iterations warm-started from the learned
                # subspace, padded with guard vectors (the edge mode of a
                # LOBPCG block converges far more slowly).
                g = int(cfg.polish_guard)
                X0 = U_ref
                if g > 0:
                    if guard_block is None:
                        extra = torch.randn(
                            (U_ref.shape[0], g), dtype=U_ref.dtype,
                            device=device,
                            generator=torch.Generator(device).manual_seed(
                                cfg.seed + 7))
                    else:
                        extra = torch.as_tensor(np.array(guard_block),
                                                dtype=U_ref.dtype,
                                                device=device)
                    X0 = torch.cat([U_ref, extra], dim=1)
                res = lobpcg(h.K_ops[-1], h.M_ops[-1], X0, k=k + g,
                             max_iter=cfg.polish_iters, tol=1e-7)
                vals, U_ref = res.eigenvalues[:k], res.eigenvectors[:, :k]
                iters = int(res.iterations)
            vals = vals.cpu().numpy()
            U_ref = U_ref.cpu().numpy()
            U_all = U_all.cpu().numpy()
        return MultigridResult(
            eigenvalues=vals, eigenvectors=U_ref, U_all=U_all,
            history=result.history, epochs_run=result.epochs_run,
            wall_time=result.wall_time, level_eigenvalues=lam_levels,
            chunk_times=result.chunk_times,
            polish_time=time.time() - t_polish, polish_iterations=iters,
            steady_steps_per_sec=result.steady_rate)

    @staticmethod
    def _train_state(model, opt) -> dict:
        """The checkpointed training state: the corrector's parameters
        (in `model.parameters()` order) and the optimizer's state."""
        return {"params": [p.detach() for p in model.parameters()],
                "opt": opt.state_dict()}

    @staticmethod
    def _default_log(epoch, metrics):
        print(
            f"Epoch {epoch:5d}: Loss={metrics['loss']:.6f} | "
            f"Res={metrics['res']:.6f} | Orth={metrics['orth']:.6f} | "
            f"Proj={metrics['proj']:.6f} | Trace={metrics['trace']:.6f} | "
            f"Order={metrics['order']:.6f} | Eigen={metrics['eigen']:.6f} | "
            f"Scale={metrics['scale']:.4f}")
