"""Node-sharded multigrid corrector training — the distributed form of
the production pipeline.

Port of `eigenpinns_tpu/solvers/multigrid_sharded.py`.
`MultigridTrainer.train(h, n_devices=...)` swaps its single-device loss
for the one built here; preprocessing (CGC, features) and
postprocessing (extraction, Rayleigh-Ritz, polish) stay on the
single-device layout on every rank (K1 there). The layout of the loop:

  * every level l is row-sharded over the SAME data axis: per-l shard
    size per_l = roundup(ceil(n_l / n_dev), 128), so each rank owns
    [level 0 shard s | level 1 shard s | ...];
  * per-level K/M/graph SpMMs ride the halo-banded sharded SpMM (K4 on
    each rank's shard block, `parallel/sharded_banded.py`) with a
    per-level RCM order; levels whose post-RCM stencil cannot satisfy
    the one-neighbor halo fall back to an all-gather ELL SpMM
    (`_ag_ell_spmm`);
  * the corrector is applied PER LEVEL, which equals the single-device
    concatenated-graph apply: the hierarchy graph is block-diagonal and
    the MLP is row-local;
  * the projection terms apply the padded prolongation transpose as an
    all-gathered ELL;
  * k x k Grams and Rayleigh quotients are local partials + psum, taken
    by the losses from the levels' `FunctionOperator`s (`node_reduce`);
    their means run over the true rows (the JAX package's padded mean
    rescaled by n_pad_l / n_l);
  * parameters are replicated; the trainer averages their gradients
    over the data axis.

Corrections are masked to true rows, so padded rows carry exact zeros.
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.losses.losses import projection
from eigenpinns_torch.parallel.mesh import Mesh, shard_array
from eigenpinns_torch.parallel.sharded import (
    ShardedOperator,
    all_gather_spmm,
    psum,
)
from eigenpinns_torch.parallel.sharded_banded import (
    ShardedBanded,
    sharded_banded_spmm,
)
from eigenpinns_torch.solvers.multigrid import (
    corrector_scale,
    level_loss,
    loss_terms,
)
from eigenpinns_torch.sparse.banded import _round_up
from eigenpinns_torch.sparse.formats import SparseELL
from eigenpinns_torch.sparse.ops import (
    FunctionOperator,
    gcn_normalized_adjacency,
    neighbor_mean_scipy,
)


def _pad_csr(A, n_rows: int, n_cols: int):
    """Grow a CSR block to (n_rows, n_cols) with empty rows/cols."""
    A = A.tocsr()
    extra_rows = n_rows - A.shape[0]
    indptr = np.concatenate([A.indptr, np.full(extra_rows, A.indptr[-1])])
    return sp.csr_matrix((A.data, A.indices, indptr),
                         shape=(n_rows, n_cols))


def _ag_ell_spmm(A_csr, n_dev: int, per: int, mesh: Mesh):
    """All-gather ELL SpMM of a (possibly rectangular) sharded operator
    whose stencil breaks the one-neighbor halo invariant. Rows must
    already be padded to n_dev * per."""
    op = ShardedOperator.from_ell(
        SparseELL.from_scipy(A_csr, device="cpu", with_transpose=False),
        n_dev)
    if op.rows_per_dev != per:
        raise ValueError(f"{op.rows_per_dev} rows per shard, expected {per}")
    return all_gather_spmm(op, mesh)


def build_sharded_multigrid_loop(h, cfg, mesh: Mesh, model, feats, U_base,
                                 lam_target, graph_kind: str,
                                 max_bandwidth: int = 4096):
    """Shard the hierarchy and return loss_fn(epoch) -> (total, metrics).

    `feats` / `U_base` are the single-device concatenated arrays built by
    MultigridTrainer.train; they are re-laid-out here (per-level RCM
    perm + padding, this rank's rows). The loss mirrors the
    single-device per-level loss term by term."""
    n_dev, me, dev = mesh.axis_size(), mesh.axis_index(), mesh.device
    red = functools.partial(psum, mesh=mesh, axis="data")
    offsets, sizes = h.node_offsets, h.actual_hierarchy
    feats_np = feats.detach().cpu().numpy()
    u_np = U_base.detach().cpu().numpy()

    levels, perms, pers = [], [], []
    for i, (off, n_l) in enumerate(zip(offsets, sizes)):
        K_sp = h.K_scipy[i].tocsr()
        M_sp = h.M_scipy[i].tocsr()
        if graph_kind == "spectral":
            G_sp = gcn_normalized_adjacency(h.edge_index_list[i], n_l,
                                            device="cpu").to_scipy()
        else:
            G_sp = neighbor_mean_scipy(h.edge_index_list[i], n_l)

        # K picks the per-level RCM order; M and the graph reuse it so
        # the level's node data lives in ONE layout.
        try:
            opK, perm = ShardedBanded.from_scipy(
                K_sp, n_dev, max_bandwidth=max_bandwidth, shards=(me,),
                device=dev)
            spK = sharded_banded_spmm(opK, mesh)
            per, banded = opK.per, True
        except ValueError:
            perm = np.arange(n_l)
            per = _round_up(max(-(-n_l // n_dev), 1), 128)
            spK = _ag_ell_spmm(_pad_csr(K_sp, per * n_dev, per * n_dev),
                               n_dev, per, mesh)
            banded = False
        n_pad = per * n_dev
        perms.append(perm)
        pers.append(per)

        def _same_perm_spmm(A_sp):
            Ap = A_sp[perm][:, perm].tocsr()
            if banded:
                try:
                    opA, _ = ShardedBanded.from_scipy(
                        Ap, n_dev, reorder=False,
                        max_bandwidth=max_bandwidth, shards=(me,),
                        device=dev)
                    if opA.per == per:
                        return sharded_banded_spmm(opA, mesh)
                except ValueError:
                    pass
            return _ag_ell_spmm(_pad_csr(Ap, n_pad, n_pad), n_dev, per,
                                mesh)

        if (M_sp - sp.diags(M_sp.diagonal())).nnz == 0:
            d = np.zeros(n_pad, np.float32)
            d[:n_l] = M_sp.diagonal()[perm]
            d_l = shard_array(d, mesh, "data")

            def spM(u, _d=d_l):
                return _d[:, None] * u
        else:
            spM = _same_perm_spmm(M_sp)
        spG = _same_perm_spmm(G_sp)

        dK = np.zeros(n_pad, np.float32)
        dK[:n_l] = K_sp.diagonal()[perm]
        dM = np.zeros(n_pad, np.float32)
        dM[:n_l] = M_sp.diagonal()[perm]
        kw = dict(reduce=red, n=n_l, rows=(me * per, n_pad))

        def _local(a):
            a = a[off:off + n_l][perm]
            p = np.zeros((n_pad, a.shape[1]), a.dtype)
            p[:n_l] = a
            return shard_array(p, mesh, "data")

        mask = np.zeros((n_pad, 1), np.float32)
        mask[:n_l] = 1.0
        levels.append({
            "n": n_l,
            "K": FunctionOperator(spK, shard_array(dK, mesh, "data"), **kw),
            "M": FunctionOperator(spM, shard_array(dM, mesh, "data"), **kw),
            "G": FunctionOperator(spG, None),
            "feats": _local(feats_np), "U_base": _local(u_np),
            "mask": shard_array(mask, mesh, "data"),
        })

    # Prolongation transposes between consecutive levels, in the
    # per-level layouts (rows: coarse perm + pad, cols: fine perm + pad).
    Pt = [None] * len(levels)
    if cfg.weight_projection > 0:
        for i in range(1, len(levels)):
            Pt_sp = h.Pt_ops[i - 1].to_scipy().tocsr()
            Pt_p = Pt_sp[perms[i - 1]][:, perms[i]]
            Pt[i] = FunctionOperator(
                _ag_ell_spmm(_pad_csr(Pt_p, pers[i - 1] * n_dev,
                                      pers[i] * n_dev),
                             n_dev, pers[i - 1], mesh),
                None, reduce=red, n=sizes[i - 1])

    def loss_fn(epoch: int):
        scale = corrector_scale(cfg, epoch)
        zero = torch.zeros((), device=dev)
        loss_res, loss_orth, loss_proj = zero, zero, zero
        lam_levels, U_slices = [], []
        for i, lv in enumerate(levels):
            U_l = (lv["U_base"]
                   + scale * model(lv["feats"], lv["G"]) * lv["mask"])
            U_l, lam_l, res_l, orth_l, zm = level_loss(cfg, U_l, lv["K"],
                                                       lv["M"])
            U_slices.append(U_l)
            lam_levels.append(lam_l)
            loss_res = loss_res + res_l
            loss_orth = loss_orth + orth_l
            if zm is not None:
                loss_res = loss_res + zm
            if cfg.weight_projection > 0 and i >= 1:
                loss_proj = loss_proj + projection(U_l, Pt[i],
                                                   U_slices[i - 1])
        return loss_terms(cfg, loss_res, loss_orth, loss_proj,
                          lam_levels[0], lam_target, scale, dev)

    return loss_fn
