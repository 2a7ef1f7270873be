"""Node-sharded sparse operators and the port's collectives.

Port of `eigenpinns_tpu/parallel/sharded.py`. Operators and eigenvector
blocks are row-sharded over the mesh's data axis: rank i of the axis
holds rows [i per, (i + 1) per) of every node-indexed array (zero rows
pad the last shard). An SpMM needs remote U rows, obtained either by

  * `all_gather_spmm`: all-gather the (N, k) block each application;
  * `halo_spmm`: one ring step each way. With an RCM-ordered operator
    whose bandwidth fits in a shard, every nonzero column of shard s
    lives in shards {s - 1, s, s + 1}, so exchanging one neighbour block
    per side replaces the full gather.

k x k Gram / Rayleigh reductions are local partial matmuls + `psum`.

The three collectives are `torch.autograd.Function`s, each with its true
adjoint as its backward pass: the ring exchange sends the cotangents
back the other way and adds them to their owner's rows (what
`shard_map`'s AD does for the JAX ppermutes), the all-gather's backward
pass sums the cotangent over the axis and keeps this rank's rows, and
the psum's is a psum. Every rank's loss is the same function of psum'd
partials, so with these adjoints each rank's parameter gradient is its
share of world-size copies of the single-device gradient, and
`average_gradients` (the mean over the data axis) gives that gradient
exactly once.

PyTorch refuses a point-to-point send to its own rank: on an axis of one
rank the ring is a local copy (the JAX ppermute maps 0 -> 0 there). On
an axis of two, both neighbours are the same rank; the two messages to
it are matched in the order they are posted (NCCL) and by tag (gloo).
On a gloo mesh with CUDA tensors every collective copies through the
host (`Mesh.staged`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from eigenpinns_torch.parallel.mesh import Mesh


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---- the collectives -----------------------------------------------------

def _host(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.detach().cpu().contiguous() if mesh.staged else x.contiguous()


def _back(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return x.to(mesh.device) if mesh.staged else x


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    y = _host(x, mesh).clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    return _back(y, mesh)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Concatenate every rank's x along the rows, in axis order."""
    xs = _host(x, mesh)
    parts = [torch.empty_like(xs) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, xs, group=mesh.groups[axis])
    return _back(torch.cat(parts, dim=0), mesh)


def _ring(to_next: torch.Tensor, to_prev: torch.Tensor, mesh: Mesh,
          axis: str):
    """Send `to_next` to the next rank of the axis's ring and `to_prev`
    to the previous; returns (from_prev, from_next). One rank: a copy."""
    n = mesh.axis_size(axis)
    if n == 1:
        return to_next.clone(), to_prev.clone()
    ranks, i = mesh.axis_ranks[axis], mesh.axis_index(axis)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    group = mesh.groups[axis]
    a, b = _host(to_next, mesh), _host(to_prev, mesh)
    from_prev, from_next = torch.empty_like(a), torch.empty_like(b)
    ops = [dist.P2POp(dist.isend, a, nxt, group, 0),
           dist.P2POp(dist.isend, b, prv, group, 1),
           dist.P2POp(dist.irecv, from_prev, prv, group, 0),
           dist.P2POp(dist.irecv, from_next, nxt, group, 1)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _back(from_prev, mesh), _back(from_next, mesh)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return _all_gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        i, rows = ctx.mesh.axis_index(ctx.axis), ctx.rows
        total = _all_reduce(g, ctx.mesh, ctx.axis)
        return total[i * rows:(i + 1) * rows], None, None


class _RingExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, width, mesh, axis):
        ctx.mesh, ctx.axis, ctx.width, ctx.n_rows = mesh, axis, width, len(u)
        return _ring(u[-width:], u[:width], mesh, axis)

    @staticmethod
    def backward(ctx, g_left, g_right):
        w = ctx.width
        # g_left belongs to the previous rank's tail, g_right to the next
        # rank's head; what comes back is the cotangent of this rank's
        # head (from the previous rank) and tail (from the next).
        g_head, g_tail = _ring(g_right.contiguous(), g_left.contiguous(),
                               ctx.mesh, ctx.axis)
        du = torch.zeros((ctx.n_rows, g_left.shape[1]), dtype=g_left.dtype,
                         device=g_left.device)
        du[:w] += g_head
        du[-w:] += g_tail
        return du, None, None, None


def psum(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Sum of x over the ranks of `axis` (differentiable)."""
    return _Psum.apply(x, mesh, axis)


def all_gather(x: torch.Tensor, mesh: Mesh,
               axis: str = "data") -> torch.Tensor:
    """The rows of every rank of `axis`, concatenated in axis order
    (differentiable)."""
    return _AllGather.apply(x, mesh, axis)


def ring_exchange(u: torch.Tensor, width: int, mesh: Mesh,
                  axis: str = "data"):
    """(left, right): the previous rank's last `width` rows and the next
    rank's first `width` rows of u, on the axis's ring (differentiable)."""
    return _RingExchange.apply(u, width, mesh, axis)


def average_gradients(params, mesh: Mesh, axis: str = "data") -> None:
    """Replace each parameter's .grad with its mean over the ranks of
    `axis`, in one all-reduce of the flattened gradients."""
    params = [p for p in params if p.grad is not None]
    if not params:
        return
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    flat = _all_reduce(flat, mesh, axis) / mesh.axis_size(axis)
    off = 0
    for p in params:
        m = p.grad.numel()
        p.grad.copy_(flat[off:off + m].view_as(p.grad))
        off += m


def broadcast_(tensors, mesh: Mesh, axis: str = "data") -> None:
    """Overwrite `tensors` in place with the first rank's of `axis`."""
    tensors = list(tensors)
    flat = _host(torch.cat([t.detach().reshape(-1) for t in tensors]), mesh)
    dist.broadcast(flat, src=mesh.axis_ranks[axis][0],
                   group=mesh.groups[axis])
    flat = _back(flat, mesh)
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def gather_rows(u: torch.Tensor, mesh: Mesh, n: int | None = None,
                axis: str = "data") -> torch.Tensor:
    """Every rank's rows of u (no gradient), the first `n` of them."""
    with torch.no_grad():
        full = _all_gather(u.contiguous(), mesh, axis)
    return full if n is None else full[:n]


# ---- sharded ELL operators ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedOperator:
    """Row-sharded ELL operator prepared for an n-shard axis (host).

    indices/values: (n_dev, rows_per_dev, W) numpy — global column
    indices. n: true (unpadded) row count. Rows are padded with zero
    rows."""

    indices: np.ndarray
    values: np.ndarray
    n: int
    n_dev: int

    @classmethod
    def from_ell(cls, A, n_dev: int):
        """From a `SparseELL` (any device)."""
        idx = np.asarray(A.indices.cpu() if isinstance(A.indices,
                                                        torch.Tensor)
                         else A.indices)
        val = np.asarray(A.values.float().cpu()
                         if isinstance(A.values, torch.Tensor)
                         else A.values, dtype=np.float32)
        n, w = idx.shape
        n_pad = _round_up(n, n_dev)
        idx = np.pad(idx, ((0, n_pad - n), (0, 0)))
        val = np.pad(val, ((0, n_pad - n), (0, 0)))
        per = n_pad // n_dev
        return cls(idx.reshape(n_dev, per, w), val.reshape(n_dev, per, w),
                   n, n_dev)

    @property
    def rows_per_dev(self) -> int:
        return self.indices.shape[1]

    def local(self, mesh: Mesh, axis: str = "data", dtype=torch.float32):
        """This rank's (indices, values) on the mesh's device."""
        if self.n_dev != mesh.axis_size(axis):
            raise ValueError(f"operator for {self.n_dev} shards on an axis "
                             f"of {mesh.axis_size(axis)}")
        i = mesh.axis_index(axis)
        return (torch.as_tensor(self.indices[i], dtype=torch.int64,
                                device=mesh.device),
                torch.as_tensor(self.values[i], dtype=dtype,
                                device=mesh.device))


def local_gather_spmm(idx: torch.Tensor, val: torch.Tensor,
                      u_full: torch.Tensor) -> torch.Tensor:
    """Rows of A U from this rank's ELL rows and the U rows they index."""
    return torch.einsum("rwk,rw->rk", u_full[idx], val.to(u_full.dtype))


def all_gather_spmm(op: ShardedOperator, mesh: Mesh, axis: str = "data"):
    """Build f(U local rows) -> (A U) local rows, via all-gather of U."""
    idx, val = op.local(mesh, axis)

    def apply(u):
        return local_gather_spmm(idx, val, all_gather(u, mesh, axis))

    return apply


def halo_spmm(op: ShardedOperator, mesh: Mesh, axis: str = "data"):
    """Build f(U local rows) -> (A U) local rows, via a one-neighbour
    ring exchange of whole shards. Requires every nonzero column of shard
    s to fall within shards s - 1 .. s + 1 (checked at build)."""
    per = op.rows_per_dev
    shard_of_col = op.indices // per
    shard_ids = np.arange(op.n_dev)[:, None, None]
    # ELL zero-padding entries point at column 0 with value 0: only real
    # entries constrain the stencil.
    bad = (np.abs(shard_of_col - shard_ids) > 1) & (op.values != 0)
    if bad.any():
        raise ValueError(
            "operator stencil crosses non-neighbor shards; reorder with "
            "RCM / use all_gather_spmm")
    idx, val = op.local(mesh, axis)
    me = mesh.axis_index(axis)
    # Global column -> window row: col - (me - 1) * per.
    local_idx = torch.clamp(idx - (me - 1) * per, 0, 3 * per - 1)

    def apply(u):
        left, right = ring_exchange(u, per, mesh, axis)
        window = torch.cat([left, u, right], dim=0)     # (3 per, k)
        return local_gather_spmm(local_idx, val, window)

    return apply


def psum_gram(mesh: Mesh, axis: str = "data"):
    """Build g(U local, V local) -> the full k x k Gram U^T V: a local
    matmul and a psum over the axis."""

    def apply(u, v):
        return psum(u.T @ v, mesh, axis)

    return apply


def pad_rows(x, n_dev: int):
    """Pad the row axis to a multiple of n_dev; returns (padded, n)."""
    n = x.shape[0]
    pad = _round_up(n, n_dev) - n
    if isinstance(x, torch.Tensor):
        return torch.nn.functional.pad(x, (0, 0, 0, pad)), n
    return np.pad(x, ((0, pad), (0, 0))), n
