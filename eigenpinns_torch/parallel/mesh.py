"""Process-group meshes, shardings and the rank launcher.

Port of `eigenpinns_tpu/parallel/mesh.py`. The JAX package runs one
controller over a `jax.sharding.Mesh`: GSPMD inserts the collectives and
`shard_map` the ppermutes. The port follows PyTorch's idiom instead,
SPMD with one process per device: every sharded entry point is called
on every rank of an initialized `torch.distributed` group with the same
host inputs, each rank holds its block of rows of every node-indexed
array, and every rank returns the same result. A `Mesh` is this rank's
view of the group: the mesh's shape, this rank's coordinates in it, and
one process group per axis (the ranks that differ only along that axis),
so that a collective addresses its named axis only.

Backends: NCCL on the card, one rank per device; gloo on the CPU and,
when the caller asks for it, for several ranks that share one card
(NCCL refuses two ranks on one device). Gloo moves only CPU tensors for
all-gather and send/recv, so the collectives of `sharded.py` copy a CUDA
tensor to the host and back on a gloo mesh. Nothing here chooses a
backend or a device by what it finds: `spawn` runs on the cards unless
asked for the CPU (NCCL for one rank a card, gloo for the CPU or for
ranks that share one card), raises when asked for a card that is not
there, and `make_mesh` raises without an initialized group.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of an n-dimensional mesh of ranks.

    `coords` are this rank's coordinates (ranks laid out row-major over
    `shape`, as `np.reshape` lays out JAX's devices); `axis_ranks[a]`
    the global ranks along axis a through this rank, in axis order;
    `groups[a]` their process group; `device` this rank's device."""

    shape: tuple
    axis_names: tuple
    coords: tuple
    axis_ranks: dict
    groups: dict
    device: torch.device
    backend: str

    def axis_size(self, axis: str = "data") -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str = "data") -> int:
        return self.coords[self.axis_names.index(axis)]

    @property
    def staged(self) -> bool:
        """Collectives copy through the host (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where an array lives on a mesh: row-sharded over `axis`, or
    replicated (`axis` None). The port's stand-in for `NamedSharding`."""

    mesh: Mesh
    axis: str | None


def make_mesh(n_devices: int | None = None, axis_names=("data",),
              shape=None, device_type: str = "cuda") -> Mesh:
    """The mesh over the initialized `torch.distributed` group: all its
    ranks (`n_devices`, when given, must be the world size), shaped
    `shape` (default: one axis). `device_type` 'cuda' puts this rank on
    the current CUDA device, 'cpu' on the host. Every rank must call it,
    in the same order as its other collectives: it creates one process
    group for every line of ranks along every axis."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "the sharded path runs on every rank of an initialized "
            "torch.distributed group (parallel.mesh.spawn, or torchrun); "
            "none is initialized")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"the mesh takes every rank of the group: "
                         f"n_devices {n_devices} != world size {world}")
    shape = tuple(int(s) for s in (shape or (n_devices,)))
    axis_names = tuple(axis_names)
    if int(np.prod(shape)) != n_devices or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} with axes {axis_names} does "
                         f"not hold {n_devices} ranks")
    backend = str(dist.get_backend())
    if device_type == "cpu":
        device = torch.device("cpu")
        if backend == "nccl":
            raise ValueError("NCCL moves CUDA tensors only; a CPU mesh "
                             "needs the gloo backend")
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_type='cuda' but this rank sees no "
                               "CUDA device (ask for device_type='cpu')")
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")

    grid = np.arange(world).reshape(shape)
    me = dist.get_rank()
    coords = tuple(int(c) for c in np.argwhere(grid == me)[0])
    axis_ranks, groups = {}, {}
    for a, name in enumerate(axis_names):
        lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
        for line in lines:
            ranks = [int(r) for r in line]
            if len(ranks) == world:
                group = dist.group.WORLD   # the whole group, in order
            else:
                group = dist.new_group(ranks)   # collective: every rank
            if me in ranks:
                axis_ranks[name], groups[name] = tuple(ranks), group
    return Mesh(shape, axis_names, coords, axis_ranks, groups, device,
                backend)


def node_sharding(mesh: Mesh, axis: str = "data") -> Sharding:
    """Shard the leading (node/collocation) axis across the mesh."""
    return Sharding(mesh, axis)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def pad_to_multiple(x, m: int, axis: int = 0):
    """Pad axis length to a multiple of m (sharding needs even splits).
    Takes a numpy array or a tensor. Returns (padded, original_length)."""
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x, n
    if isinstance(x, torch.Tensor):
        widths = [0, 0] * x.dim()
        widths[2 * (x.dim() - 1 - axis) + 1] = pad
        return torch.nn.functional.pad(x, widths), n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths), n


def shard_array(x, mesh: Mesh, spec) -> torch.Tensor:
    """The part of a host (or device) array that this rank holds under
    `spec` (a `Sharding`, an axis name, or None for replicated), as a
    tensor on the mesh's device: its block of rows, or the whole."""
    axis = spec.axis if isinstance(spec, Sharding) else spec
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x)
    if axis is None:
        return x.to(mesh.device)
    n_ax = mesh.axis_size(axis)
    if x.shape[0] % n_ax:
        raise ValueError(f"{x.shape[0]} rows do not split evenly over "
                         f"{n_ax} shards (pad_to_multiple first)")
    per = x.shape[0] // n_ax
    i = mesh.axis_index(axis)
    return x[i * per:(i + 1) * per].to(mesh.device)


# ---- the rank launcher ---------------------------------------------------

def _rank_device(device: str, rank: int) -> torch.device:
    """'cpu'; 'cuda' (rank r on cuda:r); 'cuda:i' (every rank on cuda:i,
    the ranks sharing one card)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} asked for its own card, but "
                               f"{torch.cuda.device_count()} are visible")
        dev = torch.device("cuda", rank)
    return dev


def _rank_main(rank, n_ranks, backend, device, store, timeout, fn, args,
               results):
    # One torch thread a rank: the ranks share the host's cores.
    torch.set_num_threads(1)
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout))
        # Plain pickle: torch's queue would share a tensor's memory with a
        # process that is about to exit.
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, n_ranks: int, backend: str | None = None,
          device: str = "cuda", args: tuple = (), timeout: float = 900.0,
          store_dir: str | None = None) -> list:
    """Run fn(*args) on `n_ranks` new processes joined in one
    `torch.distributed` group; returns the ranks' return values in rank
    order. The processes are started with the 'spawn' method (fn and
    args must pickle), meet through a `FileStore` in a fresh directory
    under `store_dir` (default: the temporary directory; no port is
    opened for the rendezvous), and use one torch thread each.
    `device`: 'cuda' (rank r on cuda:r, the default), 'cuda:i' (every
    rank on cuda:i, the ranks that share one card) or 'cpu'; asking for
    a card where torch sees none raises. `backend` defaults to NCCL for
    'cuda' and to gloo for 'cpu' and 'cuda:i' (NCCL refuses two ranks on
    one card). Raises with the rank's traceback when a rank fails, and
    when the ranks take longer than `timeout` seconds; every process is
    ended before it returns."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"spawn: device {device!r} asked for, but "
                           f"torch.cuda.is_available() is false (pass "
                           f"device='cpu' to run the ranks on the CPU)")
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and dev.index is None
                   else "gloo")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="epk_store_", dir=store_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        r, n_ranks, backend, device, os.path.join(tmp, "store"), timeout,
        fn, args, results)) for r in range(n_ranks)]
    out = [None] * n_ranks
    try:
        for p in procs:
            p.start()
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout)
        for _ in range(n_ranks):
            left = (deadline - datetime.datetime.now()).total_seconds()
            try:
                rank, ok, value = results.get(timeout=max(left, 1.0))
            except queue_mod.Empty:
                raise TimeoutError(f"spawn: {n_ranks} ranks did not finish "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {n_ranks} failed:\n"
                                   f"{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return out
