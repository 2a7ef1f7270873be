"""Pipeline entry point — port of `eigenpinns_tpu/main.py` (parity with
the reference's `src/main.py`).

Orchestrates: config -> mesh -> hierarchy -> multigrid training -> VTU
export (in the input mesh's vertex order) -> diagnostics. Run as

    python -m eigenpinns_torch.main --config path/to/parameters.yml
    eigenpinns-torch --config ... [--override key=value ...] [--platform cpu]

The device is the card (`cuda`) unless `--platform cpu` or
`EIGENPINNS_PLATFORM=cpu` asks for the CPU; asking for the card on a
machine without one fails rather than running on the CPU.

A nonempty `mesh_shape` trains node-sharded over the ranks of a
`torch.distributed` group, one process per rank (the JAX package runs it
over the devices of one process). Launch one rank per card with

    python -m torch.distributed.run --nproc_per_node N \
        -m eigenpinns_torch.main --override "mesh_shape=[N]" ...

(NCCL; with `--platform cpu`, gloo ranks on the host). `main` joins the
group from torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK and the
rendezvous address) and destroys it on exit. The product of
`mesh_shape` must equal the world size; a product of 1 outside torchrun
runs on a one-rank group of its own. Every rank builds the hierarchy
and returns the same eigenvectors; only rank 0 prints, writes the VTU
and the diagnostics (and the trainer's checkpoints).
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import tempfile
import time

import numpy as np

PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _torchrun_env() -> tuple | None:
    """(rank, world size, local rank) from torchrun's environment, or
    None outside it."""
    if not all(k in os.environ for k in TORCHRUN_ENV):
        return None
    return tuple(int(os.environ[k]) for k in TORCHRUN_ENV)


def _ranks_needed(config, env) -> int:
    """The world size `config.mesh_shape` asks for (0: not sharded);
    raises when it and the launch disagree."""
    n_mesh = int(np.prod(config.mesh_shape)) if config.mesh_shape else 0
    if env is None:
        if n_mesh > 1:
            raise ValueError(
                f"mesh_shape {list(config.mesh_shape)} asks for {n_mesh} "
                f"ranks, one process each: launch the CLI under torchrun "
                f"(python -m torch.distributed.run --nproc_per_node "
                f"{n_mesh} -m eigenpinns_torch.main ...)")
        return n_mesh
    world = env[1]
    if n_mesh != world and (n_mesh or world > 1):
        raise ValueError(
            f"torchrun started {world} ranks but mesh_shape "
            f"{list(config.mesh_shape)} holds {n_mesh or 'none'}: the "
            f"product of mesh_shape must equal torchrun's world size")
    return n_mesh


def main(config, device="cuda") -> np.ndarray:
    """Run the pipeline of `config` on `device`; returns the refined
    finest-level eigenvectors (in the hierarchy's node order). A
    nonempty `config.mesh_shape` runs on a `torch.distributed` group:
    torchrun's (see the module docstring), joined here and destroyed on
    return."""
    import torch
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eigenpinns_torch: the device is 'cuda' but "
                           "torch.cuda.is_available() is false; pass "
                           "--platform cpu to run on the CPU")
    env = _torchrun_env()
    n_ranks = _ranks_needed(config, env)
    if not n_ranks:
        return _pipeline(config, device, rank=0)
    if device.type == "cuda":
        # One rank a card; the mesh puts each rank on its current device.
        torch.cuda.set_device(env[2] if env else torch.cuda.current_device())
        device = torch.device("cuda", torch.cuda.current_device())
    backend = "nccl" if device.type == "cuda" else "gloo"
    if env is not None:
        dist.init_process_group(backend, init_method="env://",
                                rank=env[0], world_size=env[1])
        try:
            return _pipeline(config, device, rank=dist.get_rank())
        finally:
            dist.destroy_process_group()
    # One rank outside torchrun: a group of its own over a file store.
    with tempfile.TemporaryDirectory(prefix="epk_cli_") as store:
        dist.init_process_group(backend, init_method=f"file://{store}/store",
                                rank=0, world_size=1)
        try:
            return _pipeline(config, device, rank=0)
        finally:
            dist.destroy_process_group()


def _kernel_launches() -> dict:
    """The hand kernels' launch counts in this process."""
    from eigenpinns_torch.sparse import banded, bsr, rolling

    return {"rolling": rolling.rolling_kernel_launches,
            **{f"bsr_{k}": v for k, v in bsr.bsr_kernel_launches.items()},
            **{f"banded_{k}": v
               for k, v in banded.banded_kernel_launches.items()}}


def _pipeline(config, device, rank: int) -> np.ndarray:
    import torch

    from eigenpinns_torch.diagnostics import comprehensive_diagnostics
    from eigenpinns_torch.geometry import load_mesh
    from eigenpinns_torch.io import save_eigenfunctions
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers.multigrid import MultigridTrainer

    def say(*args):
        if rank == 0:       # rank 0 speaks for the group
            print(*args, flush=True)

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    say("Loading mesh...")
    mesh = load_mesh(config.mesh_file, normalize=True)

    say("Preprocessing mesh data...")
    t0 = time.time()
    hierarchy = build_hierarchy(
        mesh,
        config.hierarchy,
        n_modes=config.n_modes,
        sampler_type=config.sampler_type,
        edge_computation_type=config.edge_computation_type,
        k_neighbors=config.k_neighbors,
        prolongation_neighbors=config.prolongation_neighbors,
        pc_neighbors=config.pc_neighbors,
        coarse_solver=config.coarse_solver,
        seed=config.seed,
        operator_format=config.operator_format,
        device=device,
    )
    _sync()
    say(f"Hierarchy {hierarchy.actual_hierarchy} built in "
        f"{time.time() - t0:.3f}s (K operators "
        f"{[type(op).__name__ for op in hierarchy.K_ops]})")

    say("Training physics-informed multiresolution GNN...")
    trainer = MultigridTrainer(config)
    result = trainer.train(hierarchy, log_fn=None if rank == 0
                           else (lambda epoch, metrics: None))
    _sync()
    steady = sorted(n / t for n, t in
                    (result.chunk_times[1:] or result.chunk_times))
    say(f"Trained {result.epochs_run} epochs in "
        f"{result.wall_time:.1f}s "
        f"({result.epochs_run / max(result.wall_time, 1e-9):.1f} steps/s; "
        f"per-chunk median {steady[len(steady) // 2]:.2f} steps/s)")
    say(f"Extraction and polish ({result.polish_iterations} LOBPCG "
        f"iterations) in {result.polish_time:.3f}s")
    say("Refined eigenvalues (first 10):",
        np.round(result.eigenvalues[:10], 6))

    say("Run summary:", json.dumps({
        "eigenvalues": [float(v) for v in result.eigenvalues],
        "epochs_run": int(result.epochs_run),
        "world_size": int(torch.distributed.get_world_size()
                          if torch.distributed.is_initialized() else 1),
        "kernel_launches": _kernel_launches()}))
    if rank != 0:
        return result.eigenvectors

    say("Saving predicted eigenvectors...")
    if config.vtu_file:
        os.makedirs(os.path.dirname(os.path.abspath(config.vtu_file)),
                    exist_ok=True)
        # The finest level is the full mesh for every sampler; export on
        # its geometry, in the input mesh's vertex order.
        finest_mesh = hierarchy.meshes[-1]
        save_eigenfunctions(config.vtu_file, finest_mesh,
                            hierarchy.to_original_order(result.eigenvectors),
                            config.n_modes)

    say("Run diagnostics...")
    comprehensive_diagnostics(
        result.eigenvectors,
        hierarchy.K_scipy[-1],
        hierarchy.M_scipy[-1],
        n_modes=config.n_modes,
        plot_path=config.diagnostics_viz or None,
    )
    return result.eigenvectors


def cli(argv=None) -> None:
    from eigenpinns_torch.configs import Config

    ap = argparse.ArgumentParser(
        prog="eigenpinns-torch",
        description="physics-informed eigensolver pipeline on PyTorch "
                    "(CUDA by default)")
    ap.add_argument("--config", default=None,
                    help="sectioned YAML config (reference parameters.yml "
                         "format); defaults apply when omitted")
    ap.add_argument("--override", nargs="*", default=[], action="extend",
                    metavar="KEY=VALUE",
                    help="config overrides, e.g. n_modes=10 epochs=2000; "
                         "repeated --override flags accumulate")
    ap.add_argument("--platform", default=None,
                    help="the torch device: 'cuda' (or 'gpu', the "
                         "default) or 'cpu'. Defaults to "
                         "$EIGENPINNS_PLATFORM if set. Asking for the "
                         "card on a machine without one fails.")
    args = ap.parse_args(argv)

    platform = (args.platform or os.environ.get("EIGENPINNS_PLATFORM")
                or "cuda").lower()
    if platform not in PLATFORMS:
        ap.error(f"--platform must be one of {sorted(PLATFORMS)}, got "
                 f"'{platform}'")

    config = Config.from_yaml(args.config) if args.config else Config()
    overrides = {}
    for item in args.override:
        key, _, value = item.partition("=")
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value
    if overrides:
        config = config.override(**overrides)
    main(config, device=PLATFORMS[platform])


if __name__ == "__main__":
    cli()
