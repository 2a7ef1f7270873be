"""Pipeline entry point — port of `eigenpinns_tpu/main.py` (parity with
the reference's `src/main.py`).

Orchestrates: config -> mesh -> hierarchy -> multigrid training -> VTU
export (in the input mesh's vertex order) -> diagnostics, on one torch
device. Run as

    python -m eigenpinns_torch.main --config path/to/parameters.yml
    eigenpinns-torch --config ... [--override key=value ...] [--platform cpu]

The device is the card (`cuda`) unless `--platform cpu` or
`EIGENPINNS_PLATFORM=cpu` asks for the CPU; asking for the card on a
machine without one fails rather than running on the CPU.
"""

from __future__ import annotations

import argparse
import ast
import os
import time

import numpy as np

PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def main(config, device="cuda") -> np.ndarray:
    """Run the pipeline of `config` on `device`; returns the refined
    finest-level eigenvectors (in the hierarchy's node order)."""
    import torch

    from eigenpinns_torch.diagnostics import comprehensive_diagnostics
    from eigenpinns_torch.geometry import load_mesh
    from eigenpinns_torch.io import save_eigenfunctions
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers.multigrid import MultigridTrainer

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("eigenpinns_torch: the device is 'cuda' but "
                           "torch.cuda.is_available() is false; pass "
                           "--platform cpu to run on the CPU")

    def _sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    print("Loading mesh...")
    mesh = load_mesh(config.mesh_file, normalize=True)

    print("Preprocessing mesh data...")
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
    print(f"Hierarchy {hierarchy.actual_hierarchy} built in "
          f"{time.time() - t0:.3f}s (K operators "
          f"{[type(op).__name__ for op in hierarchy.K_ops]})")

    print("Training physics-informed multiresolution GNN...")
    trainer = MultigridTrainer(config)
    result = trainer.train(hierarchy)
    _sync()
    steady = sorted(n / t for n, t in
                    (result.chunk_times[1:] or result.chunk_times))
    print(f"Trained {result.epochs_run} epochs in "
          f"{result.wall_time:.1f}s "
          f"({result.epochs_run / max(result.wall_time, 1e-9):.1f} steps/s; "
          f"per-chunk median {steady[len(steady) // 2]:.2f} steps/s)")
    print(f"Extraction and polish ({result.polish_iterations} LOBPCG "
          f"iterations) in {result.polish_time:.3f}s")
    print("Refined eigenvalues (first 10):",
          np.round(result.eigenvalues[:10], 6))

    print("Saving predicted eigenvectors...")
    if config.vtu_file:
        os.makedirs(os.path.dirname(os.path.abspath(config.vtu_file)),
                    exist_ok=True)
        # The finest level is the full mesh for every sampler; export on
        # its geometry, in the input mesh's vertex order.
        finest_mesh = hierarchy.meshes[-1]
        save_eigenfunctions(config.vtu_file, finest_mesh,
                            hierarchy.to_original_order(result.eigenvectors),
                            config.n_modes)

    print("Run diagnostics...")
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
