"""What every example script shares: its command line (the device and,
where it reads one, the mesh), the miniature switch and the stand-in
mesh.

Each script runs on the card unless given `--platform cpu` or
`EIGENPINNS_PLATFORM=cpu`; asking for the card on a machine without one
fails. `EIGENPINNS_SMOKE=1` runs the JAX example's own seconds-scale
miniature sizes.
"""

import argparse
import os
import sys

# The scripts run from the checkout, with or without the package
# installed.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from eigenpinns_torch.main import PLATFORMS  # noqa: E402

SMOKE = bool(int(os.environ.get("EIGENPINNS_SMOKE", "0")))


def parse(doc: str, mesh: str | None = None) -> argparse.Namespace:
    """The script's arguments: `--platform` (resolved into `.device`)
    and, when the script reads a mesh, `--mesh` (default `mesh`, a path
    in the reference repository's layout)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--platform", default=None,
                    help="'cuda' (or 'gpu', the default) or 'cpu'; "
                         "defaults to $EIGENPINNS_PLATFORM if set")
    if mesh is not None:
        ap.add_argument("--mesh", default=mesh,
                        help=f"the .obj to read (default {mesh}); a "
                             f"stand-in surface is used when it is absent")
    args = ap.parse_args()
    platform = (args.platform or os.environ.get("EIGENPINNS_PLATFORM")
                or "cuda").lower()
    if platform not in PLATFORMS:
        ap.error(f"--platform must be one of {sorted(PLATFORMS)}")
    args.device = PLATFORMS[platform]
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the device is 'cuda' but "
                           "torch.cuda.is_available() is false; pass "
                           "--platform cpu to run on the CPU")
    return args


def load_or_standin(path: str, normalize: bool = True):
    """The mesh at `path`, or perturbed_icosphere(4) (2562 vertices, the
    bunny's stand-in) when the file is absent; says which."""
    from eigenpinns_torch.geometry import load_mesh, normalize_mesh
    from eigenpinns_torch.utils.fixtures import perturbed_icosphere

    if os.path.exists(path):
        return load_mesh(path, normalize=normalize)
    print(f"{path} is absent: running on the stand-in "
          f"perturbed_icosphere(4) (2562 vertices)", flush=True)
    mesh = perturbed_icosphere(4)
    return normalize_mesh(mesh) if normalize else mesh
