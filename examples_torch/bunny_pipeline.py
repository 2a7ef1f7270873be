"""Reference-parity production run: bunny, 10 modes, multigrid + polish.

    python examples_torch/bunny_pipeline.py [--mesh resources/bunny.obj]
        [--platform cpu]

The port of examples/bunny_pipeline.py. Set EIGENPINNS_SMOKE=1 to run a
seconds-scale miniature (CI smoke mode).
"""
import common

import numpy as np

from eigenpinns_torch.configs import Config
from eigenpinns_torch.diagnostics import comprehensive_diagnostics
from eigenpinns_torch.io import save_eigenfunctions
from eigenpinns_torch.sampling import build_hierarchy
from eigenpinns_torch.solvers.multigrid import MultigridTrainer

args = common.parse(__doc__, mesh="resources/bunny.obj")
mesh = common.load_or_standin(args.mesh, normalize=False)
levels = [64, 128] if common.SMOKE else [128, 512, 1024]
h = build_hierarchy(mesh, levels, n_modes=10, operator_format="auto",
                    device=args.device)
# A cut run cuts the corrector's 5000-epoch ramp by the same share, or
# the per-level Rayleigh-Ritz at the full scale raises (ROADMAP F25).
cfg = Config(n_modes=10, hierarchy=levels,
             epochs=30 if common.SMOKE else 2000,
             scale_ramp_epochs=75 if common.SMOKE else 5000,
             scan_chunk=10 if common.SMOKE else 200,
             polish_iters=10 if common.SMOKE else 100, log_every=500,
             verbose=True)
res = MultigridTrainer(cfg).train(h)
print("eigenvalues:", np.round(res.eigenvalues, 4))
save_eigenfunctions("outputs/bunny_model.vtu", h.meshes[-1],
                    h.to_original_order(res.eigenvectors), 10)
comprehensive_diagnostics(res.eigenvectors, h.K_scipy[-1], h.M_scipy[-1],
                          plot_path="outputs/diagnostics.png")
