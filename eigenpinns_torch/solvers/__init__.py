from eigenpinns_torch.solvers.direct import DirectResult, train_joint
from eigenpinns_torch.solvers.lobpcg import lobpcg, lobpcg_from_random
from eigenpinns_torch.solvers.multigrid import (
    MultigridResult,
    MultigridTrainer,
)
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.solvers.rayleigh_ritz import (
    eigh_generalized,
    filtered_whiten,
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_torch.solvers.smoothers import (
    cg_solve,
    coarse_grid_correction,
    jacobi_smooth,
)

__all__ = [
    "DirectResult", "train_joint", "lobpcg", "lobpcg_from_random",
    "MultigridResult", "MultigridTrainer",
    "eigsh_smallest", "eigh_generalized", "filtered_whiten",
    "rayleigh_ritz", "rayleigh_ritz_robust", "cg_solve",
    "coarse_grid_correction", "jacobi_smooth",
]
