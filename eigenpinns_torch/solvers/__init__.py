from eigenpinns_torch.solvers.batched import (
    BatchedResult,
    train_joint_family,
)
from eigenpinns_torch.solvers.deflation import (
    DeflationResult,
    solve_deflation,
    solve_deflation_adaptive,
)
from eigenpinns_torch.solvers.direct import DirectResult, train_joint
from eigenpinns_torch.solvers.direct_sharded import (
    ShardedDirectResult,
    ShardedProblem,
    prepare_sharded_problem,
    train_joint_sharded,
)
from eigenpinns_torch.solvers.eikonal_driver import (
    EikonalResult,
    ntk_traces,
    solve_eikonal,
)
from eigenpinns_torch.solvers.lobpcg import (
    lobpcg,
    lobpcg_blocked,
    lobpcg_from_random,
)
from eigenpinns_torch.solvers.lobpcg_sharded import lobpcg_sharded
from eigenpinns_torch.solvers.multigrid import (
    MultigridResult,
    MultigridTrainer,
)
from eigenpinns_torch.solvers.oracle import (
    eigsh_smallest,
    orthonormalize_gs,
    solve_eigenvalue_mesh,
    solve_eigenvalue_point_cloud,
)
from eigenpinns_torch.solvers.poisson import (
    solve_laplace_dirichlet,
    solve_laplace_dirichlet_device,
)
from eigenpinns_torch.solvers.rayleigh_ritz import (
    eigh_generalized,
    filtered_whiten,
    rayleigh_ritz,
    rayleigh_ritz_robust,
)
from eigenpinns_torch.solvers.schrodinger_driver import (
    SchrodingerMode,
    SchrodingerResult,
    solve_schrodinger,
)
from eigenpinns_torch.solvers.smoothers import (
    cg_solve,
    coarse_grid_correction,
    jacobi_smooth,
)
from eigenpinns_torch.solvers.spectral_basis import (
    SpectralBasisResult,
    family_operators,
    spectral_basis,
    spectral_basis_family,
)
from eigenpinns_torch.solvers.transfer import TransferResult, train_per_level
from eigenpinns_torch.solvers.upscale import (
    UpscaleResult,
    hierarchical_eigensolve,
)

__all__ = [
    "DirectResult", "train_joint", "lobpcg", "lobpcg_blocked",
    "lobpcg_from_random", "SpectralBasisResult", "spectral_basis",
    "spectral_basis_family", "family_operators",
    "MultigridResult", "MultigridTrainer",
    "eigsh_smallest", "orthonormalize_gs", "solve_eigenvalue_mesh",
    "solve_eigenvalue_point_cloud", "eigh_generalized", "filtered_whiten",
    "rayleigh_ritz", "rayleigh_ritz_robust", "cg_solve",
    "coarse_grid_correction", "jacobi_smooth",
    "DeflationResult", "solve_deflation", "solve_deflation_adaptive",
    "BatchedResult", "train_joint_family", "UpscaleResult",
    "hierarchical_eigensolve", "TransferResult", "train_per_level",
    "solve_laplace_dirichlet", "solve_laplace_dirichlet_device",
    "solve_schrodinger", "SchrodingerResult", "SchrodingerMode",
    "solve_eikonal", "EikonalResult", "ntk_traces",
    "ShardedDirectResult", "ShardedProblem", "prepare_sharded_problem",
    "train_joint_sharded", "lobpcg_sharded",
]
