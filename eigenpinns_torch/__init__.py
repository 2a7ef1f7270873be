"""eigenpinns_torch: the PyTorch + CUDA port of eigenpinns_tpu.

The JAX package `eigenpinns_tpu` stays the reference; this package
mirrors its layout module for module (`sparse/rolling.py` ports
`eigenpinns_tpu/sparse/rolling.py`, and so on) and never imports JAX.
Three paths run end to end: multigrid training (`build_hierarchy(...,
operator_format="auto")` then `MultigridTrainer(cfg).train(h)`, on the
device the hierarchy was built on), direct joint training on
rolling-band, strip-BSR or split operators (`RollingBanded.from_scipy`,
`BSRTile.from_scipy` or `SplitBanded.from_scipy`, `train_joint`, then a
guarded `lobpcg` polish), and the large-cloud
spectral basis (`spectral_basis`, `spectral_basis_family`: blocked
deflated LOBPCG). The solver family (`solvers/{deflation,batched,
upscale,transfer,poisson}.py`: sequential and adaptive deflation, joint
training over a mesh family, the matrix-only neural upscaler, per-level
transfer learning, Dirichlet solves) runs on the same operators. The
pipeline's CLI (`python -m eigenpinns_torch.main --config
parameters.yml`, `main.py`) chains the mesh, `build_hierarchy` with any
sampler (decimated FEM levels included), `MultigridTrainer`, the VTU
export and the diagnostics. Every entry point runs on the card unless
given `device="cpu"` (the CLI: `--platform cpu`).

Their hand-written kernels are built with nvcc on first use:
`csrc/bsr_spmm.cu` (the grouped and burst strip-BSR SpMMs that replace
the Pallas kernels `bsr_spmm_pallas_grouped` and `bsr_spmm_pallas`) and
`csrc/banded_spmm.cu` (the full-window band SpMM and its fused Gram,
replacing `banded_spmm_pallas` and `banded_spmm_gram_pallas`, and the
rolling-band SpMM with and without the Gram, replacing
`_rolling_kernel_call`: the same kernel with implicit, wrapping window
starts). CPU tensors take each kernel's plain torch version instead.
The host stage's C++ kernels (`csrc/geometry_kernels.cpp`: kNN,
farthest-point sampling, local triangulations, intrinsic-Delaunay flips)
are built on first use with the host's C++ compiler
(`geometry/native.py`).

Importing the package turns TF32 off for matmuls and cuDNN
(`torch.backends.cuda.matmul.allow_tf32 = False`,
`torch.backends.cudnn.allow_tf32 = False`): every Gram, Rayleigh
quotient and orthogonalization needs full fp32, the rule the JAX
package enforces with `hdot`.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
