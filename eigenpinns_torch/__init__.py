"""eigenpinns_torch: the PyTorch + CUDA port of eigenpinns_tpu.

The JAX package `eigenpinns_tpu` stays the reference; this package
mirrors its layout module for module (`sparse/rolling.py` ports
`eigenpinns_tpu/sparse/rolling.py`, and so on) and never imports JAX.
Two paths run end to end: multigrid training (`build_hierarchy(...,
operator_format="auto")` then `MultigridTrainer(cfg).train(h)`, on the
device the hierarchy was built on) and direct joint training on
strip-BSR operators (`BSRTile.from_scipy`, `train_joint`, then a guarded
`lobpcg` polish).

Their hand-written kernels are built with nvcc on first use:
`csrc/rolling_spmm.cu` (the rolling-band SpMM that replaces the Pallas
kernel `_rolling_kernel_call`) and `csrc/bsr_spmm.cu` (the grouped and
burst strip-BSR SpMMs that replace `bsr_spmm_pallas_grouped` and
`bsr_spmm_pallas`). CPU tensors take each kernel's plain torch version
instead.

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
