from eigenpinns_torch.models.ansatz import (
    ParametricAnsatz,
    dirichlet_window,
    gaussian_window,
)
from eigenpinns_torch.models.convert import from_flax_params
from eigenpinns_torch.models.correctors import (
    AdaptiveCorrector,
    SimpleCorrector,
    SpectralCorrector,
    make_corrector,
)
from eigenpinns_torch.models.eigennet import (
    JointEigenNet,
    LambdaEigenNet,
    StackedJointEigenNet,
)
from eigenpinns_torch.models.mlp import ACTIVATIONS, MLP
from eigenpinns_torch.models.surgery import partial_weight_copy
from eigenpinns_torch.models.upscaler import HierarchicalUpscaler

__all__ = ["ACTIVATIONS", "MLP", "SimpleCorrector", "SpectralCorrector",
           "AdaptiveCorrector", "JointEigenNet", "StackedJointEigenNet",
           "LambdaEigenNet", "HierarchicalUpscaler", "make_corrector",
           "from_flax_params", "partial_weight_copy", "ParametricAnsatz",
           "dirichlet_window", "gaussian_window"]
