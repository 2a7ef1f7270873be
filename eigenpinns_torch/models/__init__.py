from eigenpinns_torch.models.convert import from_flax_params
from eigenpinns_torch.models.correctors import (
    AdaptiveCorrector,
    SimpleCorrector,
    SpectralCorrector,
    make_corrector,
)
from eigenpinns_torch.models.eigennet import JointEigenNet
from eigenpinns_torch.models.mlp import ACTIVATIONS, MLP

__all__ = ["ACTIVATIONS", "MLP", "SimpleCorrector", "SpectralCorrector",
           "AdaptiveCorrector", "JointEigenNet", "make_corrector",
           "from_flax_params"]
