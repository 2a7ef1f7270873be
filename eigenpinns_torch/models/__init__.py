from eigenpinns_torch.models.convert import from_flax_params
from eigenpinns_torch.models.correctors import (
    AdaptiveCorrector,
    SimpleCorrector,
    SpectralCorrector,
    make_corrector,
)
from eigenpinns_torch.models.mlp import MLP

__all__ = ["MLP", "SimpleCorrector", "SpectralCorrector",
           "AdaptiveCorrector", "make_corrector", "from_flax_params"]
