from eigenpinns_torch.utils.fixtures import icosphere, perturbed_icosphere

__all__ = ["icosphere", "perturbed_icosphere"]
