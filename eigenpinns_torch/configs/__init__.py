from eigenpinns_torch.configs.config import Config

__all__ = ["Config"]
