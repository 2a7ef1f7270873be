from eigenpinns_torch.io.vtu import read_vtu, save_eigenfunctions, write_vtu

__all__ = ["write_vtu", "read_vtu", "save_eigenfunctions"]
