from repro_torch.kernels.ghost_pull.ops import ghost_pull

__all__ = ["ghost_pull"]
