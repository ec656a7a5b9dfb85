from repro_torch.kernels.wkv6.ops import wkv6

__all__ = ["wkv6"]
