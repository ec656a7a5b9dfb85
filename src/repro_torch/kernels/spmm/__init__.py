from repro_torch.kernels.spmm.ops import block_spmm

__all__ = ["block_spmm"]
