"""Device time of the dense products' kernels (cuBLAS: names holding gemm,
gemv, cutlass, xmma or splitKreduce), per round."""


def read(run):
    return 1e3 * run.device_s.get("gemm", 0.0) / run.rounds if run.rounds else None
