"""Hand-written Hopper kernels for the port's hot spots.

Each kernel package holds:
    csrc/<name>.cu — the CUDA C++ kernel (sm_90a) with a plain C entry point
    ops.py         — the wrapper: checks, launch on the current stream, a
                     launch counter; the plain version for CPU tensors only
    ref.py         — the plain PyTorch versions the tests and chip_smoke.py
                     hold the kernel against

``build.py`` compiles the sources with nvcc at first use and loads them
with ctypes.

Kernels (every TPU kernel of ``repro`` has its counterpart here):
    spmm             block-sparse Y = A @ X with dead-tile skipping (replaces
                     src/repro/kernels/spmm/spmm.py::spmm_pallas)
    wkv6             RWKV6 recurrence, the N x N state resident in registers
                     (replaces src/repro/kernels/wkv6/wkv6.py::wkv6_pallas),
                     and its backward (``WKV6``; replaces the reference's
                     jnp autodiff of src/repro/models/rwkv.py::wkv_scan)
    flash_attention  causal / sliding-window GQA attention, online softmax in
                     fp32, dead KV tiles skipped (replaces
                     src/repro/kernels/flash_attention/flash_attention.py::
                     flash_attention_pallas)
    stamp            one thread writes the device's global timer into a slot:
                     a device phase's boundary for ``utils.spans`` (no TPU
                     counterpart; no plain version, the CPU reads its clock)
    ghost_pull       a client's tau-gated ghost sync in one pass: each output
                     row of the ghost and layer-1 tables written once (no TPU
                     counterpart: the reference's jnp gather, mask and select)
"""
