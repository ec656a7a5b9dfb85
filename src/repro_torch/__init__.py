"""repro_torch: the PyTorch/CUDA port of the FedAIS system, beside the JAX
package ``repro`` (the reference it is held against).

The port mirrors ``repro``'s module paths (``repro/serve/engine.py`` has its
counterpart at ``repro_torch/serve/engine.py``). Host code is numpy, device
code is PyTorch, and every Pallas kernel of ``repro`` on a ported path is a
hand-written Hopper kernel under ``repro_torch/kernels/*/csrc``.

It imports neither ``jax`` nor anything of ``repro``. Entry points run on
``cuda:0`` unless the caller passes ``device="cpu"`` (``resolve_device``);
nothing falls back to the CPU on its own.

Ported so far:

* GCN serving (``serve``: ``ServedModel`` → ``QueryEngine`` →
  ``LoadGenerator``), the GCN forward (``models.gcn``), the eval path
  (``federated.server``), the host graph substrate (``graph``), the wire
  codec (``federated.quant``) and the block-sparse SpMM kernel
  (``kernels.spmm``);
* LM serving (``launch.serve_lm_cli``: prefill, then greedy decode) for
  ``rwkv6-1.6b``, ``gemma3-12b`` and ``mini`` (``configs``,
  ``models.layers``/``rwkv``/``attention``/``lm``, ``launch.train``'s
  configurations), with the WKV6 recurrence (``kernels.wkv6``) and flash
  attention (``kernels.flash_attention``) kernels. Every TPU kernel of
  ``repro`` now has its Hopper counterpart;
* FedAIS training (``api.FedEngine``: the stepwise, fused, fault-aware and
  async executors, the method space, the quantized wire), the deployment
  path (``checkpoint``, ``launch.serve_fed``, ``launch.fed_chaos``) and
  the multi-device executors on ``torch.distributed`` (``sharding``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
