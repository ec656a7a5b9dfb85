"""GraphSAGE-style GCN (the paper's model: 2 hidden layers, 256/128).

Port of ``repro/models/gcn.py``: the same param-dict keys and shapes
(``w_self{l}``, ``w_nbr{l}``, ``b{l}``, ``w_cls``, ``b_cls``), plain
functions on tensors. The dense products stay ``torch.matmul``, as the
reference leaves them to XLA; they are meant to run in full fp32
(``torch.get_float32_matmul_precision() == "highest"``, TF32 off — the
PyTorch defaults).

Ported so far: what the serving and eval paths run (``gcn_init``,
``neighbor_aggregate``, ``gcn_full_forward``, ``per_node_loss``). The
training forward (``gcn_batch_forward``) comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init

HIDDEN = (256, 128)
AGG_BACKENDS = ("gather", "segment", "spmm")


def gcn_init(generator: torch.Generator, n_features: int, n_classes: int,
             hidden=HIDDEN, dtype=torch.float32, device=None) -> dict:
    """Fresh params drawn from ``generator`` (same shapes and scale as the
    reference's ``gcn_init``, not the same values: torch's and jax's
    generators differ). ``device=None`` is ``cuda:0``."""
    dev = resolve_device(device)
    dims = (n_features, *hidden)
    params: dict = {}
    for l in range(len(hidden)):
        params[f"w_self{l}"] = dense_init(generator, dims[l], dims[l + 1], dtype)
        params[f"w_nbr{l}"] = dense_init(generator, dims[l], dims[l + 1], dtype)
        params[f"b{l}"] = torch.zeros((dims[l + 1],), dtype=dtype)
    params["w_cls"] = dense_init(generator, hidden[-1], n_classes, dtype)
    params["b_cls"] = torch.zeros((n_classes,), dtype=dtype)
    return {k: v.to(dev) for k, v in params.items()}


def _aggregate(table: torch.Tensor, nbr_idx: torch.Tensor,
               nbr_mask: torch.Tensor) -> torch.Tensor:
    """Mean-aggregate neighbor rows. table (M, d); nbr_idx/mask (b, K)."""
    gathered = table[nbr_idx.long()] * nbr_mask[..., None]
    deg = torch.clamp(nbr_mask.sum(-1, keepdim=True), min=1.0)
    return gathered.sum(1) / deg


def neighbor_aggregate(
    table: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    *,
    backend: str = "gather",
    csr: dict | None = None,
    adj: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean-aggregate neighbor rows through a pluggable backend.

    ``gather``   the dense (b, K, d) gather.
    ``segment``  a sum over the bucketed CSR (``graph.csr.
                 bucketed_csr_from_padded``; ``csr`` may pass it
                 precomputed, in that form). Each row owns exactly K
                 contiguous edge slots, so the sum is a ``(b, K, d)``
                 reduction in a fixed order, not an ``index_add_``, which
                 on CUDA uses atomics whose order changes between runs.
                 Padding slots are zeroed with ``where``, so a non-finite
                 row 0 does not leak through them.
    ``spmm``     the block-sparse SpMM kernel (``kernels.spmm``) against a
                 row-normalised adjacency; ``adj`` reuses a precomputed one.

    All three agree within fp32 summation-order tolerance.
    """
    if backend == "gather":
        return _aggregate(table, nbr_idx, nbr_mask)
    if backend == "segment":
        if csr is None:
            from repro_torch.graph.csr import bucketed_csr_from_padded

            csr = bucketed_csr_from_padded(nbr_idx, nbr_mask)
        b, k = nbr_idx.shape
        real = (csr["dst"] < b)[:, None]
        vals = torch.where(real, table[csr["src"].long()], 0.0)
        return vals.reshape(b, k, -1).sum(1) * csr["inv_deg"][:, None]
    if backend == "spmm":
        from repro_torch.kernels.spmm.ops import neighbor_spmm

        return neighbor_spmm(table, nbr_idx, nbr_mask, adj=adj)
    raise ValueError(f"unknown aggregation backend {backend!r}; known: {AGG_BACKENDS}")


def _sage_layer(params: dict, l: int, h_self: torch.Tensor,
                h_agg: torch.Tensor) -> torch.Tensor:
    return torch.relu(
        h_self @ params[f"w_self{l}"] + h_agg @ params[f"w_nbr{l}"] + params[f"b{l}"]
    )


def gcn_full_forward(params, features, nbr_idx, nbr_mask, *,
                     backend: str = "gather", csr: dict | None = None,
                     adj: torch.Tensor | None = None) -> torch.Tensor:
    """Exact full-graph forward (server-side evaluation; no history)."""
    h = features
    for l in range(len(HIDDEN)):
        agg = neighbor_aggregate(h, nbr_idx, nbr_mask, backend=backend,
                                 csr=csr, adj=adj)
        h = _sage_layer(params, l, h, agg)
    return h @ params["w_cls"] + params["b_cls"]


def per_node_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(b, C), (b,) -> (b,) cross-entropy per node (no reduction)."""
    logits32 = logits.to(torch.float32)
    lse = torch.logsumexp(logits32, dim=-1)
    gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def gcn_param_count(n_features: int, n_classes: int, hidden=HIDDEN) -> int:
    dims = (n_features, *hidden)
    total = 0
    for l in range(len(hidden)):
        total += 2 * dims[l] * dims[l + 1] + dims[l + 1]
    total += hidden[-1] * n_classes + n_classes
    return total


def gcn_flops_per_node(n_features: int, n_classes: int, avg_deg: float,
                       hidden=HIDDEN) -> float:
    """Forward FLOPs per node (matmuls + aggregation)."""
    dims = (n_features, *hidden)
    fl = 0.0
    for l in range(len(hidden)):
        fl += 2 * 2 * dims[l] * dims[l + 1]       # self + nbr matmuls
        fl += 2 * avg_deg * dims[l]               # mean aggregation
    fl += 2 * hidden[-1] * n_classes
    return fl
