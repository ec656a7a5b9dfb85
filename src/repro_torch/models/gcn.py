"""GraphSAGE-style GCN (the paper's model: 2 hidden layers, 256/128).

Port of ``repro/models/gcn.py``: the same param-dict keys and shapes
(``w_self{l}``, ``w_nbr{l}``, ``b{l}``, ``w_cls``, ``b_cls``), plain
functions on tensors. The dense products stay ``torch.matmul``, as the
reference leaves them to XLA; they are meant to run in full fp32
(``torch.get_float32_matmul_precision() == "highest"``, TF32 off — the
PyTorch defaults).

The whole module is ported: the serving and eval paths (``gcn_init``,
``neighbor_aggregate``, ``gcn_full_forward``, ``per_node_loss``) and the
training forward with historical embeddings (``gcn_batch_forward``, paper
Eq. 6).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init

HIDDEN = (256, 128)
AGG_BACKENDS = ("gather", "segment", "spmm")
# Rows per dense product of the full-graph forward and of the serving path.
# cuBLAS picks its fp32 GEMM kernel by the shape, so one row's product has
# other bits in a (128, K) call than in a (19,717, K) one (measured on an
# H100, PERF.md §6). Both paths multiply in blocks of ROW_BLOCK rows,
# the last one padded with zeros, so a row's bits do not depend on how many
# rows come with it, and a served row equals the eval path's bit for bit.
ROW_BLOCK = 1024


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
    spmm_route: str = "dense",
) -> torch.Tensor:
    """Mean-aggregate neighbor rows through a pluggable backend.

    ``gather``   the dense (b, K, d) gather.
    ``segment``  a sum over the bucketed CSR (``graph.csr.
                 bucketed_csr_from_padded``; ``csr`` may pass it
                 precomputed, and must then be in that form, or this
                 raises). Each row owns exactly K contiguous edge slots, so
                 the sum is a ``(b, K, d)`` reduction in a fixed order, not
                 an ``index_add_``, which on CUDA uses atomics whose order
                 changes between runs. Padding slots are zeroed with
                 ``where``, so a non-finite row 0 does not leak through them.
    ``spmm``     the block-sparse SpMM kernel (``kernels.spmm``) against a
                 row-normalised adjacency; ``adj`` reuses a precomputed one.
                 With ``spmm_route="sparse"`` (``kernels.spmm.ops.spmm_route``:
                 graphs whose dense operand does not fit) the SpMM's sparse
                 route instead, which reads the neighbor list itself.

    All three agree within fp32 summation-order tolerance.
    """
    if backend == "gather":
        return _aggregate(table, nbr_idx, nbr_mask)
    if backend == "segment":
        b, k = nbr_idx.shape
        if csr is None:
            from repro_torch.graph.csr import bucketed_csr_from_padded

            csr = bucketed_csr_from_padded(nbr_idx, nbr_mask)
        else:
            _check_bucketed(csr, b, k)
        return _segment_mean(table, csr, b, k)
    if backend == "spmm":
        from repro_torch.kernels.spmm.ops import neighbor_spmm, sparse_spmm

        if _sparse(spmm_route):
            return sparse_spmm(table, nbr_idx, nbr_mask)
        return neighbor_spmm(table, nbr_idx, nbr_mask, adj=adj)
    raise ValueError(f"unknown aggregation backend {backend!r}; known: {AGG_BACKENDS}")


SPMM_ROUTES = ("dense", "sparse")


def _sparse(route: str) -> bool:
    if route not in SPMM_ROUTES:
        raise ValueError(f"unknown spmm route {route!r}; known: {SPMM_ROUTES}")
    return route == "sparse"


def _check_bucketed(csr: dict, b: int, k: int) -> None:
    """Raise unless edge slot ``i·K + j`` routes to row i or to the overflow
    segment b: the only layout ``_segment_mean`` sums right. The
    reference's ``segment_sum`` takes any order (its two-call serve path
    packs the real edges first), so a csr from elsewhere is checked."""
    dst = csr["dst"]
    rows = torch.arange(b, device=dst.device).repeat_interleave(k)
    if tuple(dst.shape) != (b * k,) or not bool(((dst == rows) | (dst == b)).all()):
        raise ValueError(
            "segment backend: csr is not in the bucketed form (each row's K "
            "slots contiguous, padding routed to segment b); build it with "
            "graph.csr.bucketed_csr_from_padded")


def _segment_mean(table: torch.Tensor, csr: dict, b: int, k: int) -> torch.Tensor:
    real = (csr["dst"] < b)[:, None]
    vals = torch.where(real, table[csr["src"].long()], 0.0)
    return vals.reshape(b, k, -1).sum(1) * csr["inv_deg"][:, None]


def _sage_layer(params: dict, l: int, h_self: torch.Tensor,
                h_agg: torch.Tensor) -> torch.Tensor:
    return torch.relu(
        h_self @ params[f"w_self{l}"] + h_agg @ params[f"w_nbr{l}"] + params[f"b{l}"]
    )


def row_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` as products of ``ROW_BLOCK`` rows each (the last padded
    with zeros): every row goes through one product shape, whatever the
    number of rows."""
    n = x.shape[0]
    pad = (-n) % ROW_BLOCK
    if n == 0:
        return x @ w
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return torch.cat([x[i:i + ROW_BLOCK] @ w for i in range(0, n + pad, ROW_BLOCK)])[:n]


def sage_layer_rows(params: dict, l: int, h_self: torch.Tensor,
                    h_agg: torch.Tensor) -> torch.Tensor:
    """``_sage_layer`` with its products in row blocks (``row_matmul``):
    the eval and serving paths' layer."""
    return torch.relu(row_matmul(h_self, params[f"w_self{l}"])
                      + row_matmul(h_agg, params[f"w_nbr{l}"]) + params[f"b{l}"])


def classify_rows(params: dict, h: torch.Tensor) -> torch.Tensor:
    """The classifier head with its product in row blocks."""
    return row_matmul(h, params["w_cls"]) + params["b_cls"]


def gcn_batch_forward(
    params: dict,
    features: torch.Tensor,      # (n, F) own features
    ghost_feat: torch.Tensor,    # (g, F) synced ghost features (historical l=0)
    hist1: torch.Tensor,         # (n + g, H1) historical layer-1 embeddings
    nbr_idx: torch.Tensor,       # (n, K) into [own | ghost]
    nbr_mask: torch.Tensor,      # (n, K)
    batch_idx: torch.Tensor,     # (b,) rows of this batch
    nbr_keep: torch.Tensor | None = None,   # optional (b, K) extra neighbor mask
    *,
    backend: str = "gather",
    spmm_route: str = "dense",
):
    """Returns (logits (b, C), fresh_h1 (b, H1), h2 (b, H2)).

    Layer 0 reads exact own and synced ghost features; layer 1 reads the
    historical table with the fresh in-batch ``h1`` put at ``batch_idx``
    out of place, so grads flow only through in-batch rows (the history is
    detached). Both layers share one aggregation operand, built once per
    call: the bucketed CSR (``segment``) or the row-normalised (b, n + g)
    adjacency and its block mask (``spmm``; on ``spmm_route="sparse"`` the
    batch's neighbor list itself, and the transposed launch's column-sorted
    operand is built in the backward).
    """
    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown aggregation backend {backend!r}; known: {AGG_BACKENDS}")
    batch_idx = batch_idx.long()
    table0 = torch.cat([features, ghost_feat], dim=0)
    b_idx = nbr_idx[batch_idx]
    b_mask = nbr_mask[batch_idx]
    if nbr_keep is not None:
        b_mask = b_mask * nbr_keep

    if backend == "gather":
        def agg(table):
            return _aggregate(table, b_idx, b_mask)
    elif backend == "segment":
        from repro_torch.graph.csr import bucketed_csr_from_padded

        csr = bucketed_csr_from_padded(b_idx, b_mask)

        def agg(table):
            return _segment_mean(table, csr, *b_idx.shape)
    elif _sparse(spmm_route):
        from repro_torch.kernels.spmm.ops import sparse_spmm

        def agg(table):
            return sparse_spmm(table, b_idx, b_mask)
    else:
        from repro_torch.kernels.spmm.ops import (
            TILE_K,
            TILE_M,
            adjacency_block_mask,
            adjacency_from_neighbors,
            block_spmm,
        )

        m = table0.shape[0]
        adj = adjacency_from_neighbors(b_idx, b_mask, m)
        mask = adjacency_block_mask(b_idx, b_mask, m, TILE_M, TILE_K)

        def agg(table):
            return block_spmm(adj, table, mask)

    h1 = _sage_layer(params, 0, features[batch_idx], agg(table0))       # (b, 256)
    table1 = hist1.detach().index_put((batch_idx,), h1)
    h2 = _sage_layer(params, 1, h1, agg(table1))                         # (b, 128)
    logits = h2 @ params["w_cls"] + params["b_cls"]
    return logits, h1, h2


def gcn_full_forward(params, features, nbr_idx, nbr_mask, *,
                     backend: str = "gather", csr: dict | None = None,
                     adj: torch.Tensor | None = None,
                     spmm_route: str = "dense") -> torch.Tensor:
    """Exact full-graph forward (server-side evaluation; no history). Its
    dense products run in row blocks (``row_matmul``), as the serving
    path's do."""
    h = features
    for l in range(len(HIDDEN)):
        agg = neighbor_aggregate(h, nbr_idx, nbr_mask, backend=backend,
                                 csr=csr, adj=adj, spmm_route=spmm_route)
        h = sage_layer_rows(params, l, h, agg)
    return classify_rows(params, h)


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
