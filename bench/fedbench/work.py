"""What a FedAIS round must compute and move, counted from shapes and
from the aggregations' inputs; and the peaks it is held to.

Frozen with the benchmark: a change to the program cannot move these
counts. ``Work`` records each neighbour aggregation as the program launches
the SpMM for it (``reference.batch_forward`` and ``eval_logits`` call
``aggregation`` in launch order), and ``dense_flops`` counts the GraphSAGE
products of a round.
"""
from __future__ import annotations

import torch

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at 700 W): the fp32
# rate outside the tensor cores, and HBM3's bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
HIDDEN = (256, 128)

# bytes of one nonzero of A: its fp32 value and its int32 column index,
# the least a sparse operand can hold
NONZERO_BYTES = 8


class Work:
    """The SpMM launches of some rounds, in launch order, each with the
    operations and bytes its inputs need."""

    def __init__(self):
        self.launches: list = []

    def aggregation(self, idx: torch.Tensor, mask: torch.Tensor, m_cols: int, d: int,
                    backward: bool = False) -> None:
        """A mean over the live slots of ``idx`` (rows, slots) into a table
        of ``m_cols`` rows of width ``d``: Y = A @ X with A (rows, m_cols).
        With ``backward``, also its transposed launch dX = Aᵀ @ dY."""
        live = mask > 0
        nnz = int(live.sum())
        x_rows = int(torch.unique(idx[live]).numel()) if nnz else 0
        n = int(idx.shape[0])
        self.launches.append(launch_work("forward", n, m_cols, d, nnz, x_rows))
        if backward:
            self.launches.append(launch_work("backward", m_cols, n, d, nnz,
                                             int(live.any(1).sum())))


def launch_work(kind: str, n: int, m: int, d: int, nnz: int, x_rows: int) -> dict:
    """Y (n, d) = A (n, m) @ X (m, d) with ``nnz`` nonzeros in A reaching
    ``x_rows`` distinct rows of X: 2·d operations a nonzero; the nonzeros,
    each referenced row of X once and all of Y once in bytes."""
    flops = 2.0 * d * nnz
    nbytes = NONZERO_BYTES * nnz + 4.0 * d * x_rows + 4.0 * d * n
    return {"kind": kind, "n": n, "m": m, "d": d, "nnz": nnz, "x_rows": x_rows,
            "flops": flops, "bytes": nbytes,
            "bound_s": max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)}


def dense_flops(rows: int, n_features: int, n_classes: int, *, train: bool) -> float:
    """The GraphSAGE products over ``rows`` nodes: per layer a self and a
    neighbour product, then the classifier. ``train`` adds the backward:
    the weights' gradients everywhere, the inputs' gradients where the
    input carries one (layer 1 and the classifier; layer 0's inputs are
    features)."""
    h0, h1 = HIDDEN
    fwd0 = 2 * 2.0 * rows * n_features * h0
    fwd_rest = 2 * 2.0 * rows * h0 * h1 + 2.0 * rows * h1 * n_classes
    if not train:
        return fwd0 + fwd_rest
    return 2 * fwd0 + 3 * fwd_rest


def round_dense_flops(members: int, n_max: int, batch: int, epochs: int,
                      n_features: int, n_classes: int) -> float:
    """One round's products: each member's loss pass over its n_max rows
    and ``epochs`` training steps over ``batch`` rows."""
    per = (dense_flops(n_max, n_features, n_classes, train=False)
           + epochs * dense_flops(batch, n_features, n_classes, train=True))
    return members * per


def eval_dense_flops(n_nodes: int, n_features: int, n_classes: int) -> float:
    return dense_flops(n_nodes, n_features, n_classes, train=False)
