"""Counted collectives: the wire of the sharded executors.

Each wrapper runs one ``torch.distributed`` collective on a process group
(NCCL on the card, gloo on the CPU) and adds one call and the bytes it
moves to ``COUNTS[tag]``: an all-reduce counts its tensor, an all-gather
the gathered output, an all-to-all its input (= its output). The tags are
the entries of ``sharding.ledger.pod_placement_ledger`` (and the
client-sharded executor's own), so a round's counts can be held to the
ledger's.

While a CUDA graph is being captured a call is added to ``CAPTURED``
instead (the capture runs nothing); the graph's owner adds what its capture
recorded to ``COUNTS`` on each replay, as ``block_spmm.captured`` /
``launches`` do for the SpMM.

``pack`` / ``unpack`` lay several tensors of one leading size side by side
as bytes (``uint8``) or 32-bit words (``int32``), so one collective moves
them all: an all-gather or an all-to-all of bytes transports them bit for
bit, and an int32 sum with one non-zero contributor per element (the
owner-keyed fetch) does too, whatever the tensors' own type.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist

__all__ = ["CAPTURED", "COUNTS", "KIND", "CollectiveStats", "add", "all_gather",
           "all_reduce_sum", "all_to_all", "collective_stats", "diff", "pack", "reset",
           "snapshot", "unpack"]

COUNTS: dict = {}       # tag -> [calls, bytes]
CAPTURED: dict = {}     # the same, recorded while a CUDA graph was captured
KIND: dict = {}         # tag -> the collective that moved it

# torch >= 2.12 names it all_gather_single; older releases all_gather_into_tensor
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _count(tag: str, kind: str, t: torch.Tensor) -> None:
    if KIND.setdefault(tag, kind) != kind:
        raise ValueError(f"tag {tag!r} moved by {KIND[tag]} and by {kind}")
    nbytes = t.numel() * t.element_size()
    book = CAPTURED if t.is_cuda and torch.cuda.is_current_stream_capturing() else COUNTS
    calls, total = book.get(tag, (0, 0))
    book[tag] = [calls + 1, total + int(nbytes)]


def reset() -> None:
    COUNTS.clear()


def snapshot(book: dict | None = None) -> dict:
    return {k: tuple(v) for k, v in (COUNTS if book is None else book).items()}


def diff(after: dict, before: dict) -> dict:
    """``after - before`` of two snapshots, tags with nothing moved left out."""
    out = {}
    for k, (c, b) in after.items():
        c0, b0 = before.get(k, (0, 0))
        if c != c0 or b != b0:
            out[k] = (c - c0, b - b0)
    return out


def add(delta: dict) -> None:
    for k, (c, b) in delta.items():
        calls, total = COUNTS.get(k, (0, 0))
        COUNTS[k] = [calls + c, total + b]


@dataclass
class CollectiveStats:
    """Bytes and calls per collective kind (the reference's
    ``utils/hlo.py::CollectiveStats``)."""

    bytes_by_kind: dict = field(default_factory=dict)
    count_by_kind: dict = field(default_factory=dict)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())

    def summary(self) -> str:
        parts = [f"{k}: n={self.count_by_kind[k]} bytes={self.bytes_by_kind[k]:,}"
                 for k in sorted(self.bytes_by_kind)]
        return "; ".join(parts) if parts else "(no collectives)"


def collective_stats(counts: dict | None = None) -> CollectiveStats:
    """``counts`` (a ``snapshot`` or a ``diff``, ``COUNTS`` by default)
    summed by the kind of collective that moved each tag."""
    stats = CollectiveStats()
    for tag, (calls, nbytes) in (snapshot() if counts is None else counts).items():
        kind = KIND[tag]
        stats.bytes_by_kind[kind] = stats.bytes_by_kind.get(kind, 0) + int(nbytes)
        stats.count_by_kind[kind] = stats.count_by_kind.get(kind, 0) + int(calls)
    return stats


def all_reduce_sum(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Sum ``t`` in place over ``group``."""
    _count(tag, "all-reduce", t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """``t`` of every rank of ``group`` stacked on a new leading axis, in
    the group's rank order."""
    n = dist.get_world_size(group)
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _count(tag, "all-gather", out)
    _all_gather_into(out, t.contiguous(), group=group)
    return out.view((n,) + tuple(t.shape))


def all_to_all(t: torch.Tensor, group, tag: str) -> torch.Tensor:
    """Slot ``q`` of ``t``'s leading axis (one per rank of ``group``) goes to
    rank ``q``; slot ``p`` of the result is what rank ``p`` sent here."""
    if t.shape[0] != dist.get_world_size(group):
        raise ValueError(f"all_to_all: leading axis {t.shape[0]} != group size "
                         f"{dist.get_world_size(group)}")
    t = t.contiguous()
    out = torch.empty_like(t)
    _count(tag, "all-to-all", t)
    dist.all_to_all_single(out, t, group=group)
    return out


def pack(parts, word=torch.uint8) -> torch.Tensor:
    """The tensors ``parts`` (one leading size n each, any types whose rows
    fill whole words) as one (n, words) tensor of ``word``."""
    n = parts[0].shape[0]
    return torch.cat([p.contiguous().reshape(n, -1).view(word) for p in parts], dim=1)


def unpack(buf: torch.Tensor, like) -> list:
    """Undo ``pack``: ``like`` holds (trailing shape, dtype) per part; the
    leading size is ``buf``'s."""
    n, at, out = buf.shape[0], 0, []
    for shape, dtype in like:
        width = int(torch.Size(shape).numel()) * torch.empty((), dtype=dtype).element_size()
        width //= buf.element_size()
        out.append(buf[:, at:at + width].contiguous().view(dtype).reshape((n,) + tuple(shape)))
        at += width
    if at != buf.shape[1]:
        raise ValueError(f"unpack: {at} of {buf.shape[1]} words described")
    return out
