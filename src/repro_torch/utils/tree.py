"""Tree helpers (port of ``repro/utils/tree.py``, which imports jax).

A tree is a nest of dicts, lists and tuples whose leaves are tensors (or,
for the host helpers, numpy arrays). Leaves are visited in the reference's
order: a dict's keys sorted, as ``jax.tree_util`` flattens them, so a
reduction over the leaves sums them in the reference's order. Scalars come
back as 0-d tensors where the reference returns 0-d arrays.

``tree_random_like`` takes a ``torch.Generator`` in place of a key and a
tree of tensors (meta tensors will do) in place of ``ShapeDtypeStruct``s.
``tree_to_shape_dtype`` is left out: it builds ``jax.ShapeDtypeStruct``s
for the reference's dry run, which the port does not have.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

PyTree = Any


def tree_leaves(tree: PyTree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, *trees: PyTree) -> PyTree:
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else type(first)(out)
    return fn(*trees)


def tree_map_with_path(fn: Callable, tree: PyTree, path: tuple = ()) -> PyTree:
    """``fn(path, leaf)`` over a nest of dicts, lists and tuples, the
    structure kept; ``path`` holds the dict keys and list indices down to
    the leaf (``jax.tree_util.tree_map_with_path``'s keys, unwrapped)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree)


def tree_zeros_like(tree: PyTree, dtype=None) -> PyTree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=dtype or x.dtype), tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: PyTree, s) -> PyTree:
    return tree_map(lambda x: x * s, tree)


def tree_axpy(alpha, x: PyTree, y: PyTree) -> PyTree:
    """alpha * x + y, elementwise over matching trees."""
    return tree_map(lambda a, b: alpha * a + b, x, y)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Inner product between two trees, in fp32, the leaves summed in order."""
    total = torch.zeros((), dtype=torch.float32)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        total = total.to(x.device) + torch.sum(x.float() * y.float())
    return total


def tree_l2_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(tree_dot(tree, tree))


def tree_count_params(tree: PyTree) -> int:
    return int(sum(math.prod(x.shape) for x in tree_leaves(tree)))


def _itemsize(x) -> int:
    return x.element_size() if torch.is_tensor(x) else np.dtype(x.dtype).itemsize


def tree_bytes(tree: PyTree) -> int:
    return int(sum(math.prod(x.shape) * _itemsize(x) for x in tree_leaves(tree)))


def tree_cast(tree: PyTree, dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def tree_isfinite(tree: PyTree) -> torch.Tensor:
    """True iff every floating leaf is finite everywhere."""
    leaves = [torch.isfinite(x).all() for x in tree_leaves(tree) if x.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack([x.cpu() for x in leaves]).all()


def tree_shapes(tree: PyTree) -> PyTree:
    return tree_map(lambda x: tuple(x.shape), tree)


def tree_random_like(generator: torch.Generator, tree: PyTree,
                     scale: float = 0.02) -> PyTree:
    """A tree of the same shapes and dtypes on the generator's device:
    floating leaves normal draws times ``scale``, the others zeros."""
    dev = generator.device

    def fill(x):
        if x.is_floating_point():
            w = torch.randn(x.shape, generator=generator, dtype=torch.float32, device=dev)
            return (w * scale).to(x.dtype)
        return torch.zeros(x.shape, dtype=x.dtype, device=dev)

    return tree_map(fill, tree)


def global_norm_clip(tree: PyTree, max_norm: float) -> tuple[PyTree, torch.Tensor]:
    """(tree scaled to a global L2 norm of at most ``max_norm``, the norm).
    A bf16 leaf comes back fp32, as jnp promotes a bf16 array times an
    fp32 scalar array."""
    norm = tree_l2_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: x.to(torch.promote_types(x.dtype, scale.dtype)) * scale,
                    tree), norm


def format_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0:
            return f"{n:.2f} {unit}"
        n /= 1024.0
    return f"{n:.2f} PiB"


def format_count(n: float) -> str:
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000.0:
            return f"{n:.2f}{unit}"
        n /= 1000.0
    return f"{n:.2f}E"


def stable_hash(s: str) -> int:
    """Deterministic 32-bit hash (python hash() is salted per-process)."""
    h = 2166136261
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h


def np_one_hot(x: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((*x.shape, n), dtype=np.float32)
    np.put_along_axis(out, x[..., None], 1.0, axis=-1)
    return out
