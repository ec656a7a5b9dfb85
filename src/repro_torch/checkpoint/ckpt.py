"""Msgpack pytree checkpoints, in the reference's file format.

Port of ``repro/checkpoint/ckpt.py``. Layout: ``<dir>/step_<n>.msgpack``,
a map from '/'-joined key paths to ``{"dtype", "shape", "data"}`` records
(numpy dtype name, list of ints, the C-order bytes). The port reads and
writes it with its own codec (``checkpoint._msgpack``), so a file written
by either package loads in the other, and the same arrays give the same
bytes.

Key paths and their order are the reference's (``jax.tree_util``'s
flattening): a dict's keys sorted, a NamedTuple's fields in order by name,
a list's or tuple's items by index; ``None`` holds no leaf. Leaves are
numpy arrays or tensors (written from the host copy, with their own
dtype); ``load_checkpoint`` returns numpy leaves in the template's
structure, ``convert.params_from_numpy`` carries params to a device.
"""
from __future__ import annotations

import os
import re
from typing import Any

import numpy as np

from repro_torch.checkpoint._msgpack import MsgpackError, packb, unpackb

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: PyTree, path: tuple, out: list) -> None:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), out)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(getattr(tree, name), path + (name,), out)
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            _flatten(item, path + (str(i),), out)
    else:
        out.append(("/".join(path), tree))


def _unflatten(tree: PyTree, leaves) -> PyTree:
    """``tree``'s structure with its leaves replaced, in flattening order,
    by the next items of the iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):                  # a torch tensor
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: PyTree) -> dict[str, Any]:
    out: list = []
    _flatten(tree, (), out)
    return dict(out)


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.msgpack")


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Write ``tree`` as ``step_<step>.msgpack``: to a ``.tmp`` file, fsync,
    then an atomic rename; a failed write leaves no ``.tmp`` behind."""
    os.makedirs(directory, exist_ok=True)
    payload = {}
    for k, leaf in _flatten_with_paths(tree).items():
        v = _host(leaf)
        payload[k] = {"dtype": str(v.dtype), "shape": list(v.shape), "data": v.tobytes()}
    path = _path(directory, step)
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(packb(payload))
            # flush + fsync before the rename: os.replace is atomic in the
            # namespace but not durable
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(directory: str, step: int, like: PyTree) -> PyTree:
    """Restore into the structure of ``like`` (a template whose leaves
    need only ``.shape``). Each leaf is a writable numpy array with the
    file's dtype; a shape other than the template's raises."""
    path = _path(directory, step)
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    if not isinstance(payload, dict):
        raise TypeError(f"checkpoint {path} holds a {type(payload).__name__}, not a map")
    leaves = []
    for key, template in _flatten_with_paths(like).items():
        if key not in payload:
            raise KeyError(f"checkpoint {path} missing key {key!r}")
        rec = payload[key]
        arr = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"]).copy()
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != template "
                             f"{tuple(template.shape)}")
        leaves.append(arr)
    return _unflatten(like, iter(leaves))


# what a torn or corrupt file surfaces as: truncated or unreadable bytes
# (OSError, MsgpackError), a payload that is not the expected map
# (TypeError, ValueError from frombuffer or a shape mismatch), or one
# missing leaves (KeyError)
_CORRUPT_ERRORS = (OSError, ValueError, KeyError, TypeError, MsgpackError)


def load_latest(directory: str, like: PyTree, *, strict: bool = False) -> tuple[int, PyTree]:
    """Restore the newest loadable ``step_*.msgpack`` in ``directory``.

    A torn or corrupt checkpoint is skipped for the next-newest step;
    ``strict=True`` raises on the newest instead. Raises
    ``FileNotFoundError`` when there is no checkpoint, ``ValueError``
    (listing each step's failure) when none loads. Returns ``(step, tree)``.
    """
    steps = checkpoint_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no step_*.msgpack checkpoints in {directory!r}")
    failures = []
    for step in reversed(steps):
        try:
            return step, load_checkpoint(directory, step, like)
        except _CORRUPT_ERRORS as e:
            if strict:
                raise
            failures.append(f"step {step}: {type(e).__name__}: {e}")
    raise ValueError(f"no loadable checkpoint in {directory!r}; every "
                     "candidate failed:\n  " + "\n  ".join(failures))


def checkpoint_steps(directory: str) -> list[int]:
    """All checkpoint steps present in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(m.group(1))
        for fname in os.listdir(directory)
        if (m := re.fullmatch(r"step_(\d+)\.msgpack", fname))
    )


def latest_step(directory: str) -> int | None:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None
