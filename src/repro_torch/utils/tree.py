"""Host helpers copied from ``repro/utils/tree.py`` (which imports jax)."""
from __future__ import annotations


def stable_hash(s: str) -> int:
    """Deterministic 32-bit hash (python hash() is salted per-process)."""
    h = 2166136261
    for c in s.encode():
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    return h
