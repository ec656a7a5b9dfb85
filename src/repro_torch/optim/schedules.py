"""Learning-rate schedules as plain callables ``step -> lr`` on a host
integer step (port of ``repro/optim/schedules.py``).

Each value is computed in fp32 with numpy ``float32`` scalars, operation
for operation as the reference computes it on its int32 step, and returned
as a Python float (an fp32 value exactly), so the lr is the reference's to
the bit. The cosine is the C library's single-precision ``cosf``: that is
what the reference's ``jnp.cos`` computes in fp32 on the CPU, where numpy's
and torch's vectorised fp32 cosines differ from it by one ulp at some
inputs.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

_F = np.float32


@functools.cache
def _cosf():
    libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    fn = libm.cosf
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float
    return fn


def _cos(x: np.float32) -> np.float32:
    return _F(_cosf()(float(x)))


def constant(lr: float):
    def schedule(step: int) -> float:
        return float(_F(lr))

    return schedule


def _cosine(lr: float, decay_steps: int, final_ratio: float, step: np.float32) -> np.float32:
    frac = np.clip(step / _F(decay_steps), _F(0.0), _F(1.0))
    cos = _F(0.5) * (_F(1.0) + _cos(_F(np.pi) * frac))
    return _F(lr) * (_F(final_ratio) + _F(1.0 - final_ratio) * cos)


def cosine_decay(lr: float, decay_steps: int, final_ratio: float = 0.1):
    def schedule(step: int) -> float:
        return float(_cosine(lr, decay_steps, final_ratio, _F(step)))

    return schedule


def linear_warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                         final_ratio: float = 0.1):
    cos_steps = max(1, decay_steps - warmup_steps)

    def schedule(step: int) -> float:
        s = _F(step)
        if s < warmup_steps:
            return float(_F(lr) * s / _F(max(1, warmup_steps)))
        return float(_cosine(lr, cos_steps, final_ratio, s - _F(warmup_steps)))

    return schedule
