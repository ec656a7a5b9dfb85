"""Adaptive embedding synchronization (paper Eq. 9-11 + the delay model).

Theorem 2 bounds the expected min squared gradient norm after runtime
c_total by  2(F0 - Finf)/(eta c_total) * (c + o/tau) + eta^2 lam^2 zeta^2 (tau-1):
larger tau amortises communication o but adds staleness noise. Minimising
over tau gives Eq. (10); the practical parameter-free rule (Eq. 11) tracks
sqrt(F_t / F_0):

    tau_t = ceil( sqrt(F(theta_t) / F(theta_0)) * tau_0 )

so synchronization becomes *more frequent as the loss decays* — exactly the
schedule the convergence condition (Thm. 3 / Eq. 12) wants.

A copy of ``repro/core/sync.py``: host float arithmetic, so exact.
"""
from __future__ import annotations

import math


def tau_theoretical(
    f_t: float, f_inf: float, o: float, eta: float, c_total: float,
    lam: float, zeta2: float,
) -> float:
    """Eq. (10): optimal tau from the error bound (needs lam, zeta)."""
    denom = eta ** 3 * c_total * lam ** 2 * zeta2
    if denom <= 0:
        return 1.0
    return math.sqrt(max(0.0, 2.0 * (f_t - f_inf) * o) / denom)


def adaptive_tau(f_t: float, f_0: float, tau0: int, *, tau_min: int = 1, tau_max: int = 64) -> int:
    """Eq. (11): the practical parameter-free rule (F_inf approximated by 0)."""
    if f_0 <= 0.0 or not math.isfinite(f_t) or not math.isfinite(f_0):
        return tau0
    tau = math.ceil(math.sqrt(max(f_t, 0.0) / f_0) * tau0)
    return max(tau_min, min(tau_max, tau))


def error_bound(f0: float, f_inf: float, eta: float, lam: float, zeta2: float,
                c: float, o: float, tau: float, c_total: float) -> float:
    """The Theorem-2 bound itself (Eq. 9) — used by tests to verify Eq. (10)
    actually minimises it, and by the benchmark that plots the trade-off."""
    term1 = 2.0 * (f0 - f_inf) / (eta * c_total) * (c + o / tau)
    term2 = eta ** 2 * lam ** 2 * zeta2 * (tau - 1.0)
    return term1 + term2


def delay_model(c_epoch: list[float] | tuple, o: float, tau: float) -> dict:
    """Paper's runtime model: full sync c_syn = max_k c_k + o; periodic
    c_avg = max_k mean(c_k) + o / tau."""
    c_syn = max(c_epoch) + o
    c_avg = max(c_epoch) + o / max(tau, 1.0)
    return {"c_syn": c_syn, "c_avg": c_avg, "speedup": c_syn / max(c_avg, 1e-12)}
