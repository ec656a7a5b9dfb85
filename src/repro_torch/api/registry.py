"""String-keyed registries: method name -> (config preset, strategy kind),
aggregator name -> Aggregator factory, scheduler name -> RoundScheduler.

Port of ``repro/api/registry.py``, with the paper's method-space registered
as the reference registers it. These methods run: ``fedais``, ``fedais1``,
``fedais2``, ``fedall``, ``fedrandom``, ``fedpns``, ``fedlocal``.
``fedsage+`` and ``fedgraph`` resolve to strategy kinds still to port, and
the ``staleness`` aggregator and ``async`` scheduler belong to the async
path (ROADMAP A2); ``sync_fused`` is the fused executor (A4). Each raises
``NotImplementedError`` naming its queue item.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

from repro_torch.api.protocols import FedAvg, SyncScheduler, WeightedFedAvg
from repro_torch.api.strategies import build_strategy  # re-exported  # noqa: F401
from repro_torch.core.fedais import MethodConfig


@dataclass(frozen=True)
class MethodSpec:
    name: str
    strategy: str                 # strategy kind key ("auto" = infer)
    defaults: Mapping[str, Any]   # MethodConfig field overrides


_METHODS: dict[str, MethodSpec] = {}


def register_method(name: str, *, strategy: str = "auto",
                    overwrite: bool = False, **defaults) -> MethodSpec:
    """Register a method under ``name`` with MethodConfig field defaults."""
    if name in _METHODS and not overwrite:
        raise KeyError(f"method {name!r} already registered")
    spec = MethodSpec(name=name, strategy=strategy, defaults=dict(defaults))
    _METHODS[name] = spec
    return spec


def unregister_method(name: str) -> None:
    _METHODS.pop(name, None)


def available_methods() -> tuple[str, ...]:
    return tuple(sorted(_METHODS))


def method_config(name: str, **overrides) -> MethodConfig:
    """Resolve a registered method name to its MethodConfig."""
    if name not in _METHODS:
        raise KeyError(f"unknown method {name!r}; known: {sorted(_METHODS)}")
    spec = _METHODS[name]
    kw = dict(spec.defaults)
    kw.update(overrides)
    kw.setdefault("strategy", spec.strategy)
    return MethodConfig(name=name, **kw)


def _build(table: dict, not_ported: dict, what: str, name: str, **kwargs):
    if name in not_ported:
        raise NotImplementedError(f"{what} {name!r} is not ported yet ({not_ported[name]})")
    if name not in table:
        raise KeyError(f"unknown {what} {name!r}; known: {sorted(table)}")
    return table[name](**kwargs)


_AGGREGATORS: dict[str, Callable] = {}
_AGGREGATORS_NOT_PORTED = {"staleness": "ROADMAP A2"}


def register_aggregator(name: str, factory: Callable, *, overwrite: bool = False) -> None:
    if name in _AGGREGATORS and not overwrite:
        raise KeyError(f"aggregator {name!r} already registered")
    _AGGREGATORS[name] = factory


def available_aggregators() -> tuple[str, ...]:
    return tuple(sorted(_AGGREGATORS))


def build_aggregator(name: str):
    return _build(_AGGREGATORS, _AGGREGATORS_NOT_PORTED, "aggregator", name)


register_aggregator("fedavg", FedAvg)
register_aggregator("weighted", WeightedFedAvg)


_SCHEDULERS: dict[str, Callable] = {}
_SCHEDULERS_NOT_PORTED = {"sync_fused": "ROADMAP A4", "async": "ROADMAP A2"}


def register_scheduler(name: str, factory: Callable, *, overwrite: bool = False) -> None:
    if name in _SCHEDULERS and not overwrite:
        raise KeyError(f"scheduler {name!r} already registered")
    _SCHEDULERS[name] = factory


def available_schedulers() -> tuple[str, ...]:
    return tuple(sorted(_SCHEDULERS))


def build_scheduler(name: str, **kwargs):
    """Resolve a registered scheduler key; kwargs go to the factory."""
    return _build(_SCHEDULERS, _SCHEDULERS_NOT_PORTED, "scheduler", name, **kwargs)


register_scheduler("sync", SyncScheduler)
register_scheduler("sync_stepwise", lambda **kw: SyncScheduler(fused=False, **kw))


# ---------------------------------------------------------------------------
# the paper's method-space (Table 2 / Fig. 5 columns)
# ---------------------------------------------------------------------------

register_method("fedall", importance_sampling=False, adaptive_sync=False,
                use_all_samples=True, tau0=1)
register_method("fedrandom", importance_sampling=False, adaptive_sync=False,
                use_all_samples=False, tau0=1)
register_method("fedsage+", strategy="generator",
                importance_sampling=False, adaptive_sync=False,
                use_all_samples=True, tau0=1, use_generator=True)
register_method("fedpns", importance_sampling=False, adaptive_sync=False,
                use_all_samples=True, tau0=2)
register_method("fedgraph", strategy="bandit",
                importance_sampling=False, adaptive_sync=False,
                use_all_samples=True, tau0=1, bandit_fanout=True)
register_method("fedlocal", importance_sampling=False, adaptive_sync=False,
                use_all_samples=True, tau0=1, use_ghosts=False)
register_method("fedais1", importance_sampling=True, adaptive_sync=False)
register_method("fedais2", importance_sampling=False, adaptive_sync=True,
                use_all_samples=True)
register_method("fedais", importance_sampling=True, adaptive_sync=True)
