"""The port's package surface against the reference's (ROADMAP C6).

For every package of ``repro`` that declares ``__all__``, each name must
import from the same package of ``repro_torch``, except the names listed in
``WAITING`` with the ROADMAP item that brings them; each of those must
still fail to import, so the list cannot go stale. The six extension
protocols of ``repro.api`` have the reference's method names, and the
port's default components satisfy them.
"""
import importlib
import inspect
import pkgutil
from pathlib import Path

import pytest

import repro

ROADMAP = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()

# (package, name) -> the ROADMAP item that brings it, or why it differs
WAITING = {
    # takes the reference's jitted vmapped update, which the port leaves
    # out; the port's fault-aware fused merge is faults.build_faulty_merge
    ("faults", "build_faulty_chunk"): "deliberate difference",
}
PROTOCOLS = ("ClientSelector", "Aggregator", "SyncController", "CostModel", "RoundScheduler",
             "RoundCallback")


def _reference_packages() -> dict:
    out = {}
    for info in pkgutil.walk_packages(repro.__path__, "repro."):
        if not info.ispkg:
            continue
        mod = importlib.import_module(info.name)
        if hasattr(mod, "__all__"):
            out[info.name[len("repro."):]] = list(mod.__all__)
    return out


PACKAGES = _reference_packages()


def _port_name(pkg: str, name: str):
    """The port's ``pkg.name``, or raise ImportError as ``from ... import``
    would."""
    mod = importlib.import_module(f"repro_torch.{pkg}")
    if not hasattr(mod, name):
        raise ImportError(f"cannot import name {name!r} from repro_torch.{pkg}")
    return getattr(mod, name)


def test_every_exporting_package_is_checked():
    assert {"api", "checkpoint", "configs", "core", "data", "faults", "optim", "serve",
            "sharding", "kernels.spmm", "kernels.wkv6", "kernels.flash_attention"} \
        <= set(PACKAGES)
    assert {pkg for pkg, _ in WAITING} <= set(PACKAGES)
    for (pkg, name), why in WAITING.items():
        assert name in PACKAGES[pkg]
        assert why == "deliberate difference" or why in ROADMAP, why
    assert "build_faulty_chunk" in ROADMAP


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_reference_names_import_from_the_port(pkg):
    missing = []
    for name in PACKAGES[pkg]:
        if (pkg, name) in WAITING:
            continue
        try:
            _port_name(pkg, name)
        except ImportError as e:
            missing.append(f"{name}: {e}")
    assert not missing, missing


@pytest.mark.parametrize("key", sorted(WAITING), ids=lambda k: ".".join(k))
def test_waiting_names_still_fail_to_import(key):
    with pytest.raises(ImportError):
        _port_name(*key)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_port_all_lists_what_it_exports(pkg):
    """The port's ``__all__`` names every reference name it has, and each
    of its names resolves."""
    try:
        mod = importlib.import_module(f"repro_torch.{pkg}")
    except ImportError:
        assert all((pkg, n) in WAITING for n in PACKAGES[pkg])
        return
    have = set(getattr(mod, "__all__", ()))
    assert {n for n in PACKAGES[pkg] if (pkg, n) not in WAITING} <= have
    for name in have:
        assert hasattr(mod, name), name


@pytest.mark.parametrize("name", PROTOCOLS)
def test_protocols_have_the_reference_methods(name):
    ref = getattr(importlib.import_module("repro.api"), name)
    got = _port_name("api", name)

    def methods(cls):
        return {m for m, v in vars(cls).items() if inspect.isfunction(v)
                and not m.startswith("_")}

    assert methods(got) == methods(ref)
    for m in methods(ref):
        assert (list(inspect.signature(getattr(got, m)).parameters)
                == list(inspect.signature(getattr(ref, m)).parameters)), m


def test_port_defaults_satisfy_the_protocols():
    from repro_torch import api

    pairs = [(api.UniformSelector(), api.ClientSelector),
             (api.SizeBiasedSelector(), api.ClientSelector),
             (api.LossBiasedSelector(), api.ClientSelector),
             (api.FedAvg(), api.Aggregator), (api.WeightedFedAvg(), api.Aggregator),
             (api.StalenessWeightedAggregator(), api.Aggregator),
             (api.AdaptiveSyncController(), api.SyncController),
             (api.FixedSyncController(), api.SyncController),
             (api.PaperCostModel(), api.CostModel),
             (api.SyncScheduler(), api.RoundScheduler),
             (api.AsyncScheduler(), api.RoundScheduler)]
    pairs += [(cb, api.RoundCallback) for cb in api.default_callbacks()]
    for obj, proto in pairs:
        assert isinstance(obj, proto), (type(obj).__name__, proto.__name__)
    assert not isinstance(object(), api.ClientSelector)


def test_kernel_exports_are_the_counted_wrappers():
    """``repro_torch.kernels.<name>`` exports the wrapper whose launch
    counter ``chip_smoke.py`` reads, not a copy of it."""
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.spmm import ops as sops
    from repro_torch.kernels.wkv6 import ops as wops

    assert _port_name("kernels.spmm", "block_spmm") is sops.block_spmm
    assert _port_name("kernels.wkv6", "wkv6") is wops.wkv6
    assert _port_name("kernels.flash_attention", "flash_attention") is fops.flash_attention
