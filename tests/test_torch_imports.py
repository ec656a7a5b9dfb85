"""The port stands alone: no jax, nothing of ``repro`` and no ``msgpack``
(the card's machine has none; the port's checkpoints use its own codec) in
``src/repro_torch`` or ``chip_smoke.py``, and no quiet CPU fallback."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not (_imported_roots(path) & set(FORBIDDEN)), path


def test_every_submodule_imports_without_jax():
    code = """
import sys, pkgutil, importlib
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["jaxlib"] = None
sys.modules["msgpack"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 58


@pytest.mark.parametrize("name", ["faults", "faults.plan", "faults.fused", "api.fused",
                                  "federated.baselines", "federated.simulator"])
def test_method_space_modules_stand_alone(name):
    """The method space's modules and the fused executor's are among those
    checked above, and each imports without jax and without the
    reference."""
    path = PORT.joinpath(*name.split(".")).with_suffix(".py")
    if not path.exists():
        path = PORT.joinpath(*name.split("."), "__init__.py")
    assert path.is_file(), name
    assert not (_imported_roots(path) & set(FORBIDDEN)), name
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import importlib
importlib.import_module("repro_torch.{name}")
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", ["checkpoint", "checkpoint.ckpt", "checkpoint._msgpack",
                                  "serve.model", "serve.engine", "launch.serve_fed",
                                  "launch.fed_chaos", "launch.serve"])
def test_deployment_modules_stand_alone(name):
    """The deployment path's modules import without jax, the reference and
    msgpack."""
    path = PORT.joinpath(*name.split(".")).with_suffix(".py")
    if not path.exists():
        path = PORT.joinpath(*name.split("."), "__init__.py")
    assert path.is_file(), name
    assert not (_imported_roots(path) & set(FORBIDDEN)), name
    code = f"""
import sys, warnings
warnings.simplefilter("ignore", DeprecationWarning)
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["msgpack"] = None
import importlib
importlib.import_module("repro_torch.{name}")
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


def test_deployment_entry_points_never_fall_back(monkeypatch, tmp_path):
    """``ServedModel.restore`` and the launchers default to ``cuda:0`` and
    raise without CUDA."""
    from repro_torch.api import FedEngine
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset
    from repro_torch.launch import fed_chaos, serve_fed
    from repro_torch.serve import ServedModel, save_federation

    g = make_dataset("pubmed", scale=64, seed=0)
    fed = partition_graph(g, 3, alpha=0.5, seed=0)
    eng = FedEngine(g, fed, "fedais", rounds=1, clients_per_round=2, device="cpu")
    state = eng.init_state()
    save_federation(str(tmp_path), 1, state)
    assert ServedModel.restore(str(tmp_path), g, fed, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServedModel.restore(str(tmp_path), g, fed)
    assert serve_fed.build_args([]).device == fed_chaos.build_args([]).device == "cuda:0"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_fed.run_pipeline(serve_fed.build_args([
            "--quick", "--ckpt-dir", str(tmp_path / "new"), "--out", str(tmp_path / "x.json")]))
    assert not (tmp_path / "x.json").exists()


def test_resolve_device_never_falls_back(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.models.gcn import gcn_init
    from repro_torch.serve import GraphStore, ServedModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    with pytest.raises(RuntimeError):
        gcn_init(torch.Generator().manual_seed(0), 4, 2)
    params = gcn_init(torch.Generator().manual_seed(0), 4, 2, device="cpu")
    store = GraphStore(np.zeros((3, 4), np.float32), np.zeros((3, 2), np.int32),
                       np.zeros((3, 2), np.float32))
    with pytest.raises(RuntimeError):
        ServedModel(params, store, backend="gather")


@pytest.mark.parametrize("name", ["examples.serve_lm", "launch.serve_lm_cli", "models.lm",
                                  "models.attention"])
def test_lm_modules_stand_alone(name):
    """The LM slice's modules, the serving example among them, import
    without jax and the reference."""
    path = PORT.joinpath(*name.split(".")).with_suffix(".py")
    assert path.is_file(), name
    assert not (_imported_roots(path) & set(FORBIDDEN)), name
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import importlib
importlib.import_module("repro_torch.{name}")
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


def test_lm_entry_points_never_fall_back(monkeypatch):
    """The LM slice's entry points default to ``cuda:0`` and raise without
    CUDA, like the serving slice's."""
    import argparse

    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.serve_lm_cli import serve
    from repro_torch.models.lm import init_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("gemma3-12b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_lm(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(argparse.Namespace(arch="gemma3-12b", batch=1, prompt_len=4, gen=2, seed=0,
                                 device=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_params_from_numpy({"embed": np.zeros((4, 2), np.float32)}, cfg)


def test_training_entry_points_never_fall_back(monkeypatch):
    """The training slice's entry point, ``FedEngine``, defaults to
    ``cuda:0`` and raises without CUDA; on ``device="cpu"`` it runs."""
    from repro_torch.api import FedEngine
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset

    g = make_dataset("pubmed", scale=64, seed=0)
    fed = partition_graph(g, 3, alpha=0.5, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedEngine(g, fed, "fedais", rounds=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedEngine(g, fed, "fedais", rounds=1, device="cuda:0")
    eng = FedEngine(g, fed, "fedais", rounds=1, clients_per_round=2, device="cpu")
    assert eng.device == torch.device("cpu") and eng.run().history["round"] == [0]


def test_chip_smoke_refuses_without_a_checkout_or_card(tmp_path):
    """Alone in a directory (or on a machine without CUDA) it prints no
    result and exits non-zero."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


SHARDING = ("sharding", "sharding.comm", "sharding.fed", "sharding.tables", "sharding.ledger",
            "sharding.ranks")


def test_the_glob_covers_the_sharding_modules():
    """``test_no_jax_or_reference_imports`` globs the port: the multi-device
    executors' modules are among its cases."""
    found = {str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
    for name in SHARDING:
        rel = name.replace(".", "/") + ("/__init__.py" if name == "sharding" else ".py")
        assert rel in found, rel


@pytest.mark.parametrize("name", SHARDING + ("api.fused", "api.engine", "launch.fed_chaos"))
def test_sharding_modules_stand_alone(name):
    """The multi-device executors' modules import without jax, the
    reference and msgpack, and touch no process group at import."""
    path = PORT.joinpath(*name.split(".")).with_suffix(".py")
    if not path.exists():
        path = PORT.joinpath(*name.split("."), "__init__.py")
    assert path.is_file(), name
    assert not (_imported_roots(path) & set(FORBIDDEN)), name
    code = f"""
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["msgpack"] = None
import importlib
importlib.import_module("repro_torch.{name}")
import torch.distributed as dist
assert not dist.is_initialized()
assert not [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr


def test_sharded_entry_points_never_fall_back(monkeypatch):
    """The rank launcher defaults to the card (NCCL) and raises without
    CUDA; an engine on the CPU refuses a mesh whose ranks run on the card."""
    from types import SimpleNamespace

    from repro_torch.api import FedEngine
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset
    from repro_torch.sharding.ranks import RankPool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RankPool(2)
    g = make_dataset("pubmed", scale=64, seed=0)
    fed = partition_graph(g, 3, alpha=0.5, seed=0)
    mesh = SimpleNamespace(mesh_dim_names=("clients",), device_type="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FedEngine(g, fed, "fedais", rounds=1, mesh=mesh)
    with pytest.raises(ValueError, match="device"):
        FedEngine(g, fed, "fedais", rounds=1, mesh=mesh, device="cpu")
