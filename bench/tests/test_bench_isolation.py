"""Nothing the harness loads is JAX or the JAX package: top-level module
names compared whole (``repro_torch`` begins with ``repro`` and is the
port, not the package it was ported from)."""
from __future__ import annotations

import json
import subprocess
import sys

import benchutil

SCRIPT = """
import json, sys
sys.path[:0] = [{bench!r}, {src!r}]
from fedbench import cli, cell
rc = cli.main(["--workload", {cell!r}, "--seed", "11", "--seconds", "0.3", "--trace", "0"],
              root={root!r}, require_chip=False, device="cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps({{"rc": rc, "tops": tops, "forbidden": cell.loaded_forbidden()}}))
"""


def test_a_toy_run_loads_no_jax(tmp_path):
    root = benchutil.toy_root(tmp_path)
    code = SCRIPT.format(bench=str(root / "bench"), src=str(benchutil.SRC),
                         cell=benchutil.TOY_CELL, root=str(root))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "OMP_NUM_THREADS": "2"}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["rc"] == 0 and json.loads(lines[-2])["correct"] is True
    assert "repro_torch" in out["tops"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["tops"])
    assert out["forbidden"] == []


def test_forbidden_names_compare_whole(monkeypatch):
    from fedbench import cell

    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert "repro" not in cell.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.api", object())
    assert "repro" in cell.loaded_forbidden()
