"""Helpers of the benchmark's own tests: the paths, and a toy copy of the
benchmark (a small graph, few clients) that runs on the CPU in seconds."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
SRC = REPO / "src"
for p in (str(BENCH), str(SRC)):
    if p not in sys.path:
        sys.path.insert(0, p)

TOY_CELL = "toy-pubmed.k4-m2"
TOY_LIMITS = {"loss_pass": 1e-4, "loss_pass12": 1e-4, "update": 1e-3, "update3": 1e-3,
              "hist1": 1e-4, "update_w": 1e-3, "hist1_w": 1e-4, "age": 0, "ghost_rows": 0,
              "batch_flips": 4, "eval_loss": 1e-4, "eval_loss_w": 1e-4, "tau": 0,
              "spmm_launches": 0}


def toy_root(tmp: Path, cfg_name: str = "fedais-pubmed", traffic_name: str = "k16-m5") -> Path:
    """A copy of the benchmark with one more configuration, traffic, cell
    and limits file, added as files and entries only: Pubmed's generator
    at 600 nodes and 16 features, 4 clients, 2 a round, an eval every 3."""
    root = Path(tmp) / "toy"
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / f"{cfg_name}.json").read_text())
    cfg.update(name="toy-pubmed", max_features=16)
    cfg["graph"].update(n_nodes=600, n_edges=2700, n_features=16)
    (root / "bench/configs/toy-pubmed.json").write_text(json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / f"{traffic_name}.json").read_text())
    tr["partition"]["n_clients"] = 4
    tr.update(cohort=2, eval_every=3)
    (root / "bench/traffic/k4-m2.json").write_text(json.dumps(tr))
    (root / f"bench/limits/{TOY_CELL}.json").write_text(json.dumps(TOY_LIMITS))
    bench["configs"].append({"name": "toy-pubmed", "source": "https://arxiv.org/abs/2409.14655",
                             "file": "bench/configs/toy-pubmed.json", "reduced": ["graph"],
                             "why": "a toy size for the CPU tests"})
    bench["workloads"].append({"name": TOY_CELL, "config": "toy-pubmed", "traffic": "k4-m2",
                               "chips": 1, "why": "a toy size for the CPU tests"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(TOY_CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_toy(root: Path, seed: int, *extra: str, device: str = "cpu",
            require_chip: bool = False, capsys=None) -> dict:
    """One harness run of the toy cell in this process; its result line."""
    from fedbench import cli

    rc = cli.main(["--workload", TOY_CELL, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", "0", *extra], root=root, require_chip=require_chip,
                  device=device)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])
