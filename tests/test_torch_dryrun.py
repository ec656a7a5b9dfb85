"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

``build_case``'s ``meta`` against the reference's ``build_case(...)[2]``
(built on a (1, 1) mesh, without compiling) for every arch x shape; the
walk's FLOPs (``FlopCounterMode`` on meta tensors) against a hand count of
a small dense config's products; every arch's train, prefill and decode
walk at full width over one repeating unit and a short sequence, the MoE
archs included; the WKV scan's meta path against its per-step loop;
``StepLedger``'s bytes and peak on a known program; a CLI run on the
single-pod production mesh (a fake 256-rank world, stopped after); and
importing the launch modules starts no process group.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.launch import dryrun as jdryrun
from repro_torch.configs import InputShape, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.models.rwkv import wkv_scan
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
UNIT = SimpleNamespace(shape={"data": 1, "model": 1})
# a small dense configuration on llama3-405b's layout (gated MLP, GQA, RoPE)
SMALL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=512,
             vocab_size=1024)


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_matches_reference(arch, shape, jmesh):
    want = jdryrun.build_case(arch, shape, jmesh)[2]
    got = dryrun.build_case(arch, shape, UNIT)[2]
    assert got == want


def _hand_forward(cfg, B, S, head_rows):
    """The products of one forward of a dense ``attn`` model: q, k, v, o,
    the scores and P·V over all S x S pairs (the plain path masks, it does
    not skip), the gated MLP's three, and the head over ``head_rows``
    positions."""
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    T = B * S
    layer = (2 * T * d * (qd + 2 * kvd) + 2 * T * qd * d
             + 2 * 2 * B * cfg.n_heads * S * S * cfg.resolved_head_dim
             + 3 * 2 * T * d * ff)
    return cfg.n_layers * layer, 2 * B * head_rows * d * cfg.vocab_size


@pytest.mark.parametrize("remat", [False, True])
def test_flops_equal_a_hand_count(remat):
    B, S = 2, 16
    cfg = dataclasses.replace(get_config("llama3-405b"), **SMALL, remat=remat)
    prefill = InputShape("p", S, B, "prefill")
    step, args, meta, _ = dryrun.build_case("llama3-405b", "p", UNIT, extra=SMALL,
                                            shape=prefill)
    blocks, head = _hand_forward(cfg, B, S, head_rows=1)
    assert dryrun.walk(step, args)["flops"] == blocks + head
    assert meta["model_flops"] == 2.0 * cfg.active_param_count() * B * S
    # training: every product's two operands take gradients (the first
    # layer's input comes from the embedding), so the backward is twice
    # the forward; under remat each unit's forward runs once more, but for
    # its last product (the MLP's w_out): torch's non-reentrant checkpoint
    # stops recomputing once the backward's saved tensors are all made
    train = InputShape("t", S, B, "train")
    step, args, meta, _ = dryrun.build_case("llama3-405b", "t", UNIT,
                                            extra=dict(SMALL, remat=remat), shape=train)
    blocks, head = _hand_forward(cfg, B, S, head_rows=S)
    w_out = 2 * B * S * cfg.d_ff * cfg.d_model
    assert meta["remat"] is remat
    assert (dryrun.walk(step, args)["flops"]
            == 3 * (blocks + head) + remat * (blocks - cfg.n_units * w_out))
    # decode: one token against an S-slot cache
    dec = InputShape("d", S, B, "decode")
    step, args, _, _ = dryrun.build_case("llama3-405b", "d", UNIT, extra=SMALL, shape=dec)
    d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
    layer = (2 * B * d * (qd + 2 * kvd) + 2 * B * qd * d
             + 2 * 2 * B * cfg.n_heads * S * cfg.resolved_head_dim + 3 * 2 * B * d * ff)
    assert dryrun.walk(step, args)["flops"] == cfg.n_layers * layer + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_walks_train_prefill_decode(arch):
    """Full width, one repeating unit (and one encoder layer), B 2, S 32:
    each step runs on meta tensors and gives its outputs' shapes."""
    cfg = get_config(arch)
    extra = {"n_layers": len(cfg.block_pattern)}
    if cfg.n_encoder_layers:
        extra["n_encoder_layers"] = 1
    B, S = 2, 32
    for kind in ("train", "prefill", "decode"):
        shape = InputShape(kind, S, B, kind)
        step, args, meta, trees = dryrun.build_case(arch, kind, UNIT, extra=extra,
                                                    shape=shape)
        with FlopCounterMode(display=False) as fc:
            out = step(*args)
        assert fc.get_total_flops() > 0, kind
        if kind == "train":
            loss, _, grads = out
            assert loss.shape == () and loss.is_meta
            assert ([g.shape for g in tree_leaves(grads)]
                    == [p.shape for p in tree_leaves(args[0])])
        elif kind == "prefill":
            assert tuple(out[0].shape) == (B, cfg.vocab_size)
            assert len(out[1]["units"]) == 1
        else:
            assert tuple(out[0].shape) == (B, 1, cfg.vocab_size)


@pytest.mark.parametrize("state0", [False, True])
def test_wkv_scan_meta_path_counts_the_loops_products(state0):
    def run(dev):
        g = torch.Generator().manual_seed(0)
        ts = [torch.randn(2, 7, 3, 8, generator=g).to(dev).requires_grad_(True)
              for _ in range(4)]
        u = torch.randn(3, 8, generator=g).to(dev).requires_grad_(True)
        s0 = (torch.randn(2, 3, 8, 8, generator=g).to(dev).requires_grad_(True)
              if state0 else None)
        with FlopCounterMode(display=False) as fc:
            y, S = wkv_scan(*ts, u, s0)
            (y.sum() + S.sum()).backward()
        return fc.get_total_flops(), y.shape, S.shape, [t.grad.shape for t in ts + [u]]

    assert run("meta") == run("cpu")


def test_step_ledger_bytes_and_peak():
    a = torch.empty(1000, device="meta")           # 4,000 B, made before the walk
    with dryrun.StepLedger() as ledger:
        for _ in range(10):
            x = a * 2                               # reads 4,000 B, writes 4,000 B
        x.add_(1)                                   # in place: no new storage
        y = x.view(10, 100)                         # a view moves nothing
        z = torch.cat([y, y])                       # reads 2 x 4,000, writes 8,000
    assert ledger.bytes == 10 * 8000 + 8000 + 16000
    assert ledger.peak_bytes == 4000 + 8000         # x and z (two products: 8,000)
    del z


def test_run_case_row_and_cli_on_the_production_mesh(tmp_path, capsys):
    assert not dist.is_initialized()
    rc = dryrun.main(["--arch", "rwkv6-1.6b", "--shape", "long_500k", "--mesh", "pod1",
                      "--out", str(tmp_path)])
    assert rc == 0 and not dist.is_initialized()
    assert "dry-run: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out
    row = json.loads((tmp_path / "rwkv6-1.6b_long_500k_pod1.json").read_text())
    want = jdryrun.build_case("rwkv6-1.6b", "long_500k",
                              jax.make_mesh((1, 1), ("data", "model")))[2]
    for k in ("params", "active_params", "model_flops", "kind", "remat", "attn_impl"):
        assert row[k] == want[k], k
    assert row["chips"] == 256 and row["mesh"] == "pod1" and row["status"] == "ok"
    assert row["collective_bytes_per_device"] == 0.0 and row["collective_source"]
    assert set(row["roofline"]) >= {"compute_s", "memory_s", "bound_s", "dominant",
                                    "useful_flops_ratio", "mfu_upper_bound"}
    mem = row["memory"]
    assert mem["argument_bytes"] == sum(mem[f"{k}_bytes"] for k in
                                        ("params", "moments", "decode_state", "data"))
    assert mem["params_bytes"] > 0 and mem["decode_state_bytes"] > 0
    table = dryrun.roofline_rows([row, {"arch": "a", "shape": "s", "mesh": "m",
                                        "status": "skipped"}])
    assert table[0]["dominant"] == row["roofline"]["dominant"]
    assert table[1]["status"] == "skipped"
    skipped = dryrun.run_case("llama3-405b", "long_500k", "pod1", mesh=UNIT)
    assert skipped["status"] == "skipped"


def test_import_starts_no_process_group():
    code = ("import torch.distributed as d, repro_torch.launch.dryrun, "
            "repro_torch.launch.mesh, repro_torch.sharding.specs; "
            "assert not d.is_initialized(); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
