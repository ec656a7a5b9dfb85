"""The comparison that decides ``correct``, driven through a whole toy run
on the CPU (the harness's look for a chip skipped): a sound run passes,
and each fault a training cell on one chip can have, planted under the
timed path, makes ``correct`` false; the control (the reference in TF32
in the program's place) fails a number."""
from __future__ import annotations

import json

import benchutil
import pytest


def _unchanged(monkeypatch):
    """A round that returns its state unchanged."""
    from repro_torch.api import fused

    monkeypatch.setattr(fused.FusedRounds, "_body", lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """Every other valid row of each batch left out, the loss the mean over the
    rest."""
    from repro_torch.core import fedais

    orig = fedais.sample_batch

    def half(*a, **k):
        idx, valid = orig(*a, **k)
        valid = valid.clone()
        valid[valid.nonzero()[::2, 0]] = False
        return idx, valid

    monkeypatch.setattr(fedais, "sample_batch", half)


def _altered(monkeypatch):
    """One node's loss altered where the loss pass produces it."""
    from repro_torch.core import fedais

    orig = fedais.per_node_loss

    def altered(logits, labels):
        out = orig(logits, labels).clone()
        out[0] = out[0] + 0.5
        return out

    monkeypatch.setattr(fedais, "per_node_loss", altered)


@pytest.mark.parametrize("fault,want", [(None, True), (_unchanged, False),
                                        (_half_batch, False), (_altered, False)],
                         ids=["sound", "state_unchanged", "half_batch", "answer_altered"])
def test_fault_makes_correct_false(tmp_path, monkeypatch, capsys, fault, want):
    root = benchutil.toy_root(tmp_path)
    if fault is not None:
        fault(monkeypatch)
    res = benchutil.run_toy(root, 2_147_483_701, capsys=capsys)
    assert res["correct"] is want, json.dumps(res["checks"])
    assert list(res)[-1] == "checks"


def test_control_fails_a_number(tmp_path, capsys):
    root = benchutil.toy_root(tmp_path)
    res = benchutil.run_toy(root, 2_147_483_702, "--control", "tf32", capsys=capsys)
    checks = res["checks"]
    failed = [k for k, c in checks.items() if c["value"] > c["limit"]]
    assert failed, checks


def test_card_run_of_the_toy_cell(tmp_path, capsys):
    """On a card: the toy cell through the real harness, traced, correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = benchutil.toy_root(tmp_path)
    from fedbench import cli

    assert cli.main(["--workload", benchutil.TOY_CELL, "--seed", "7", "--seconds", "1",
                     "--trace", "1"], root=root) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["busy_s"] > 0
