"""The port's LM training driver (``launch.train``) against the
reference's, on the CPU, from the same initial params (the reference's
``init_lm`` handed to the port through ``_init_params``), on ``mini`` cut
to 2 layers of width 128 with a 512-token vocabulary (both packages' mini
config patched alike), sequences of 32 and batches of 2:

* ``train``: per-step losses within 1e-4;
* ``train_federated``: per-round losses within 1e-4, tau, steps and sync
  events equal, and the importance picks equal. The run's seed (5) is one
  whose loss deltas behind each pick sit far apart (the smallest gap 6.7e-3,
  67 x the tolerance; the test asserts more than 10 x), so a near-tie
  cannot pass silently;
* resume from a checkpoint gives the uninterrupted run's losses;
* ``main`` and ``examples.train_lm_federated.main`` run.
"""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro_torch.launch.train as ttrain
from repro.models import lm as jlm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import train_lm_federated

TOL = 1e-4
FED_SEED = 5
SMALL = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=512)
BASE = dict(arch="mini", seq_len=32, batch=2, lr=3e-3, seed=0, log_every=100,
            ckpt_dir=None, ckpt_every=1000, fed=False, clients=2, tau0=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def same_start(monkeypatch):
    """Both packages' mini cut to SMALL, and the port started from the
    reference's initial params."""
    jmini, tmini = jtrain.mini_config, ttrain.mini_config
    monkeypatch.setattr(jtrain, "mini_config", lambda **kw: jmini(**{**SMALL, **kw}))
    monkeypatch.setattr(ttrain, "mini_config", lambda **kw: tmini(**{**SMALL, **kw}))

    def init(cfg, seed, device):
        jp = jlm.init_lm(jax.random.PRNGKey(seed), jtrain.get_train_config("mini"))
        return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, device)

    monkeypatch.setattr(ttrain, "_init_params", init)


def _args(**kw):
    return argparse.Namespace(**{**BASE, "device": "cpu", **kw})


def test_train_matches_reference(same_start):
    got = ttrain.train(_args(steps=5))
    want = jtrain.train(_args(steps=5))
    assert len(got["losses"]) == len(want["losses"]) == 5
    np.testing.assert_allclose(got["losses"], want["losses"], atol=TOL, rtol=TOL)
    assert got["losses"][-1] < got["losses"][0]


class _RecordingNumpy:
    """numpy, with every ``argsort`` input recorded (the reference's loss
    deltas, one list per client-round that has them)."""

    def __init__(self):
        self.deltas = []

    def __getattr__(self, name):
        return getattr(np, name)

    def argsort(self, a, *args, **kw):
        self.deltas.append([float(x) for x in a])
        return np.argsort(a, *args, **kw)


def test_train_federated_matches_reference(same_start, monkeypatch):
    rec = _RecordingNumpy()
    monkeypatch.setattr(jtrain, "np", rec)
    kw = dict(steps=12, fed=True, seed=FED_SEED)
    got = ttrain.train_federated(_args(**kw))
    want = jtrain.train_federated(_args(**kw))
    assert len(got["history"]) == len(want["history"]) >= 3
    for g, w in zip(got["history"], want["history"]):
        assert (g["round"], g["tau"], g["steps"]) == (w["round"], w["tau"], w["steps"])
        np.testing.assert_allclose(g["loss"], w["loss"], atol=TOL, rtol=TOL)
    assert got["sync_events"] == want["sync_events"]
    # the importance picks: the port's deltas are the reference's, and each
    # pick follows from deltas whose gaps dwarf the tolerance
    port_deltas = [d for rnd in got["deltas"] for d in rnd if d is not None]
    port_picks = [p for rnd, drs in zip(got["picks"], got["deltas"])
                  for p, d in zip(rnd, drs) if d is not None]
    assert len(port_deltas) == len(rec.deltas) >= 4
    for mine, ref, pick in zip(port_deltas, rec.deltas, port_picks):
        np.testing.assert_allclose(mine, ref, atol=TOL, rtol=TOL)
        gaps = np.diff(np.sort(ref))
        assert gaps.min() > 10 * TOL, ref
        assert pick == [int(i) for i in np.argsort(ref)[::-1]][:len(pick)]
    # first rounds take the candidates in order
    assert all(p == list(range(len(p))) for p in got["picks"][0])


def test_resume_gives_the_uninterrupted_losses(same_start, tmp_path):
    full = ttrain.train(_args(steps=4))["losses"]
    ck = str(tmp_path / "ck")
    first = ttrain.train(_args(steps=2, ckpt_dir=ck, ckpt_every=2))["losses"]
    rest = ttrain.train(_args(steps=4, ckpt_dir=ck, ckpt_every=2))["losses"]
    assert len(first) == 2 and len(rest) == 2
    assert first + rest == full


def test_main_and_example_run(same_start):
    out = ttrain.main(["--arch", "mini", "--steps", "2", "--batch", "2", "--seq-len", "16",
                       "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    fed = ttrain.main(["--steps", "4", "--batch", "2", "--seq-len", "16", "--fed",
                       "--clients", "2", "--tau0", "2", "--device", "cpu"])
    assert fed["sync_events"] == 2 * len(fed["history"])
    ex = train_lm_federated.main(["--steps", "4", "--batch", "2", "--seq-len", "16",
                                  "--clients", "2", "--device", "cpu"])
    assert np.isfinite(ex["centralized"]["final_loss"])
    assert np.isfinite(ex["federated"]["final_loss"])


def test_cut_config_is_what_both_packages_train(same_start):
    a, b = jtrain.get_train_config("mini"), ttrain.get_train_config("mini")
    assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)} == \
        {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert a.n_layers == 2 and a.vocab_size == 512


def test_training_entry_points_never_fall_back(monkeypatch):
    """``train``, ``train_federated``, ``make_lm_batch`` and the example
    default to ``cuda:0`` and raise without CUDA."""
    from repro_torch.data import TokenPipeline, make_lm_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ttrain.build_parser().parse_args([]).device is None
    assert train_lm_federated.build_args([]).device is None
    for fn in (ttrain.train, ttrain.train_federated):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(argparse.Namespace(**{**BASE, "steps": 1}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_lm_batch(TokenPipeline(16, 4, 1), 0)
