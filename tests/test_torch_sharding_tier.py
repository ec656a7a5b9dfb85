"""A client-sharded run on two gloo ranks against the reference's fused run,
at the whole-run tier (ROADMAP, North star; ``test_torch_engine.py``).

Both sides start from the reference's initial params; the port's ranks
replay the reference's key chain (``test_torch_fedais.JaxDraws``, drawn
here and handed to every rank as ``core.fedais.RecordedDraws``, since a
rank imports no jax). The sharded executor draws every real member's
uniforms in the unsharded order and keeps its slice, so each member trains
on the reference's draws. Held: identical cohorts and history keys, round,
tau and flops exact, the comm and wall-clock columns exact in round 0 and
within 1% after, test_acc within 0.1 every round and 0.05 at the end.
"""
from types import SimpleNamespace

import numpy as np
import pytest

from repro.api import FedEngine as JEngine
from repro_torch.core.fedais import batch_size_for
from repro_torch.api import method_config
from repro_torch.sharding.ranks import RankPool, run_engine
from test_torch_engine import JRecording, assert_whole_run_tier
from test_torch_fedais import JaxDraws, _init_params

ROUNDS, M = 4, 4


def recorded_draws(fed, mcfg, rounds, m, seed=0):
    """The reference's key chain for ``rounds`` rounds of ``m`` members, as
    ``RecordedDraws`` rounds: (batch (m, J, n_max), fanout (m, J, b, D))."""
    jd, J = JaxDraws(seed), mcfg.local_epochs
    b = fed.n_max if mcfg.use_all_samples else batch_size_for(mcfg, fed.n_max)
    out = []
    for _ in range(rounds):
        batch = np.zeros((m, J, fed.n_max), np.float32)
        fanout = np.zeros((m, J, b, fed.max_deg), np.float32)
        for i, stream in enumerate(jd.clients(m)):
            for j in range(J):
                ed = stream.epoch()
                batch[i, j] = ed.batch_uniform((fed.n_max,)).numpy()
                fanout[i, j] = ed.fanout_uniform((b, fed.max_deg)).numpy()
        out.append((None if mcfg.use_all_samples else batch, fanout))
    return out


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, device="cpu", store_dir=str(tmp_path_factory.mktemp("ranks"))) as p:
        yield p


def test_sharded_run_holds_the_whole_run_tier(small_fed, pool):
    jg, jfed = small_fed
    sel = JRecording()
    jeng = JEngine(jg, jfed, "fedais", rounds=ROUNDS, clients_per_round=M, seed=0,
                   eval_every=2, selector=sel)
    ref = jeng.run()
    assert jeng.last_executor == "fused"
    spec = {"dataset": {"name": "pubmed", "scale": 32, "seed": 0},
            "partition": {"n_clients": 8, "alpha": 0.5, "seed": 0},
            "mesh": "clients", "params": _init_params(jfed),
            "draws": recorded_draws(jfed, method_config("fedais"), ROUNDS, M),
            "engine": dict(rounds=ROUNDS, clients_per_round=M, seed=0, eval_every=2)}
    outs = pool.run(run_engine, spec)
    got = outs[0]
    assert got["executor"] == "sharded_fused"
    assert_whole_run_tier(SimpleNamespace(history=got["history"], final=got["final"]), ref,
                          got["cohorts"], sel.cohorts)
    for k, v in got["params"].items():
        assert np.array_equal(outs[1]["params"][k], v), k
