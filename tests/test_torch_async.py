"""The async path of the port against the reference (``repro/api/protocols.py``)
and against the port's own sync engine, on ``small_fed``.

* the biased selectors pick what the reference picks from the same seed and
  ``prev_loss`` (host numpy: exact), an empty client and unseen clients
  included;
* ``staleness_discount`` in all three modes (exact);
* ``StalenessWeightedAggregator``: all fresh is the base merge bit for bit;
  stale merges discount, compose with the base's weights (rtol 1e-6
  against the reference) and refuse a base that does not declare
  ``uses_weights``;
* the virtual clock (exact);
* a full-quorum ``AsyncScheduler`` run is bit-identical to the port's sync
  run (the spmm backends, whose CPU versions sum in a fixed order), and its
  ``virtual_time`` is the ``wall_clock`` meter;
* rounds = 0 is a no-op;
* the merge's write-back keeps the freshest of a client's duplicate
  updates, and outputs held in flight are not changed by later in-place
  merges;
* the bandit's duplicate and out-of-order reward cases
  (``tests/test_async.py:385-435``), on both strategies.

Whole async runs against the reference's (the merge schedule, the fault
counters, the billing of unmerged dispatches) are in
``test_torch_async_schedule.py`` and ``test_torch_async_faults.py``.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
from repro.api.strategies import BanditStrategy as JBanditStrategy
from repro.federated.costs import VirtualClock as JVirtualClock
from repro_torch.api import (
    AsyncScheduler,
    FedAvg,
    FedEngine,
    LossBiasedSelector,
    SizeBiasedSelector,
    StalenessWeightedAggregator,
    WeightedFedAvg,
    method_config,
    staleness_discount,
)
from repro_torch.api.strategies import BanditStrategy
from repro_torch.federated.costs import VirtualClock
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset

PARITY_KEYS = ("test_acc", "test_loss", "tau", "comm_total", "comm_embed",
               "flops", "wall_clock")
SPMM = dict(train_backend="spmm", eval_backend="spmm")


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


# ---------------------------------------------------------------------------
# selectors
# ---------------------------------------------------------------------------

def _fake(sizes, m, node_mask=None):
    fed = SimpleNamespace(client_sizes=np.asarray(sizes), n_clients=len(sizes),
                          node_mask=node_mask)
    return SimpleNamespace(fed=fed, clients_per_round=m)


@pytest.mark.parametrize("m", [3, 10])
def test_size_biased_selector_matches(m):
    sizes = np.asarray([0, 5, 3, 0, 9, 1, 7, 2], np.int64)     # two empty clients
    eng = _fake(sizes, m)
    js, ts = SimpleNamespace(rng=np.random.default_rng(5)), SimpleNamespace(
        rng=np.random.default_rng(5))
    for _ in range(6):
        want = japi.SizeBiasedSelector().select(eng, js)
        got = SizeBiasedSelector().select(eng, ts)
        np.testing.assert_array_equal(got, want)
        assert not set(got.tolist()) & {0, 3}
    assert len(got) == min(m, 6)


def test_loss_biased_selector_matches():
    rng = np.random.default_rng(1)
    K, n_max = 8, 6
    node_mask = (rng.random((K, n_max)) < 0.8).astype(np.float32)
    node_mask[2] = 0.0                                # a client with no nodes
    pl = np.where(node_mask > 0, rng.random((K, n_max)), 0.0).astype(np.float32)
    pl[[1, 5]] = -1.0                                 # never seen
    pl[3, :2] = -1.0                                  # partly seen
    eng = _fake(np.ones(K, np.int64), 5, node_mask)
    js = SimpleNamespace(rng=np.random.default_rng(3), prev_loss=jnp.asarray(pl))
    ts = SimpleNamespace(rng=np.random.default_rng(3), prev_loss=torch.from_numpy(pl))
    for _ in range(4):
        want = japi.LossBiasedSelector().select(eng, js)
        got = LossBiasedSelector().select(eng, ts)
        np.testing.assert_array_equal(got, want)
        assert set(got[:2].tolist()) == {1, 5} and 2 not in got.tolist()
    assert SizeBiasedSelector.precomputable and not LossBiasedSelector.precomputable


# ---------------------------------------------------------------------------
# staleness weighting
# ---------------------------------------------------------------------------

def test_staleness_discount_modes_match():
    s = np.asarray([0, 1, 3, 10])
    for mode, a in (("poly", 0.5), ("poly", 1.0), ("exp", 1.0), ("exp", 0.3), ("const", 0.5)):
        np.testing.assert_array_equal(staleness_discount(s, mode=mode, a=a),
                                      japi.staleness_discount(s, mode=mode, a=a))
    with pytest.raises(ValueError, match="staleness mode"):
        staleness_discount(s, mode="nope")


def _stack(seed=0, m=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((m, 5, 4)).astype(np.float32),
            "b": rng.standard_normal((m, 4)).astype(np.float32)}


def test_staleness_aggregator_fresh_is_the_base_merge():
    stacked = {k: torch.from_numpy(v) for k, v in _stack().items()}
    w = torch.tensor([3.0, 1.0, 5.0])
    for base in (FedAvg(), WeightedFedAvg()):
        agg = StalenessWeightedAggregator(base=base)
        want = base.aggregate(stacked, w)
        for got in (agg.aggregate(stacked, w, np.zeros(3, np.int64)), agg.aggregate(stacked, w)):
            assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("base", ["fedavg", "weighted"])
def test_staleness_aggregator_discounts_like_the_reference(base):
    raw = _stack(1)
    stacked = {k: torch.from_numpy(v) for k, v in raw.items()}
    w, tau = np.asarray([3.0, 1.0, 5.0], np.float32), np.asarray([0, 2, 1])
    tb = FedAvg() if base == "fedavg" else WeightedFedAvg()
    jb = japi.FedAvg() if base == "fedavg" else japi.WeightedFedAvg()
    got = StalenessWeightedAggregator(base=tb, mode="poly", a=1.0).aggregate(
        stacked, torch.from_numpy(w), tau)
    want = japi.StalenessWeightedAggregator(base=jb, mode="poly", a=1.0).aggregate(
        {k: jnp.asarray(v) for k, v in raw.items()}, jnp.asarray(w), tau)
    for k in raw:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    # the literal cases of the reference's own tests
    one = {"w": torch.tensor([[0.0], [10.0]])}
    agg = StalenessWeightedAggregator(base=FedAvg(), mode="poly", a=1.0)
    torch.testing.assert_close(agg.aggregate(one, None, np.asarray([0, 3]))["w"],
                               torch.tensor([2.0]))
    agg = StalenessWeightedAggregator(base=WeightedFedAvg(), mode="poly", a=1.0)
    torch.testing.assert_close(
        agg.aggregate(one, torch.tensor([1.0, 3.0]), np.asarray([0, 1]))["w"],
        torch.tensor([6.0]))


def test_staleness_aggregator_rejects_undeclared_base():
    class Median:
        def aggregate(self, stacked_params, weights=None):
            return {"w": stacked_params["w"].median(dim=0).values}

    stacked = {"w": torch.tensor([[0.0], [10.0], [20.0]])}
    agg = StalenessWeightedAggregator(base=Median())
    assert agg.aggregate(stacked, None, np.asarray([0, 0, 0]))["w"].tolist() == [10.0]
    with pytest.raises(TypeError, match="uses_weights"):
        agg.aggregate(stacked, None, np.asarray([0, 2, 0]))


def test_virtual_clock_matches():
    steps = [(0.0, 0.125, 0.25), (0.375, 0.5, 0.1), (0.2, 0.1, 0.05), (5.0, 1e-3, 0.0)]
    tc, jc = VirtualClock(), JVirtualClock()
    for step in steps:
        assert tc.merge_elapsed(*step) == jc.merge_elapsed(*step)
        assert tc.now == jc.now
    clock = VirtualClock(now=10.0)
    assert clock.merge_elapsed(8.0, 1.0, 0.25) == 0.25 and clock.now == 10.25


# ---------------------------------------------------------------------------
# whole runs
# ---------------------------------------------------------------------------

def test_full_quorum_async_is_the_sync_run(port_fed):
    g, fed = port_fed
    mcfg = method_config("fedais", tau0=4)
    kw = dict(rounds=3, clients_per_round=3, seed=0, device="cpu", **SPMM)
    sync = FedEngine(g, fed, mcfg, **kw).run()
    asy = FedEngine(g, fed, mcfg, scheduler=AsyncScheduler(), **kw).run()
    for k in PARITY_KEYS:
        assert sync.history[k] == asy.history[k], k
    assert sync.final == asy.final
    assert asy.history["staleness_max"] == [0, 0, 0]
    assert asy.history["merged"] == [3, 3, 3]
    assert asy.history["virtual_time"] == sync.history["wall_clock"]


def test_async_rounds_zero_is_a_noop(port_fed):
    g, fed = port_fed
    kw = dict(rounds=0, clients_per_round=3, seed=0, device="cpu")
    sync = FedEngine(g, fed, "fedais", **kw).run()
    eng = FedEngine(g, fed, "fedais", scheduler=AsyncScheduler(), **kw)
    state = eng.init_state()
    asy = eng.run(state)
    assert asy.history == {} == sync.history and asy.final == sync.final
    assert asy.final["comm_total_bytes"] == 0.0
    assert state.rng.bit_generator.state == np.random.default_rng(0).bit_generator.state


def test_async_validation(port_fed):
    g, fed = port_fed
    eng = FedEngine(g, fed, "fedais", rounds=1, clients_per_round=3, device="cpu")
    state = eng.init_state()
    with pytest.raises(ValueError, match="quorum"):
        AsyncScheduler(quorum=5).run(eng, state)
    with pytest.raises(ValueError, match="speed_factors"):
        AsyncScheduler(speed_factors=np.ones(3)).run(eng, state)
    with pytest.raises(ValueError, match="backoff"):
        AsyncScheduler(timeout_s=1.0, backoff=0.5).run(eng, state)
    eng = FedEngine(g, fed, method_config("fedais", aggregator="staleness"), rounds=1,
                    clients_per_round=3, device="cpu")
    with pytest.raises(ValueError, match="already a StalenessWeightedAggregator"):
        AsyncScheduler(staleness_mode="exp", staleness_a=1.0).run(eng, eng.init_state())
    eng = FedEngine(g, fed, method_config("fedais", scheduler="async"), rounds=1,
                    device="cpu")
    assert isinstance(eng.scheduler, AsyncScheduler)


# ---------------------------------------------------------------------------
# the merge's write-back
# ---------------------------------------------------------------------------

def _clone(out):
    params, hist1, age, gf, stats = out
    return ({k: v.clone() for k, v in params.items()}, hist1.clone(), age.clone(), gf.clone(),
            {k: v.clone() if torch.is_tensor(v) else v.copy() for k, v in stats.items()})


def _flat(out):
    params, hist1, age, gf, stats = out
    return ([params[k] for k in sorted(params)] + [hist1, age, gf]
            + [stats[k] for k in sorted(stats) if torch.is_tensor(stats[k])])


def test_duplicate_in_flight_writes_back_the_freshest(port_fed):
    g, fed = port_fed
    eng = FedEngine(g, fed, "fedais", rounds=2, clients_per_round=3, seed=0, device="cpu")
    state = eng.init_state()
    sel = np.asarray([3, 5, 3])          # client 3 twice, the second the freshest
    out = eng.dispatch(state, sel, 0)
    assert not torch.equal(out[1][0], out[1][2])
    want_params = FedAvg().aggregate(out[0])
    eng.merge(state, 0, sel, out, staleness=np.asarray([1, 0, 0]),
              aggregator=StalenessWeightedAggregator(base=FedAvg()))
    assert torch.equal(state.hist.hist1[3], out[1][2])
    assert torch.equal(state.hist.age[3], out[2][2])
    assert torch.equal(state.hist.ghost_feat[3], out[3][2])
    assert torch.equal(state.prev_loss[3], out[4]["loss_all"][2])
    assert torch.equal(state.hist.hist1[5], out[1][1])
    # every update aggregates: a discounted mean over all three
    d = staleness_discount([1, 0, 0])
    for k, v in state.params.items():
        torch.testing.assert_close(
            v, (out[0][k] * torch.tensor(d / d.sum(), dtype=torch.float32).reshape(
                (3,) + (1,) * (v.ndim))).sum(0))
        assert not torch.equal(v, want_params[k])


def test_held_outputs_survive_later_in_place_merges(port_fed):
    g, fed = port_fed
    eng = FedEngine(g, fed, "fedais", rounds=3, clients_per_round=3, seed=0, device="cpu")
    state = eng.init_state()
    held = eng.dispatch(state, np.asarray([1, 2, 4]), 0)
    snapshot = _clone(held)
    tables = [state.hist.hist1, state.hist.age, state.hist.ghost_feat, state.prev_loss,
              *state.params.values()]
    ptrs = {t.untyped_storage().data_ptr() for t in tables}
    assert not ptrs & {t.untyped_storage().data_ptr() for t in _flat(held)}
    before = state.hist.hist1[[1, 2, 4]].clone()
    later = eng.dispatch(state, np.asarray([2, 4, 6]), 0)
    eng.merge(state, 0, np.asarray([2, 4, 6]), later)
    assert not torch.equal(state.hist.hist1[[1, 2, 4]], before)    # the tables moved
    assert all(torch.equal(a, b) for a, b in zip(_flat(held), _flat(snapshot)))
    assert np.array_equal(held[4]["n_sync"], snapshot[4]["n_sync"])


# ---------------------------------------------------------------------------
# the bandit's reward attribution under async merges
# ---------------------------------------------------------------------------

class _RecordingBandit:
    def __init__(self):
        self.updates = []

    def choose(self, k):
        return 10

    def update(self, k, reward):
        self.updates.append((int(k), float(reward)))


def _harness(cls):
    eng = SimpleNamespace(fed=SimpleNamespace(n_clients=3), seed=0)
    strat = cls(method_config("fedgraph"))
    state = SimpleNamespace(round=0, last_staleness=None)
    strat.setup(eng, state)
    strat.bandit = _RecordingBandit()
    return eng, strat, state


def _stats(losses):
    return {"epoch_losses": np.asarray(losses, np.float64).reshape(-1, 1)}


def _duplicate_case(cls):
    eng, strat, state = _harness(cls)
    strat.post_round(eng, state, np.array([0]), _stats([1.0]))
    state.round, state.last_staleness = 2, np.array([1, 0])
    strat.post_round(eng, state, np.array([0, 0]), _stats([0.9, 0.8]))
    return strat


def _out_of_order_case(cls):
    eng, strat, state = _harness(cls)
    state.round, state.last_staleness = 1, np.array([0])
    strat.post_round(eng, state, np.array([0]), _stats([0.5]))
    state.round, state.last_staleness = 2, np.array([2])
    strat.post_round(eng, state, np.array([0]), _stats([1.4]))
    n_after_straggler = len(strat.bandit.updates)
    state.round, state.last_staleness = 3, np.array([0])
    strat.post_round(eng, state, np.array([0]), _stats([0.3]))
    return strat, n_after_straggler


def test_bandit_duplicate_in_flight_rewards_oldest_to_freshest():
    strat = _duplicate_case(BanditStrategy)
    assert strat.bandit.updates == [(0, 0.0), (0, pytest.approx(0.1)), (0, pytest.approx(0.1))]
    assert strat.last_client_loss[0] == pytest.approx(0.8)
    assert strat.last_reward_version[0] == 2
    ref = _duplicate_case(JBanditStrategy)
    assert strat.bandit.updates == ref.bandit.updates


def test_bandit_skips_out_of_order_straggler_reward():
    strat, n = _out_of_order_case(BanditStrategy)
    assert n == 1                                   # the straggler rewarded nothing
    assert strat.bandit.updates[-1] == (0, pytest.approx(0.5 - 0.3))
    assert strat.last_client_loss[0] == pytest.approx(0.3)
    assert strat.last_reward_version[0] == 3
    ref, ref_n = _out_of_order_case(JBanditStrategy)
    assert (strat.bandit.updates, n) == (ref.bandit.updates, ref_n)


def test_fedgraph_async_run_with_duplicates(port_fed):
    g, fed = port_fed
    eng = FedEngine(g, fed, "fedgraph", rounds=4, clients_per_round=3, seed=0, device="cpu",
                    scheduler=AsyncScheduler(quorum=2, concurrency=4))
    res = eng.run()
    assert np.isfinite(res.final["loss"])
    assert (eng.strategy.last_reward_version >= -1).all()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU ops here are small: one intra-op thread each keeps
    parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
