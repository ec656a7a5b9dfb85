"""The training slice's host substrate and small pieces against the
reference's: the partition (every array equal), the cost meters and the
adaptive-tau rule (exact), the registries, the server's merge helpers, and
AdamW on identical grads (1e-6 over several steps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import registry as jreg
from repro.core import sync as jsync
from repro.federated import costs as jcosts
from repro.federated import server as jserver
from repro.federated.partition import partition_graph as jpartition
from repro.graph.data import make_dataset as jmake_dataset
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro_torch.api import registry as treg
from repro_torch.api.engine import FedEngine
from repro_torch.core import sync as tsync
from repro_torch.federated import costs as tcosts
from repro_torch.federated import server as tserver
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.optim import adamw_init, adamw_update

FED_ARRAYS = ("features", "labels", "node_mask", "train_mask", "val_mask", "nbr_idx",
              "nbr_mask", "ghost_owner", "ghost_row", "ghost_mask", "global_ids")


@pytest.mark.parametrize("alpha,k", [(0.5, 8), (None, 5)])
def test_partition_is_bit_equal(small_fed, alpha, k):
    """``small_fed`` (conftest: pubmed scale 32, 8 clients, alpha 0.5) and an
    iid split: every array and every scalar equal."""
    g = make_dataset("pubmed", scale=32, seed=0)
    got = partition_graph(g, k, alpha=alpha, seed=0)
    want = small_fed[1] if (alpha, k) == (0.5, 8) else jpartition(
        jmake_dataset("pubmed", scale=32, seed=0), k, alpha=alpha, seed=0)
    for f in FED_ARRAYS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("name", "n_clients", "n_max", "g_max", "max_deg", "n_classes",
              "n_cross_edges", "n_features"):
        assert getattr(got, f) == getattr(want, f), f
    assert np.array_equal(got.client_sizes, want.client_sizes)


def test_cost_meters_are_exact():
    rng = np.random.default_rng(0)
    x = rng.random(1000) * 10.0 ** rng.integers(-8, 8, 1000)
    assert tcosts.seq_sum(x) == jcosts.seq_sum(x) and tcosts.seq_sum([]) == 0.0
    d_t, d_j = tcosts.DelayModel(), jcosts.DelayModel()
    arr = rng.random(7) * 1e9
    assert np.array_equal(d_t.compute_time(arr), d_j.compute_time(arr))
    assert np.array_equal(d_t.comm_time(arr), d_j.comm_time(arr))
    assert tcosts.embed_sync_bytes(37.0, (500, 256)) == jcosts.embed_sync_bytes(37.0, (500, 256))
    assert tcosts.model_bytes(12345) == jcosts.model_bytes(12345)
    m_t, m_j = tcosts.CostMeter(), jcosts.CostMeter()
    for v in rng.random((5, 5)):
        for m, cls in ((m_t, tcosts.CostMeter), (m_j, jcosts.CostMeter)):
            m.add(cls(*v[:4], int(v[4] * 10)))
    assert m_t.snapshot() == m_j.snapshot()
    c_t, c_j = tcosts.VirtualClock(), jcosts.VirtualClock()
    for a, b, c in rng.random((4, 3)):
        assert c_t.merge_elapsed(a, b, c) == c_j.merge_elapsed(a, b, c)


def test_adaptive_tau_is_exact():
    for f_t in (0.0, 1e-3, 0.3, 1.0, 2.5, 7.0, 1e4, float("inf"), float("nan")):
        for f_0 in (0.0, -1.0, 0.5, 1.0, 3.0):
            for tau0 in (1, 2, 4):
                assert tsync.adaptive_tau(f_t, f_0, tau0) == jsync.adaptive_tau(f_t, f_0, tau0)
    args = (2.0, 0.1, 0.5, 0.01, 100.0, 1.5, 0.2)
    assert tsync.tau_theoretical(*args) == jsync.tau_theoretical(*args)
    eb = (2.0, 0.1, 0.01, 1.5, 0.2, 1.0, 0.5, 3.0, 100.0)
    assert tsync.error_bound(*eb) == jsync.error_bound(*eb)
    assert tsync.delay_model([1.0, 2.0], 0.5, 3.0) == jsync.delay_model([1.0, 2.0], 0.5, 3.0)


def test_registry_matches_the_reference():
    from repro_torch.api import (
        AsyncScheduler,
        BanditStrategy,
        GeneratorStrategy,
        MethodStrategy,
        StalenessWeightedAggregator,
    )

    assert treg.available_methods() == jreg.available_methods()
    for name in jreg.available_methods():
        assert treg.method_config(name) == type(treg.method_config(name))(
            **vars(jreg.method_config(name))), name
    assert treg.method_config("fedais", tau0=7).tau0 == 7
    with pytest.raises(KeyError):
        treg.method_config("nope")
    # all nine methods build the strategy of their kind
    kinds = {"fedsage+": GeneratorStrategy, "fedgraph": BanditStrategy}
    for name in treg.available_methods():
        strategy = treg.build_strategy(treg.method_config(name))
        assert type(strategy) is kinds.get(name, MethodStrategy), name
    assert treg.available_aggregators() == jreg.available_aggregators()
    assert treg.available_schedulers() == jreg.available_schedulers()
    assert isinstance(treg.build_aggregator("staleness"), StalenessWeightedAggregator)
    sched = treg.build_scheduler("async", quorum=4)
    assert isinstance(sched, AsyncScheduler) and sched.quorum == 4
    # the three sync keys pick the executor as the reference's do
    for key in ("sync", "sync_fused", "sync_stepwise"):
        assert treg.build_scheduler(key).fused is jreg.build_scheduler(key).fused, key


def test_engine_refuses_what_is_not_ported(small_fed):
    """Nothing of the engine is refused any more: a mesh is taken (the
    sharded executors, tests/test_torch_sharding.py) and checked, as the
    guard and the fault plan are, as the reference checks them, and the
    fused executor runs when asked for (tests/test_torch_fused.py)."""
    from types import SimpleNamespace

    g = make_dataset("pubmed", scale=32, seed=0)
    fed = partition_graph(g, 8, alpha=0.5, seed=0)
    with pytest.raises(TypeError, match="DeviceMesh"):
        FedEngine(g, fed, "fedais", device="cpu", mesh=object())
    with pytest.raises(ValueError, match="clients"):
        FedEngine(g, fed, "fedais", device="cpu",
                  mesh=SimpleNamespace(mesh_dim_names=("x", "y"), device_type="cpu"))
    for kw, word in (({"guard": "yes please"}, "guard"), ({"faults": object()}, "faults")):
        with pytest.raises(ValueError, match=word):
            FedEngine(g, fed, "fedais", device="cpu", **kw)
    from repro_torch.faults import FaultPlan, UpdateGuard

    for guard in (True, False, None, UpdateGuard(max_norm=1.0)):
        FedEngine(g, fed, "fedais", device="cpu", guard=guard, faults=FaultPlan())
    with pytest.raises(ValueError, match="train_backend"):
        FedEngine(g, fed, "fedais", device="cpu", train_backend="dense")
    with pytest.raises(ValueError, match="sync dtype"):
        FedEngine(g, fed, "fedais", device="cpu", sync_dtype="fp16")
    for dtype in ("fp32", "bf16", "int8"):
        assert FedEngine(g, fed, "fedais", device="cpu", sync_dtype=dtype).sync_dtype == dtype
    from repro_torch.api import SyncScheduler

    for scheduler in (SyncScheduler(fused=True), "sync_fused"):
        eng = FedEngine(g, fed, "fedais", rounds=1, clients_per_round=2, device="cpu",
                        scheduler=scheduler)
        assert eng.run().history["round"] == [0] and eng.last_executor == "fused"


def test_server_merge_helpers_match():
    rng = np.random.default_rng(1)
    stacked = {"w": rng.standard_normal((5, 4, 3)).astype(np.float32),
               "b": rng.standard_normal((5, 3)).astype(np.float32)}
    w = rng.random(5).astype(np.float32) * 100
    t_stacked = {k: torch.from_numpy(v) for k, v in stacked.items()}
    for got, want in ((tserver.fedavg(t_stacked), jserver.fedavg(stacked)),
                      (tserver.fedavg_weighted(t_stacked, torch.from_numpy(w)),
                       jserver.fedavg_weighted(stacked, jnp.asarray(w)))):
        for k in stacked:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)
    for seed in range(3):
        assert np.array_equal(
            tserver.select_clients(np.random.default_rng(seed), 10, 4),
            jserver.select_clients(np.random.default_rng(seed), 10, 4))
    for mcfg in (treg.method_config("fedais"), treg.method_config("fedall")):
        assert tserver.update_tau(mcfg, 0.7, 1.3, 4) == jserver.update_tau(mcfg, 0.7, 1.3, 4)


def test_adamw_matches_on_identical_grads():
    """Several steps on the same grads: the reference's fp32 arithmetic to
    1e-6 (the bias corrections are computed in fp32 on both sides)."""
    rng = np.random.default_rng(2)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ts, js = adamw_init(tp), jadamw_init(jp)
    for step in range(6):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** (step - 3)).astype(np.float32)
                 for k, v in params.items()}
        grads["w"][0, :2] = 0.0                     # a zero grad, a tiny one
        grads["w"][1, 0] = 1e-30
        tp, ts = adamw_update({k: torch.from_numpy(v) for k, v in grads.items()}, ts, tp,
                              0.01)
        jp, js = jadamw_update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp, 0.01)
        assert ts.step == int(js.step) == step + 1
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
            np.testing.assert_allclose(ts.mu[k].numpy(), np.asarray(js.mu[k]), rtol=1e-6,
                                       atol=1e-30)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6,
                                       atol=1e-30)
    assert all(not v.requires_grad for v in tp.values())
