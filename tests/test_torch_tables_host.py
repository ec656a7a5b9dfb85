"""The host side of the multi-device executors against the reference's.

The bucket builders (``ghost_exchange_buckets``, ``simulate_ghost_exchange``,
``exchange_ghost_features``, ``writeback_routing``,
``simulate_writeback_exchange``, ``pod_table_padding``), the mesh-free
helpers (``cohort_padding``, ``pairwise_sum``, ``pad_tables_to_pods``,
``sync_round_gates``) and the analytic byte ledger
(``pod_placement_ledger``) are held exactly against the reference's on the
same seeded numpy inputs: the cases of ``tests/test_tables.py`` and a few
more. Then the port's own pieces of the wire: ``comm.pack`` / ``unpack``
and the write-back's wire rows give back what went in (decoded as the
codec's round trip), and ``round_collectives`` restates the ledger.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.federated.partition as jpart
import repro.sharding.fed as jfed
import repro.sharding.tables as jtables
import repro_torch.federated.partition as tpart
import repro_torch.sharding.fed as tfed
import repro_torch.sharding.tables as ttables
from repro.launch.fed_dryrun import pod_placement_ledger as jledger
from repro_torch.federated.quant import quant_roundtrip
from repro_torch.sharding import comm, ledger

BUCKET_CASES = [(0, 5, 4, 2), (1, 8, 3, 3), (2, 3, 2, 8), (3, 1, 1, 1), (4, 10, 6, 4),
                (5, 7, 3, 1)]
WRITEBACK_CASES = [(0, 2, 1, 2, 3), (1, 3, 2, 1, 4), (2, 1, 1, 4, 2), (3, 4, 1, 2, 1),
                   (4, 2, 2, 2, 5)]


def random_topology(seed: int, K: int, g_max: int, n_max: int, fill=0.7):
    """A random partition-shaped ghost topology (tests/test_tables.py's)."""
    rng = np.random.default_rng(seed)
    gm = (rng.random((K, g_max)) < fill).astype(np.float32)
    go = np.where(gm > 0, rng.integers(0, K, (K, g_max)), -1).astype(np.int32)
    gr = rng.integers(0, n_max, (K, g_max)).astype(np.int32)
    return go, gr, gm


def random_cohorts(seed, S, n_pods, n_shards, mL, rpp, dummy_frac=0.3):
    """(S, m) padded cohorts: duplicate-free real ids plus out-of-range
    dummies (tests/test_tables.py's)."""
    rng = np.random.default_rng(seed)
    m = n_pods * n_shards * mL
    Kp = n_pods * rpp
    sel = np.zeros((S, m), np.int32)
    for s in range(S):
        n_real = min(max(1, int(m * (1 - dummy_frac))), Kp)
        sel[s, :n_real] = rng.permutation(Kp)[:n_real]
        sel[s, n_real:] = Kp + rng.integers(0, 3, m - n_real)
    return sel


def _same_dataclass(a, b):
    for k, v in vars(b).items():
        got = getattr(a, k)
        if isinstance(v, np.ndarray):
            assert got.dtype == v.dtype and np.array_equal(got, v), k
        else:
            assert got == v, k


@pytest.mark.parametrize("seed,K,g_max,n_pods", BUCKET_CASES)
def test_ghost_buckets_and_exchanges_match(seed, K, g_max, n_pods):
    n_max = 5
    go, gr, gm = random_topology(seed, K, g_max, n_max)
    b, jb = (tpart.ghost_exchange_buckets(go, gr, gm, n_pods),
             jpart.ghost_exchange_buckets(go, gr, gm, n_pods))
    _same_dataclass(b, jb)
    assert b.n_clients_padded == jb.n_clients_padded
    rng = np.random.default_rng(seed + 1)
    hist1_all = rng.normal(size=(K, n_max + g_max, 3)).astype(np.float32)
    feats = rng.normal(size=(K, n_max, 4)).astype(np.float32)
    assert np.array_equal(tpart.simulate_ghost_exchange(b, hist1_all),
                          jpart.simulate_ghost_exchange(jb, hist1_all))
    for dtype in ("fp32", "bf16", "int8"):
        got = tpart.exchange_ghost_features(b, feats, dtype=dtype)
        want = jpart.exchange_ghost_features(jb, feats, dtype=dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want), dtype


def test_ghost_buckets_validate_pod_count():
    go, gr, gm = random_topology(0, 4, 2, 4)
    with pytest.raises(ValueError, match="n_pods"):
        tpart.ghost_exchange_buckets(go, gr, gm, 0)


@pytest.mark.parametrize("seed,n_pods,n_shards,mL,rpp", WRITEBACK_CASES)
def test_writeback_routing_and_exchange_match(seed, n_pods, n_shards, mL, rpp):
    sel = random_cohorts(seed, 3, n_pods, n_shards, mL, rpp)
    plan = tpart.writeback_routing(sel, n_pods, n_shards, rpp)
    jplan = jpart.writeback_routing(sel, n_pods, n_shards, rpp)
    _same_dataclass(plan, jplan)
    fixed = tpart.writeback_routing(sel, n_pods, n_shards, rpp, cap=2 * plan.cap)
    _same_dataclass(fixed, jpart.writeback_routing(sel, n_pods, n_shards, rpp,
                                                   cap=2 * plan.cap))
    rng = np.random.default_rng(seed)
    for s in range(3):
        table = rng.normal(size=(n_pods * rpp, 2)).astype(np.float32)
        values = rng.normal(size=(sel.shape[1], 2)).astype(np.float32)
        assert np.array_equal(tpart.simulate_writeback_exchange(plan, s, values, table),
                              jpart.simulate_writeback_exchange(jplan, s, values, table))


def test_writeback_routing_validation():
    with pytest.raises(ValueError, match="split"):
        tpart.writeback_routing(np.zeros((1, 6), np.int32), 4, 1, 2)
    with pytest.raises(ValueError, match="cap"):
        tpart.writeback_routing(np.arange(8, dtype=np.int32)[None], 2, 1, 4, cap=2)


@pytest.mark.parametrize("m,n", [(0, 1), (3, 2), (8, 4), (5, 8), (17, 3), (64, 64)])
def test_paddings_match(m, n):
    assert tfed.cohort_padding(m, n) == jfed.cohort_padding(m, n)
    assert tpart.pod_table_padding(m, n) == jpart.pod_table_padding(m, n)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_pairwise_sum_matches_bit_for_bit(n):
    x = np.random.default_rng(n).normal(size=(n, 7)).astype(np.float32) * 1e3
    got = tfed.pairwise_sum(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jfed.pairwise_sum(jnp.asarray(x))))
    a, b, c, d = (np.float32(v) for v in (1e8, -1e8, 3.25, 4.75))
    assert float(tfed.pairwise_sum(torch.tensor([a, b, c, d]))) == float((a + b) + (c + d))


@pytest.mark.parametrize("K,n_pods", [(5, 4), (5, 5), (3, 8), (8, 2)])
def test_pad_tables_to_pods_matches(K, n_pods):
    rng = np.random.default_rng(K)
    t1 = rng.normal(size=(K, 3)).astype(np.float32)
    t2 = rng.integers(0, 9, K).astype(np.int32)
    got = ttables.pad_tables_to_pods({"a": torch.from_numpy(t1), "b": (torch.from_numpy(t2),)},
                                     n_pods)
    want = jtables.pad_tables_to_pods({"a": jnp.asarray(t1), "b": (jnp.asarray(t2),)}, n_pods)
    assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert got["b"][0].dtype == torch.int32
    assert np.array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
    same = (torch.zeros(K * n_pods, 2),)
    assert ttables.pad_tables_to_pods(same, n_pods) is same


@pytest.mark.parametrize("seed,S,tau,J", [(0, 8, 0, 4), (1, 5, 1, 4), (2, 16, 8, 4),
                                          (3, 7, 3, 2), (4, 6, 12, 6), (5, 3, 5, 1)])
def test_sync_round_gates_match(seed, S, tau, J):
    eoffs = np.random.default_rng(seed).integers(0, 64, size=S)
    for enabled in (True, False):
        got = ttables.sync_round_gates(eoffs, tau, J, enabled=enabled)
        want = jtables.sync_round_gates(eoffs, tau, J, enabled=enabled)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("sync_dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("seed,K,n_pods,cohort,cap", [(0, 8, 2, 4, 2), (1, 10, 5, 5, 1),
                                                      (2, 3, 1, 3, 4)])
def test_pod_placement_ledger_matches(seed, K, n_pods, cohort, cap, sync_dtype):
    go, gr, gm = random_topology(seed, K, 6, 9)
    kw = dict(n_pods=n_pods, cohort_pad=cohort, wb_cap=cap, n_max=9, g_max=6, n_feat=12,
              n_classes=3, tau=3, local_epochs=4, rounds=2, sync_dtype=sync_dtype)
    got = ledger.pod_placement_ledger(tpart.ghost_exchange_buckets(go, gr, gm, n_pods), **kw)
    want = jledger(jpart.ghost_exchange_buckets(go, gr, gm, n_pods), **kw)
    assert got == want
    # one round's collectives restate the ledger's entries, at the wire dtype
    cohort_b = got["per_round_collective_bytes"]["cohort_scaled"]
    wire = got["quant"]["wire_collective_bytes"]
    on = ledger.round_collectives(got, gate=True)
    off = ledger.round_collectives(got, gate=False)
    assert on["ghost_all_to_all"] == (1, wire["ghost_all_to_all"])
    assert on["wb_stage2_all_to_all"] == (1, wire["wb_stage2_all_to_all"])
    assert on["fetch_psum_tables"] == (1, cohort_b["fetch_psum_tables"])
    assert on["merge_allreduce"] == (1, cohort_b["merge_allreduce"])
    assert set(on) - set(off) == {"ghost_all_to_all", "ghost_fetch_psum"}
    pair = ledger.round_collectives(got, gate=False, merge_reduce="pairwise", n_ranks=4)
    assert pair["merge_all_gather"] == (1, 4 * cohort_b["merge_allreduce"])


@pytest.mark.parametrize("sync_dtype", ["fp32", "bf16", "int8"])
def test_wire_rows_round_trip(sync_dtype):
    """The write-back's wire: packed as bytes and unpacked, the float rows
    come back as the codec's round trip, the int32 rows as they were."""
    g = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 5, 4, generator=g), torch.randint(0, 99, (3, 5), generator=g,
                                                             dtype=torch.int32),
             torch.randn(3, 2, 6, generator=g), torch.randn(3, 7, generator=g)]
    tensors, layout = tfed.wire_rows(parts, sync_dtype)
    buf = comm.pack(tensors)
    assert buf.dtype == torch.uint8 and buf.shape[0] == 3
    got = tfed.unwire_rows(buf, layout, sync_dtype)
    for p, q in zip(parts, got):
        want = quant_roundtrip(p, sync_dtype) if p.is_floating_point() else p
        assert q.dtype == want.dtype and torch.equal(q, want)
    words = comm.pack([parts[0], parts[1]], torch.int32)
    back = comm.unpack(words, [((5, 4), torch.float32), ((5,), torch.int32)])
    assert torch.equal(back[0], parts[0]) and torch.equal(back[1], parts[1])
    with pytest.raises(ValueError, match="described"):
        comm.unpack(words, [((5, 4), torch.float32)])
