"""The port's host substrate against the reference, exact.

``repro_torch.graph`` / ``repro_torch.serve.updates`` are numpy copies of
the reference's, and the quant codec is its tensor twin: equal inputs must
give equal arrays, bit for bit.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.federated import quant as jquant
from repro.graph import csr as jcsr
from repro.graph import data as jdata
from repro.serve.updates import GraphStore as JStore
from repro_torch.federated import quant as tquant
from repro_torch.graph import csr as tcsr
from repro_torch.graph import data as tdata
from repro_torch.serve.updates import GraphStore as TStore


def _assert_graph_equal(a, b):
    for f in ("features", "labels", "edges", "train_mask", "val_mask", "test_mask"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_classes == b.n_classes
    assert dataclasses.asdict(a.spec) == dataclasses.asdict(b.spec)


@pytest.fixture(scope="module", params=[32, 64])
def graphs(request):
    scale = request.param
    return (tdata.make_dataset("pubmed", scale=scale, seed=0),
            jdata.make_dataset("pubmed", scale=scale, seed=0))


def test_make_dataset_and_downsample_equal(graphs):
    t, j = graphs
    _assert_graph_equal(t, j)
    _assert_graph_equal(tdata.downsample_edges(t, 0.5, seed=3),
                        jdata.downsample_edges(j, 0.5, seed=3))
    assert ({k: dataclasses.asdict(v) for k, v in tdata.DATASET_SPECS.items()}
            == {k: dataclasses.asdict(v) for k, v in jdata.DATASET_SPECS.items()})


@pytest.mark.parametrize("max_deg", [None, 4, 32])
def test_padded_neighbors_and_csr_equal(graphs, max_deg):
    g = graphs[0]
    ti, tm = tcsr.build_padded_neighbors(g.adjacency_lists(), max_deg, seed=1)
    ji, jm = jcsr.build_padded_neighbors(g.adjacency_lists(), max_deg, seed=1)
    assert np.array_equal(ti, ji) and np.array_equal(tm, jm)
    assert ti.dtype == ji.dtype and tm.dtype == jm.dtype
    tc, jc = tcsr.csr_from_padded(ti, tm), jcsr.csr_from_padded(ji, jm)
    for k in ("src", "dst", "inv_deg"):
        assert tc[k].dtype == jc[k].dtype and np.array_equal(tc[k], jc[k]), k
    assert tcsr.degree_stats(tm) == jcsr.degree_stats(jm)

    tb = tcsr.bucketed_csr_from_padded(torch.from_numpy(ti), torch.from_numpy(tm))
    jb = jcsr.bucketed_csr_from_padded(jnp.asarray(ji), jnp.asarray(jm))
    for k in ("src", "dst", "inv_deg"):
        assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), k
        assert tb[k].numpy().dtype == np.asarray(jb[k]).dtype, k


def test_graph_store_mutations_equal(graphs):
    g = graphs[0]
    idx, mask = tcsr.build_padded_neighbors(g.adjacency_lists(), 8, seed=0)
    n = g.n_nodes
    # a small capacity so that add_nodes grows the store geometrically
    ts = TStore(g.features, idx, mask, capacity=n + 2, seed=5)
    js = JStore(g.features, idx, mask, capacity=n + 2, seed=5)
    rng = np.random.default_rng(0)

    def same():
        for f in ("features", "nbr_idx", "nbr_mask"):
            assert np.array_equal(getattr(ts, f), getattr(js, f)), f
        for f in ("n_active", "capacity", "n_grows", "n_edges_added",
                  "n_edges_evicted"):
            assert getattr(ts, f) == getattr(js, f), f

    # hub edges overflow row 0's 8 slots, exercising the random eviction
    edges = np.concatenate([rng.integers(0, n, (40, 2)),
                            np.stack([np.zeros(20, int), np.arange(1, 21)], 1)])
    assert np.array_equal(ts.add_edges(edges), js.add_edges(edges))
    same()
    for c in (1, 3, 5):
        feats = rng.standard_normal((c, g.n_features)).astype(np.float32)
        new = ts.n_active
        att = np.stack([np.arange(new, new + c), rng.integers(0, new, c)], 1)
        (ti, ta), (ji, ja) = ts.add_nodes(feats, att), js.add_nodes(feats, att)
        assert np.array_equal(ti, ji) and np.array_equal(ta, ja)
        same()
    assert ts.n_grows > 0
    rows = rng.integers(0, ts.n_active, 17)
    for x, y in zip(ts.neighbors(rows), js.neighbors(rows)):
        assert np.array_equal(x, y)
    assert np.array_equal(ts.degrees(), js.degrees())


def _codec_inputs():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((33, 20)).astype(np.float32) * 3
    # no denormal row: XLA's CPU backend flushes denormals to zero (the
    # reference then encodes such a row as all-zero), torch keeps them
    x[3] = 0.0                                      # all-zero row
    x[5] = 1e-30                                    # tiny (normal) row
    x[7, 2] = 1e6                                   # one outlier
    x[9] = np.linspace(-127, 127, 20) / 2           # exact .5 ties
    return x


@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
def test_quant_codec_bit_exact(dtype):
    x = _codec_inputs()
    tx = torch.from_numpy(x.copy())
    tp, ts = tquant.encode(tx, dtype)
    jp, js = jquant.encode(jnp.asarray(x), dtype)
    if dtype == "bf16":
        assert np.array_equal(tp.view(torch.int16).numpy(),
                              np.asarray(jp).view(np.int16))
    else:
        assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert (ts is None) == (js is None)
    if ts is not None:
        assert np.array_equal(ts.numpy(), np.asarray(js))
    td = tquant.decode(tp, ts, dtype).numpy()
    jd = np.asarray(jquant.decode(jp, js, dtype))
    assert td.dtype == jd.dtype and np.array_equal(td, jd)
    assert np.array_equal(tquant.quant_roundtrip(tx, dtype).numpy(),
                          np.asarray(jquant.quant_roundtrip(jnp.asarray(x), dtype)))
    if dtype == "int8":
        assert np.array_equal(td[3], np.zeros(20, np.float32))
    if dtype == "fp32":
        assert tp is tx and tquant.quant_roundtrip(tx, dtype) is tx
    for shape in [(), (4,), (3, 0), (0, 5), (2, 3, 4)]:
        assert tquant.wire_bytes(shape, dtype) == jquant.wire_bytes(shape, dtype)
    with pytest.raises(ValueError):
        tquant.check_sync_dtype("fp8")
