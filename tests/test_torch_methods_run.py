"""Every registered method runs one round of ``FedEngine(...).run()`` on the
CPU under each training backend (gather, segment, spmm), and ``fedais``
two rounds under the async scheduler, the staleness aggregator and each
sync wire dtype: the run completes with a finite loss and an accuracy in
[0, 1]. What each run computes is held against the reference in
``test_torch_methods.py``, ``test_torch_async*.py`` and
``test_torch_quant_sync.py``.
"""
import numpy as np
import pytest

from repro_torch.api import FedEngine
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


@pytest.mark.parametrize("backend", ["gather", "segment", "spmm"])
@pytest.mark.parametrize("method", ["fedall", "fedrandom", "fedsage+", "fedpns", "fedgraph",
                                    "fedlocal", "fedais1", "fedais2", "fedais"])
def test_every_method_runs_on_every_backend(port_fed, method, backend):
    g, fed = port_fed
    res = FedEngine(g, fed, method, rounds=1, clients_per_round=2, seed=0, device="cpu",
                    train_backend=backend, eval_backend=backend).run()
    assert res.history["round"] == [0] and np.isfinite(res.final["loss"])
    assert 0.0 <= res.final["acc"] <= 1.0


@pytest.mark.parametrize("kw", [{"scheduler": "async"}, {"aggregator": "staleness"},
                                {"sync_dtype": "fp32"}, {"sync_dtype": "bf16"},
                                {"sync_dtype": "int8"}],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_every_component_runs(port_fed, kw):
    g, fed = port_fed
    res = FedEngine(g, fed, "fedais", rounds=2, clients_per_round=2, seed=0, device="cpu",
                    **kw).run()
    assert res.history["round"] == [0, 1] and np.isfinite(res.final["loss"])
