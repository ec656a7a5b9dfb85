"""The quantized sync wire in training: the port's ``fedais`` under
``sync_dtype`` "bf16" and "int8" against the reference's.

The ghost pull's rows and the merge's write-back (hist1, ghost_feat,
prev_loss; age stays exact) round-trip through ``federated.quant``. Both
engines start from the reference's initial params; the port replays the
reference's key chain. Held at the whole-run tier (``test_torch_engine``):
the codec itself is bit-exact (``test_torch_host.py``), but XLA's CPU
backend flushes denormals to zero and torch does not, and the params the
cohorts bring back differ by AdamW's amplified rounding. ``"fp32"`` is
inert: the same history, bit for bit, as a run that names no wire dtype.
"""
import numpy as np
import pytest

from repro.api import FedEngine as JEngine
from repro_torch.api import FedEngine
from repro_torch.convert import params_from_numpy
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from test_torch_async import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_engine import JRecording, TRecording, assert_whole_run_tier
from test_torch_fedais import JaxDraws, _init_params

ROUNDS, M = 3, 4


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


def _port_run(port_fed, **kw):
    g, fed = port_fed
    sel = TRecording()
    eng = FedEngine(g, fed, "fedais", rounds=ROUNDS, clients_per_round=M, seed=0,
                    selector=sel, device="cpu", **kw)
    state = eng.init_state(params=params_from_numpy(_init_params(fed), "cpu"),
                           draws=JaxDraws(0))
    return eng.run(state), sel.cohorts, state


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_whole_run_matches(small_fed, port_fed, dtype):
    g, fed = small_fed
    jsel = JRecording()
    ref = JEngine(g, fed, "fedais", rounds=ROUNDS, clients_per_round=M, seed=0,
                  selector=jsel, sync_dtype=dtype).run()
    got, cohorts, state = _port_run(port_fed, sync_dtype=dtype, train_backend="spmm",
                                    eval_backend="spmm")
    assert_whole_run_tier(got, ref, cohorts, jsel.cohorts)
    assert np.isfinite(got.history["test_loss"]).all()
    # the write-back went through the codec: bf16 leaves 16 low mantissa
    # bits at zero in every written hist1 row
    if dtype == "bf16":
        raw = state.hist.hist1.numpy().view(np.uint32)
        assert ((raw & 0xFFFF) == 0).all() and (raw != 0).any()


def test_fp32_wire_is_inert(port_fed):
    # on the spmm backends: the gather and segment backends' backward
    # accumulates rows with CPU threads in no fixed order, so two of their
    # runs need not agree to the bit
    kw = dict(train_backend="spmm", eval_backend="spmm")
    base, c0, s0 = _port_run(port_fed, **kw)
    fp32, c1, s1 = _port_run(port_fed, sync_dtype="fp32", **kw)
    assert c0 == c1
    assert base.history == fp32.history and base.final == fp32.final
    assert all((a == b).all() for a, b in zip(s0.hist, s1.hist))


def test_unknown_wire_dtype_is_refused(port_fed):
    g, fed = port_fed
    with pytest.raises(ValueError, match="sync dtype"):
        FedEngine(g, fed, "fedais", device="cpu", sync_dtype="fp16")
