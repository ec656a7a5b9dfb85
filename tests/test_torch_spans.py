"""The port's span system (``repro_torch.utils.spans``) and its records in
the fused FedAIS round.

Off, the system records nothing and hands out one shared no-op. On, host
spans nest with self time (a span's duration less its children's) and
sit on the profiler's timeline; device phases follow the round's
structure. The fused executor's CUDA-graph path is driven on the CPU by a
stand-in graph: its capture runs the body and puts back what the body
wrote (a capture runs nothing), its replay runs the captured body again
(a replay reruns the captured work on the static buffers). With it a run
captures and replays as on the card, and the phase accounting (the last
replay's boundaries times the key's replays) is the card's.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.fused import FusedRounds
from repro_torch.core.fedais import sync_gates
from repro_torch.federated.partition import partition_graph
from repro_torch.graph.data import make_dataset
from repro_torch.utils import spans

ROUNDS, M, EVAL_EVERY = 7, 3, 3


@pytest.fixture(autouse=True)
def spans_off():
    """Every test starts and ends with the system off and empty."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_fed():
    g = make_dataset("pubmed", scale=32, seed=0)
    return g, partition_graph(g, 8, alpha=0.5, seed=0)


# -- the system alone ---------------------------------------------------------

def test_off_records_nothing_and_shares_one_noop():
    a, b = spans.span("fedais.a"), spans.span("fedais.b", device_allocs=True)
    assert a is spans.NOOP and b is spans.NOOP
    assert spans.device_phase("loss_pass") is spans.NOOP
    marks = spans.new_marks("cpu")
    assert marks is None and spans.phase_scope(marks) is spans.NOOP
    spans.count("rounds", 3, key=(1, (2,), (True,)))
    with spans.span("fedais.capture", timed=True) as clock:
        pass
    assert clock.seconds >= 0.0
    assert spans.totals() == {"spans": {}, "phases": {}, "counters": {}}


def test_nesting_self_time_and_counts():
    spans.enable()
    for _ in range(2):
        with spans.span("fedais.parent"):
            with spans.span("fedais.child"):
                with spans.span("fedais.grandchild"):
                    sum(range(2000))
            with spans.span("fedais.child"):
                sum(range(1000))
            sum(range(1000))
    t = spans.totals()["spans"]
    assert {k: v["count"] for k, v in t.items()} == {
        "fedais.parent": 2, "fedais.child": 4, "fedais.grandchild": 2}
    par, ch, gc = t["fedais.parent"], t["fedais.child"], t["fedais.grandchild"]
    assert par["self_s"] == pytest.approx(par["total_s"] - ch["total_s"], abs=1e-12)
    assert ch["self_s"] == pytest.approx(ch["total_s"] - gc["total_s"], abs=1e-12)
    assert gc["self_s"] == gc["total_s"] > 0
    assert 0 < par["self_s"] < par["total_s"]


def test_spans_sit_on_the_profiler_timeline():
    spans.enable()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("fedais.outer"):
            with spans.span("fedais.inner"):
                torch.ones(4).sum()
    names = {e.key for e in prof.key_averages()}
    assert {"fedais.outer", "fedais.inner"} <= names


def test_stamp_refuses_what_it_cannot_write():
    """The stamp kernel runs on the card only; its checks run here."""
    from repro_torch.kernels.stamp.ops import stamp

    with pytest.raises(ValueError):
        stamp(torch.zeros(4, dtype=torch.int64), 0)


def test_counters_phases_and_diff():
    spans.enable()
    spans.count("replays", 2, key=(5, (10, 10), (True, False)))
    before = spans.totals()
    spans.count("replays", key=(5, (10, 10), (True, False)))
    marks = spans.new_marks("cpu")
    with spans.phase_scope(marks):
        with spans.device_phase("sampling"):
            pass
        with spans.device_phase("train_step"):
            pass
    assert spans.device_phase("merge") is spans.NOOP     # outside a scope
    spans.read_phases(marks, 3)
    # one stamp a boundary: each phase ends where the next one starts
    first = list(marks.times())
    assert marks.names == ["sampling", "train_step"] and len(first) == 3
    # a scope over filled marks writes them again; another order refuses
    with spans.phase_scope(marks):
        with spans.device_phase("sampling"):
            pass
        with pytest.raises(RuntimeError):
            with spans.device_phase("merge"):
                pass
    assert marks.names == ["sampling", "train_step"] and marks.times()[0] > first[0]
    d = spans.diff(spans.totals(), before)
    assert d["counters"] == {"replays": 1, "replays[5/10,10/1,0]": 1}
    assert {k: v["count"] for k, v in d["phases"].items()} == {"sampling": 3,
                                                                "train_step": 3}
    assert all(v["ms"] >= 0 for v in d["phases"].values())


def test_kept_marks_are_made_once():
    assert spans.kept_marks("fedais.test", "cpu", 2) is None
    spans.enable()
    marks = spans.kept_marks("fedais.test", "cpu", 2)
    assert marks is spans.kept_marks("fedais.test", "cpu", 2) and marks.slots == 2
    for _ in range(2):
        with spans.phase_scope(marks):
            with spans.device_phase("eval"):
                pass
        spans.read_phases(marks)
    assert spans.totals()["phases"]["eval"]["count"] == 2
    with pytest.raises(RuntimeError):            # a third boundary
        with spans.phase_scope(marks):
            with spans.device_phase("eval"):
                pass
            with spans.device_phase("merge"):
                pass


# -- the fused round ----------------------------------------------------------

class _StandInGraph:
    """``torch.cuda.CUDAGraph`` on the CPU: replay runs the captured body."""

    def __init__(self):
        self.body = None

    def register_generator_state(self, gen):
        self.gen = gen

    def pool(self):
        return "pool"

    def replay(self):
        self.body()


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """The fused executor's graph path on the CPU (module docstring)."""
    pending = {}
    capture = FusedRounds._capture

    def spy(self, key, body, *a):
        pending.update(rounds=self, body=body)
        return capture(self, key, body, *a)

    @contextlib.contextmanager
    def graph(g, pool=None, capture_error_mode=None):
        rounds = pending["rounds"]
        g.body = pending["body"]
        saved = ({k: v.clone() for k, v in rounds._params.items()},
                 [t.clone() for t in rounds._tables],
                 {m: {k: v.clone() for k, v in inp.items()} for m, inp in rounds._inputs.items()},
                 g.gen.get_state())
        yield
        params, tables, inputs, gen = saved
        for k, v in params.items():
            rounds._params[k].copy_(v)
        for t, v in zip(rounds._tables, tables):
            t.copy_(v)
        for m, inp in inputs.items():
            for k, v in inp.items():
                rounds._inputs[m][k].copy_(v)
        g.gen.set_state(gen)

    monkeypatch.setattr(FusedRounds, "_capture", spy)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def run(port_fed, *, on, graphed):
    g, fed = port_fed
    spans.reset()
    spans.enable(on)
    eng = api.FedEngine(g, fed, api.method_config("fedais", tau0=2), rounds=ROUNDS,
                        clients_per_round=M, eval_every=EVAL_EVERY, seed=0, device="cpu",
                        train_backend="spmm", eval_backend="spmm")
    state = eng.init_state()
    eng._fused = FusedRounds(eng)
    eng._fused._graphed = graphed
    taus = []
    # first in the stack: the tau each round ran at, before its eval moves it
    eng.callbacks.insert(0, type("Taus", (api.callbacks.BaseCallback,), {
        "fused_safe": True, "on_round_end": lambda self, ctx: taus.append(ctx.state.tau)})())
    result = eng.run(state)
    spans.enable(False)
    assert eng.last_executor == "fused"
    return eng, state, result, spans.totals(), taus


def assert_same(a, b):
    (_, sa, ra, _, _), (_, sb, rb, _, _) = a, b
    assert ra.history == rb.history and ra.final == rb.final
    for k in sa.params:
        assert torch.equal(sa.params[k], sb.params[k]), k
    for name in ("hist1", "age", "ghost_feat"):
        assert torch.equal(getattr(sa.hist, name), getattr(sb.hist, name)), name
    assert torch.equal(sa.prev_loss, sb.prev_loss)


def test_traced_fused_run_is_bit_equal(port_fed, stand_in_graphs):
    """Chunks that capture and replay give the same params, tables and
    history with the system on and off, and the same as eager rounds."""
    eager = run(port_fed, on=False, graphed=False)
    off = run(port_fed, on=False, graphed=True)
    on = run(port_fed, on=True, graphed=True)
    assert off[0]._fused.captures and off[3] == {"spans": {}, "phases": {},
                                                 "counters": {}}
    assert_same(eager, off)
    assert_same(off, on)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graphs"])
def test_phase_counts_follow_the_round(port_fed, stand_in_graphs, graphed):
    """loss_pass once per member and round, train_step and optimizer J
    times, ghost_pull once per open gate; the spans' and counters' counts;
    each capture's seconds are its capture span's duration."""
    eng, state, result, t, taus = run(port_fed, on=True, graphed=graphed)
    J = eng.mcfg.local_epochs
    opened = sum(sum(sync_gates(eng.mcfg, taus[r], r * J)) for r in range(ROUNDS))
    phases = {k: v["count"] for k, v in t["phases"].items()}
    chunks = len(range(0, ROUNDS, EVAL_EVERY))
    assert phases == {"loss_pass": M * ROUNDS, "sampling": M * J * ROUNDS,
                      "train_step": M * J * ROUNDS, "optimizer": M * J * ROUNDS,
                      "ghost_pull": M * opened,
                      "table_traffic": ROUNDS * (3 + M * J), "merge": 2 * ROUNDS,
                      "eval": chunks}
    assert all(v["ms"] > 0 for v in t["phases"].values())
    c, s = t["counters"], t["spans"]
    assert (c["chunks"], c["rounds"], c["evals"]) == (chunks, ROUNDS, chunks)
    captures = eng._fused.captures
    assert c.get("replays", 0) + c["eager_rounds"] == ROUNDS
    assert c["eager_rounds"] == (len(captures) if graphed else ROUNDS)
    assert c.get("captures", 0) == len(captures) == (c["eager_rounds"] if graphed else 0)
    assert sum(v for k, v in c.items() if k.startswith("replays[")) == c.get("replays", 0)
    assert s["fedais.chunk"]["count"] == s["fedais.chunk.select"]["count"] == chunks
    assert s["fedais.chunk.host_tail"]["count"] == s["fedais.chunk.rounds"]["count"] == chunks
    assert s["fedais.chunk.readback"]["count"] == s["fedais.chunk.read_phases"]["count"] == chunks
    assert s["fedais.eval.read_phases"]["count"] == chunks
    assert s["fedais.eval"]["count"] == chunks
    # the allocator is read at the chunk's start and end, in a child span
    # each; the evals inside the chunk count in it
    assert s["fedais.chunk.allocs"]["count"] == 2 * chunks and "fedais.eval.allocs" not in s
    assert c["device_allocs"] == 0        # nothing on a card
    tail = s["fedais.chunk.host_tail"]
    assert tail["self_s"] < tail["total_s"]   # the evals inside it are its children
    if graphed:
        assert s["fedais.chunk.capture"]["count"] == len(captures) > 0
        assert s["fedais.chunk.replay"]["count"] == c["replays"] > 0
        assert sum(x["seconds"] for x in captures) == pytest.approx(
            s["fedais.chunk.capture"]["total_s"], abs=1e-9)
    else:
        assert "fedais.chunk.capture" not in s and "fedais.chunk.replay" not in s


def test_switching_the_spans_recaptures_the_graphs(port_fed, stand_in_graphs):
    """A graph carries phase boundaries exactly while the spans are on:
    switching them drops the executor's graphs, which the next chunk
    captures again."""
    g, fed = port_fed
    eng = api.FedEngine(g, fed, api.method_config("fedais", tau0=2), rounds=ROUNDS,
                        clients_per_round=M, eval_every=EVAL_EVERY, seed=0, device="cpu",
                        train_backend="spmm", eval_backend="spmm")
    state = eng.init_state()
    ex = eng._fused = FusedRounds(eng)
    ex._graphed = True
    for cb in eng.callbacks:
        cb.on_run_start(eng, state)
    captured = []
    for t0, on in ((0, True), (2, True), (4, False), (5, True)):
        spans.enable(on)
        spans.reset()
        eng._run_chunk(state, t0, 1 if t0 == 4 else 2)
        phases = spans.totals()["phases"]
        captured.append(len(ex.captures))
        assert set(ex._graphs) and set(ex._marks) == (set(ex._graphs) if on else set())
        assert bool(phases) == on
        if on:       # every round's phases: eager or replayed, none missed
            assert phases["loss_pass"]["count"] == M * (1 if t0 == 4 else 2)
    # the second chunk replays; each switch captures its keys again
    assert captured[1] == captured[0] < captured[2] < captured[3]


def test_capture_seconds_with_the_system_off(port_fed, stand_in_graphs):
    eng, *_ = run(port_fed, on=False, graphed=True)
    assert all(np.isfinite(c["seconds"]) and c["seconds"] > 0 for c in eng._fused.captures)


def test_stepwise_rounds_record_no_phase(port_fed):
    """Outside the fused executor's scope a round's phases are no-ops; the
    eval's phase is the eval's."""
    g, fed = port_fed
    spans.enable()
    eng = api.FedEngine(g, fed, "fedais", rounds=2, clients_per_round=M, seed=0,
                        device="cpu", train_backend="spmm", eval_backend="spmm",
                        scheduler=api.SyncScheduler(fused=False))
    eng.run()
    assert eng.last_executor == "stepwise"
    assert set(spans.totals()["phases"]) == {"eval"}
