"""One run of a FedAIS training cell: the program's set-up, its measured
window, its traced window, and what the judge needs of it.

The system under test is ``repro_torch``'s ``FedEngine`` on its fused
executor (``SyncScheduler`` -> ``run_fused`` -> ``_run_chunk`` ->
``api/fused.py::FusedRounds``: a round is a CUDA graph per key, replayed),
with the SpMM kernel for the aggregations of training and eval. The
harness drives ``_run_chunk`` in the chunks ``run_fused`` makes (each
ends at an eval round), so that it can stop at a chunk's end when the
window is over and read the state after the first rounds.

Set-up, one engine and one state throughout:

1. rounds 0, 1 and 2 as chunks of one round (round 0 evaluates); the
   params and the cohorts' rows of every table are read after each;
2. rounds 3 .. 10 as one chunk; the eval at round 10 sets tau by Eq. 11,
   and the params are read;
3. one round at each sync pattern of every tau from J + 1 down to 1
   (``warm_taus``), with tau set for that round and put back after: every
   CUDA graph key that Eq. 11 can ask for in the window is captured before
   it (``graph_captures`` counts any the window captures);
4. the window: the chunks that follow, until ``seconds`` have passed;
5. after it, one more round at the sync interval the window ran last, whose
   start state and cohort rows the judge compares (``compared_round``).
"""
from __future__ import annotations

import gc
import math
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

from fedbench import graphgen, judge, reference, trace, work

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def warm_taus(epochs: int) -> list:
    """The sync intervals of the warm-up rounds: every tau from J + 1 down
    to 1, in as many consecutive rounds as it has sync patterns (a round's
    gates shift with its epoch offset J·t modulo tau, which takes
    tau / gcd(tau, J) values). A tau above J gates at most one of a round's
    J epochs, and J + 1's patterns gate each epoch once and none, so these
    rounds meet every graph key that Eq. 11 can ask for."""
    return [t for t in range(epochs + 1, 0, -1) for _ in range(t // math.gcd(t, epochs))]


def thread_sample() -> tuple:
    """(CPU last run on, CPU seconds, involuntary context switches) of the
    calling thread, from /proc (zeros where the system does not say)."""
    try:
        with open("/proc/thread-self/stat") as f:
            st = f.read().rsplit(")", 1)[1].split()
        with open("/proc/thread-self/status") as f:
            nv = [ln for ln in f if ln.startswith("nonvoluntary_ctxt_switches")]
        return (int(st[36]), (int(st[11]) + int(st[12])) / os.sysconf("SC_CLK_TCK"),
                int(nv[0].split()[1]) if nv else 0)
    except (OSError, ValueError, IndexError):
        return (0, 0.0, 0)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the port must not pull in,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def make_inputs(cfg: dict, traffic: dict) -> tuple:
    """The graph and its partition, from the configuration's and the
    traffic's seeds (the same for every run seed: the seed varies the
    weights, the draws and the cohorts, not the sizes)."""
    g = cfg["graph"]
    graph = graphgen.make_graph(
        cfg["dataset"], n_nodes=g["n_nodes"], n_edges=g["n_edges"],
        n_features=g["n_features"], n_classes=g["n_classes"], splits=tuple(g["splits"]),
        scale=g["scale"], max_features=cfg["max_features"], homophily=g["homophily"],
        feature_noise=g["feature_noise"], mean_scale=g["mean_scale"], seed=g["seed"])
    p = traffic["partition"]
    part = graphgen.partition(graph, p["n_clients"], alpha=p["alpha"],
                              max_deg=p["max_deg"], edge_keep=p["edge_keep"], seed=p["seed"])
    return graph, part


def method_of(cfg: dict) -> reference.Method:
    m = cfg["method"]
    return reference.Method(sample_ratio=m["sample_ratio"], batch_cap=m["batch_cap"],
                            fanout=m["neighbor_fanout"], local_epochs=m["local_epochs"],
                            lr=m["lr"], tau0=m["tau0"])


class Program:
    """The program under test, set up for one cell."""

    def __init__(self, torch, cfg, traffic, graph, part, seed, device, params0):
        from repro_torch.api import FedEngine, method_config
        from repro_torch.api.callbacks import EvalCallback, HistoryCallback
        from repro_torch.federated.partition import FederatedGraph
        from repro_torch.graph.data import GraphData
        from torch.profiler import record_function

        class SpannedEval(EvalCallback):
            """The default eval and tau update, inside a profiler span."""
            fused_safe = True

            def on_round_end(self, ctx):
                with record_function("fedais.eval"):
                    super().on_round_end(ctx)

        self.torch = torch
        gd = GraphData(name=graph["name"], features=graph["features"], labels=graph["labels"],
                       edges=graph["edges"], n_classes=graph["n_classes"],
                       train_mask=graph["train_mask"], val_mask=graph["val_mask"],
                       test_mask=graph["test_mask"], spec=None)
        fed = FederatedGraph(
            name=graph["name"], n_clients=part["n_clients"], n_max=part["n_max"],
            g_max=part["g_max"], max_deg=part["max_deg"], features=part["features"],
            labels=part["labels"], node_mask=part["node_mask"], train_mask=part["train_mask"],
            val_mask=part["val_mask"], nbr_idx=part["nbr_idx"], nbr_mask=part["nbr_mask"],
            ghost_owner=part["ghost_owner"], ghost_row=part["ghost_row"],
            ghost_mask=part["ghost_mask"], global_ids=part["global_ids"],
            n_classes=part["n_classes"], n_cross_edges=part["n_cross_edges"])
        m = cfg["method"]
        mcfg = method_config(m["name"], tau0=m["tau0"], sample_ratio=m["sample_ratio"],
                             batch_cap=m["batch_cap"], neighbor_fanout=m["neighbor_fanout"],
                             local_epochs=m["local_epochs"], lr=m["lr"],
                             aggregator=m["aggregator"])
        self.eval_every = traffic["eval_every"]
        self.engine = FedEngine(
            gd, fed, mcfg, rounds=1 << 40, clients_per_round=traffic["cohort"], seed=seed,
            callbacks=[SpannedEval(self.eval_every), HistoryCallback()],
            train_backend=cfg["backend"], eval_backend=cfg["backend"], device=device)
        self.state = self.engine.init_state(params={k: v.clone() for k, v in params0.items()})
        ok, why = self.engine.fused_eligibility(self.state)
        if not ok:
            raise RuntimeError(f"the fused executor is not eligible: {why}")
        for cb in self.engine.callbacks:
            cb.on_run_start(self.engine, self.state)
        self.t = 0

    def chunk(self, n: int) -> int:
        """Run rounds t .. t + n - 1 as one chunk; returns n."""
        with self.torch.profiler.record_function("fedais.chunk"):
            if self.engine._run_chunk(self.state, self.t, n):
                raise RuntimeError("a callback stopped the run")
        self.t += n
        return n

    def next_chunk(self) -> int:
        """The chunk ``run_fused`` would run next: up to the next eval round."""
        t, e = self.t, self.eval_every
        nxt = t if t % e == 0 else (t // e + 1) * e
        return self.chunk(nxt - t + 1)

    def snapshot(self, cohort) -> dict:
        torch, st = self.torch, self.state
        rows = torch.as_tensor(np.asarray(cohort), dtype=torch.long, device=st.prev_loss.device)
        return {"params": {k: v.detach().clone() for k, v in st.params.items()},
                "hist1": st.hist.hist1[rows].cpu(), "age": st.hist.age[rows].cpu(),
                "ghost": judge.digest(st.hist.ghost_feat[rows]).cpu(),
                "prev_loss": st.prev_loss.clone()}

    def history(self, t: int) -> dict:
        h = self.state.result.history
        i = h["round"].index(t)
        return {"test_loss": h["test_loss"][i], "tau": h["tau"][i]}

    def captures(self) -> int:
        fused = self.engine._fused
        return 0 if fused is None else len(fused.captures)

    def full_state(self) -> dict:
        """Every table and the draw generator's position, copied to the host."""
        st = self.state
        host = lambda x: x.detach().to("cpu", copy=True)
        return {"params": {k: host(v) for k, v in st.params.items()},
                "hist1": host(st.hist.hist1), "age": host(st.hist.age),
                "ghost": host(st.hist.ghost_feat), "prev_loss": host(st.prev_loss),
                "gen": st.draws.gen.get_state(), "rng": _copy_rng(st.rng),
                "t": self.t, "tau": st.tau}

    def compared_round(self, m: int) -> dict:
        """The next round, at the sync interval the window ran last, as a
        chunk of its own: the state it started from, its cohort, and the
        cohort's rows after it; with the window's last eval."""
        start = self.full_state()
        K = start["hist1"].shape[0]
        cohort = _copy_rng(start["rng"]).choice(K, size=min(m, K), replace=False)
        last = self.history(self.t - 1)
        self.chunk(1)
        return {"start": start, "cohort": cohort, "snap": self.snapshot(cohort),
                "hist": last}


def _copy_rng(rng):
    out = np.random.default_rng()
    out.bit_generator.state = rng.bit_generator.state
    return out


def spmm_launches() -> int:
    from repro_torch.kernels.spmm.ops import block_spmm
    return block_spmm.launches


def run(torch, cfg, traffic, seed: int, seconds: float, do_trace: bool, device,
        t_start: float, log) -> SimpleNamespace:
    """Set up, measure and (with ``do_trace``) trace one run of the
    program; returns what the metrics and the judge read."""
    out = SimpleNamespace(seed=seed, method=method_of(cfg), eval_every=traffic["eval_every"],
                          cohort=traffic["cohort"])
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    graph, part = make_inputs(cfg, traffic)
    out.graph, out.part = graph, part
    log(f"inputs made at {time.perf_counter() - t_start:.3f} s: n_max {part['n_max']}, "
        f"g_max {part['g_max']}, {len(graph['edges'])} edges")
    if cuda:
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        nvcc_s = build.build(["spmm"]).get("spmm", 0.0)
        log(f"spmm library ready in {time.perf_counter() - t0:.3f} s "
            f"(nvcc {nvcc_s:.3f} s this run)")
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params0 = reference.init_params(gen, part["features"].shape[2], part["n_classes"], device)
    out.params0 = {k: v.clone() for k, v in params0.items()}
    prog = Program(torch, cfg, traffic, graph, part, seed, device, params0)
    del params0
    sync()
    log(f"engine built at {time.perf_counter() - t_start:.3f} s")
    m = traffic["cohort"]
    cohorts = graphgen.select_cohorts(seed, part["n_clients"], m, 3)
    out.cohorts = cohorts
    out.prev0 = prog.state.prev_loss.clone()
    out.snaps = []
    for r in range(3):
        prog.chunk(1)
        out.snaps.append(prog.snapshot(cohorts[r]))
    sync()
    log(f"rounds 0-2 done at {time.perf_counter() - t_start:.3f} s")
    prog.next_chunk()
    out.params10 = {k: v.detach().clone() for k, v in prog.state.params.items()}
    out.hist0, out.hist10 = prog.history(0), prog.history(prog.t - 1)
    natural = prog.state.tau
    for tau in warm_taus(cfg["method"]["local_epochs"]):
        prog.state.tau = tau
        prog.chunk(1)
    prog.state.tau = natural
    sync()
    out.setup_s = time.perf_counter() - t_start
    log(f"set-up {out.setup_s:.3f} s: {prog.t} rounds, {prog.captures()} graph keys captured, "
        f"tau {natural} after round 10")

    launches0, captures0 = spmm_launches(), prog.captures()
    rounds = evals = failed = 0
    hist = prog.state.result.history
    chunk_s, threads = [], [thread_sample()]
    # the harness's own objects (inputs, snapshots) leave the collector's
    # generations, so its passes in the window scan the program's alone
    gc.collect()
    gc.freeze()
    t0, t0_wall = time.perf_counter(), time.time()
    while True:
        n = prog.next_chunk()
        rounds, evals = rounds + n, evals + 1
        if not np.isfinite(hist["test_loss"][-1]):
            failed += n
        chunk_s.append(time.perf_counter() - t0)
        threads.append(thread_sample())
        if chunk_s[-1] >= seconds:
            break
    sync()
    gc.unfreeze()
    out.window_s = time.perf_counter() - t0
    out.rounds, out.evals = rounds, evals
    out.step_ms = out.window_s / rounds * 1e3
    J = cfg["method"]["local_epochs"]
    out.spmm_launches = spmm_launches() - launches0
    # the CPU path runs the plain SpMM, which counts no launch
    out.spmm_expected = rounds * m * (2 + 3 * J) + evals * 2 if cuda else None
    out.captures_in_window = prog.captures() - captures0
    out.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    out.failed = failed
    per = np.diff([0.0] + chunk_s)
    log(f"window {out.window_s:.3f} s: {rounds} rounds, {evals} evals, step {out.step_ms:.4f} ms, "
        f"{out.captures_in_window} graph keys captured in it, peak {out.peak_bytes} B; "
        f"chunks (s, from {t0_wall:.3f} on the wall clock): {per.round(3).tolist()}")
    log("main thread a chunk (CPU it ran on last, its CPU seconds, its involuntary context "
        "switches): " + str([(b[0], round(b[1] - a[1], 3), b[2] - a[2])
                              for a, b in zip(threads, threads[1:])]))
    log(f"window evals (round, test loss, accuracy, tau): "
        f"{list(zip(hist['round'], hist['test_loss'], hist['test_acc'], hist['tau']))[-evals:]}")
    out.win = prog.compared_round(m)
    log(f"compared round {prog.t - 1} at tau {out.win['start']['tau']}")

    if do_trace:
        start = prog.full_state()
        tchunks = traffic.get("trace_chunks", 2)
        counted = {"rounds": 0, "evals": 0, "taus": []}

        def traced():
            for _ in range(tchunks):
                counted["taus"].append((prog.t, prog.state.tau))
                counted["rounds"] += prog.next_chunk()
                counted["evals"] += 1

        tr = trace.trace(torch, traced)
        log(f"trace read: {len(tr['device'])} device and {len(tr['host'])} host events")
        out.trace = trace.summarize(tr)
        del tr
        out.trace.update(rounds=counted["rounds"], evals=counted["evals"])
        out.trace_start, out.trace_taus = start, counted["taus"]
        log(f"traced {counted['rounds']} rounds in {out.trace['window_s']:.4f} s, busy "
            f"{out.trace['busy_s']:.4f} s; left out of the window: "
            f"{out.trace['profiler_s']:.4f} s of device idle under the profiler's bookkeeping")

    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def replay_work(torch, cfg, out, device) -> work.Work:
    """The traced rounds' SpMM launches and their work, replayed by the
    reference from the state the traced window started from (its batches
    and fanouts follow the same draws; a rare batch that rounding would
    draw otherwise moves a launch's count by a few nonzeros)."""
    st = out.trace_start
    graph, part = out.graph, out.part
    eval_nbrs = graphgen.padded_neighbors(graphgen.adjacency_lists(graph["edges"],
                                                                   len(graph["labels"])),
                                          part["max_deg"], out.seed)
    inp = reference.device_inputs(part, graph, eval_nbrs, device)
    K = part["n_clients"]
    ghost = st["ghost"].to(device)
    state = {"hist1": st["hist1"].to(device), "age": st["age"].to(device),
             "prev_loss": st["prev_loss"].to(device),
             "ghost": {k: ghost[k] for k in range(K)}, "gen": st["gen"]}
    params = {k: v.to(device) for k, v in st["params"].items()}
    ref = reference.RefRun(inp, method_of(cfg), params, out.seed, device, state=state)
    w = work.Work()
    rng = st["rng"]
    e = out.eval_every
    t = st["t"]
    end = t + out.trace["rounds"]
    taus = dict(out.trace_taus)
    tau = st["tau"]
    while t < end:
        tau = taus.get(t, tau)
        nxt = t if t % e == 0 else (t // e + 1) * e
        for r in range(t, nxt + 1):
            cohort = rng.choice(K, size=min(out.cohort, K), replace=False)
            ref.round(r, cohort, tau, work=w)
        ref.eval_logits(ref.params, work=w)
        t = nxt + 1
    return w
