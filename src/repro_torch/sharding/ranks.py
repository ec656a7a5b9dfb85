"""A small rank launcher: N processes in one process group on this machine.

The reference's single controller drives every device from one process;
``torch.distributed`` runs one process per rank. ``RankPool`` starts
``world_size`` processes with ``torch.multiprocessing`` (spawned), joins
them in one process group through a ``file://`` store in a temporary
directory (no TCP port), and keeps them for many tasks: ``pool.run(fn,
*args)`` calls ``fn(*args)`` on every rank and returns the ranks' results
in rank order. ``fn`` must be importable by name (a module-level function).

``device="cpu"`` makes a gloo world of CPU ranks, each on one torch thread;
``device=None`` (the default) an NCCL world, rank r on card r mod the
card count, and raises without CUDA. A task that raises on any rank raises
here with that rank's traceback, and the pool is then closed: every
process it started is stopped. On several machines (or with ``torchrun``)
the process group comes from the launcher instead, and the meshes of
``sharding.fed`` / ``sharding.tables`` are built the same way.
"""
from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

__all__ = ["RankPool", "run_engine"]


def _worker(rank: int, world: int, device: str, store: str, inbox, outbox,
            timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    try:
        if device == "cpu":
            torch.set_num_threads(1)
            backend = "gloo"
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
            backend = "nccl"
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=world,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
        outbox.put((rank, "ready", None))
    except Exception:                                   # noqa: BLE001
        # reported to the pool, which raises it with this traceback
        outbox.put((rank, "error", traceback.format_exc()))
        return
    try:
        while True:
            task = inbox.get()
            if task is None:
                break
            fn, args = task
            try:
                outbox.put((rank, "ok", fn(*args)))
            except Exception:                           # noqa: BLE001
                outbox.put((rank, "error", traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` ranks in one process group, reused across tasks."""

    def __init__(self, world_size: int, *, device=None, store_dir: str | None = None,
                 timeout_s: float = 300.0):
        import torch
        import torch.multiprocessing as mp

        from repro_torch.device import resolve_device

        self.world_size = int(world_size)
        self.device = resolve_device(device).type
        if self.device == "cuda" and torch.cuda.device_count() < 1:
            raise RuntimeError("RankPool on the card needs CUDA")
        self.timeout_s = float(timeout_s)
        self._dir = tempfile.mkdtemp(prefix="ranks-", dir=store_dir)
        store = os.path.join(self._dir, "store")
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes, self._procs = [], []
        for r in range(self.world_size):
            inbox = ctx.Queue()
            proc = ctx.Process(target=_worker, args=(r, self.world_size, self.device, store,
                                                     inbox, self._outbox, self.timeout_s),
                               daemon=True)
            proc.start()
            self._inboxes.append(inbox)
            self._procs.append(proc)
        self._collect("ready")

    def _collect(self, what: str) -> list:
        out = [None] * self.world_size
        seen = 0
        deadline = time.monotonic() + self.timeout_s
        while seen < self.world_size:
            try:
                rank, status, value = self._outbox.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    self.close()
                    why = f"ranks {dead} died" if dead else f"timed out after {self.timeout_s} s"
                    raise RuntimeError(f"RankPool: {what}: {why}")
                continue
            if status == "error":
                self.close()
                raise RuntimeError(f"RankPool: {what}: rank {rank} raised:\n{value}")
            out[rank] = value
            seen += 1
        return out

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("RankPool is closed")
        for inbox in self._inboxes:
            inbox.put((fn, args))
        return self._collect(getattr(fn, "__name__", "task"))

    def close(self) -> None:
        """Stop every rank (politely, then by force) and remove the store."""
        for inbox, proc in zip(self._inboxes, self._procs):
            if proc.is_alive():
                inbox.put(None)
        while True:         # a rank exits only once its results are read
            try:
                self._outbox.get(timeout=0.1)
            except queue.Empty:
                break
        for proc in self._procs:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=5)
        self._procs, self._inboxes = [], []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Recording:
    """A selector that keeps the cohorts its base drew."""

    def __init__(self, base):
        self.base, self.cohorts = base, []
        self.precomputable = getattr(base, "precomputable", False)

    def select(self, engine, state):
        sel = self.base.select(engine, state)
        self.cohorts.append([int(c) for c in sel])
        return sel


def run_engine(spec: dict) -> dict:
    """One ``FedEngine`` run on this rank from a picklable ``spec``, for
    ``RankPool.run`` (every rank runs it; the engines agree on every host
    decision). Keys: ``dataset`` and ``partition`` (``make_dataset`` and
    ``partition_graph`` keywords), ``method`` (a registered name, or a dict
    of ``method_config`` keywords with ``name``), ``mesh`` (None,
    ``"clients"``, or ``[pods, clients]``), ``engine`` (``FedEngine``
    keywords), ``faults`` (``FaultPlan`` keywords), ``params`` (numpy
    initial params), ``draws`` (``RecordedDraws`` rounds) and ``chunks``
    (``[[t0, n], ...]`` to run through ``_run_chunk`` instead of ``run``).
    Returns the eligibility verdicts for the cohort size (fused, sharded,
    pod-sharded, with their reasons), the history, the final row, the
    executor, the cohorts, the fault counters, the params and the K-row
    tables as numpy, and the sharded executor's round log."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import FedEngine, UniformSelector, method_config
    from repro_torch.core.fedais import RecordedDraws
    from repro_torch.faults import FaultPlan
    from repro_torch.federated.partition import partition_graph
    from repro_torch.graph.data import make_dataset
    from repro_torch.sharding.fed import make_client_mesh
    from repro_torch.sharding.tables import gather_tables, make_pod_mesh

    device = "cpu" if dist.get_backend() == "gloo" else None
    g = make_dataset(**spec["dataset"])
    fed = partition_graph(g, **spec["partition"])
    method = spec.get("method", "fedais")
    if isinstance(method, dict):
        method = method_config(**method)
    mesh = spec.get("mesh")
    if mesh == "clients":
        mesh = make_client_mesh(device=device)
    elif mesh is not None:
        mesh = make_pod_mesh(*mesh, device=device)
    kw = dict(spec.get("engine", {}))
    if spec.get("faults"):
        kw["faults"] = FaultPlan(**spec["faults"])
    sel = _Recording(UniformSelector())
    eng = FedEngine(g, fed, method, mesh=mesh, device=device, selector=sel, **kw)
    params = spec.get("params")
    if params is not None:
        params = {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}
    draws = spec.get("draws")
    state = eng.init_state(params=params, draws=None if draws is None else
                           RecordedDraws(draws, eng.device))
    m = eng.clients_per_round
    eligibility = {"fused": eng.fused_eligibility(state),
                   "sharded": eng.sharded_eligibility(m),
                   "pod_sharded": eng.pod_sharded_eligibility(m)}
    result = None
    if spec.get("chunks") is None:
        result = eng.run(state)
    else:
        for t0, n in spec["chunks"]:
            eng._run_chunk(state, t0, n)
    tables = (state.hist.hist1, state.hist.age, state.hist.ghost_feat, state.prev_loss)
    if state.pod_shard is not None:
        tables = gather_tables(tables, mesh, fed.n_clients)
    rounds = next(iter(eng._sharded.values())).round_log if eng._sharded else []
    return {
        "eligibility": eligibility,
        "history": None if result is None else result.history,
        "final": None if result is None else result.final,
        "executor": eng.last_executor, "cohorts": sel.cohorts,
        "fault_events": state.fault_events.snapshot(),
        "params": {k: v.detach().cpu().numpy() for k, v in state.params.items()},
        "tables": [t.cpu().numpy() for t in tables], "round_log": rounds,
    }
