"""The fused executor: a round as one body over static buffers, replayed.

Port of the reference's fused executor (``repro/api/engine.py``:
``_build_fused_chunk`` and the non-mesh branches of ``_run_chunk``). The
reference scans the rounds of a chunk in one jitted call whose big buffers
are donated. Here one round is one body over static buffers: the params,
the ``hist1`` / ``age`` / ``ghost_feat`` / ``prev_loss`` tables and the
client arrays of the run's ``EngineState``, and per cohort size the cohort
ids, the weights, the drop and corruption multipliers and a light-stats
buffer. The body runs the cohort's LocalUpdate (``core.fedais``), the
aggregation (the aggregator's, or under a fault plan the masked merge of
``faults.fused``) and the write-back, and ends by copying the new params
and rows into those same buffers, so nothing is reallocated per round.

On CUDA the body is captured into a ``torch.cuda.CUDAGraph`` once per graph
key and replayed each round. The key is what the body bakes in from the
host: the cohort size, the fanouts and the round's sync gates (the epochs
``(epoch_offset + j) % tau == 0`` that pull ghosts). The first round of a
key runs the body eagerly: it is a real round, and it loads every kernel
instance and library handle the capture then meets. The capture itself
runs nothing, so it leaves the tables, the params and the draw generator
as they were; the generator of the run's ``TorchDraws`` is registered with
every graph, so a replay draws what an eager round would. All graphs share
one memory pool (they never run at once) and keep nothing of it between
replays: every output is copied into a buffer made outside the capture.
The SpMM and ghost pull launches recorded while capturing are added to
``block_spmm.launches`` and ``ghost_pull.launches`` on each replay (the
SpMM's sparse-route launches also to ``block_spmm.sparse_launches``). A failed
capture or replay raises.

With ``repro_torch.utils.spans`` on, the executor opens the spans
``fedais.chunk.stage``, ``.rounds`` (around the chunk's rounds, with
``.replay``, ``.eager_round`` and ``.capture`` inside) and ``.readback``
(with ``.read_phases`` inside), and opens a phase scope around each round,
so that the device phases of the body (``table_traffic``, ``merge`` here
and the LocalUpdate's in ``core.fedais``) are recorded: on CUDA a boundary
is a stamp kernel's node in the graph, and a captured key keeps the marks
its nodes rewrite on every replay. After the chunk's readback each key
replayed in the chunk adds its last replay's phases times its replays in
the chunk (an eager round, every round on the CPU, adds its own).
Switching the spans on or off drops the graphs, so that a graph carries
phase boundaries exactly while the spans are on.

On the CPU the body runs eagerly every round: the same code the card
captures. A chunk's cohorts, weights and fault multipliers reach the
device in one copy each, and before each round the static inputs are
filled from them with ``copy_`` on the device; after it the round's light
stats are copied on the device into the chunk's (rounds, ...) buffer,
which the host reads once per chunk.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fedais import TorchDraws, sync_gates
from repro_torch.faults.fused import build_faulty_merge
from repro_torch.federated.quant import quant_roundtrip
from repro_torch.kernels.ghost_pull.ops import ghost_pull
from repro_torch.kernels.spmm.ops import block_spmm
from repro_torch.sharding import comm
from repro_torch.utils import spans
from repro_torch.utils.spans import device_phase, span

# Per-round stats streamed out of a fused round: everything but the
# (m, n_max) loss_all table, which the write-back puts into prev_loss, and
# n_sync, which the round's sync gates give on the host. Each is (m, width)
# in the round's light buffer, followed by the round's n_quarantined.
LIGHT_STATS = ("epoch_losses", "n_ghost_pulled", "mean_importance_entropy")


class FusedRounds:
    """The fused rounds of one engine (``FedEngine._fused``), bound to the
    ``EngineState`` of its current run. ``captures`` lists, per graph key
    captured, its key, the seconds the capture took and the SpMM and ghost
    pull launches (and collectives) it recorded."""

    # no other thread touches the card while a fused round is captured
    capture_error_mode = "global"
    # the rounds open a phase scope (the sharded executors' do not)
    phased = True

    def __init__(self, engine):
        self.engine = engine
        self.faulty = engine._faults_active
        if self.faulty:
            g = engine._guard
            self._merge = build_faulty_merge(
                uses_weights=getattr(engine.aggregator, "uses_weights", False),
                finite_guard=g is not None, max_norm=None if g is None else g.max_norm,
                sync_dtype=engine.sync_dtype)
        self._state = self._draws = None
        self._graphed = engine.device.type == "cuda"
        # graph key -> (CUDA graph, SpMM launches (all, sparse route), ghost
        # pull launches and collectives captured)
        self._graphs: dict = {}
        self._inputs: dict = {}      # cohort size -> static input buffers
        self._pool = None
        self.captures: list = []
        self._marks: dict = {}       # graph key -> its phase boundaries
        self._spanned = False        # whether the graphs carry phase boundaries

    # -- binding ------------------------------------------------------------

    def _bind(self, state) -> None:
        """Make ``state``'s params and tables the buffers the rounds read and
        write. A new state (a new run) drops every graph, and so does a new
        draw provider (the graphs replay the old one's generator); a table
        or params dict that something rebound between chunks is copied back
        into the buffer the graphs hold. Switching the spans on or off drops
        the graphs too, so that a graph carries phase boundaries exactly
        while the spans are on."""
        new_state = state is not self._state
        if new_state:
            self._state = state
            self._inputs = {}
            self._params = {k: v.detach().clone() for k, v in state.params.items()}
            self._tables = (state.hist.hist1, state.hist.age, state.hist.ghost_feat,
                            state.prev_loss)
        spanned = self.phased and spans.enabled()
        if new_state or state.draws is not self._draws or spanned != self._spanned:
            self._draws, self._spanned = state.draws, spanned
            self._graphs = {}
            self._marks = {}
            self._pool = None
        if self.engine.device.type == "cuda" and not isinstance(state.draws, TorchDraws):
            raise ValueError(f"the fused executor on CUDA replays a TorchDraws generator; "
                             f"got {type(state.draws).__name__} (fused_eligibility)")
        for k, buf in self._params.items():
            if state.params[k] is not buf:
                buf.copy_(state.params[k])
        state.params = self._params
        now = (state.hist.hist1, state.hist.age, state.hist.ghost_feat, state.prev_loss)
        for buf, cur in zip(self._tables, now):
            if cur is not buf:
                buf.copy_(cur)
        hist1, age, ghost_feat, prev_loss = self._tables
        state.hist = state.hist._replace(hist1=hist1, age=age, ghost_feat=ghost_feat)
        state.prev_loss = prev_loss

    def _static_inputs(self, m: int) -> dict:
        if m not in self._inputs:
            eng, dev = self.engine, self.engine.device
            J = eng.mcfg.local_epochs
            self._inputs[m] = {
                "rows": torch.zeros(m, dtype=torch.long, device=dev),
                "weights": torch.zeros(m, dtype=torch.float32, device=dev),
                "keep": torch.ones(m, dtype=torch.float32, device=dev),
                "cmult": torch.ones(m, dtype=torch.float32, device=dev),
                "light": torch.zeros(m * J + 2 * m + 1, dtype=torch.float32, device=dev),
            }
        return self._inputs[m]

    # -- the round body -------------------------------------------------------

    def _body(self, m: int, tau: int, eoff: int, fanouts) -> None:
        """One round over the static buffers (``dispatch`` + the server half
        of ``merge``, as the stepwise executor runs them)."""
        eng, state = self.engine, self._state
        inp = self._inputs[m]
        rows = inp["rows"]
        hist1, age, ghost_feat, prev_loss = self._tables
        with device_phase("table_traffic"):
            clients = {k: v[rows] for k, v in state.arrays.items()}
            cohort_rows = (hist1[rows], age[rows], ghost_feat[rows], prev_loss[rows])
        out = eng._cohort(self._params, clients, state.arrays["features"], hist1,
                          *cohort_rows, tau, fanouts, eoff, state.draws.clients(m))
        stats = out[4]
        if self.faulty:
            with device_phase("merge"):
                merged, n_quar = self._merge(self._params, rows, out, self._tables,
                                             inp["weights"], inp["keep"], inp["cmult"])
        else:
            new_params, new_hist1, new_age, new_ghost_feat, _ = out
            with device_phase("merge"):
                merged = eng.aggregator.aggregate(new_params, inp["weights"])
                n_quar = torch.zeros((), device=rows.device)
            with device_phase("table_traffic"):
                loss_all = stats["loss_all"]
                if eng.sync_dtype != "fp32":
                    new_hist1 = quant_roundtrip(new_hist1, eng.sync_dtype)
                    new_ghost_feat = quant_roundtrip(new_ghost_feat, eng.sync_dtype)
                    loss_all = quant_roundtrip(loss_all, eng.sync_dtype)
                hist1[rows] = new_hist1
                age[rows] = new_age
                ghost_feat[rows] = new_ghost_feat
                prev_loss[rows] = loss_all
        with device_phase("merge"):
            for k, buf in self._params.items():
                buf.copy_(merged[k])
            inp["light"].copy_(torch.cat([stats[k].reshape(-1) for k in LIGHT_STATS]
                                         + [n_quar.reshape(1).to(torch.float32)]))

    def _round(self, m: int, tau: int, eoff: int, fanouts) -> None:
        """Run one round: eagerly on the CPU and for a graph key's first
        round (which then captures the key), else by replay."""
        key = (m, tuple(int(f) for f in fanouts), sync_gates(self.engine.mcfg, tau, eoff))
        self._keyed(key, lambda: self._body(m, tau, eoff, fanouts))

    def _keyed(self, key, body) -> None:
        if self._graphed and key in self._graphs:
            graph, (launches, sparse), pulls, collectives = self._graphs[key]
            marks = self._marks.get(key)
            with span("fedais.chunk.replay"), spans.phase_scope(marks):
                graph.replay()
            block_spmm.launches += launches
            block_spmm.sparse_launches += sparse
            ghost_pull.launches += pulls
            comm.add(collectives)
            spans.count("replays", key=key)
            if marks is not None:
                self._replayed[key] = self._replayed.get(key, 0) + 1
            return
        marks = self._new_marks()
        with span("fedais.chunk.eager_round"), spans.phase_scope(marks):
            body()
        spans.count("eager_rounds", key=key)
        if marks is not None:
            self._pending.append(marks)
        if self._graphed:
            self._capture(key, body, None if marks is None else marks.n)

    def _new_marks(self, slots: int = spans.STAMP_SLOTS) -> spans.Marks | None:
        """Marks for a round's phase boundaries (None where no phase is
        recorded)."""
        return spans.new_marks(self.engine.device, slots) if self.phased else None

    def _capture(self, key, body, slots: int | None = None) -> None:
        """Record ``body`` into a new graph of the shared pool, with the
        draws' generator registered, and the SpMM and ghost pull launches
        and collectives it recorded (and, with the spans on, its phase boundaries: the
        ``slots`` its eager round wrote)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._state.draws.gen)
        before, pulls_before = block_spmm.captured, ghost_pull.captured
        sparse_before = block_spmm.sparse_captured
        comm_before = comm.snapshot(comm.CAPTURED)
        marks = None if slots is None else self._new_marks(slots)
        with span("fedais.chunk.capture", timed=True) as clock:
            # the scope's last stamp goes into the graph too
            with torch.cuda.graph(graph, pool=self._pool,
                                  capture_error_mode=self.capture_error_mode), \
                    spans.phase_scope(marks):
                body()
            torch.cuda.synchronize()
        seconds = clock.seconds
        spans.count("captures")
        if marks is not None:
            self._marks[key] = marks
        if self._pool is None:
            self._pool = graph.pool()
        launches = block_spmm.captured - before
        sparse = block_spmm.sparse_captured - sparse_before
        pulls = ghost_pull.captured - pulls_before
        collectives = comm.diff(comm.snapshot(comm.CAPTURED), comm_before)
        self._graphs[key] = (graph, (launches, sparse), pulls, collectives)
        record = [list(k) if isinstance(k, tuple) else k for k in key]
        self.captures.append({"key": record, "seconds": seconds, "spmm_launches": launches,
                              "spmm_sparse_launches": sparse,
                              "ghost_pull_launches": pulls,
                              "collectives": {k: list(v) for k, v in collectives.items()}})

    # -- a chunk ------------------------------------------------------------

    def run_chunk(self, state, sels, fans, eoffs, drop_stack=None, cmask_stack=None) -> dict:
        """Rounds ``sels`` (one cohort each, all of one size) with their
        fanouts and epoch offsets; under a fault plan ``drop_stack`` and
        ``cmask_stack`` are the (rounds, m) drop and corruption masks.
        Returns the rounds' light stats as host arrays with a leading
        rounds axis (``n_quarantined`` too under a plan), read in one copy."""
        eng = self.engine
        m, n = len(sels[0]), len(sels)
        J = eng.mcfg.local_epochs
        with span("fedais.chunk.stage"):
            self._bind(state)
            # the marks of the chunk's eager rounds; replays per graph key
            self._pending, self._replayed = [], {}
            inp = self._static_inputs(m)
            # the chunk's inputs reach the device in one copy each; each
            # round then fills its static inputs from them on the device
            sel_stack = np.stack([np.asarray(s, np.int64) for s in sels])
            per_round = {"rows": sel_stack,
                         "weights": eng.fed.client_sizes[sel_stack].astype(np.float32)}
            if self.faulty:
                cmult = np.ones((n, m), np.float32)
                cmult[cmask_stack] = eng.faults.corrupt_value()
                per_round["keep"] = (~drop_stack).astype(np.float32)
                per_round["cmult"] = cmult
            per_round = {k: torch.from_numpy(v).to(eng.device) for k, v in per_round.items()}
            light = torch.empty((n, inp["light"].numel()), dtype=torch.float32,
                                device=eng.device)
            n_sync = np.zeros((n, m), np.int32)
        with span("fedais.chunk.rounds"):
            for i in range(n):
                for k, v in per_round.items():
                    inp[k].copy_(v[i])
                self._round(m, state.tau, int(eoffs[i]), fans[i])
                light[i].copy_(inp["light"])
                n_sync[i] = sum(sync_gates(eng.mcfg, state.tau, int(eoffs[i])))
        with span("fedais.chunk.readback"):
            host = light.cpu().numpy()
            out, at = {"n_sync": n_sync}, 0
            for k, tail in zip(LIGHT_STATS, ((J,), (), ())):
                width = m * int(np.prod(tail))
                out[k] = host[:, at:at + width].reshape((n, m) + tail)
                at += width
            if self.faulty:
                out["n_quarantined"] = host[:, -1].astype(np.int64)
            if self._pending or self._replayed:
                with span("fedais.chunk.read_phases"):
                    for marks in self._pending:
                        spans.read_phases(marks)
                    for key, replays in self._replayed.items():
                        spans.read_phases(self._marks[key], replays)
        return out


class ShardedRounds(FusedRounds):
    """The sharded rounds of one engine on its mesh: client-sharded
    (``pods=False``, executor ``"sharded_fused"``, ``sharding.fed``) or
    pod-sharded (``pods=True``, ``"pod_sharded"``, ``sharding.tables``).

    The same machinery as the fused rounds: static buffers bound to the
    run's ``EngineState``, one round a body over them, on the card a CUDA
    graph per key (the collectives captured inside it, NCCL's communicators
    made by an eager collective on each group first), on the CPU the body
    eagerly over gloo. The key adds the padded cohort size, and for pods
    the write-back's bucket capacity; a round whose sync gate is off has
    its own key, whose graph holds no ghost exchange. Captures run in
    ``thread_local`` mode: NCCL's watchdog thread polls its events while a
    graph is captured.

    The client-sharded tables are the state's K-row tables with one
    scratch row (the dummies' write-back); the pod-sharded ones are this
    rank's pod shards (``rows_per_pod`` rows), and the state then holds
    those shards (``EngineState.pod_shard``;
    ``sharding.tables.gather_tables`` gives the K-row tables back).
    ``round_log`` lists per round its sync gate, its write-back capacity
    (pods) and its collectives, ``{tag: (calls, bytes)}``, replays
    counted."""

    capture_error_mode = "thread_local"
    phased = False

    def __init__(self, engine, *, pods: bool):
        import torch.distributed as dist

        from repro_torch.sharding.fed import axis_index, axis_size
        from repro_torch.sharding.tables import POD_AXIS

        self.engine, self.pods, self.faulty = engine, pods, False
        self._state = self._draws = None
        self._graphed = engine.device.type == "cuda"
        self._graphs, self._inputs, self._pool, self._marks = {}, {}, None, {}
        self.captures: list = []
        self.round_log: list = []
        mesh = engine.mesh
        if pods:
            P, C = axis_size(mesh, POD_AXIS), axis_size(mesh, "clients")
            self.n_shards = P * C
            self.shard = axis_index(mesh, POD_AXIS) * C + axis_index(mesh, "clients")
            self.group = dist.group.WORLD
            groups = (self.group, mesh.get_group(POD_AXIS), mesh.get_group("clients"))
        else:
            axis = engine.client_axis
            self.n_shards, self.shard = axis_size(mesh, axis), axis_index(mesh, axis)
            self.group = mesh.get_group(axis)
            groups = (self.group,)
        self._body_fn = None
        if engine.device.type == "cuda":
            # NCCL makes a communicator at a group's first collective, which
            # a graph capture cannot hold: one eager collective per group
            for g in groups:
                dist.all_reduce(torch.zeros(1, device=engine.device), group=g)
            torch.cuda.synchronize()

    # -- binding ------------------------------------------------------------

    def _bind(self, state) -> None:
        """Make ``state``'s params and tables the rounds' buffers: the
        client-sharded executor's K-row tables gain a scratch row, the
        pod-sharded executor's become this rank's pod shards. A rebound
        table is copied back into its buffer."""
        eng = self.engine
        if eng.device.type == "cuda" and not isinstance(state.draws, TorchDraws):
            raise ValueError(f"the sharded executors on CUDA replay a TorchDraws generator; "
                             f"got {type(state.draws).__name__} (fused_eligibility)")
        new_state = state is not self._state
        if new_state or state.draws is not self._draws:
            self._graphs, self._pool, self._draws = {}, None, state.draws
        now = (state.hist.hist1, state.hist.age, state.hist.ghost_feat, state.prev_loss)
        if new_state:
            self._state, self._inputs = state, {}
            self._params = {k: v.detach().clone() for k, v in state.params.items()}
            if self.pods:
                if state.pod_shard is not None:
                    raise ValueError("the state's tables are pod shards of another run")
                self._tables = self._views = tuple(self._shard(now))
            else:
                self._tables = tuple(torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])
                                     for t in now)
                self._views = tuple(t[:-1] for t in self._tables)
        else:
            for view, cur in zip(self._views, now):
                if cur is not view:
                    view.copy_(cur)
        for k, buf in self._params.items():
            if state.params[k] is not buf:
                buf.copy_(state.params[k])
        state.params = self._params
        hist1, age, ghost_feat, prev_loss = self._views
        state.hist = state.hist._replace(hist1=hist1, age=age, ghost_feat=ghost_feat)
        state.prev_loss = prev_loss
        if self.pods:
            state.pod_shard = self._pod_shard

    def _shard(self, tables):
        """This rank's pod shards of the K-row tables, and the engine's pod
        statics (the ``POD_ARRAY_KEYS`` arrays and the ghost-source
        features, from the bucketed owner exchange)."""
        from repro_torch.federated.partition import (
            exchange_ghost_features,
            ghost_exchange_buckets,
        )
        from repro_torch.sharding.fed import axis_index, axis_size
        from repro_torch.sharding.tables import (
            POD_ARRAY_KEYS,
            POD_AXIS,
            build_pod_sharded_chunk,
            pad_tables_to_pods,
            shard_tables_to_mesh,
        )

        eng, fed, mesh, dev = self.engine, self.engine.fed, self.engine.mesh, self.engine.device
        P = axis_size(mesh, POD_AXIS)
        self.buckets = ghost_exchange_buckets(fed.ghost_owner, fed.ghost_row, fed.ghost_mask, P)
        host = pad_tables_to_pods({k: torch.from_numpy(np.asarray(getattr(fed, k)))
                                   for k in POD_ARRAY_KEYS}, P)
        host["gsrc"] = torch.from_numpy(exchange_ghost_features(self.buckets, fed.features,
                                                                dtype=eng.sync_dtype))
        statics = {k: v.to(dev) for k, v in shard_tables_to_mesh(host, mesh).items()}
        self._gsrc = statics.pop("gsrc")
        self._statics = statics
        self._pod_shard = (P, axis_index(mesh, POD_AXIS), self.buckets.rows_per_pod,
                           fed.n_clients)
        self._body_fn = build_pod_sharded_chunk(
            eng._prefetched_cohort(), mesh, self.buckets, reduce=eng.merge_reduce,
            sync_dtype=eng.sync_dtype, device=dev)
        return shard_tables_to_mesh(pad_tables_to_pods(tuple(tables), P), mesh)

    def _client_body(self):
        if self._body_fn is None:
            from repro_torch.sharding.fed import build_sharded_chunk

            eng = self.engine
            self._body_fn = build_sharded_chunk(eng._cohort, eng.mesh, eng.client_axis,
                                                reduce=eng.merge_reduce,
                                                sync_dtype=eng.sync_dtype)
        return self._body_fn

    # -- a chunk ------------------------------------------------------------

    def _host_inputs(self, sel: np.ndarray, w: np.ndarray) -> tuple[dict, int | None]:
        """The (rounds, ...) static inputs of a chunk's padded cohorts on
        the host, and the write-back's bucket capacity (pods)."""
        from repro_torch.sharding.fed import axis_index, axis_size, client_round_inputs
        from repro_torch.sharding.tables import pod_round_inputs

        eng = self.engine
        if not self.pods:
            return client_round_inputs(sel, w, n_shards=self.n_shards, shard=self.shard,
                                       n_clients=eng.fed.n_clients), None
        P, p, rpp, _ = self._pod_shard
        return pod_round_inputs(sel, w, n_pods=P, n_client_shards=axis_size(eng.mesh, "clients"),
                                pod=p, client=axis_index(eng.mesh, "clients"),
                                rows_per_pod=rpp)

    def run_chunk(self, state, sels, fans, eoffs, drop_stack=None, cmask_stack=None) -> dict:
        """The client-sharded or pod-sharded rounds of a chunk (see
        ``FusedRounds.run_chunk``). Under a fault plan (dropout and
        stragglers only) the dropped members become dummies of weight 0
        whose write-back lands nowhere; the light stats of every member
        arrive in one all-gather per chunk (``light_stats_gather``)."""
        from repro_torch.sharding.fed import cohort_padding, slice_streams
        from repro_torch.sharding.tables import sync_round_gates

        self._bind(state)
        eng, dev = self.engine, self.engine.device
        mcfg, fed = eng.mcfg, eng.fed
        J, m, n = mcfg.local_epochs, len(sels[0]), len(sels)
        dummy = self._pod_shard[0] * self._pod_shard[2] if self.pods else fed.n_clients
        sel = np.stack([np.asarray(s, np.int64) for s in sels])
        w = eng._cohort_weights(sel)
        if drop_stack is not None and drop_stack.any():
            w[drop_stack] = 0.0
            sel[drop_stack] = dummy
        pad = cohort_padding(m, self.n_shards)
        fan = np.stack([np.asarray(f, np.int64) for f in fans])
        if pad:
            sel = np.pad(sel, ((0, 0), (0, pad)), constant_values=dummy)
            fan = np.pad(fan, ((0, 0), (0, pad)), mode="edge")
            w = np.pad(w, ((0, 0), (0, pad)))
        m_pad = m + pad
        mL = m_pad // self.n_shards
        lo = self.shard * mL
        host, cap = self._host_inputs(sel, w)
        per_round = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in host.items()}
        key_in = (m_pad, cap)
        if key_in not in self._inputs:
            self._inputs[key_in] = {k: torch.empty_like(v[0]) for k, v in per_round.items()}
            self._inputs[key_in]["light"] = torch.zeros(mL * (J + 2), dtype=torch.float32,
                                                        device=dev)
        inp = self._inputs[key_in]
        batch_shape = None if mcfg.use_all_samples else (fed.n_max,)
        fanout_shape = (fed.n_max if mcfg.use_all_samples else eng.bsz, fed.max_deg)
        gates = sync_round_gates(eoffs, state.tau, J,
                                 enabled=mcfg.use_ghosts and not mcfg.use_generator)
        light = torch.empty((n, inp["light"].numel()), dtype=torch.float32, device=dev)
        n_sync = np.zeros((n, m), np.int32)
        for i in range(n):
            for k, v in per_round.items():
                inp[k].copy_(v[i])
            tau, eoff, fan_l = state.tau, int(eoffs[i]), fan[i, lo:lo + mL]
            gate = bool(gates[i])

            def body():
                streams = slice_streams(state.draws, m, lo, lo + mL, local_epochs=J,
                                        batch_shape=batch_shape, fanout_shape=fanout_shape,
                                        device=dev)
                if self.pods:
                    stats = self._body_fn(self._params, self._tables, self._statics,
                                          self._gsrc, inp, tau, fan_l, eoff, streams, gate)
                else:
                    stats = self._client_body()(self._params, self._tables, state.arrays,
                                                inp, tau, fan_l, eoff, streams)
                inp["light"].copy_(torch.cat([stats[k].reshape(-1) for k in LIGHT_STATS]))

            before = comm.snapshot()
            key = (m, m_pad, tuple(int(f) for f in fan[i]),
                   sync_gates(mcfg, tau, eoff), cap)
            self._keyed(key, body)
            self.round_log.append({"gate": gate, "cap": cap,
                                   "collectives": comm.diff(comm.snapshot(), before)})
            light[i].copy_(inp["light"])
            n_sync[i] = sum(sync_gates(mcfg, tau, eoff))
        # (shards, rounds, mL * (J + 2)) -> each round's stats of the padded
        # cohort in shard order -> the real cohort's
        every = comm.all_gather(light, self.group, "light_stats_gather").cpu().numpy()
        every = every.reshape(self.n_shards, n, -1)
        out, at = {"n_sync": n_sync}, 0
        for k, tail in zip(LIGHT_STATS, ((J,), (), ())):
            width = mL * int(np.prod(tail))
            part = every[:, :, at:at + width].reshape((self.n_shards, n, mL) + tail)
            out[k] = np.concatenate(list(part), axis=1)[:, :m]
            at += width
        return out
