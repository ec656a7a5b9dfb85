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
The SpMM launches recorded while capturing are added to
``block_spmm.launches`` on each replay. A failed capture or replay raises.

On the CPU the body runs eagerly every round: the same code the card
captures. A chunk's cohorts, weights and fault multipliers reach the
device in one copy each, and before each round the static inputs are
filled from them with ``copy_`` on the device; after it the round's light
stats are copied on the device into the chunk's (rounds, ...) buffer,
which the host reads once per chunk.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.core.fedais import TorchDraws, sync_gates
from repro_torch.faults.fused import build_faulty_merge
from repro_torch.federated.quant import quant_roundtrip
from repro_torch.kernels.spmm.ops import block_spmm

# Per-round stats streamed out of a fused round: everything but the
# (m, n_max) loss_all table, which the write-back puts into prev_loss, and
# n_sync, which the round's sync gates give on the host. Each is (m, width)
# in the round's light buffer, followed by the round's n_quarantined.
LIGHT_STATS = ("epoch_losses", "n_ghost_pulled", "mean_importance_entropy")


class FusedRounds:
    """The fused rounds of one engine (``FedEngine._fused``), bound to the
    ``EngineState`` of its current run. ``captures`` lists, per graph key
    captured, its key, the seconds the capture took and the SpMM launches
    it recorded."""

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
        self._graphs: dict = {}      # graph key -> (CUDA graph, SpMM launches captured)
        self._inputs: dict = {}      # cohort size -> static input buffers
        self._pool = None
        self.captures: list = []

    # -- binding ------------------------------------------------------------

    def _bind(self, state) -> None:
        """Make ``state``'s params and tables the buffers the rounds read and
        write. A new state (a new run) drops every graph, and so does a new
        draw provider (the graphs replay the old one's generator); a table
        or params dict that something rebound between chunks is copied back
        into the buffer the graphs hold."""
        new_state = state is not self._state
        if new_state:
            self._state = state
            self._inputs = {}
            self._params = {k: v.detach().clone() for k, v in state.params.items()}
            self._tables = (state.hist.hist1, state.hist.age, state.hist.ghost_feat,
                            state.prev_loss)
        if new_state or state.draws is not self._draws:
            self._draws = state.draws
            self._graphs = {}
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
        out = eng._cohort(
            self._params, {k: v[rows] for k, v in state.arrays.items()},
            state.arrays["features"], hist1, hist1[rows], age[rows], ghost_feat[rows],
            prev_loss[rows], tau, fanouts, eoff, state.draws.clients(m))
        stats = out[4]
        if self.faulty:
            merged, n_quar = self._merge(self._params, rows, out, self._tables,
                                         inp["weights"], inp["keep"], inp["cmult"])
        else:
            new_params, new_hist1, new_age, new_ghost_feat, _ = out
            merged = eng.aggregator.aggregate(new_params, inp["weights"])
            loss_all = stats["loss_all"]
            if eng.sync_dtype != "fp32":
                new_hist1 = quant_roundtrip(new_hist1, eng.sync_dtype)
                new_ghost_feat = quant_roundtrip(new_ghost_feat, eng.sync_dtype)
                loss_all = quant_roundtrip(loss_all, eng.sync_dtype)
            hist1[rows] = new_hist1
            age[rows] = new_age
            ghost_feat[rows] = new_ghost_feat
            prev_loss[rows] = loss_all
            n_quar = torch.zeros((), device=rows.device)
        for k, buf in self._params.items():
            buf.copy_(merged[k])
        inp["light"].copy_(torch.cat([stats[k].reshape(-1) for k in LIGHT_STATS]
                                     + [n_quar.reshape(1).to(torch.float32)]))

    def _round(self, m: int, tau: int, eoff: int, fanouts) -> None:
        """Run one round: eagerly on the CPU and for a graph key's first
        round (which then captures the key), else by replay."""
        if self.engine.device.type != "cuda":
            self._body(m, tau, eoff, fanouts)
            return
        gates = sync_gates(self.engine.mcfg, tau, eoff)
        key = (m, tuple(int(f) for f in fanouts), gates)
        if key in self._graphs:
            graph, launches = self._graphs[key]
            graph.replay()
            block_spmm.launches += launches
            return
        self._body(m, tau, eoff, fanouts)
        self._capture(key, m, tau, eoff, fanouts)

    def _capture(self, key, m: int, tau: int, eoff: int, fanouts) -> None:
        """Record the body into a new graph of the shared pool, with the
        draws' generator registered and the SpMM launches it recorded."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._state.draws.gen)
        before = block_spmm.captured
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool):
            self._body(m, tau, eoff, fanouts)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if self._pool is None:
            self._pool = graph.pool()
        launches = block_spmm.captured - before
        self._graphs[key] = (graph, launches)
        self.captures.append({"key": [m, list(key[1]), list(key[2])], "seconds": seconds,
                              "spmm_launches": launches})

    # -- a chunk ------------------------------------------------------------

    def run_chunk(self, state, sels, fans, eoffs, drop_stack=None, cmask_stack=None) -> dict:
        """Rounds ``sels`` (one cohort each, all of one size) with their
        fanouts and epoch offsets; under a fault plan ``drop_stack`` and
        ``cmask_stack`` are the (rounds, m) drop and corruption masks.
        Returns the rounds' light stats as host arrays with a leading
        rounds axis (``n_quarantined`` too under a plan), read in one copy."""
        self._bind(state)
        eng = self.engine
        m, n = len(sels[0]), len(sels)
        J = eng.mcfg.local_epochs
        inp = self._static_inputs(m)
        # the chunk's inputs reach the device in one copy each; each round
        # then fills its static inputs from them on the device
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
        for i in range(n):
            for k, v in per_round.items():
                inp[k].copy_(v[i])
            self._round(m, state.tau, int(eoffs[i]), fans[i])
            light[i].copy_(inp["light"])
            n_sync[i] = sum(sync_gates(eng.mcfg, state.tau, int(eoffs[i])))
        host = light.cpu().numpy()
        out, at = {"n_sync": n_sync}, 0
        for k, tail in zip(LIGHT_STATS, ((J,), (), ())):
            width = m * int(np.prod(tail))
            out[k] = host[:, at:at + width].reshape((n, m) + tail)
            at += width
        if self.faulty:
            out["n_quarantined"] = host[:, -1].astype(np.int64)
        return out
