"""The default RoundCallback stack: server eval + adaptive tau, history
recording, verbose logging, early stop.

A copy of ``repro/api/callbacks.py``; ``EvalCallback`` runs the port's
``evaluate_global`` on the engine's ``eval_backend``.

Callbacks run in list order after each round's merge + cost accounting; a
callback that sets ``ctx.stop = True`` ends the run after the round.
EvalCallback must precede the callbacks that consume ``ctx.metrics``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.federated.server import evaluate_global
from repro_torch.utils import spans
from repro_torch.utils.spans import span

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.api.engine import EngineState, FedEngine


@dataclass
class RoundContext:
    """What a callback sees at a round boundary."""

    engine: "FedEngine"
    state: "EngineState"
    t: int                          # round index
    rounds: int                     # total planned rounds
    metrics: Optional[dict] = None  # server eval (set by EvalCallback)
    stop: bool = False              # set True to end the run
    # async-scheduler extras (None under the lockstep SyncScheduler):
    virtual_time: Optional[float] = None       # server virtual clock at merge
    staleness: Optional[np.ndarray] = None     # per-merged-update staleness τ


class BaseCallback:
    """No-op base; subclass and override what you need."""

    def on_run_start(self, engine, state):
        pass

    def on_round_end(self, ctx: RoundContext):
        pass

    def on_run_end(self, engine, state):
        pass


class EvalCallback(BaseCallback):
    """Server-side test eval every ``eval_every`` rounds (and on the last
    round), followed by the SyncController tau update (Algorithm 1 line 8)."""

    def __init__(self, eval_every: int = 1):
        self.eval_every = eval_every

    def on_round_end(self, ctx):
        if ctx.t % self.eval_every == 0 or ctx.t == ctx.rounds - 1:
            st, eng = ctx.state, ctx.engine
            with span("fedais.eval", device_allocs=True):
                ev = evaluate_global(st.params, eng.eval_graph, "test")
                with span("fedais.eval.metrics"):
                    if st.initial_loss is None:
                        st.initial_loss = max(ev["loss"], 1e-6)
                    st.tau = eng.sync.update(eng.mcfg, ev["loss"], st.initial_loss)
            spans.count("evals")
            ctx.metrics = ev
            st.last_eval = (ctx.t, ev)   # lets FedEngine.run skip a re-eval


class HistoryCallback(BaseCallback):
    """Append the per-round (acc, loss, tau, cumulative cost) history rows;
    under an async scheduler also the virtual-clock/staleness columns."""

    def on_round_end(self, ctx):
        if ctx.metrics is None:
            return
        st, ev = ctx.state, ctx.metrics
        st.result.record(
            round=ctx.t, test_acc=ev["acc"], test_loss=ev["loss"], f1=ev["f1"],
            auc=ev["auc"], tau=st.tau,
            comm_total=st.result.costs.comm_total_bytes,
            comm_embed=st.result.costs.comm_embed_bytes,
            flops=st.result.costs.compute_flops,
            wall_clock=st.result.costs.wall_clock_s,
        )
        if ctx.staleness is not None:
            st.result.record(
                virtual_time=ctx.virtual_time,
                staleness_mean=float(np.mean(ctx.staleness)),
                staleness_max=int(np.max(ctx.staleness)),
                merged=len(ctx.staleness),
            )


class VerboseCallback(BaseCallback):
    """Legacy ``verbose=True`` one-liner per evaluated round."""

    def on_round_end(self, ctx):
        if ctx.metrics is None:
            return
        st, ev = ctx.state, ctx.metrics
        print(f"[{ctx.engine.mcfg.name}] round {ctx.t:3d} acc={ev['acc']:.4f} "
              f"loss={ev['loss']:.4f} tau={st.tau} "
              f"comm={st.result.costs.comm_total_bytes/1e6:.1f}MB")


class EarlyStopCallback(BaseCallback):
    """Stop once test accuracy first reaches ``target_acc``."""

    def __init__(self, target_acc: float):
        self.target_acc = target_acc

    def on_round_end(self, ctx):
        if ctx.metrics is not None and ctx.metrics["acc"] >= self.target_acc:
            ctx.stop = True


def default_callbacks(*, eval_every: int = 1, verbose: bool = False,
                      target_acc: float | None = None) -> list:
    """The stack reproducing the legacy loop's eval/record/print/stop tail."""
    cbs: list = [EvalCallback(eval_every), HistoryCallback()]
    if verbose:
        cbs.append(VerboseCallback())
    if target_acc is not None:
        cbs.append(EarlyStopCallback(target_acc))
    return cbs
