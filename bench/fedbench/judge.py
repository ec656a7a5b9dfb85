"""The comparison that decides ``correct``.

A run hands the judge what the timed path produced: from set-up, the
params after rounds 0, 1, 2 and 10, the rows of every table that rounds
0-2 wrote for their cohorts, the eval losses at rounds 0 and 10 and the
tau that the eval at round 10 set; from the window, the SpMM launches it
counted; and after it, one more round at the sync interval the window ran
last (its graph key), with the state it started from and its cohort's rows
after it. The reference (``reference.RefRun``, fp32, its own params and
tables from the same initial weights and seed) follows rounds 0-2 and,
from the program's state at the window's end, the round after it (the one
place it starts from the program's state: the eleven and more rounds
between are not followed, and rounds 0-2 check the start). Each member's
batches are drawn from the loss pass the program wrote into ``prev_loss``
(so that rounding in the loss pass cannot move a node across the batch's
boundary and part the exact tables); every such loss pass is held to the
reference's own (``loss_pass``), and the batches the reference's own loss
pass would draw otherwise are counted (``batch_flips``). It evaluates the
program's params at rounds 0 and 10 and at the window's last eval.

The numbers, each against its limit in the cell's limits file:

* ``loss_pass``: worst member of round 0 and of the round after the
  window (the two that start from the program's own params), |mean loss -
  reference's| over the member's nodes, divided by the larger of the
  reference's mean and ln C, the loss of a uniform guess over C classes
  (the GCN forward through the SpMM); ``loss_pass12`` the same of rounds 1
  and 2, where the reference's own params have drifted from the program's
  by rounding;
* ``update`` and ``update_w``: the worst leaf of the change of the params
  in round 0 and in the round after the window, |‖Δprogram‖ -
  ‖Δreference‖| / max(‖Δreference‖, the median leaf's) (the gradients,
  AdamW, FedAvg);
* ``update3``: the median leaf's gap of the change over rounds 0-2. Leaves
  whose first gradient in the reference is under a thousandth of the
  median leaf's are left out of these three;
* ``hist1`` and ``hist1_w``: worst member of round 0 and of the round after
  the window, the gap of the written layer-1 table's norms over the
  reference's (the pushes);
* ``age`` and ``ghost_rows``: entries of the age table and ghost feature
  rows that differ from the reference's, over every compared round
  (exact);
* ``batch_flips``: epochs, over every compared round, whose batch the
  reference's own loss pass would have drawn otherwise;
* ``eval_loss``: worst of the evals at rounds 0 and 10, |program's test
  loss - reference's test loss of the program's params|, over the larger
  of the reference's and ln C; ``eval_loss_w`` the same of the window's
  last eval;
* ``tau``: |tau - Eq. 11 from the reference's test losses| after round 10
  and after the window's last eval, summed;
* ``spmm_launches``: |SpMM launches in the window - rounds x m x (2 + 3J)
  - evals x 2| (every aggregation went through the kernel).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from fedbench import graphgen, reference

NAMES = ("loss_pass", "loss_pass12", "update", "update3", "hist1", "update_w", "hist1_w", "age",
         "ghost_rows", "batch_flips", "eval_loss", "eval_loss_w", "tau", "spmm_launches")


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def digest(g: torch.Tensor) -> torch.Tensor:
    """A per-row checksum of feature rows: their bits, weighted by
    position, summed in int64 (equal rows give equal sums)."""
    bits = g.contiguous().view(torch.int32).to(torch.int64)
    w = torch.arange(1, bits.shape[-1] + 1, device=bits.device, dtype=torch.int64)
    return (bits * w).sum(-1)


def update_gap(prog: list, ref: list, first_grads: dict) -> tuple:
    """Per span of rounds (each round, and all of them), the worst and the
    median leaf's gap of the norms of the params' change; returns (leaves
    kept, {span: {worst, median, leaf}})."""
    med_g = float(np.median(list(first_grads.values())))
    kept = [k for k, v in first_grads.items() if v >= 1e-3 * med_g]
    spans = [(r, r + 1) for r in range(len(prog) - 1)] + [(0, len(prog) - 1)]
    detail = {}
    for a, b in spans:
        dev = ref[b][kept[0]].device
        dref = {k: _norm(ref[b][k].double() - ref[a][k].double()) for k in kept}
        dprog = {k: _norm(prog[b][k].to(dev).double() - prog[a][k].to(dev).double())
                 for k in kept}
        med = float(np.median(list(dref.values())))
        gaps = {k: abs(dprog[k] - dref[k]) / max(dref[k], med, 1e-30) for k in kept}
        gaps = {k: g if math.isfinite(g) else float("inf") for k, g in gaps.items()}
        detail[f"{a}->{b}"] = {"worst": max(gaps.values()),
                               "median": float(np.median(list(gaps.values()))),
                               "leaf": max(gaps, key=gaps.get)}
    return kept, detail


def judge(obs, cfg: dict, device, log) -> dict:
    """The numbers compared, from the observations ``obs`` of a run (the
    program's, or the control's in its place)."""
    graph, part = obs.graph, obs.part
    method = obs.method
    eval_nbrs = graphgen.padded_neighbors(
        graphgen.adjacency_lists(graph["edges"], len(graph["labels"])), part["max_deg"], obs.seed)
    inp = reference.device_inputs(part, graph, eval_nbrs, device)
    params0 = {k: v.to(device) for k, v in obs.params0.items()}
    ref = reference.RefRun(inp, method, params0, obs.seed, device)
    out = {k: 0.0 for k in NAMES}
    scale = math.log(part["n_classes"])
    ref_params = [{k: v.clone() for k, v in ref.params.items()}]
    prev = obs.prev0.to(device)
    tau = method.tau0
    first_grads = None
    loss_gaps: dict = {}
    flips: dict = {}

    def members(key, cohort, snap, ro, hist1_name):
        """The cohort's rows after a round against the reference's."""
        loss_prog = snap["prev_loss"].to(device)
        for i, (k, mo) in enumerate(zip(cohort, ro.members)):
            real = inp["node_mask"][int(k)] > 0
            mp = float(loss_prog[int(k)][real].double().mean())
            mr = float(mo.loss_all[real].double().mean())
            loss_gaps.setdefault(key, []).append(abs(mp - mr) / max(abs(mr), scale))
            if hist1_name:
                hp, hr = _norm(snap["hist1"][i].to(device)), _norm(mo.hist1)
                out[hist1_name] = max(out[hist1_name], abs(hp - hr) / max(hr, 1e-30))
            out["age"] += int((snap["age"][i].to(device) != mo.age).sum())
            out["ghost_rows"] += int((snap["ghost"][i].to(device) != digest(mo.ghost)).sum())
            out["batch_flips"] += mo.diverged_batches
            flips[key] = flips.get(key, 0) + mo.diverged_batches

    for r, cohort in enumerate(obs.cohorts):
        snap = obs.snaps[r]
        loss_prog = snap["prev_loss"].to(device)
        follow = [(loss_prog[int(k)], prev[int(k)]) for k in cohort]
        ro = ref.round(r, cohort, tau, follow=follow)
        if r == 0:
            first_grads = ro.first_grad_norms
            l0_own = ref.eval_loss(ref.params)
            tau = reference.adaptive_tau(l0_own, max(l0_own, 1e-6), method.tau0)
        members(r, cohort, snap, ro, "hist1" if r == 0 else None)
        prev = loss_prog
        ref_params.append({k: v.clone() for k, v in ref.params.items()})
    prog_params = [obs.params0] + [s["params"] for s in obs.snaps]
    kept, detail = update_gap(prog_params, ref_params, first_grads)
    out["update"] = detail["0->1"]["worst"]
    out["update3"] = detail[f"0->{len(prog_params) - 1}"]["median"]
    l0 = ref.eval_loss({k: v.to(device) for k, v in obs.snaps[0]["params"].items()})
    l10 = ref.eval_loss({k: v.to(device) for k, v in obs.params10.items()})
    del ref, ref_params

    # the round after the window, from the state it started from: the
    # window's last eval, its tau, and the graph key the window ran
    w = obs.win
    st = w["start"]
    wparams = {k: v.to(device) for k, v in st["params"].items()}
    wprev = st["prev_loss"].to(device)
    state = {"hist1": st["hist1"].to(device).clone(), "age": st["age"].to(device).clone(),
             "prev_loss": wprev.clone(),
             "ghost": {int(k): st["ghost"][int(k)].to(device) for k in w["cohort"]},
             "gen": st["gen"]}
    wref = reference.RefRun(inp, method, wparams, obs.seed, device, state=state)
    loss_prog = w["snap"]["prev_loss"].to(device)
    ro = wref.round(st["t"], w["cohort"], st["tau"], grads=True,
                    follow=[(loss_prog[int(k)], wprev[int(k)]) for k in w["cohort"]])
    members("window", w["cohort"], w["snap"], ro, "hist1_w")
    _, wdetail = update_gap([wparams, w["snap"]["params"]], [wparams, wref.params],
                            ro.first_grad_norms)
    out["update_w"] = wdetail["0->1"]["worst"]
    lw = wref.eval_loss(wparams)
    rows = torch.as_tensor(np.asarray(w["cohort"]), dtype=torch.long, device=device)
    train = (inp["train_mask"][rows] * inp["node_mask"][rows]) > 0
    zero = float((loss_prog[rows][train] == 0).double().mean())
    del wref, state

    out["loss_pass"] = max(loss_gaps[0] + loss_gaps["window"])
    out["loss_pass12"] = max(loss_gaps[1] + loss_gaps[2])
    out["eval_loss"] = max(abs(obs.hist0["test_loss"] - l0) / max(l0, scale),
                           abs(obs.hist10["test_loss"] - l10) / max(l10, scale))
    out["eval_loss_w"] = abs(w["hist"]["test_loss"] - lw) / max(lw, scale)
    f0 = max(l0, 1e-6)
    out["tau"] = (abs(obs.hist10["tau"] - reference.adaptive_tau(l10, f0, method.tau0))
                  + abs(w["hist"]["tau"] - reference.adaptive_tau(lw, f0, method.tau0)))
    if getattr(obs, "spmm_expected", None) is not None:
        out["spmm_launches"] = abs(obs.spmm_launches - obs.spmm_expected)
    else:
        out.pop("spmm_launches")
    log(f"judge detail: update per span {detail}, window round {wdetail}; loss pass gap per "
        f"round {loss_gaps}; batch flips per round {flips}; share of the round after the "
        f"window's training nodes whose loss is 0 in fp32: {zero}")
    log(f"judge: leaves compared {len(kept)} of {len(first_grads)}; test loss at 0 / 10 / the "
        f"window's last eval: program {obs.hist0['test_loss']} / {obs.hist10['test_loss']} / "
        f"{w['hist']['test_loss']}, reference {l0} / {l10} / {lw}; tau {obs.hist10['tau']} / "
        f"{w['hist']['tau']} (round {st['t']})")
    return out


def control(cfg: dict, traffic: dict, seed: int, device, precision: str, log,
            fault: str | None = None):
    """The control's observations: the reference in ``precision`` (and
    with ``fault`` planted, ``reference.FAULTS``) put in the program's place
    over rounds 0-11 (evals at 0 and 10; round 11 stands for the round after
    the window)."""
    from types import SimpleNamespace

    from fedbench import cell

    graph, part = cell.make_inputs(cfg, traffic)
    method = cell.method_of(cfg)
    eval_nbrs = graphgen.padded_neighbors(
        graphgen.adjacency_lists(graph["edges"], len(graph["labels"])), part["max_deg"], seed)
    inp = reference.device_inputs(part, graph, eval_nbrs, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params0 = reference.init_params(gen, part["features"].shape[2], part["n_classes"], device)
    run = reference.RefRun(inp, method, params0, seed, device, precision=precision, fault=fault)
    e = traffic["eval_every"]
    cohorts = graphgen.select_cohorts(seed, part["n_clients"], traffic["cohort"], e + 2)
    obs = SimpleNamespace(graph=graph, part=part, seed=seed, method=method, cohorts=cohorts[:3],
                          params0={k: v.clone() for k, v in params0.items()},
                          prev0=run.prev_loss.clone(), snaps=[])
    tau, l0 = method.tau0, None
    for r in range(e + 2):
        if r == e + 1:
            obs.params10 = {k: v.clone() for k, v in run.params.items()}
            start = {"params": obs.params10, "hist1": run.hist1.clone(), "age": run.age.clone(),
                     "prev_loss": run.prev_loss.clone(), "gen": run.gen.get_state(),
                     "ghost": {int(k): run.ghost_of(int(k)).clone() for k in cohorts[r]},
                     "t": r, "tau": tau}
        run.round(r, cohorts[r], tau)
        if r < 3 or r == e + 1:
            rows = torch.as_tensor(np.asarray(cohorts[r]), dtype=torch.long, device=device)
            snap = {"params": {k: v.clone() for k, v in run.params.items()},
                    "hist1": run.hist1[rows].cpu(), "age": run.age[rows].cpu(),
                    "ghost": torch.stack([digest(run.ghost_of(int(k)))
                                          for k in cohorts[r]]).cpu(),
                    "prev_loss": run.prev_loss.clone()}
            if r < 3:
                obs.snaps.append(snap)
            else:
                obs.win = {"start": start, "cohort": cohorts[r], "snap": snap,
                           "hist": obs.hist10}
        if r % e == 0:
            loss = run.eval_loss(run.params)
            if l0 is None:
                l0 = max(loss, 1e-6)
            tau = reference.adaptive_tau(loss, l0, method.tau0)
            if r == 0:
                obs.hist0 = {"test_loss": loss, "tau": tau}
            obs.hist10 = {"test_loss": loss, "tau": tau}
    log(f"control ({precision}, fault {fault}) ran {e + 2} rounds")
    return obs
