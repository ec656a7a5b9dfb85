"""End-to-end LM training driver (port of ``repro/launch/train.py``).

Two modes:
  * standard (``train``): AdamW training of any registered arch's smoke
    configuration (or the bundled ``mini`` config) on the synthetic token
    pipeline, under ``linear_warmup_cosine``, with checkpoints and resume;
  * ``--fed`` (``train_federated``): FedAIS-scheduled training, the paper's
    technique applied to sequence models. Clients are data shards; each
    round each client picks its batches by loss-delta importance (Eq. 7-8
    at sequence-batch granularity), takes tau local AdamW steps from a
    fresh optimizer state, and the server merges by FedAvg
    (``api.registry.build_aggregator("fedavg")``); Eq. 11
    (``core.sync.adaptive_tau``) adapts tau between syncs.

Everything runs on ``--device`` (default ``cuda:0``; ``cpu`` runs the
kernels' plain versions). On the card attention trains through the flash
kernels' forward and backward, and RWKV through the WKV6 kernel's
(``--arch rwkv6-1.6b``).

A checkpoint holds the params and the AdamW state (its moments and step),
so a resumed run continues the uninterrupted run's losses; the reference
keeps only the params and restarts its optimizer on resume.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch mini --steps 200
    PYTHONPATH=src python -m repro_torch.launch.train --arch mini --steps 20 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch mini --steps 200 --fed --clients 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 20
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api.registry import build_aggregator
from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import ModelConfig, get_smoke_config, list_archs
from repro_torch.core.sync import adaptive_tau
from repro_torch.data.pipeline import TokenPipeline, make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import AdamState, adamw_init
from repro_torch.optim.schedules import constant, linear_warmup_cosine
from repro_torch.utils.tree import tree_count_params, tree_map


def mini_config(**overrides) -> ModelConfig:
    """Small dense model for the CPU end-to-end example.
    Scale up with e.g. ``mini_config(d_model=768, n_layers=12)`` (~100M)."""
    kw = dict(
        arch_id="mini", family="dense", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=2, d_ff=1536, vocab_size=8192, head_dim=64,
        block_pattern=("attn",), activation="silu", gated_mlp=True,
        dtype="float32", max_seq_len=2048,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def get_train_config(arch: str) -> ModelConfig:
    if arch == "mini":
        return mini_config()
    return get_smoke_config(arch)


def _init_params(cfg, seed: int, device) -> dict:
    """The initial params of a run: ``init_lm`` from a generator seeded
    with ``seed`` on ``device``. (A test replaces this function to start
    both packages from the same params.)"""
    return lm.init_lm(torch.Generator(device=device).manual_seed(seed), cfg, device)


def _ckpt_tree(params, opt: AdamState) -> dict:
    """What a checkpoint holds; bf16 leaves widened to fp32 (exactly) for
    numpy, narrowed back by ``_restore``."""
    widen = lambda t: t.float() if t.dtype == torch.bfloat16 else t
    return {"params": tree_map(widen, params), "mu": tree_map(widen, opt.mu),
            "nu": tree_map(widen, opt.nu), "step": np.asarray(opt.step, np.int64)}


def _restore(directory: str, step: int, params, opt: AdamState):
    got = load_checkpoint(directory, step, _ckpt_tree(params, opt))
    back = lambda like, a: torch.from_numpy(a).to(device=like.device, dtype=like.dtype)
    return (tree_map(back, params, got["params"]),
            AdamState(step=int(got["step"]), mu=tree_map(back, opt.mu, got["mu"]),
                      nu=tree_map(back, opt.nu, got["nu"])))


def train(args) -> dict:
    dev = resolve_device(getattr(args, "device", None))
    cfg = get_train_config(args.arch)
    pipe = TokenPipeline(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed)
    params = _init_params(cfg, args.seed, dev)
    opt = adamw_init(params)
    print(f"arch={cfg.arch_id} params={tree_count_params(params)/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq_len} device={dev}")

    schedule = linear_warmup_cosine(args.lr, args.steps // 10 + 1, args.steps)
    step_fn = lm.make_train_step(cfg, schedule)

    start = 0
    if args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            params, opt = _restore(args.ckpt_dir, last, params, opt)
            print(f"resumed from step {last}")
            start = last

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_lm_batch(pipe, step, dev)
        params, opt, metrics = step_fn(params, opt, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            tok_s = args.batch * args.seq_len * (step - start + 1) / max(dt, 1e-9)
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} tok/s={tok_s:,.0f}")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, _ckpt_tree(params, opt))
    return {"final_loss": losses[-1], "first_loss": losses[0], "losses": losses}


def train_federated(args) -> dict:
    """FedAIS-scheduled LM training (the paper's bridge to the LM zoo).
    Besides the reference's result it returns each round's importance
    picks and loss deltas per client (``picks``, ``deltas``; None for a
    client's first round, which takes its candidates in order)."""
    dev = resolve_device(getattr(args, "device", None))
    cfg = get_train_config(args.arch)
    K = args.clients
    params = _init_params(cfg, args.seed, dev)
    print(f"[fed] arch={cfg.arch_id} params={tree_count_params(params)/1e6:.1f}M "
          f"clients={K} device={dev}")

    # each client gets its own (differently seeded) data shard
    pipes = [TokenPipeline(cfg.vocab_size, args.seq_len, args.batch, seed=args.seed + 7 * k)
             for k in range(K)]
    # constant lr: a client's Adam state restarts every round (FedAvg
    # semantics), so a warmup schedule would pin the lr at its first values
    step_fn = lm.make_train_step(cfg, constant(args.lr))

    @torch.no_grad()
    def loss_fn(p, b):
        return lm.lm_loss(p, cfg, b)[0]

    # clients train equal token counts a round, so plain FedAvg is exact
    aggregator = build_aggregator("fedavg")

    def merge(*xs):
        # one leaf at a time, so the K-copy is one leaf's
        return aggregator.aggregate({"leaf": torch.stack(xs)})["leaf"]

    tau0 = args.tau0
    tau = tau0
    f0 = None
    prev_losses = [None] * K
    rounds = 0
    total_steps = 0
    history, picks_log, deltas_log = [], [], []
    comm_events = 0
    t_start = time.time()

    while total_steps < args.steps:
        new_params, round_losses, picks, deltas_round = [], [], [], []
        for k in range(K):
            p_k, opt_k = params, adamw_init(params)
            # importance-weighted batch choice: the shard batches with the
            # largest loss delta first (Eq. 7-8 at sequence-batch granularity)
            candidates = [make_lm_batch(pipes[k], rounds * tau * 3 + c, dev) for c in range(3)]
            deltas = None
            if prev_losses[k] is not None:
                deltas = [abs(float(loss_fn(params, b)) - prev_losses[k]) for b in candidates]
                order = [int(i) for i in np.argsort(deltas)[::-1]]
            else:
                order = list(range(len(candidates)))
            chosen = order[: max(1, tau)]
            last = None
            for i in chosen:
                p_k, opt_k, m = step_fn(p_k, opt_k, candidates[i])
                last = float(m["loss"])
            prev_losses[k] = last
            round_losses.append(last)
            new_params.append(p_k)
            picks.append(chosen)
            deltas_round.append(deltas)
        params = tree_map(merge, *new_params)
        del new_params
        comm_events += K
        total_steps += tau * K
        rounds += 1
        f_t = float(np.mean(round_losses))
        if f0 is None:
            f0 = max(f_t, 1e-9)
        tau = adaptive_tau(f_t, f0, tau0)
        history.append({"round": rounds, "loss": f_t, "tau": tau, "steps": total_steps})
        picks_log.append(picks)
        deltas_log.append(deltas_round)
        print(f"[fed] round {rounds:3d} steps={total_steps:4d} "
              f"loss={f_t:.4f} tau={tau} syncs={comm_events}")
    return {"history": history, "final_loss": history[-1]["loss"],
            "first_loss": history[0]["loss"], "sync_events": comm_events,
            "wall_s": time.time() - t_start, "picks": picks_log, "deltas": deltas_log}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mini", choices=["mini", *list_archs()])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--fed", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--tau0", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    out = train_federated(args) if args.fed else train(args)
    print(f"loss: {out['first_loss']:.4f} -> {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
