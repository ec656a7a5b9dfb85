"""FedAIS scheduling applied to a transformer LM, the paper's bridge to
sequence models (port of ``examples/train_lm_federated.py``).

Trains the bundled ``mini`` dense LM twice on the synthetic token pipeline:
centralised AdamW, then federated local training where client batches are
chosen by loss-delta importance (Eq. 7-8) and the sync interval follows
the adaptive Eq. 11 rule. On ``cuda:0`` unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_federated --steps 120
    PYTHONPATH=src python -m repro_torch.examples.train_lm_federated --steps 8 --device cpu
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import train, train_federated


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    # the reference example's fixed settings
    args.arch, args.lr, args.seed, args.log_every = "mini", 3e-4, 0, 20
    args.ckpt_dir, args.ckpt_every, args.tau0 = None, 10_000, 4
    return args


def main(argv=None) -> dict:
    """Both runs; returns {"centralized": train's result, "federated":
    train_federated's}."""
    args = build_args(argv)
    print("=== centralized baseline ===")
    base = train(args)
    print("\n=== FedAIS-scheduled federated ===")
    fed = train_federated(args)
    print(f"\ncentralized: {base['first_loss']:.3f} -> {base['final_loss']:.3f}")
    print(f"federated  : {fed['first_loss']:.3f} -> {fed['final_loss']:.3f} "
          f"({fed['sync_events']} model syncs)")
    return {"centralized": base, "federated": fed}


if __name__ == "__main__":
    main()
