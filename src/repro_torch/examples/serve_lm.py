"""Batched LM serving: prefill + KV-cache decode on the smoke configuration
of any registered architecture (port of ``examples/serve_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mini [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch whisper-large-v3

Runs ``launch.serve_lm_cli.serve`` with the reference example's defaults
(batch 4, a 32-token prompt, 16 generated tokens, seed 0) on ``cuda:0``
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import list_archs
from repro_torch.launch.serve_lm_cli import serve


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mini", choices=["mini", *list_archs()])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    args.seed = 0
    return args


def main(argv=None) -> dict:
    """Serve once; returns ``serve``'s result (``prefill_s``,
    ``decode_tok_s``, ``tokens``)."""
    return serve(build_args(argv))


if __name__ == "__main__":
    main()
