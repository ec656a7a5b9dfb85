"""Deprecated shim: LM serving lives in ``repro_torch.launch.serve_lm_cli``
(port of ``repro/launch/serve.py``), so that ``python -m
repro_torch.launch.serve_fed`` (the federated GCN server) and the LM stack
are told apart.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm_cli ...   # LM prefill/decode
    PYTHONPATH=src python -m repro_torch.launch.serve_fed ...      # federated GCN
"""
from __future__ import annotations

import warnings

from repro_torch.launch.serve_lm_cli import main, serve  # noqa: F401

warnings.warn(
    "repro_torch.launch.serve is deprecated: LM serving is "
    "repro_torch.launch.serve_lm_cli (the federated GCN server is "
    "repro_torch.launch.serve_fed)",
    DeprecationWarning,
    stacklevel=2,
)

if __name__ == "__main__":
    main()
