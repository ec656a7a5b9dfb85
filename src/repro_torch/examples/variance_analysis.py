"""The paper's variance analysis (Eq. 3-5 / Theorem 1), empirically (port
of ``examples/variance_analysis.py``): (a) the embedding-approximation
error that historical embeddings introduce at different staleness levels,
(b) the minibatch-variance reduction of importance sampling over uniform.

    PYTHONPATH=src python -m repro_torch.examples.variance_analysis
        [--device cpu] [--rounds 1] [--scale 32] [--backend gather|segment|spmm]

The params come from ``gcn_init`` seeded 0 and the staleness noise from a
``torch.Generator`` seeded 1 (the reference draws both with
``jax.random``, from keys 0 and 1): one draw of the layer-1 table's shape,
scaled by each staleness level.
``--rounds`` R > 1 draws R such tables and reports the mean error over
them and the variance of the batch logits across them
(``estimator_variance``); R = 1 is the reference's run.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.importance import importance_probs, sampling_variance, uniform_probs
from repro_torch.core.variance import embedding_error, estimator_variance, theorem1_bound
from repro_torch.device import resolve_device
from repro_torch.graph.csr import build_padded_neighbors
from repro_torch.graph.data import make_dataset
from repro_torch.models.gcn import (
    AGG_BACKENDS,
    HIDDEN,
    _sage_layer,
    gcn_batch_forward,
    gcn_full_forward,
    gcn_init,
    neighbor_aggregate,
    per_node_loss,
)

STALENESS = (0.0, 0.1, 0.5, 1.0)


def build_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' runs the plain versions)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="noise draws per staleness level")
    ap.add_argument("--scale", type=int, default=32, help="Pubmed downscale factor")
    ap.add_argument("--backend", default="gather", choices=AGG_BACKENDS,
                    help="neighbour aggregation of the forward passes")
    return ap.parse_args(argv)


def run(args: argparse.Namespace, *, params: dict | None = None,
        noise: torch.Tensor | None = None) -> dict:
    """Returns ``{"staleness": [rows], "v_imp", "v_uni", "reduction"}``.
    ``params`` replaces the seeded ``gcn_init`` draw and ``noise`` (R, n,
    H1) the standard normal draws (the tests pass the reference's)."""
    dev = resolve_device(args.device)
    g = make_dataset("pubmed", scale=args.scale, seed=0)
    idx_np, mask_np = build_padded_neighbors(g.adjacency_lists(), 16)
    feats = torch.from_numpy(g.features).to(dev)
    labels = torch.from_numpy(g.labels).to(dev)
    idx, mask = torch.from_numpy(idx_np).to(dev), torch.from_numpy(mask_np).to(dev)
    n = g.n_nodes
    if params is None:
        params = gcn_init(torch.Generator().manual_seed(0), g.n_features,
                          g.n_classes, device=dev)

    def full_forward():
        return gcn_full_forward(params, feats, idx, mask, backend=args.backend)

    with torch.no_grad():
        # exact layer-1 embeddings
        h1_exact = _sage_layer(params, 0, feats,
                               neighbor_aggregate(feats, idx, mask, backend=args.backend))
        if noise is None:
            gen = torch.Generator(device=dev).manual_seed(1)
            noise = torch.randn((args.rounds, *h1_exact.shape), generator=gen, device=dev)
        noise = noise.to(dev).reshape(-1, *h1_exact.shape)
        std = h1_exact.std(correction=0)
        print("== (a) embedding-approximation error vs staleness (Thm. 1 regime) ==")
        # only HALF the nodes are in-batch: out-of-batch neighbors read the
        # (noisy = stale) historical table — exactly the Eq. (6) approximation
        batch = torch.arange(n // 2, device=dev)
        ones_b = torch.ones(n // 2, device=dev)
        h2_exact_logits = full_forward()[: n // 2]
        n_nbrs = float(mask.sum(1).mean())
        rows = []
        for staleness in STALENESS:
            errs, bounds, logits_r = [], [], []
            for z in noise:
                nz = staleness * z * std
                hist1 = torch.cat([h1_exact + nz, torch.zeros((1, HIDDEN[0]), device=dev)])
                logits, _, _ = gcn_batch_forward(
                    params, feats, torch.zeros((1, g.n_features), device=dev), hist1,
                    idx, mask, batch, backend=args.backend)
                errs.append(float(embedding_error(logits, h2_exact_logits, ones_b)))
                bounds.append(theorem1_bound(1.0, float(nz.abs().max() + 1e-9), n_nbrs, 2))
                logits_r.append(logits)
            row = {"staleness": staleness, "err": sum(errs) / len(errs),
                   "bound": sum(bounds) / len(bounds),
                   "logit_variance": float(estimator_variance(torch.stack(logits_r)))}
            rows.append(row)
            print(f"  staleness={staleness:.1f}: output L2 err={row['err']:.4f} "
                  f"(Thm.1-style bound scale={row['bound']:.2f})"
                  + (f", logit variance over {len(errs)} draws {row['logit_variance']:.3g}"
                     if len(errs) > 1 else ""))

        print("\n== (b) minibatch variance: importance vs uniform (Eq. 7) ==")
        losses = per_node_loss(full_forward(), labels)
        ones = torch.ones(n, device=dev)
        v_imp = float(sampling_variance(importance_probs(losses, ones), losses, ones))
        v_uni = float(sampling_variance(uniform_probs(ones), losses, ones))
    out = {"staleness": rows, "v_imp": v_imp, "v_uni": v_uni,
           "reduction": 1.0 - v_imp / v_uni}
    print(f"  Eq.7 objective: importance={v_imp:.1f}  uniform={v_uni:.1f}  "
          f"reduction={100 * out['reduction']:.1f}%")
    return out


def main(argv=None) -> int:
    run(build_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
