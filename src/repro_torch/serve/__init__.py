"""repro_torch.serve: online inference for the federated GCN on the card.

``ServedModel`` holds params and a device-resident warm layer-1 embedding
cache (``ServedModel.restore`` builds it from a ``save_federation``
checkpoint); ``QueryEngine`` answers micro-batched node-classification
queries over it at bucket shapes (a CUDA graph per (body, bucket) on the
card); ``GraphStore`` absorbs streaming graph updates with exact 1-hop
cache invalidation; ``LoadGenerator`` drives the stack with seeded
synthetic traffic into a ``LatencyLedger``, whose payload
``validate_bench_serve`` checks.
"""
from repro_torch.serve.engine import CACHE_POLICIES, DEFAULT_BUCKETS, QueryEngine
from repro_torch.serve.loadgen import (
    LOAD_MODES,
    LatencyLedger,
    LoadGenerator,
    validate_bench_serve,
)
from repro_torch.serve.model import (
    SERVE_BACKENDS,
    WARM_MODES,
    ServedModel,
    federation_template,
    federation_tree,
    save_federation,
)
from repro_torch.serve.updates import CapacityError, GraphStore

__all__ = [
    "CACHE_POLICIES",
    "DEFAULT_BUCKETS",
    "LOAD_MODES",
    "SERVE_BACKENDS",
    "WARM_MODES",
    "CapacityError",
    "GraphStore",
    "LatencyLedger",
    "LoadGenerator",
    "QueryEngine",
    "ServedModel",
    "federation_template",
    "federation_tree",
    "save_federation",
    "validate_bench_serve",
]
