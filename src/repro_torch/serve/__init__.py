"""repro_torch.serve: online inference for the federated GCN on the card.

``ServedModel`` holds params and a device-resident warm layer-1 embedding
cache; ``QueryEngine`` answers micro-batched node-classification queries
over it at bucket shapes; ``GraphStore`` absorbs streaming graph updates
with exact 1-hop cache invalidation; ``LoadGenerator`` drives the stack with
seeded synthetic traffic into a ``LatencyLedger``.
"""
from repro_torch.serve.engine import CACHE_POLICIES, DEFAULT_BUCKETS, QueryEngine
from repro_torch.serve.loadgen import LOAD_MODES, LatencyLedger, LoadGenerator
from repro_torch.serve.model import SERVE_BACKENDS, WARM_MODES, ServedModel
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
]
