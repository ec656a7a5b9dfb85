"""repro_torch.sharding — the multi-device executors on ``torch.distributed``.

Port of ``repro/sharding`` (``fed.py``, ``tables.py``) and of the analytic
ledger of ``repro/launch/fed_dryrun.py``:

* ``fed``: the client-sharded round (``FedEngine(mesh=make_client_mesh())``,
  executor ``"sharded_fused"``): each rank trains its slice of the cohort,
  the merge is a weighted all-reduce;
* ``tables``: the pod-sharded round (``mesh=make_pod_mesh(P, C)``,
  executor ``"pod_sharded"``): every K-sized table lives in pod shards;
* ``comm``: the counted collectives both run on; ``ledger``: the bytes a
  round must move; ``ranks``: a launcher of N ranks on one machine.

* ``specs``: the per-leaf rules of the production mesh (port of
  ``repro/sharding/specs.py``): a spec per parameter, batch, decode-state
  and activation axis, and its DTensor placements on a ``DeviceMesh``.

NCCL on the card, gloo on the CPU (only when the caller asks for the CPU).
"""
from repro_torch.sharding.fed import (
    CLIENT_AXIS,
    build_sharded_chunk,
    client_axis_of,
    cohort_padding,
    make_client_mesh,
    pairwise_sum,
)
from repro_torch.sharding.specs import (
    activation_rules,
    batch_spec,
    decode_state_spec,
    param_spec_tree,
)
from repro_torch.sharding.tables import (
    POD_AXIS,
    build_pod_sharded_chunk,
    make_pod_mesh,
    pad_tables_to_pods,
    pod_axes_of,
    shard_tables_to_mesh,
)

__all__ = [
    "CLIENT_AXIS",
    "POD_AXIS",
    "activation_rules",
    "batch_spec",
    "build_pod_sharded_chunk",
    "build_sharded_chunk",
    "client_axis_of",
    "cohort_padding",
    "decode_state_spec",
    "make_client_mesh",
    "make_pod_mesh",
    "pad_tables_to_pods",
    "pairwise_sum",
    "param_spec_tree",
    "pod_axes_of",
    "shard_tables_to_mesh",
]
