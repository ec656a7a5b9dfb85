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

NCCL on the card, gloo on the CPU (only when the caller asks for the CPU).
"""
