"""Per-architecture sharding rules for the production mesh (port of
``repro/sharding/specs.py``).

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
    - batch dims shard over ("pod", "data")
    - weight feature dims shard over "model" (tensor parallel): column for
      in-projections, row for out-projections; MoE expert axis over "model"
    - FSDP (train mode): the non-"model" weight dim additionally shards over
      "data" (ZeRO-style); "pod" replicates weights (pure DP across pods)
    - long_500k (batch=1): the KV-cache/sequence dim shards over "data"

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), an axis name, or a tuple of axis names (the dim split over
them, the first name major): the content of the reference's
``PartitionSpec``. ``placements`` turns a spec into DTensor placements on a
``DeviceMesh``; ``param_sharding_tree`` gives ``(mesh, placements)`` per
leaf.

Rules are name-based on the trailing dims of each leaf, so they hold for
the port's trees, which keep repeated units as Python lists where the
reference stacks them on a leading axis: a port leaf's spec is the
reference's without that leading ``None``. A path is the tuple of dict keys
and list indices down to the leaf. Non-divisible cases fall back to
replication, checked against the mesh's axis sizes by name
(``launch.mesh.axis_sizes``).
"""
from __future__ import annotations

from repro_torch.launch.mesh import axis_sizes
from repro_torch.utils.tree import tree_map_with_path

# trailing-dims rule per leaf name. "F" = fsdp axis ("data" in train mode,
# else None); "M" = "model".
_RULES_2D = {
    # embeddings / heads
    "embed": ("M", "F"),
    "lm_head": ("F", "M"),
    "pos_emb": (None, "M"),
    "enc_pos": (None, "M"),
    # attention
    "wq": ("F", "M"), "wk": ("F", "M"), "wv": ("F", "M"), "wo": ("M", "F"),
    # dense mlp
    "w_in": ("F", "M"), "w_gate": ("F", "M"), "w_out": ("M", "F"),
    # rwkv time-mix / channel-mix
    "wr": ("F", "M"), "wg": ("F", "M"),
    "wck": ("F", "M"), "wcv": ("M", "F"), "wcr": ("F", "M"),
    "mix_w1": (None, None), "decay_w1": (None, None), "decay_w2": (None, None),
    # griffin
    "w_rec_in": ("F", "M"), "w_gate_in": ("F", "M"),
    "w_a": (None, "M"), "w_i": (None, "M"), "conv_w": (None, "M"),
    # gcn (federated sharded simulator)
    "w_self0": ("F", "M"), "w_nbr0": ("F", "M"),
    "w_self1": ("F", "M"), "w_nbr1": ("F", "M"), "w_cls": (None, None),
}

# MoE expert stacks: (E, d, ff)-shaped, expert axis -> "model"
_RULES_MOE_3D = {
    "w_in": ("M", "F", None),
    "w_gate": ("M", "F", None),
    "w_out": ("M", None, "F"),
}


def _axis(sym, *, fsdp: bool):
    if sym == "M":
        return "model"
    if sym == "F":
        return "data" if fsdp else None
    return sym


def _leaf_name(path) -> tuple[str, bool]:
    """(the leaf's own key, whether "moe" is on its path). List indices are
    path entries like any key."""
    keys = [str(p) for p in path]
    name = keys[-1] if keys else ""
    return name, "moe" in keys


def _divisible(dim: int | None, axis, sizes: dict) -> bool:
    if axis is None or dim is None:
        return True
    n = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        n *= sizes[a]
    return dim % n == 0


def param_spec(path, leaf, mesh, *, fsdp: bool) -> tuple:
    """A list index on ``path`` marks one unit of a stack the reference
    holds as one leaf with a leading unit dim: the rule is chosen for that
    rank, and the unit dim's entry dropped (so arctic's dense residual FFN,
    2-d per unit under "moe", takes the expert-stack rule as in the
    reference)."""
    name, in_moe = _leaf_name(path)
    shape = tuple(leaf.shape)
    stacked = any(isinstance(p, int) for p in path)
    if in_moe and name in _RULES_MOE_3D and len(shape) + stacked >= 3:
        rule = _RULES_MOE_3D[name]
    elif name in _RULES_2D:
        rule = _RULES_2D[name]
    else:
        rule = ()
    sizes = axis_sizes(mesh)
    # align rule to trailing dims, pad leading dims with None
    axes = [None] * len(shape)
    for i, sym in enumerate(rule):
        pos = len(shape) - len(rule) + i
        if pos < 0:
            continue
        ax = _axis(sym, fsdp=fsdp)
        if _divisible(shape[pos], ax, sizes):
            axes[pos] = ax
    return tuple(axes)


def param_spec_tree(params_shapes, mesh, *, fsdp: bool = False, profile: str = "tp"):
    """profile "tp": tensor-parallel rules above (+FSDP for train).
    profile "dp": replicate all weights; batch shards over every mesh axis
    (for small models where TP spends the interconnect on weight
    all-gathers)."""
    if profile == "dp":
        return tree_map_with_path(lambda path, leaf: (), params_shapes)
    return tree_map_with_path(lambda path, leaf: param_spec(path, leaf, mesh, fsdp=fsdp),
                              params_shapes)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(i)`` on each
    mesh dim that tensor dim i is split over, ``Replicate()`` elsewhere. A
    dim split over several axes must name them in the mesh's order (the
    first name major, as in the reference), which is DTensor's order for
    several mesh dims sharding one tensor dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} is split over {group}, not in the "
                             f"mesh's axis order {tuple(names)}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def param_sharding_tree(params_shapes, mesh, *, fsdp: bool = False):
    """``(mesh, placements)`` per leaf: the spec tree on a ``DeviceMesh``."""
    return tree_map_with_path(
        lambda path, leaf: (mesh, placements(param_spec(path, leaf, mesh, fsdp=fsdp), mesh)),
        params_shapes)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """One rank's shard of a ``shape`` tensor under ``spec`` on ``mesh``
    (the first rank's, the largest where a split is uneven)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                       placements(spec, mesh))[0])


def dp_axes(mesh, profile: str = "tp"):
    """Batch-parallel axes: ("pod","data") when a pod axis exists; the "dp"
    profile additionally folds the model axis into the batch axes."""
    axes = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    if profile == "dp":
        axes = axes + ("model",)
    return axes


def batch_spec(mesh, batch_size: int, ndim: int, profile: str = "tp") -> tuple:
    """Shard the leading batch dim over dp axes (when divisible)."""
    sizes = axis_sizes(mesh)
    axes = dp_axes(mesh, profile)
    total = 1
    for a in axes:
        total *= sizes[a]
    if batch_size % total == 0:
        lead = axes if len(axes) > 1 else axes[0]
    elif batch_size % sizes[axes[-1]] == 0:
        lead = axes[-1]
    else:
        lead = None
    return (lead, *([None] * (ndim - 1)))


def decode_state_spec(path, leaf, mesh, batch: int) -> tuple:
    """KV caches (..., B, S, Hkv, hd) (``k``, ``v``, and the cross
    attention's ``xk``, ``xv``) / recurrent states: shard B over dp axes;
    batch=1 long-context: shard the cache sequence dim over "data"."""
    name, _ = _leaf_name(path)
    shape = tuple(leaf.shape)
    sizes = axis_sizes(mesh)
    axes: list = [None] * len(shape)
    dp = dp_axes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]
    if name in ("k", "v", "xk", "xv") and len(shape) >= 4:
        b_pos = len(shape) - 4
        s_pos = len(shape) - 3
        if shape[b_pos] % total == 0:
            axes[b_pos] = dp if len(dp) > 1 else dp[0]
        elif shape[b_pos] % sizes[dp[-1]] == 0:
            axes[b_pos] = dp[-1]
        elif shape[s_pos] % sizes["data"] == 0:
            axes[s_pos] = "data"   # long-context: sequence-shard the cache
        if shape[-2] % sizes["model"] == 0 and shape[-2] >= sizes["model"]:
            axes[-2] = "model"     # kv heads over model axis when they fit
        return tuple(axes)
    # recurrent states: (..., B, ...) — find a batch-sized dim to shard
    for pos in range(len(shape)):
        if shape[pos] == batch and batch % sizes[dp[-1]] == 0:
            axes[pos] = dp[-1]
            break
    return tuple(axes)


def activation_rules(mesh, *, train: bool, profile: str = "tp") -> dict:
    """Logical-axis -> mesh-axis map of the activations."""
    dp = dp_axes(mesh, profile)
    batch_ax = dp if len(dp) > 1 else dp[0]
    if profile == "dp":
        return {"batch": batch_ax, "seq": None, "heads": None, "kv_heads": None,
                "ff": None, "embed": None, "vocab": None, "experts": None,
                "boundary_seq": None}
    return {
        "batch": batch_ax,
        "seq": None,
        "heads": "model",
        "kv_heads": None,
        "ff": "model",
        "embed": None,
        "vocab": "model",
        "experts": "model",
        # layer-boundary activations: sequence-parallel over the model axis
        # during training
        "boundary_seq": "model" if train else None,
    }
