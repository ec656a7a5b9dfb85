"""Dry run: the accounting of every (architecture x input shape x mesh)
on meta tensors (port of ``repro/launch/dryrun.py``).

The reference lowers and compiles each case with XLA on 512 placeholder
devices and reads the roofline terms from the compiled program
(``lower``/``compile``/``cost_analysis``, the HLO's collectives). Torch has
no such compiler pass, so the port walks the step itself, once, on meta
tensors (shapes and dtypes, no storage, nothing computed):

* the params, the AdamW moments, the decode state and the data are meta
  tensors (``build_case``), each with its spec from ``sharding.specs``;
  their bytes per device come from each leaf's local shape under its
  DTensor placements on the production mesh (``launch.mesh``: a fake
  process group of 256 or 512 ranks, started by the CLI, never at import);
* the step runs the plain path (``use_kernel=False``: the kernel wrappers
  take CPU or CUDA tensors only), under ``torch.utils.flop_counter``'s
  ``FlopCounterMode`` for its FLOPs and under ``StepLedger`` for its bytes
  and its peak of live bytes. Train: ``loss_and_grads`` (the loss and
  its gradient by autograd; the reference's step also runs the clip and
  AdamW, elementwise ops no FLOP counter counts, whose bytes this walk
  leaves out; the moments are built and counted per device). Prefill:
  the port's ``lm_prefill`` (the LM head on the last position, the K/V
  written into the decode state it returns). Decode: one
  ``decode_step``. The Python loop runs every layer, so nothing is
  extrapolated; the WKV recurrence runs as one batched step of its
  products on meta tensors (``models.rwkv._wkv_scan_meta``: the loop's
  FLOPs and saved states, fewer passes over the state);
* the collective term is 0 bytes: the walk runs the plain path on whole
  tensors, not DTensors, so it runs no collective (``collective_source``);
  the reference reads its bytes from the partitioned HLO. The fed dry run
  (``launch.fed_dryrun``) does count its collectives: its round bodies run
  each one through ``sharding.comm``.

Row keys that differ from the reference's: ``walk_s`` takes the place of
``lower_s``, ``compile_s`` and ``variant_compile_s`` (one walk, not three
compiles); ``collective_source`` is new and ``collectives`` is empty;
``dot_duplication`` (an HLO fusion count) is left out; ``memory`` holds the
bytes per device of each input tree and the whole step's peak of live
bytes (``activation_peak_bytes``) in place of XLA's memory analysis. The
walk does not depend on the mesh, so ``--mesh both`` walks each case once.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-12b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (
    INPUT_SHAPES,
    InputShape,
    get_config,
    input_specs,
    list_archs,
    long_context_variant,
    shape_applicable,
)
from repro_torch.device import MetaGenerator
from repro_torch.launch.mesh import (
    axis_sizes,
    make_host_mesh,
    make_production_mesh,
    mesh_chips,
    mesh_label,
    production_chip_count,
    start_fake_world,
    stop_world,
)
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.sharding.specs import (
    batch_spec,
    decode_state_spec,
    local_shape,
    param_spec,
    param_spec_tree,
)
from repro_torch.utils.roofline import RooflineReport
from repro_torch.utils.tree import tree_leaves, tree_map_with_path

# archs whose optimizer moments drop to bf16 to fit the mesh's memory
BF16_MOMENT_ARCHS = {"llama3-405b", "arctic-480b", "dbrx-132b"}
COLLECTIVE_SOURCE = ("none run: the step walks one device's plain program on whole tensors, "
                     "not DTensors, so no collective runs to be counted (the reference reads "
                     "collective bytes from the partitioned HLO)")


class StepLedger(TorchDispatchMode):
    """Bytes an op-by-op walk moves, and its peak of live bytes.

    ``bytes``: every op that is not a view reads each tensor argument once
    and writes each output once (the unfused traffic; fused kernels move
    less). ``peak_bytes``: the most bytes of storages allocated during the
    walk that were alive at once, read from weak references to each
    storage (``StorageWeakRef``), so a storage counts until its last
    holder, autograd's saved tensors included, lets it go. The inputs
    (params, moments, state, data) were allocated before the walk and are
    not counted. A sweep of the weak references runs only when the running
    sum could pass the peak."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}
        self._upper = 0

    @staticmethod
    def _size(t) -> int:
        return t.numel() * t.element_size()

    def _sweep(self) -> None:
        self._live = {k: v for k, v in self._live.items() if not v[0].expired()}
        self._upper = sum(n for _, n in self._live.values())

    def _track(self, t) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef

        ref = StorageWeakRef(t.untyped_storage())
        old = self._live.get(ref.cdata)
        if old is not None and not old[0].expired():
            return
        n = t.untyped_storage().nbytes()
        self._live[ref.cdata] = (ref, n)
        self._upper += n
        if self._upper > self.peak_bytes:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self._upper)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        ins = [a for a in tree_flatten((args, kwargs))[0] if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0] if isinstance(o, torch.Tensor)]
        self.bytes += sum(self._size(t) for t in ins + outs)
        if not any(r.alias_info is not None for r in func._schema.returns):
            for o in outs:       # a fresh storage (an in-place op's is its input's)
                self._track(o)
        return out


def _case_config(arch: str, shape, *, extra=None):
    """The reference's case configuration: ``long_context_variant`` at
    ``long_500k``, activation checkpointing by default in training, then
    ``extra``'s fields. Returns (cfg, the full config's param count)."""
    cfg = get_config(arch)
    if shape.name == "long_500k":
        cfg = long_context_variant(cfg)
    overrides = dict(extra or {})
    n_params = cfg.param_count()
    if shape.kind == "train":
        overrides.setdefault("remat", True)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg, n_params


@functools.lru_cache(maxsize=None)
def _meta_params(cfg):
    """The params of ``cfg`` as meta tensors, built once per config (no
    step changes them: the train step differentiates detached copies)."""
    return lm.init_lm(MetaGenerator(), cfg, "meta")


def _opt_spec(path, leaf, mesh, *, fsdp: bool, profile: str) -> tuple:
    """A moment leaf's spec: the param's under "tp"; under "dp" (ZeRO-1:
    weights replicate) the whole mesh, or else the model axis, on the first
    dim that divides (the port's leaves have no stacked-unit dim in front,
    so that dim is found per unit)."""
    if leaf.ndim == 0:
        return ()
    if profile != "dp":
        return param_spec(path, leaf, mesh, fsdp=fsdp)
    sizes = axis_sizes(mesh)
    total = 1
    for v in sizes.values():
        total *= v
    axes = [None] * leaf.ndim
    for i, dim in enumerate(leaf.shape):
        if dim % total == 0:
            axes[i] = tuple(sizes)
            break
        if dim % sizes["model"] == 0 and dim >= sizes["model"]:
            axes[i] = "model"
            break
    return tuple(axes)


def build_case(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               extra: dict | None = None, profile: str = "tp", shape=None):
    """Returns (step_fn, example_args, meta, trees): the step, its inputs
    as meta tensors, the reference's ``meta`` dict (same keys and values),
    and {"params" | "moments" | "decode_state" | "data": (tree, its spec
    tree)}, a spec tree mirroring its tree. ``shape`` (an ``InputShape``)
    stands in for ``INPUT_SHAPES[shape_name]``; ``mesh`` is a
    ``DeviceMesh`` or anything ``launch.mesh.axis_sizes`` reads."""
    shape = shape or INPUT_SHAPES[shape_name]
    cfg, n_params = _case_config(arch, shape, extra=extra)
    params = _meta_params(cfg)
    pspec = param_spec_tree(params, mesh, fsdp=fsdp and shape.kind == "train",
                            profile=profile)
    data = input_specs(cfg, shape)
    dspec = {k: batch_spec(mesh, shape.global_batch, v.ndim, profile) if v.ndim else ()
             for k, v in data.items()}
    meta = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
        "kind": shape.kind, "params": n_params,
        "active_params": cfg.active_param_count(),
        "remat": cfg.remat, "attn_impl": cfg.attn_impl, "profile": profile,
    }
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        moment_dtype = torch.bfloat16 if arch in BF16_MOMENT_ARCHS else torch.float32
        opt = adamw_init(params, moment_dtype)
        moments = {"mu": opt.mu, "nu": opt.nu}
        ospec = tree_map_with_path(
            lambda path, leaf: _opt_spec(path, leaf, mesh, fsdp=fsdp, profile=profile),
            moments)

        def step(params, batch):
            return lm.loss_and_grads(params, cfg, batch, use_kernel=False)

        meta["model_flops"] = 6.0 * cfg.active_param_count() * B * S
        return step, (params, data), meta, {
            "params": (params, pspec), "moments": (moments, ospec), "data": (data, dspec)}

    if shape.kind == "prefill":
        max_len = S + (cfg.n_image_tokens or 0)

        def step(params, batch):
            with torch.no_grad():
                return lm.lm_prefill(params, cfg, batch["tokens"], max_len,
                                     image_embeds=batch.get("image_embeds"),
                                     enc_frames=batch.get("enc_frames"), use_kernel=False)

        meta["model_flops"] = 2.0 * cfg.active_param_count() * B * S
        return step, (params, data), meta, {"params": (params, pspec),
                                            "data": (data, dspec)}

    # decode: one token at the cache's last position
    enc_out = None
    if cfg.n_encoder_layers:
        enc_out = torch.zeros((B, cfg.encoder_seq_len, cfg.d_model), dtype=cfg.torch_dtype,
                              device="meta")
    state = lm.init_decode_state(params, cfg, B, S, enc_out=enc_out)
    sspec = tree_map_with_path(lambda path, leaf: decode_state_spec(path, leaf, mesh, B),
                               state)

    def step(params, state, batch):
        with torch.no_grad():
            return lm.decode_step(params, cfg, state, batch["tokens"], S - 1)

    meta["model_flops"] = 2.0 * cfg.active_param_count() * B  # one token per seq
    return step, (params, state, data), meta, {
        "params": (params, pspec), "decode_state": (state, sspec), "data": (data, dspec)}


def _spec_leaves(specs) -> list:
    """The specs of a spec tree in ``tree_leaves``' order (a spec, a
    tuple, is a leaf here)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in _spec_leaves(v)]
    return [specs]


def tree_bytes_per_device(tree, specs, mesh) -> int:
    """Bytes one device holds of ``tree``: each leaf's local shape under its
    spec's placements on ``mesh``."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree), _spec_leaves(specs), strict=True):
        n = 1
        for v in local_shape(leaf.shape, spec, mesh):
            n *= v
        total += n * leaf.element_size()
    return total


def walk(step, args) -> dict:
    """Run ``step(*args)`` on meta tensors under ``FlopCounterMode`` and a
    ``StepLedger``: {"flops", "bytes", "activation_peak_bytes", "walk_s"}."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.perf_counter()
    ledger = StepLedger()
    with FlopCounterMode(display=False) as counter, ledger:
        out = step(*args)
    del out
    return {"flops": float(counter.get_total_flops()), "bytes": float(ledger.bytes),
            "activation_peak_bytes": ledger.peak_bytes, "walk_s": time.perf_counter() - t0}


def run_case(arch: str, shape_name: str, mesh_name: str, *, mesh=None, shape=None,
             fsdp=True, extra=None, profile="tp", verbose=True,
             walks: dict | None = None) -> dict:
    """One row: the case's bytes per device under its placements, the
    walk's FLOPs, bytes and peak, and the roofline. ``mesh`` defaults to
    the production mesh ``mesh_name`` names (its fake world must be
    running); ``walks`` caches the walk (mesh-independent) across meshes."""
    shape = shape or INPUT_SHAPES[shape_name]
    cfg, _ = _case_config(arch, shape, extra=extra)
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    if mesh is None:
        mesh = make_production_mesh(multi_pod=mesh_name == "pod2")
    chips = mesh_chips(mesh)
    try:
        step, args, meta, trees = build_case(arch, shape_name, mesh, fsdp=fsdp, extra=extra,
                                             profile=profile, shape=shape)
        key = (arch, shape, tuple(sorted((extra or {}).items())))
        w = walks.get(key) if walks is not None else None
        if w is None:
            w = walk(step, args)
            if walks is not None:
                walks[key] = w
        mem = {f"{k}_bytes": 0 for k in ("params", "moments", "decode_state", "data")}
        for k, (tree, specs) in trees.items():
            mem[f"{k}_bytes"] = tree_bytes_per_device(tree, specs, mesh)
        mem["argument_bytes"] = sum(mem.values())
        mem["activation_peak_bytes"] = w["activation_peak_bytes"]
    except Exception as e:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}
    rep = RooflineReport(arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
                         hlo_flops=w["flops"], hlo_bytes=w["bytes"], collective_bytes=0.0,
                         model_flops=meta["model_flops"])
    result = {
        "status": "ok",
        **meta,
        "mesh": mesh_name,
        "chips": chips,
        "walk_s": w["walk_s"],
        "flops_per_device": w["flops"] / chips,
        "bytes_per_device": w["bytes"] / chips,
        "collective_bytes_per_device": 0.0,
        "collective_source": COLLECTIVE_SOURCE,
        "collectives": {},
        "roofline": rep.row(),
        "memory": mem,
    }
    if verbose:
        print(rep.pretty())
        print(f"    walk={w['walk_s']:.1f}s args/device={mem['argument_bytes'] / 2**30:.2f} GiB "
              f"activation peak={mem['activation_peak_bytes'] / 2**30:.2f} GiB (whole step)")
    return result


def unit_mesh_rows(cases: list[dict]) -> list[dict]:
    """Rows of steps one card ran, each on a 1x1 mesh (a fake world of one
    rank, started here and stopped after). A case is {"arch", "label",
    "kind", "batch", "seq_len", "extra"}: the shape that ran and the
    config's fields as they ran (``extra``, e.g. a cut ``n_layers``)."""
    start_fake_world(1)
    try:
        mesh = make_host_mesh(1, device="cpu")
        return [run_case(c["arch"], c["label"], mesh_label(mesh), mesh=mesh,
                         shape=InputShape(c["label"], c["seq_len"], c["batch"], c["kind"]),
                         extra=c.get("extra"), verbose=False) for c in cases]
    finally:
        stop_world()


def roofline_rows(results: list[dict]) -> list[dict]:
    """The roofline table of dry-run rows: per (arch x shape x mesh), the
    three terms in ms, the dominant one, the useful-FLOPs ratio and the MFU
    bound."""
    rows = []
    for r in results:
        if r.get("status") != "ok":
            rows.append({"arch": r.get("arch"), "shape": r.get("shape"),
                         "mesh": r.get("mesh"), "status": r.get("status", "error")})
            continue
        rf = r["roofline"]
        rows.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"], "status": "ok",
            "compute_ms": rf["compute_s"] * 1e3,
            "memory_ms": rf["memory_s"] * 1e3,
            "collective_ms": rf["collective_s"] * 1e3,
            "dominant": rf["dominant"],
            "useful_flops_ratio": rf["useful_flops_ratio"],
            "mfu_upper_pct": rf["mfu_upper_bound"] * 100,
            "args_gb_per_device": r["memory"]["argument_bytes"] / 2**30,
        })
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["pod1", "pod2"] if args.mesh == "both" else [args.mesh]

    results, walks = [], {}
    t0 = time.perf_counter()
    for mesh_name in meshes:
        start_fake_world(production_chip_count(multi_pod=mesh_name == "pod2"))
        try:
            mesh = make_production_mesh(multi_pod=mesh_name == "pod2")
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}|{shape}|{mesh_name}"
                    path = None
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        path = os.path.join(args.out, f"{arch}_{shape}_{mesh_name}.json")
                        if os.path.exists(path):
                            print(f"[cached] {tag}")
                            continue
                    print(f"=== {tag} ===", flush=True)
                    r = run_case(arch, shape, mesh_name, mesh=mesh, walks=walks)
                    results.append(r)
                    if r["status"] == "error":
                        print(f"    ERROR: {r['error']}")
                    elif r["status"] == "skipped":
                        print(f"    SKIPPED: {r['reason']}")
                    if path:
                        with open(path, "w") as f:
                            json.dump(r, f, indent=1)
        finally:
            stop_world()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run: {n_ok} ok, {n_skip} skipped, {n_err} errors in "
          f"{time.perf_counter() - t0:.1f} s")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
