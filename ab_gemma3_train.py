"""One checkout's gemma3-12b training numbers on the card, for comparing two trees.

    python3 ab_gemma3_train.py ROOT TAG [--default-allocator]

runs, with the port at ROOT (this checkout: ``.``; another: unpack it with
``git archive`` into a directory ``.gitignore`` lists) and this file's own
timer and tracer (``chip_smoke.Timer``, ``chip_smoke._trace`` beside it):

* the flash attention backward pair (dq, then dk/dv) at gemma3-12b's
  training shapes in bf16, B 2, S 2,048, H 16/8, hd 240: the local block
  (window 1,024) and the global one (causal), each kernel also alone, with
  the route the tree's library takes;
* gemma3-12b at full width, 6 of its 48 layers (one 5:1 local:global
  unit), bf16 with AdamW moments fp32, 4 steps of ``make_train_step`` under
  ``linear_warmup_cosine`` at 3e-4 on 2 x 2,048 ``TokenPipeline`` tokens
  (what ``chip_smoke.py``'s phase 16 runs), then one steady step traced;

and prints one line ``AB {json}``: the pair's times, the steps, peak
memory, launches and routes a step, the traced step's device busy time
and the flash kernels' device time. It runs under PyTorch's
expandable-segments allocator (``PYTORCH_CUDA_ALLOC_CONF``), unless
``--default-allocator``: a tree whose AdamW updates gemma3's 1.0 B-element
embedding whole needs ~4 GB blocks that the default allocator's reserved
segments could not give on an 80 GB H100 (out of memory with much of it
reserved but free). Compare two trees only within one call, in turns (A,
B, B, A), each in its own process:

    for t in A B B A; do python3 ab_gemma3_train.py <root of $t> $t; done

Needs one card; builds that tree's flash attention library at first use.
"""
import dataclasses
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = (("gemma3_local_bf16", 1024), ("gemma3_global_bf16", None))
B, S, H, HKV, HD = 2, 2048, 16, 8, 240
ARCH, LAYERS, BATCH, TEXT, STEPS, LR = "gemma3-12b", 6, 2, 2048, 4, 3e-4


def pair_times(torch, ops, timer, gen, window, reps=10) -> dict:
    """The backward pair's ms (and each kernel's alone) at one shape."""
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").bfloat16()
                   for shape in ((B, S, H, HD), (B, S, HKV, HD), (B, S, HKV, HD), (B, S, H, HD)))
    kw = {"causal": True, "window": window}
    o, lse = ops.flash_attention_lse(q, k, v, **kw)
    before = {n: dict(getattr(ops, n).routes) for n in ("flash_bwd_dq", "flash_bwd_dkdv")}
    _, delta = ops.flash_bwd_dq(q, k, v, o, lse, do, **kw)
    ops.flash_bwd_dkdv(q, k, v, lse, delta, do, **kw)
    routes = {n: [r for r, c in getattr(ops, n).routes.items() if c != before[n][r]]
              for n in before}
    return {"routes": routes,
            "ms": timer(lambda: ops.flash_bwd(q, k, v, o, lse, do, **kw), reps),
            "dq_ms": timer(lambda: ops.flash_bwd_dq(q, k, v, o, lse, do, **kw), reps),
            "dkdv_ms": timer(lambda: ops.flash_bwd_dkdv(q, k, v, lse, delta, do, **kw), reps)}


def main(argv) -> int:
    root, tag = os.path.abspath(argv[1]), argv[2]
    allocator = "default" if "--default-allocator" in argv[3:] else "expandable_segments"
    sys.path[:0] = [HERE, os.path.join(root, "src")]
    if allocator == "expandable_segments":
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline, make_lm_batch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import lm
    from repro_torch.optim import linear_warmup_cosine

    if not torch.cuda.is_available():
        print("ab_gemma3_train: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.samefile(os.path.dirname(ops.__file__),
                            os.path.join(root, "src", "repro_torch", "kernels",
                                         "flash_attention")):
        print(f"ab_gemma3_train: imported {ops.__file__}, not {root}'s", file=sys.stderr)
        return 1
    build.build(["flash_attention"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    timer = cs.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(16)
    pairs = {name: pair_times(torch, ops, timer, gen, window) for name, window in SHAPES}
    del timer
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS)
    pipe = TokenPipeline(cfg.vocab_size, TEXT, BATCH, seed=0)
    params, opt = lm.init_train_state(torch.Generator(device=dev).manual_seed(0), cfg,
                                      torch.float32, dev)
    step = lm.make_train_step(cfg, linear_warmup_cosine(LR, STEPS // 10 + 1, STEPS))
    counters = {"flash_attention": ops.flash_attention, "flash_bwd_dq": ops.flash_bwd_dq,
                "flash_bwd_dkdv": ops.flash_bwd_dkdv}
    torch.cuda.reset_peak_memory_stats()
    launches0 = {n: c.launches for n, c in counters.items()}
    routes0 = {n: dict(counters[n].routes) for n in ("flash_bwd_dq", "flash_bwd_dkdv")}
    steps = []
    for i in range(STEPS):
        batch = make_lm_batch(pipe, i, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        steps.append({"ms": (time.perf_counter() - t0) * 1e3, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
    launches = {n: (c.launches - launches0[n]) // STEPS for n, c in counters.items()}
    routes = {n: {r: (c - routes0[n][r]) // STEPS for r, c in counters[n].routes.items()}
              for n in routes0}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steady = sorted(r["ms"] for r in steps[1:])[len(steps[1:]) // 2]
    batch = make_lm_batch(pipe, STEPS, dev)
    _, prof = cs._trace(torch, lambda: step(params, opt, batch), 24)
    flash_ms = {}
    for e in prof["top_device"]:
        name = re.search(r"flash_\w+(?:<[^>]*>)?", e["name"])
        if name:
            flash_ms[name.group(0)] = flash_ms.get(name.group(0), 0.0) + e["device_ms"]
    print("AB " + json.dumps({
        "tag": tag, "root": root, "device": torch.cuda.get_device_name(0),
        "allocator": allocator, "pairs": pairs,
        "arch": ARCH, "layers": LAYERS, "params": cfg.param_count(), "steps": steps,
        "steady_step_ms": steady, "tokens_per_s": BATCH * TEXT / (steady / 1e3),
        "peak_memory_gb": peak_gb, "launches_a_step": launches, "routes_a_step": routes,
        "busy_ms": prof["device_busy_ms"], "traced_wall_ms": prof["wall_ms"],
        "busy_share": prof["device_busy_share"], "flash_device_ms": flash_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
