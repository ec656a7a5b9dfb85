"""One checkout's RWKV training numbers on the card, for comparing two trees.

    python3 ab_rwkv_train.py ROOT TAG

runs, from the checkout at ROOT (this one: ``.``; another: unpack it with
``git archive`` into a directory ``.gitignore`` lists), its own
``chip_smoke.check_wkv6_bwd`` at rwkv6-1.6b's training shape (B 2, T 2,048,
H 32, N 64) in bf16 and fp32, then ``chip_smoke.rwkv_train_whole``
(rwkv6-1.6b whole, 4 train steps, the counts from 0, one traced steady
step), and prints one line ``AB {json}``: the backward's times with that
tree's timer, the steady step, peak memory, launches, the traced step's
device busy time and the WKV6 kernels' device time. Host-bound step times
move with the host, so compare two trees only within one call, in turns
(A, B, B, A), each in its own process:

    for t in A B B A; do python3 ab_rwkv_train.py <root of $t> $t; done

Needs one card; builds that tree's wkv6 kernels at first use.
"""
import json
import os
import sys


def main(argv) -> int:
    root, tag = os.path.abspath(argv[1]), argv[2]
    sys.path[:0] = [root, os.path.join(root, "src")]
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6 import ops as wops
    from repro_torch.kernels.wkv6 import ref as wref
    from repro_torch.models import lm

    if not torch.cuda.is_available():
        print("ab_rwkv_train: no CUDA device", file=sys.stderr)
        return 1
    build.build(["wkv6"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the tree's WKV6 kernel counters, whichever it has
    counters = {name: getattr(wops, name) for name in
                ("wkv6", "wkv6_bwd", "wkv6_bwd_blocks", "wkv6_bwd_reduce")
                if hasattr(getattr(wops, name, None), "launches")}
    dev = torch.device("cuda")
    cs.log = lambda *a: None
    timer = cs.Timer(torch)
    gen = torch.Generator(device=dev).manual_seed(16)
    rows = []
    for name, dtype in (("rwkv6_train_bf16", torch.bfloat16), ("rwkv6_train_fp32", torch.float32)):
        row = cs.check_wkv6_bwd(torch, wops, wref, timer, gen, name, 2, 2048, 32, 64, dtype, None,
                                False, 10, 1)
        rows.append({k: row.get(k) for k in ("shape", "ms", "ms_no_wait", "blocks_ms",
                                             "reduce_ms", "bound_ms", "max_abs_err")})
    del timer
    torch.cuda.empty_cache()
    rec, launches = cs.rwkv_train_whole(torch, lm, counters, get_config, dev, tag, True)
    prof = rec["profile"]
    print("AB " + json.dumps({
        "tag": tag, "root": root, "wkv6_bwd": rows,
        "steady_step_ms": rec["steady_step_ms"], "step_ms": [r["ms"] for r in rec["steps"]],
        "tokens_per_s": rec["tokens_per_s"], "peak_memory_gb": rec["peak_memory_gb"],
        "launches": launches, "busy_ms": prof["device_busy_ms"], "traced_wall_ms": prof["wall_ms"],
        "busy_share": prof["device_busy_share"],
        "wkv6_device_ms": {e["name"].split("::")[-1].split("(")[0]: e["device_ms"]
                           for e in prof["top_device"] if "wkv6" in e["name"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
