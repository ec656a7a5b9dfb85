"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each kernel source under ``kernels/*/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``). The file name carries a hash of the source and the flags,
so an edited source builds anew and an unchanged one is loaded as it is.
``build()`` starts one ``nvcc`` per missing library, all at once.

Nothing falls back: a missing ``nvcc`` or a failed build raises
``RuntimeError``. Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = _KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"

# kernel name -> CUDA source
KERNEL_SOURCES = {
    "spmm": _KERNELS_DIR / "spmm" / "csrc" / "spmm.cu",
    "spmm_sparse": _KERNELS_DIR / "spmm" / "csrc" / "spmm_sparse.cu",
    "wkv6": _KERNELS_DIR / "wkv6" / "csrc" / "wkv6.cu",
    "flash_attention": _KERNELS_DIR / "flash_attention" / "csrc" / "flash_attention.cu",
    "stamp": _KERNELS_DIR / "stamp" / "csrc" / "stamp.cu",
    "ghost_pull": _KERNELS_DIR / "ghost_pull" / "csrc" / "ghost_pull.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> seconds nvcc took / its stderr (ptxas register and spill report)
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def library_path(name: str) -> Path:
    src = KERNEL_SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together. Returns ``build_seconds``."""
    names = list(KERNEL_SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return build_seconds
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    failed = []
    for n, (p, tmp, out, t0) in procs.items():
        log, _ = p.communicate()
        build_seconds[n] = time.perf_counter() - t0
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"{n} (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return build_seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
