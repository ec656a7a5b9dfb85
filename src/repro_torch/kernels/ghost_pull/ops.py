"""Public wrapper for the one-pass ghost pull kernel.

``ghost_pull(feats_all, hist1_all, ghost_owner, ghost_row, ghost_mask, need,
ghost_feat, hist1, n_max)`` is one client's tau-gated sync (FedAIS
Algorithm 1, lines 15-17): it returns ``(new_ghost_feat, new_hist1)``, where
ghost slot ``s`` with ``need[s] > 0`` takes the owner's round-start rows
``feats_all[max(owner[s], 0), row[s]] * ghost_mask[s]`` and
``hist1_all[...]`` (as layer-1 row ``n_max + s``), and every other row is
the old one. The inputs are left as they were.

On CUDA tensors it launches the hand-written kernel (``csrc/ghost_pull.cu``,
built by ``kernels/build.py``): one launch writes both outputs, each output
row once, reading each row that feeds it once. On other tensors (the CPU,
the dry run's meta tensors) it runs the plain version ``ref.ghost_pull_ref``,
which gathers, masks and selects as separate ops; the two give the same
bits. There is no other fallback: a CUDA tensor of the wrong type, shape,
layout or device, or a failed build or launch, raises. The launch reads
nothing back, so it can be captured into a CUDA graph.

``ghost_pull.launches`` counts kernel launches (the plain version never
moves it). A launch recorded into a CUDA graph under capture runs nothing
then: it adds to ``ghost_pull.captured`` instead, and the graph's owner
(``api.fused``) adds the launches it captured to ``launches`` each time it
replays the graph.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ghost_pull.ref import ghost_pull_ref

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.kernels import build

        lib = build.load("ghost_pull")
        fn = lib.ghost_pull_f32
        # 8 inputs, 2 outputs; k_feat, feat_rows, k_hist, hist_rows, g, n_max, F, H; stream
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ghost_pull_error_string.argtypes = [ctypes.c_int]
        lib.ghost_pull_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ghost_pull_error_string)
    return _fn


def _check(feats_all, hist1_all, ghost_owner, ghost_row, ghost_mask, need, ghost_feat,
           hist1, n_max) -> None:
    named = {"feats_all": feats_all, "hist1_all": hist1_all, "ghost_owner": ghost_owner,
             "ghost_row": ghost_row, "ghost_mask": ghost_mask, "need": need,
             "ghost_feat": ghost_feat, "hist1": hist1}
    dev = feats_all.device
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"ghost_pull: {name} on {t.device}, feats_all on {dev}; all "
                             "must be on one CUDA device (or off CUDA)")
        want = torch.int32 if name in ("ghost_owner", "ghost_row") else torch.float32
        if t.dtype != want:
            raise TypeError(f"ghost_pull kernel takes {name} as {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"ghost_pull: {name} must be contiguous")
    g = ghost_owner.shape[0] if ghost_owner.ndim == 1 else -1
    if (feats_all.ndim != 3 or hist1_all.ndim != 3 or g < 0
            or any(tuple(t.shape) != (g,) for t in (ghost_row, ghost_mask, need))
            or ghost_feat.ndim != 2 or tuple(ghost_feat.shape) != (g, feats_all.shape[2])
            or hist1.ndim != 2
            or tuple(hist1.shape) != (n_max + g, hist1_all.shape[2])):
        raise ValueError(
            f"ghost_pull: bad shapes feats_all {tuple(feats_all.shape)}, hist1_all "
            f"{tuple(hist1_all.shape)}, owner/row/mask/need {tuple(ghost_owner.shape)}/"
            f"{tuple(ghost_row.shape)}/{tuple(ghost_mask.shape)}/{tuple(need.shape)}, "
            f"ghost_feat {tuple(ghost_feat.shape)}, hist1 {tuple(hist1.shape)}, n_max {n_max}")


def ghost_pull(feats_all: torch.Tensor, hist1_all: torch.Tensor, ghost_owner: torch.Tensor,
               ghost_row: torch.Tensor, ghost_mask: torch.Tensor, need: torch.Tensor,
               ghost_feat: torch.Tensor, hist1: torch.Tensor,
               n_max: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(new ghost_feat (g, F), new hist1 (n_max + g, H1)) from the round-start
    sources ``feats_all`` (K, rows, F) and ``hist1_all`` (K', rows', H1), the
    slots' int32 ``ghost_owner`` / ``ghost_row`` and fp32 ``ghost_mask`` /
    ``need`` (g,), and the client's current ``ghost_feat`` and ``hist1``.
    On CUDA the outputs are allocated with ``torch.empty`` and the kernel
    runs on the current stream, without a synchronise."""
    if feats_all.device.type != "cuda":
        return ghost_pull_ref(feats_all, hist1_all, ghost_owner, ghost_row, ghost_mask,
                              need, ghost_feat, hist1, n_max)
    _check(feats_all, hist1_all, ghost_owner, ghost_row, ghost_mask, need, ghost_feat,
           hist1, n_max)
    out_feat = torch.empty_like(ghost_feat)
    out_hist1 = torch.empty_like(hist1)
    fn, err_str = _kernel()
    rc = fn(feats_all.data_ptr(), hist1_all.data_ptr(), ghost_owner.data_ptr(),
            ghost_row.data_ptr(), ghost_mask.data_ptr(), need.data_ptr(),
            ghost_feat.data_ptr(), hist1.data_ptr(), out_feat.data_ptr(), out_hist1.data_ptr(),
            *feats_all.shape[:2], *hist1_all.shape[:2], ghost_owner.shape[0], n_max,
            feats_all.shape[2], hist1_all.shape[2],
            torch.cuda.current_stream(feats_all.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ghost_pull_f32 launch failed: {err_str(rc).decode()} "
                           f"(cudaError {rc})")
    if torch.cuda.is_current_stream_capturing():
        ghost_pull.captured += 1
    else:
        ghost_pull.launches += 1
    return out_feat, out_hist1


ghost_pull.launches = 0
ghost_pull.captured = 0
