"""Roofline model for NVIDIA H100 SXM meshes (port of
``repro/utils/roofline.py``, whose constants are the TPU v5e's).

Three terms per (arch, shape, mesh), all in seconds (lower bound estimates):

    compute    = hlo_flops        / (chips * PEAK_FLOPS_BF16)
    memory     = hlo_bytes        / (chips * HBM_BW)
    collective = collective_bytes / (chips * NVLINK_BW)

The field names are the reference's. In the port ``hlo_flops`` and
``hlo_bytes`` are the step's whole-program FLOPs and bytes as the dry run
counts them (``launch.dryrun``: a FLOP counter and a byte count over the
step's ops on meta tensors; there is no HLO), and ``model_flops`` the
analytic 6·N·D or 2·N·D. ``chip_smoke.py`` takes its kernels' peaks from
here as well.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

# H100 SXM5 80 GB, per GPU, dense (no sparsity), at the data sheet's boost
# clock (NVIDIA H100 Tensor Core GPU data sheet):
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, BF16 on the tensor cores
PEAK_FLOPS_TF32 = 494.7e12    # FLOP/s, TF32 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, FP32 FMA on the CUDA cores
HBM_BW = 3.35e12              # B/s, HBM3
# NVLink 4 (18 links): 900 GB/s per GPU, the bidirectional aggregate (450
# GB/s each way). The collective term reads it as the reference reads its
# per-link ICI rate: bytes over one number per chip.
NVLINK_BW = 900e9             # B/s


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float              # whole-program FLOPs (all chips)
    hlo_bytes: float              # whole-program HBM bytes accessed
    collective_bytes: float       # whole-program bytes crossing NVLink
    model_flops: float            # 6*N*D (dense) or 6*N_active*D analytic
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    def __post_init__(self):
        self.compute_s = self.hlo_flops / (self.chips * PEAK_FLOPS_BF16)
        self.memory_s = self.hlo_bytes / (self.chips * HBM_BW)
        self.collective_s = self.collective_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """model_flops / hlo_flops: how much of the counted compute is
        'useful'."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def mfu_upper_bound(self) -> float:
        """Model-FLOPs utilisation if the dominant term were the runtime."""
        t = self.bound_s
        if t <= 0:
            return 0.0
        return self.model_flops / (t * self.chips * PEAK_FLOPS_BF16)

    def row(self) -> dict:
        d = asdict(self)
        d.update(
            dominant=self.dominant,
            bound_s=self.bound_s,
            useful_flops_ratio=self.useful_flops_ratio,
            mfu_upper_bound=self.mfu_upper_bound,
        )
        return d

    def pretty(self) -> str:
        return (
            f"{self.arch:18s} {self.shape:12s} {self.mesh:10s} "
            f"comp={self.compute_s*1e3:9.3f}ms mem={self.memory_s*1e3:9.3f}ms "
            f"coll={self.collective_s*1e3:9.3f}ms dom={self.dominant:10s} "
            f"useful={self.useful_flops_ratio:6.3f} mfu<= {self.mfu_upper_bound*100:5.1f}%"
        )


def mfu(model_flops: float, seconds: float, chips: int = 1) -> float:
    """Model-FLOPs utilisation of a measured step: ``model_flops`` over
    what ``chips`` cards at the bf16 peak do in ``seconds``."""
    return model_flops / (seconds * chips * PEAK_FLOPS_BF16)


def model_flops_dense(n_params: int, tokens: int) -> float:
    """Standard 6*N*D estimate for a dense decoder train step."""
    return 6.0 * n_params * tokens


def model_flops_forward(n_params: int, tokens: int) -> float:
    """2*N*D for inference (prefill/decode) steps."""
    return 2.0 * n_params * tokens
