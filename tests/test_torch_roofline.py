"""The port's roofline (``repro_torch.utils.roofline``) against the
reference's (``repro.utils.roofline``): the same terms with the H100's
constants in place of the v5e's, the reference's row keys, and the
analytic model FLOPs. ``chip_smoke.py`` takes its peaks from the module."""
import importlib.util
from pathlib import Path

import pytest

from repro.utils import roofline as jroof
from repro_torch.utils import roofline as troof

ROOT = Path(__file__).resolve().parents[1]
H100 = troof.PEAK_FLOPS_BF16


def _report(mod, peak, bw, link, chips=256, mesh="pod1"):
    return mod.RooflineReport(arch="x", shape="train_4k", mesh=mesh, chips=chips,
                              hlo_flops=chips * peak,                # exactly 1s compute
                              hlo_bytes=chips * bw * 0.5,            # 0.5s memory
                              collective_bytes=chips * link * 0.25,
                              model_flops=chips * peak * 0.8)


def test_h100_constants():
    assert troof.PEAK_FLOPS_BF16 == 989e12
    assert troof.PEAK_FLOPS_TF32 == 494.7e12
    assert troof.PEAK_FLOPS_FP32 == 67e12
    assert troof.HBM_BW == 3.35e12
    assert troof.NVLINK_BW == 900e9


@pytest.mark.parametrize("chips", [1, 256, 512])
def test_roofline_report_terms(chips):
    """The reference's ``test_roofline_report_terms`` with the H100's
    constants."""
    r = _report(troof, troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.NVLINK_BW, chips)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(0.5)
    assert r.collective_s == pytest.approx(0.25)
    assert r.dominant == "compute"
    assert r.bound_s == pytest.approx(1.0)
    assert r.useful_flops_ratio == pytest.approx(0.8)
    assert r.mfu_upper_bound == pytest.approx(0.8)


@pytest.mark.parametrize("scale,dominant", [((1.0, 2.0, 0.1), "memory"),
                                            ((1.0, 0.1, 3.0), "collective"),
                                            ((0.0, 0.0, 0.0), "compute")])
def test_dominant_and_degenerate_terms(scale, dominant):
    c, m, k = scale
    r = troof.RooflineReport(arch="x", shape="s", mesh="m", chips=2,
                             hlo_flops=2 * H100 * c, hlo_bytes=2 * troof.HBM_BW * m,
                             collective_bytes=2 * troof.NVLINK_BW * k, model_flops=H100)
    assert r.dominant == dominant
    assert r.bound_s == pytest.approx(max(scale))
    if not any(scale):
        assert r.useful_flops_ratio == 0.0 and r.mfu_upper_bound == 0.0


def test_row_has_the_reference_keys_and_the_same_ratios():
    """Both rows from one set of terms in seconds: the same keys, the same
    terms, ratios and dominant term."""
    ref = _report(jroof, jroof.PEAK_FLOPS_BF16, jroof.HBM_BW, jroof.ICI_BW)
    port = _report(troof, troof.PEAK_FLOPS_BF16, troof.HBM_BW, troof.NVLINK_BW)
    jrow, trow = ref.row(), port.row()
    assert set(trow) == set(jrow)
    for k in ("compute_s", "memory_s", "collective_s", "bound_s", "useful_flops_ratio",
              "mfu_upper_bound", "chips"):
        assert trow[k] == pytest.approx(jrow[k]), k
    assert trow["dominant"] == jrow["dominant"]
    assert port.pretty().split()[:3] == ref.pretty().split()[:3]


@pytest.mark.parametrize("n,tokens", [(1_600_000_000, 4096), (11_766_000_000, 8192), (7, 1)])
def test_model_flops_and_mfu(n, tokens):
    assert troof.model_flops_dense(n, tokens) == jroof.model_flops_dense(n, tokens)
    assert troof.model_flops_forward(n, tokens) == jroof.model_flops_forward(n, tokens)
    flops = troof.model_flops_dense(n, tokens)
    assert troof.mfu(flops, flops / H100) == pytest.approx(1.0)
    assert troof.mfu(flops, flops / H100, chips=4) == pytest.approx(0.25)


def test_chip_smoke_takes_its_peaks_from_the_module():
    spec = importlib.util.spec_from_file_location("chip_smoke_for_test", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.PEAK_BF16_FLOPS == troof.PEAK_FLOPS_BF16
    assert cs.PEAK_TF32_FLOPS == troof.PEAK_FLOPS_TF32
    assert cs.PEAK_FP32_FLOPS == troof.PEAK_FLOPS_FP32
    assert cs.PEAK_BYTES_PER_S == troof.HBM_BW
    assert cs.FP32_MM_FLOPS == max(troof.PEAK_FLOPS_FP32, troof.PEAK_FLOPS_TF32 / 3)
