"""The port's roofline terms (``repro_torch.launch.roofline``) and analytic
FLOP/traffic models (``repro_torch.launch.analytic``): the reference's six
cases on the H100's figures, passed as parameters, and both models ``==``
the reference's on every (arch, shape) cell, skipped cells included."""

import pytest

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.launch import analytic as janalytic
from repro.launch.settings import SHAPES as JSHAPES
from repro.launch.settings import cell_skipped as jcell_skipped
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import analytic, roofline
from repro_torch.launch.analytic import (analytic_bytes_per_device,
                                         analytic_flops_global)
from repro_torch.launch.settings import SHAPES, cell_skipped

# the H100 figures, passed explicitly so that each case names what it uses
H100 = dict(peak_flops=989e12, hbm_bw=3.35e12, nvlink_bw=450e9, ib_bw=50e9,
            gpus_per_node=8)


def _row(arch="granite-3-2b", shape="train_4k", flops=1e12, nbytes=1e11,
         coll=1e9, model=1e15):
    return {
        "arch": arch, "shape": shape,
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": nbytes,
        "collectives": {"effective_bytes_per_device": coll},
        "model_flops_global": model,
    }


def test_terms_and_dominance():
    t = roofline.roofline_terms(_row(), 256, **H100)
    assert t["t_compute_s"] == pytest.approx(1e12 / H100["peak_flops"])
    # a row without the per-axis split puts its bytes on the slowest link
    assert t["t_collective_s"] == pytest.approx(1e9 / H100["ib_bw"])
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0.0 <= t["roofline_fraction"] <= 1.0 + 1e-9
    assert t["fraction_resource"] >= t["roofline_fraction"]


def test_negative_collective_clamped_and_flagged():
    t = roofline.roofline_terms(_row(coll=-5e9), 256, **H100)
    assert t["t_collective_s"] == 0.0
    assert t["collective_nonlinear_flag"] is True


def test_analytic_models_cover_every_cell():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            if cell_skipped(arch, shape):
                continue
            b = analytic_bytes_per_device(arch, shape)
            f = analytic_flops_global(arch, shape)
            assert b > 0 and f > 0, (arch, shape)


def test_analytic_flops_scaling_relations():
    # attention-free arch: train/prefill process the same 1M tokens, so the
    # ratio is exactly the bwd(2x)+remat(1x) factor = 4x
    f_train = analytic_flops_global("falcon-mamba-7b", "train_4k")
    f_prefill = analytic_flops_global("falcon-mamba-7b", "prefill_32k")
    assert f_train == pytest.approx(4.0 * f_prefill, rel=1e-6)
    # attention arch: prefill's 8x-longer sequences add quadratic work,
    # shrinking the ratio below 4 but keeping it above 1
    f_train_a = analytic_flops_global("granite-3-2b", "train_4k")
    f_prefill_a = analytic_flops_global("granite-3-2b", "prefill_32k")
    assert 1.0 < f_train_a / f_prefill_a < 4.0
    # decode processes B tokens, not B*S
    f_decode = analytic_flops_global("granite-3-2b", "decode_32k")
    assert f_decode < f_prefill_a / 1000


def test_analytic_memory_decode_dominated_by_weights_and_cache():
    b = analytic_bytes_per_device("granite-20b", "decode_32k")
    # must at least stream the TP-sharded active weights once
    cfg = get_config("granite-20b")
    assert b >= cfg.active_param_count() * 2 / 16


def test_memory_term_prefers_analytic_model():
    t = roofline.roofline_terms(_row(nbytes=1e14), 256, **H100)   # inflated
    assert t["t_memory_hlo_upper_s"] == pytest.approx(1e14 / H100["hbm_bw"])
    assert t["t_memory_s"] < t["t_memory_hlo_upper_s"]


def test_defaults_are_the_h100_figures():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.IB_BW, roofline.GPUS_PER_NODE) == tuple(H100.values())
    assert roofline.roofline_terms(_row(), 256) == \
        roofline.roofline_terms(_row(), 256, **H100)


@pytest.mark.parametrize("axes,sizes,want", [
    (("model",), {"data": 16, "model": 16}, "ib_bw"),     # two nodes
    (("data",), {"data": 16, "model": 16}, "ib_bw"),      # stride 16
    (("pod", "data"), {"pod": 2, "data": 16, "model": 16}, "ib_bw"),
    (("model",), {"data": 32, "model": 8}, "nvlink_bw"),  # one node
    (("data",), {"data": 2, "model": 4}, "nvlink_bw"),    # 8 ranks in all
    (("data",), {"data": 4, "model": 4}, "ib_bw"),        # stride 4, 16
])
def test_each_axis_takes_the_slowest_link_it_spans(axes, sizes, want):
    assert roofline.link_bw(axes, sizes, **{k: H100[k] for k in (
        "nvlink_bw", "ib_bw", "gpus_per_node")}) == H100[want]


def test_collective_term_sums_each_axis_over_its_link():
    row = _row()
    row["axis_sizes"] = {"data": 32, "model": 8}
    row["collectives"] = {"effective_bytes_per_device": 3e9, "by_axis": {
        "model": {"effective_bytes_per_device": 1e9},
        "data": {"effective_bytes_per_device": 2e9}}}
    t = roofline.roofline_terms(row, 256, **H100)
    assert t["t_collective_s"] == pytest.approx(1e9 / 450e9 + 2e9 / 50e9)


def test_the_same_arch_and_shape_lists_as_the_reference():
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    assert SHAPES == JSHAPES


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", JARCH_IDS)
def test_analytic_models_equal_the_reference(arch, shape):
    """Bytes, FLOPs and the skip reason ``==`` the reference on every
    cell, skipped cells included (the models are defined there too)."""
    assert cell_skipped(arch, shape) == jcell_skipped(arch, shape)
    assert analytic_bytes_per_device(arch, shape) == \
        janalytic.analytic_bytes_per_device(arch, shape)
    assert analytic_flops_global(arch, shape) == \
        janalytic.analytic_flops_global(arch, shape)
    sh = dict(SHAPES[shape])
    assert analytic_bytes_per_device(arch, sh) == \
        analytic_bytes_per_device(arch, shape)
    assert (analytic.MODEL_AX, analytic.DP_AX, analytic.CHIPS) == \
        (janalytic.MODEL_AX, janalytic.DP_AX, janalytic.CHIPS) == \
        (16, 16, 256)
