"""conv3x3_roofline.tcm on the CPU: the 3x3 stride-1 convolutions that
``conv3x3_work`` counts at a tiny TCM width against a count by hand, the
bound it gives, and the reader on synthetic traces: nothing for the paper
codec's loop or a trace without the kernel, the expected share with it."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import conv3x3_work  # noqa: E402
import run  # noqa: E402
import work  # noqa: E402

TINY = {"N": 16, "M": 40, "config": [1, 2, 1, 1, 2, 1],
        "head_dim": [8] * 6, "window_size": 8, "hyper_window": 4,
        "hyper_head_dim": 8, "num_slices": 5, "max_support_slices": 5,
        "atten_dim": 16, "atten_head_dim": 8}


def _by_hand(wd, b, h, w):
    """FLOPs of one call's 3x3 stride-1 convolutions, layer by layer."""
    n, m, cfg = wd["N"], wd["M"], wd["config"]
    sw, s = m // wd["num_slices"], wd["num_slices"]

    def f(ci, co, lv):
        return 2 * b * (h >> lv) * (w >> lv) * co * 9 * ci

    g_a = sum(f(2 * n, 2 * n, lv) + 2 * c * f(n, n, lv)
              for lv, c in ((1, cfg[0]), (2, cfg[1]), (3, cfg[2])))
    # g_s: each upsampling block's two subpel convolutions at the coarser
    # level and its 3x3 at the finer, the stage's residual blocks, the
    # final subpel to 3 x 4 channels
    g_s = (2 * f(m, 8 * n, 4) + f(2 * n, 2 * n, 3)
           + 2 * cfg[3] * f(n, n, 3) + 2 * f(2 * n, 8 * n, 3)
           + f(2 * n, 2 * n, 2) + 2 * cfg[4] * f(n, n, 2)
           + 2 * f(2 * n, 8 * n, 2) + f(2 * n, 2 * n, 1)
           + 2 * cfg[5] * f(n, n, 1) + f(2 * n, 12, 1))
    h_a = f(2 * n, 2 * n, 5) + 2 * cfg[0] * f(n, n, 5)
    h_s = (2 * f(192, 8 * n, 6) + f(2 * n, 2 * n, 5) + 2 * cfg[3] * f(n, n, 5)
           + f(2 * n, 4 * m, 5))
    slices = 0
    for i in range(s):
        cin = m + sw * min(i, wd["max_support_slices"])
        for c in (cin, cin, cin + sw):     # cc_mean, cc_scale, lrp
            slices += f(c, 224, 4) + f(224, 128, 4) + f(128, sw, 4)
    return g_a + h_a + 2 * (2 * h_s + slices) + g_s


def test_the_count_at_a_tiny_width():
    got = conv3x3_work.convs(TINY, 2, 256, 384)
    flops = sum(conv3x3_work.conv_work(*c)[0] for c in got)
    assert flops == _by_hand(TINY, 2, 256, 384)
    assert all(c[0] == 2 for c in got)         # one launch over the batch
    one = conv3x3_work.bound_s(TINY, 1, 256, 384)
    assert 0 < one < conv3x3_work.bound_s(TINY, 2, 256, 384) <= 2 * one


def test_the_cell_s_bound_is_operations():
    widths = run.resolve(run.benchmark(), "tcm-b16-opaque")["config"]["model"]
    c = conv3x3_work.convs(widths, 16, 512, 768)
    flops = sum(conv3x3_work.conv_work(*x)[0] for x in c)
    # ~1036 GFLOP an image: g_s ~618, g_a ~305, the slice chains ~57 a side
    assert 0.95e12 < flops / 16 < 1.12e12
    assert conv3x3_work.bound_s(widths, 16, 512, 768) == pytest.approx(
        flops / work.PEAK_TF32, rel=0.01)


def _run(loop, by_name, calls=2):
    widths = run.resolve(run.benchmark(), "tcm-b16-opaque")["config"]["model"]
    return SimpleNamespace(
        trace=None if by_name is None else {"by_name": by_name},
        traffic={"loop": loop, "batch": 1, "height": 256, "width": 256},
        config={"model": widths}, calls=[None] * calls)


def test_the_reader():
    reader = run.load_file(run.reader_path("conv3x3_roofline.tcm"), "m_conv")
    kname = "void (anonymous namespace)::conv3x3_tf32_kernel<128>(float const*)"
    assert reader.read(_run("codec", {kname: 1.0})) is None
    assert reader.read(_run("codec_tcm", None)) is None
    other = {"gdn_tf32_kernel<192, 1>": 1.0}
    assert reader.read(_run("codec_tcm", other)) is None
    r = _run("codec_tcm", {kname: 0.5, "void cudnn::conv3x3_like": 9.0})
    bound = conv3x3_work.bound_s(r.config["model"], 1, 256, 256)
    assert reader.read(r) == pytest.approx(100 * bound * 2 / 0.5)
