"""The 3x3 stride-1 fp32 kernel (``ops/kernels/conv3x3.py``) on a card: at
every (Cin, Cout, H, W) of its class that TCM and the paper's codec run at
512x768 (and the sticker's 512x512), as close to a float64 convolution as
cuDNN's fp32 convolution is, within twice its error; each image's output
the same bits at batch 1, 4 and 16 and in every place of the batch;
captured and replayed in a CUDA graph; and one launch per convolution of
a codec call, not one per image.

Needs an NVIDIA GPU with nvcc and skips without one; imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_conv3x3_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from rgba_tpu_torch.core.precision import (DEFAULT_POLICY,  # noqa: E402
                                           batch_invariant_scope,
                                           deterministic_scope,
                                           precision_scope)
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.tcm import TCM  # noqa: E402
from rgba_tpu_torch.ops.conv import Conv, conv2d, per_image  # noqa: E402
from rgba_tpu_torch.ops.kernels import conv3x3 as k3  # noqa: E402

pytestmark = pytest.mark.cuda

# (Cin, Cout, H, W): TCM at 512x768 (g_a, g_s, the hyper transforms, the
# slice transforms), the paper's codec (slices and hyper syntheses at
# 512x768, slices of the 512x512 sticker)
TCM_SHAPES = sorted({
    (256, 256, 256, 384), (128, 128, 256, 384), (256, 12, 256, 384),
    (256, 256, 128, 192), (128, 128, 128, 192), (256, 1024, 128, 192),
    (256, 256, 64, 96), (128, 128, 64, 96), (256, 1024, 64, 96),
    (320, 1024, 32, 48), (256, 256, 16, 24), (128, 128, 16, 24),
    (192, 1024, 8, 12), (256, 1280, 16, 24),
    *((320 + 64 * i, 224, 32, 48) for i in range(5)),
    *((384 + 64 * i, 224, 32, 48) for i in range(5)),
    (224, 128, 32, 48), (128, 64, 32, 48)})
PAPER_SHAPES = sorted({
    *((80 + 8 * i, 224, 64, 96) for i in range(7)),
    *((80 + 16 * i, 224, 64, 96) for i in range(6)),
    (224, 128, 64, 96), (128, 8, 64, 96), (128, 16, 64, 96),
    (320, 288, 32, 48), (256, 224, 16, 24),
    (192, 768, 8, 12), (192, 224, 16, 24), (224, 1024, 16, 24),
    (256, 288, 32, 48), (288, 320, 32, 48),
    (120, 224, 64, 64), (224, 128, 64, 64), (128, 8, 64, 64)})


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    with precision_scope(DEFAULT_POLICY), deterministic_scope():
        yield torch.device("cuda")


def _inputs(card, b, ci, co, h, w, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(b, ci, h, w, device=card, generator=g).contiguous(
        memory_format=torch.channels_last)
    wt = torch.randn(co, ci, 3, 3, device=card, generator=g) / (9 * ci) ** 0.5
    bias = 0.1 * torch.randn(co, device=card, generator=g)
    return x, wt, bias


@pytest.mark.parametrize("ci,co,h,w",
                         sorted(set(TCM_SHAPES) | set(PAPER_SHAPES)))
def test_against_float64(card, ci, co, h, w):
    """Two images: the kernel's largest error against float64 is at most
    twice cuDNN's fp32 (TF32 off) own."""
    x, wt, bias = _inputs(card, 2, ci, co, h, w)
    with torch.inference_mode():
        ref = F.conv2d(x.double(), wt.double(), bias.double(), 1, 1)
        got = k3.conv3x3(x, wt, bias)
        cudnn = F.conv2d(x, wt, bias, 1, 1)
    assert got.shape == ref.shape
    err = float((got.double() - ref).abs().max())
    assert err <= 2 * float((cudnn.double() - ref).abs().max()), err


@pytest.mark.parametrize("ci,co,h,w", [(128, 128, 32, 48), (256, 12, 16, 24),
                                       (120, 224, 8, 12), (64, 1024, 9, 13)])
def test_each_image_alike_in_any_batch(card, ci, co, h, w):
    """16 images at batch 16, in four batches of 4 and one by one: each
    image's output the same bits wherever it sits."""
    x, wt, bias = _inputs(card, 16, ci, co, h, w, seed=1)
    with torch.inference_mode():
        prep = k3.kernel_weights(wt)
        whole = k3.conv3x3(x, wt, bias, prep)
        fours = torch.cat([k3.conv3x3(x[i:i + 4], wt, bias, prep)
                           for i in range(0, 16, 4)])
        ones = torch.cat([k3.conv3x3(x[i:i + 1], wt, bias, prep)
                          for i in range(16)])
        # image 0 in every place of a batch of 16 whose others differ
        moved = [k3.conv3x3(torch.roll(x, i, 0), wt, bias, prep)[i]
                 for i in range(16)]
    assert torch.equal(whole, fours) and torch.equal(whole, ones)
    for m in moved:
        assert torch.equal(m, whole[0])


def test_captured_and_replayed(card):
    """A CUDA graph of one launch replays the eager result for new inputs."""
    x, wt, bias = _inputs(card, 4, 128, 224, 32, 48, seed=2)
    with torch.inference_mode():
        prep = k3.kernel_weights(wt)
        static = x.clone()
        k3.conv3x3(static, wt, bias, prep)          # built and warmed
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        before = k3.KERNEL.launches
        with torch.cuda.graph(graph):
            out = k3.conv3x3(static, wt, bias, prep)
        for seed in (3, 4):
            new = _inputs(card, 4, 128, 224, 32, 48, seed=seed)[0]
            static.copy_(new)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, k3.conv3x3(new, wt, bias, prep))
    assert k3.KERNEL.launches > before


def test_a_layout_asked_for_inside_a_capture_is_not_kept(card):
    """A ``Conv`` whose first routed call is captured (a codec step whose
    eager call ran on another worker) builds its weight layout inside the
    graph and keeps none: the graph fills it at each replay, which gives
    the eager result, and the next eager call keeps its own."""
    x, wt, bias = _inputs(card, 2, 64, 96, 16, 24, seed=5)
    conv = Conv(64, 96, 3, 1, policy=DEFAULT_POLICY, device=card,
                generator=torch.Generator().manual_seed(0))
    with torch.inference_mode(), batch_invariant_scope():
        k3.conv3x3(x, wt, bias)                     # the library, loaded
        static = x.clone()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = conv(static)
        assert conv._kernel_cache == (None, None)
        graph.replay()
        torch.cuda.synchronize()
        want = conv(x)
        assert conv._kernel_cache[0] is not None
        assert torch.equal(out, want)


def test_routed_only_inside_the_scope(card):
    """``Conv`` 3x3 / stride 1 takes the kernel inside the scope and cuDNN
    outside it; a 5x5 stride-2 ``Conv`` never takes it, nor a plain path's
    ``conv2d`` call without the module; a Cin the kernel cannot take
    raises."""
    kw = dict(policy=DEFAULT_POLICY, device=card,
              generator=torch.Generator().manual_seed(0))
    conv, strided = Conv(64, 96, 3, 1, **kw), Conv(64, 96, 5, 2, **kw)
    x = _inputs(card, 3, 64, 96, 16, 24)[0]
    with torch.inference_mode():
        before = k3.KERNEL.launches
        plain = conv(x)
        strided(x)
        assert k3.KERNEL.launches == before
        with batch_invariant_scope():
            got = conv(x)
            strided(x)
            assert k3.KERNEL.launches == before + 1
            conv2d(x, conv.weight, conv.bias, DEFAULT_POLICY, 1, 1)
            assert k3.KERNEL.launches == before + 1
            want = per_image(lambda t: F.conv2d(t, conv.weight, conv.bias,
                                                1, 1), x)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    assert float((got - plain).abs().max()) <= 1e-4 * float(want.abs().max())
    assert got.is_contiguous(memory_format=torch.channels_last)
    odd = Conv(12, 16, 3, 1, **kw)
    with pytest.raises(ValueError):
        with torch.inference_mode(), batch_invariant_scope():
            odd(torch.zeros(1, 12, 8, 8, device=card))


def _stride1_3x3_calls(model, run):
    """(3x3 stride-1 padding-1 Conv forwards, kernel launches) of run()."""
    calls = [0]

    def hook(mod, args, out):
        calls[0] += 1
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Conv) and tuple(m.weight.shape[-2:]) == (3, 3)
             and m.stride == 1 and m.padding == 1]
    before = k3.KERNEL.launches
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return calls[0], k3.KERNEL.launches - before


def _u8(batch, h, w, seed, opaque=False):
    d = synthetic_rgba_batch(batch, h, w, seed=seed)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = (np.full(img.shape[:3] + (1,), 255, np.uint8) if opaque else
             np.round(d["alpha"] * 255).astype(np.uint8))
    return img, alpha


def test_one_launch_per_convolution_of_a_tcm_call(card):
    """An eager TCM round trip of 2 images launches the kernel once per
    3x3 stride-1 convolution it runs, and a replayed one as often."""
    policy = dataclasses.replace(DEFAULT_POLICY, fused_win_attn=True,
                                 fused_gdn=True, fused_gate_chain=True)
    model = TCM(policy=policy, device=card,
                generator=torch.Generator().manual_seed(0)).eval()
    img, alpha = _u8(2, 256, 256, seed=3, opaque=True)
    codec = RGBAFileCodec(CodecIO(model, "rgb"))
    counts = []
    for _ in range(3):      # eager, captured, replayed
        counts.append(_stride1_3x3_calls(model, lambda: codec.decode_batch(
            codec.encode_batch(img, alpha))))
    convs, launches = counts[0]
    assert convs > 0 and launches == convs
    assert counts[2][1] == launches
    codec.rgb_io.close()


def test_one_launch_per_convolution_of_a_paper_call(card):
    """The paper's codec (RGB and mask) likewise: its slice transforms and
    hyper syntheses launch the kernel once per convolution."""
    policy = dataclasses.replace(DEFAULT_POLICY, fused_win_attn=True,
                                 fused_gdn=True, fused_gate_chain=True,
                                 fused_dse=True, packed_dse=False)
    pipe = RGBAPipeline(policy, seed=0).eval()
    img, alpha = _u8(2, 256, 256, seed=4)
    codec = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                          CodecIO(pipe.mask_codec, "mask"))
    counts = []
    for _ in range(3):
        counts.append(_stride1_3x3_calls(pipe, lambda: codec.decode_batch(
            codec.encode_batch(img, alpha))))
    convs, launches = counts[0]
    assert convs > 0 and launches == convs
    assert counts[2][1] == launches
    codec.rgb_io.close()
    codec.mask_io.close()
