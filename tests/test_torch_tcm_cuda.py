"""TCM (``rgba_tpu_torch/models/tcm.py``) on a card: the kernels at the
geometries it adds (window attention at C=128 with head dims 8, 16 and 32
over windows of 8 and 4, GDN at C=256, the gate chain at C=128 with ReLU
and post-activation) against their plain versions, the codec at the
published widths replayed from CUDA graphs byte for byte against the eager
codec and alike in any batch, and the paper's codec launching its kernels
as before.

Needs an NVIDIA GPU with nvcc and skips without one; imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_tcm_cuda.py

Tolerances, as tests/test_torch_kernels_cuda.py: fp32 2e-5 + 2e-5*|ref|;
bf16 2^-5 * max(1, max|ref|).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402
from rgba_tpu_torch.eval.container import RGBAFileCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.tcm import TCM  # noqa: E402
from rgba_tpu_torch.ops import window  # noqa: E402
from rgba_tpu_torch.ops.kernels import dse, gate_chain, gdn, win_attn  # noqa: E402

pytestmark = pytest.mark.cuda

KERNELS = (win_attn, gdn, gate_chain, dse)
TCM_POLICY = dataclasses.replace(DEFAULT_POLICY, fused_win_attn=True,
                                 fused_gdn=True, fused_gate_chain=True)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (CUDA kernels have no CPU mode)")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 plain versions exact
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = saved


def _assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        assert bool((err <= 2e-5 + 2e-5 * want.abs()).all()), float(err.max())
    else:
        assert float(err.max()) <= 2.0 ** -5 * max(1.0, float(want.abs().max()))


def _launches():
    return tuple(k.KERNEL.launches for k in KERNELS)


# ------------------------------------------------------------- kernels

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ws,nh", [(8, 16), (8, 8), (8, 4), (4, 4)])
def test_window_attention_at_tcms_widths(card, dtype, ws, nh):
    """C=128 with head dims 8, 16 and 32 (16, 8 and 4 heads), windows of
    8 and 4, the shifted windows' region ids and every window alive."""
    c, n, b = 128, ws * ws, 2
    h, w = 4 * ws, 6 * ws
    g = torch.Generator().manual_seed(ws * nh)
    region = torch.from_numpy(window.swin_region_ids(h, w, ws, ws // 2))
    region = region.repeat(b, 1).to(card)
    nw = region.shape[0]
    args = [torch.randn(nw, n, c, generator=g).to(card, dtype), region,
            torch.ones(nw, 1, device=card),
            (torch.randn(c, 3 * c, generator=g) / c ** 0.5).to(card, dtype),
            (0.1 * torch.randn(3 * c, generator=g)).to(card),
            (torch.randn(c, c, generator=g) / c ** 0.5).to(card, dtype),
            (0.1 * torch.randn(c, generator=g)).to(card),
            torch.randn(nh, n, n, generator=g).to(card)]
    got = win_attn.fused_window_attention(*args, num_heads=nh)
    _assert_close(got, win_attn.window_attention_plain(*args, num_heads=nh),
                  dtype)
    # a window's output does not depend on the windows launched with it
    half = win_attn.fused_window_attention(
        args[0][:nw // 2].contiguous(), region[:nw // 2], args[2][:nw // 2],
        *args[3:], num_heads=nh)
    assert torch.equal(half, got[:nw // 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [1, 129, 1001, 128 * 192])
def test_gdn_at_256_channels(card, dtype, inverse, m):
    """GDN past 192 channels (two passes of 128 output channels), ragged
    row counts included; a row gives the same bits in any launch."""
    c = 256
    g = torch.Generator().manual_seed(m)
    x = torch.randn(m, c, generator=g).to(card, dtype)
    gt = (0.1 * torch.eye(c) + 1e-3 * torch.rand(c, c, generator=g)).to(card)
    beta = (1.0 + 0.1 * torch.rand(c, generator=g)).to(card)
    before = gdn.KERNEL.launches
    got = gdn.fused_gdn(x, gt, beta, inverse)
    assert gdn.KERNEL.launches == before + 1
    _assert_close(got, gdn.gdn_plain(x, gt, beta, inverse), dtype)
    part = gdn.fused_gdn(x[: (m + 1) // 2].contiguous(), gt, beta, inverse)
    assert torch.equal(part, got[: (m + 1) // 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gate_chain_relu_post_activation_at_128(card, dtype):
    """SWAtten's gate: ReLU units with post-activation at C=128, with g; an
    image gives the same bits alone as in its batch."""
    from rgba_tpu_torch.ops.swin import SWAtten
    gate = SWAtten(192, policy=TCM_POLICY, device=card,
                   generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 9, 13, 128, generator=g).to(card, dtype)
    z = torch.randn(3, 9, 13, 128, generator=g).to(card, dtype)
    with torch.inference_mode():
        weights = gate.gate_chain_weights()
        got = gate_chain.fused_gate_chain(x, z, *weights, "relu", True)
        _assert_close(got, gate_chain.gate_chain_plain(
            x, z, *weights, "relu", True), dtype)
        alone = gate_chain.fused_gate_chain(x[1:2].contiguous(),
                                            z[1:2].contiguous(), *weights,
                                            "relu", True)
    assert torch.equal(alone, got[1:2])


# --------------------------------------------------------------- codec

def _live_tcm(model, seed=1, gain=0.9):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.add_((0.02 * torch.randn(p.shape, generator=g)).to(p.device))
        model.g_a[-1].weight.mul_(gain)
        model.g_s[-1][0].bias.fill_(0.5)
    return model.eval()


@pytest.fixture(scope="module")
def tcm(card):
    return _live_tcm(TCM(policy=TCM_POLICY, device=card,
                         generator=torch.Generator().manual_seed(0)))


def _opaque(batch, h, w, seed):
    d = synthetic_rgba_batch(batch, h, w, seed=seed)
    img = np.round(d["image"] * 255).astype(np.uint8)
    return img, np.full(img.shape[:3] + (1,), 255, np.uint8)


def _tcm_codec(model, graphs=True):
    io = CodecIO(model, "rgb")
    if not graphs:
        io.graphs.backend = None
    return RGBAFileCodec(io)


def test_tcm_replays_equal_the_eager_codec(tcm):
    """Published widths: four calls of a capturing codec give the eager
    codec's blobs and uint8 RGBA byte for byte, with the eager codec's
    kernel launches a call (window attention, GDN and gate chain, no DSE);
    once captured a call replays 8 steps: the encode pass, the chain's
    first step, 5 slice steps and the image."""
    img, alpha = _opaque(2, 256, 384, seed=3)
    eager = _tcm_codec(tcm, graphs=False)
    before = _launches()
    want = eager.encode_batch(img, alpha)
    want_rgba = eager.decode_batch(want, output="uint8")
    per_call = tuple(a - b for a, b in zip(_launches(), before))
    assert all(per_call[:3]) and per_call[3] == 0
    assert (want_rgba[..., 3] == 255).all()
    codec = _tcm_codec(tcm)
    io = codec.rgb_io
    for i in range(4):
        before = _launches()
        replays = io.graphs.replays
        assert codec.encode_batch(img, alpha) == want
        np.testing.assert_array_equal(
            codec.decode_batch(want, output="uint8"), want_rgba)
        assert tuple(a - b for a, b in zip(_launches(), before)) == per_call
        if i >= 2:
            assert io.graphs.replays - replays == 8
    assert io.graphs.fallbacks == 0
    eager.rgb_io.close()
    io.close()


def test_tcm_blob_decodes_alike_in_any_batch(tcm):
    """Blobs of a batch of 4 equal each image's blob alone, and decode
    alike as a batch, at interleave 2 and one by one (the entropy head's
    SWAtten, LayerNorms and linears run each image alone)."""
    img, alpha = _opaque(4, 256, 256, seed=5)
    codec = _tcm_codec(tcm)
    blobs = codec.encode_batch(img, alpha)
    assert blobs == [codec.encode_batch(img[i:i + 1], alpha[i:i + 1])[0]
                     for i in range(4)]
    whole = codec.decode_batch(blobs, output="uint8")
    np.testing.assert_array_equal(
        codec.decode_batch(blobs, output="uint8", interleave=2), whole)
    for i in range(4):
        np.testing.assert_array_equal(
            codec.decode_batch(blobs[i:i + 1], output="uint8"), whole[i:i + 1])
    codec.rgb_io.close()


def test_the_paper_codec_launches_as_before(card):
    """The paper's codec (its four kernels) launches 4 / 15 / 10 / 3
    kernels a round trip, eager and replayed, with the same blobs."""
    policy = dataclasses.replace(TCM_POLICY, fused_dse=True, packed_dse=False)
    pipe = RGBAPipeline(policy, seed=0)
    d = synthetic_rgba_batch(1, 256, 256, seed=7)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    codecs = [RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                            CodecIO(pipe.mask_codec, "mask"))
              for _ in range(2)]
    for io in (codecs[0].rgb_io, codecs[0].mask_io):
        io.graphs.backend = None
    want = None
    for c in codecs:
        for _ in range(3):
            before = _launches()
            blobs = c.encode_batch(img, alpha)
            c.decode_batch(blobs, output="uint8")
            assert tuple(a - b for a, b in zip(_launches(), before)) == \
                (4, 15, 10, 3)
            want = want or blobs
            assert blobs == want
        c.rgb_io.close()
        c.mask_io.close()
