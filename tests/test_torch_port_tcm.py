"""TCM, the mixed Transformer-CNN codec of opaque images
(``rgba_tpu_torch/models/tcm.py``), on the CPU at small widths against the
benchmark's plain float32 reference (``benchmark/reference/tcm.py``, loaded
by its path): each block, the whole model, the bitstream codec through
``CodecIO`` and the container, and what the change to ``ChannelARPrior``
must leave as it was for the paper's codecs.

Weights are seeded and made live (bias noise, a gain on g_a's last
convolution, g_s's output biases at 0.5), so the latents span several
bins and the decoded images sit inside [0, 1].  The tolerances are
``tests/test_torch_parity.py``'s: 1e-4 for transforms, 2e-4 for x_hat,
1e-5 for bpp.
"""

import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from rgba_tpu_torch.core.precision import DEFAULT_POLICY
from rgba_tpu_torch.eval.codec_io import CodecIO
from rgba_tpu_torch.eval.container import RGBAFileCodec, pack_rgba, unpack_rgba
from rgba_tpu_torch.models.pipeline import RGBAPipeline
from rgba_tpu_torch.models.tcm import TCM
from rgba_tpu_torch.ops import residual, swin
from rgba_tpu_torch.ops.kernels import gdn as kgdn
from rgba_tpu_torch.utils import trace

BENCH = Path(__file__).resolve().parents[1] / "benchmark"


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load("tcm_reference", BENCH / "reference" / "tcm.py")

SMALL = dict(N=16, M=40, head_dim=(8,) * 6, hyper_head_dim=8, atten_dim=16,
             atten_head_dim=8)
KW = dict(policy=DEFAULT_POLICY, device="cpu")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _perturb(module, seed, scale=0.05):
    """Seeded noise on every parameter, so LayerNorms, biases and tables
    are not at their starts."""
    g = _gen(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=g))
    return module


def _live(model, seed=1, gain=8.0):
    with torch.no_grad():
        g = _gen(seed)
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.add_(0.02 * torch.randn(p.shape, generator=g))
        model.g_a[-1].weight.mul_(gain)
        model.g_s[-1][0].bias.fill_(0.5)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    port = _live(TCM(generator=_gen(), **KW, **SMALL))
    plain = ref.TCM(**SMALL).eval()
    plain.load_state_dict(port.state_dict(), strict=True)
    return port, plain


def _images(n, h=256, w=256, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.random((n, h // 32, w // 32, 3))
    img = np.kron(base, np.ones((1, 32, 32, 1))) * 0.7 + \
        0.3 * rng.random((n, h, w, 3))
    return np.round(img * 255).astype(np.uint8)


# ---------------------------------------------------------------- blocks

BLOCKS = {
    "block_w": (lambda: swin.Block(16, 8, 8, False, generator=_gen(), **KW),
                lambda: ref.Block(16, 8, 8, "W"), (2, 16, 24, 16)),
    "block_sw": (lambda: swin.Block(16, 8, 8, True, generator=_gen(), **KW),
                 lambda: ref.Block(16, 8, 8, "SW"), (2, 16, 24, 16)),
    "block_sw_window4": (
        lambda: swin.Block(16, 8, 4, True, generator=_gen(), **KW),
        lambda: ref.Block(16, 8, 4, "SW"), (2, 8, 12, 16)),
    "convtrans_sw": (
        lambda: swin.ConvTransBlock(16, 8, 8, True, generator=_gen(), **KW),
        lambda: ref.ConvTransBlock(16, 16, 8, 8, "SW"), (2, 32, 16, 24)),
    "swatten": (lambda: swin.SWAtten(40, 16, 8, 8, generator=_gen(), **KW),
                lambda: ref.SWAtten(40, 8, 8, 16), (2, 40, 16, 24)),
    "residual": (lambda: residual.ResidualBlock(16, generator=_gen(), **KW),
                 lambda: ref.ResidualBlock(16), (2, 16, 16, 16)),
    "with_stride": (lambda: residual.ResidualBlockWithStride(
        8, 32, generator=_gen(), **KW),
        lambda: ref.ResidualBlockWithStride(8, 32, 2), (2, 8, 16, 16)),
    "upsample": (lambda: residual.ResidualBlockUpsample(
        8, 32, generator=_gen(), **KW),
        lambda: ref.ResidualBlockUpsample(8, 32, 2), (2, 8, 8, 8)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_the_reference(name):
    make, make_ref, shape = BLOCKS[name]
    block = _perturb(make(), 7)
    plain = make_ref()
    plain.load_state_dict(block.state_dict(), strict=True)
    x = torch.randn(shape, generator=_gen(5))
    with torch.no_grad():
        err = float((block(x) - plain(x)).abs().max())
    assert err <= 1e-4, err


def test_the_kernel_route_matches_the_plain_route_on_the_cpu():
    """With the three kernels routed (each takes its plain version on the
    CPU) a ConvTransBlock, a SWAtten and a strided block give the
    unrouted modules' outputs."""
    import dataclasses
    routed = dataclasses.replace(DEFAULT_POLICY, fused_win_attn=True,
                                 fused_gdn=True, fused_gate_chain=True)
    for make, shape in ((lambda p: swin.ConvTransBlock(
            16, 8, 8, True, policy=p, device="cpu", generator=_gen()),
            (2, 32, 16, 24)),
            (lambda p: swin.SWAtten(40, 16, 8, 8, policy=p, device="cpu",
                                    generator=_gen()), (2, 40, 16, 24)),
            (lambda p: residual.ResidualBlockWithStride(
                8, 32, policy=p, device="cpu", generator=_gen()),
             (2, 8, 16, 16))):
        a, b = make(DEFAULT_POLICY), make(routed)
        x = torch.randn(shape, generator=_gen(6))
        with torch.no_grad():
            err = float((a(x) - b(x)).abs().max())
        assert err <= 1e-5, err


def test_a_latent_no_larger_than_a_window_is_refused():
    block = swin.SwinBlock(16, 8, 8, generator=_gen(), **KW)
    with pytest.raises(ValueError, match="not larger"):
        block(torch.zeros(1, 16, 8, 16))


# ----------------------------------------------------------------- model

def test_model_matches_the_reference(models):
    port, plain = models
    x = torch.from_numpy(_images(2)).float().permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        a, b = port(x), plain(x)
    assert float((a["y"] - b["y"]).abs().max()) <= 1e-4
    assert float((a["x_hat"] - b["x_hat"]).abs().max()) <= 2e-4
    assert abs(float(a["bpp"]) - float(b["bpp"])) <= 1e-5
    # the latents are live: more than the z floor, symbols off zero
    assert float(b["bpp"]) > 0.3


def test_published_widths_and_keys():
    """At the published widths the port and the reference hold the same
    76.6 M parameters under LIC_TCM's keys."""
    port = TCM(generator=_gen(), **KW)
    plain = ref.TCM()
    assert {k: v.shape for k, v in port.state_dict().items()} == \
        {k: v.shape for k, v in plain.state_dict().items()}
    n = sum(p.numel() for p in plain.parameters())
    assert 76.5e6 < n < 76.7e6
    top = {k.split(".")[0] for k in plain.state_dict()}
    assert top == {"g_a", "g_s", "h_a", "h_mean_s", "h_scale_s", "atten_mean",
                   "atten_scale", "cc_mean_transforms", "cc_scale_transforms",
                   "lrp_transforms", "entropy_bottleneck"}


# ----------------------------------------------------------------- codec

@pytest.fixture(scope="module")
def tcm_codec(models):
    io = CodecIO(models[0], "rgb")
    yield RGBAFileCodec(io)
    io.close()


def _opaque(img):
    return np.full(img.shape[:3] + (1,), 255, np.uint8)


def test_container_round_trip_equals_the_reference(models, tcm_codec):
    _, plain = models
    img = _images(2, seed=11)
    blobs = tcm_codec.encode_batch(img, _opaque(img))
    for blob in blobs:
        meta = unpack_rgba(blob)
        flags = struct.unpack("<B", blob[5:6])[0]
        assert meta["tcm"] and flags & 16 and not flags & 1
        assert meta["mask"] is None
    rgba = tcm_codec.decode_batch(blobs, output="uint8")
    assert (rgba[..., 3] == 255).all()
    x_hat, y_hat = tcm_codec.rgb_io.decompress_batch_with_latent(
        [unpack_rgba(b)["rgb"] for b in blobs])
    x = torch.from_numpy(img).float().permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        want = plain.entropy(plain.g_a(x))["y_hat"].numpy()
    assert np.abs(y_hat - want).max() <= 1e-4
    rgb = ref.codec(plain, torch.from_numpy(img))["rgb"].numpy()
    assert np.abs(rgba[..., :3].astype(int) - rgb.astype(int)).max() <= 1


def test_indexes_do_not_depend_on_the_batch(tcm_codec):
    """The encoder's symbols and indexes of each image are the same alone
    and in a batch of 4, and a batch decodes alike at interleave 1 and 2
    and image by image: encoder and decoder agree however they batch."""
    img = _images(4, seed=13)
    io = tcm_codec.rgb_io
    x = torch.from_numpy(img)
    whole = [t.numpy() for t in io._compress_tensors(
        io._nchw(x), None, None)]
    for i in range(4):
        alone = io._compress_tensors(io._nchw(x[i:i + 1]), None, None)
        for t_all, t_one in zip(whole, alone):
            sl = t_all[:, i:i + 1] if t_all.ndim == 5 else t_all[i:i + 1]
            np.testing.assert_array_equal(sl, t_one.numpy())
    blobs = tcm_codec.encode_batch(img, _opaque(img))
    assert blobs == [tcm_codec.encode_batch(img[i:i + 1],
                                            _opaque(img[i:i + 1]))[0]
                     for i in range(4)]
    one = tcm_codec.decode_batch(blobs, output="uint8", interleave=1)
    two = tcm_codec.decode_batch(blobs, output="uint8", interleave=2)
    np.testing.assert_array_equal(one, two)
    for i in range(4):
        np.testing.assert_array_equal(
            tcm_codec.decode_batch(blobs[i:i + 1], output="uint8"), one[i:i + 1])


@pytest.fixture(scope="module")
def paper_codec():
    pipe = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    c = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                      CodecIO(pipe.mask_codec, "mask"))
    yield c
    c.rgb_io.close()
    c.mask_io.close()


def test_a_decoder_refuses_the_other_models_blobs(tcm_codec, paper_codec):
    img = _images(1, h=64, w=64, seed=17)
    paper_blob = paper_codec.encode_batch(img, _opaque(img))[0]
    assert "tcm" not in unpack_rgba(paper_blob)
    with pytest.raises(ValueError, match="paper's RGB codec"):
        tcm_codec.decode_batch([paper_blob])
    img = _images(1, seed=17)
    tcm_blob = tcm_codec.encode_batch(img, _opaque(img))[0]
    with pytest.raises(ValueError, match="written by TCM"):
        paper_codec.decode_batch([tcm_blob])
    # one of each in a batch is refused too
    fake = pack_rgba(256, 256, unpack_rgba(tcm_blob)["rgb"], None)
    with pytest.raises(ValueError):
        tcm_codec.decode_batch([tcm_blob, fake])


def test_tcm_codes_opaque_images_only(tcm_codec):
    img = _images(2, seed=19)
    alpha = _opaque(img)
    alpha[1, :8, :8] = 0
    with pytest.raises(ValueError, match="not opaque"):
        tcm_codec.encode_batch(img, alpha)
    with pytest.raises(ValueError, match="rate_gate"):
        tcm_codec.encode_batch(img, _opaque(img), rate_gate=True)


def test_spans_of_an_eager_call(tcm_codec, tmp_path):
    img = _images(1, seed=23)
    with trace.trace(str(tmp_path)):
        tcm_codec.decode_batch(tcm_codec.encode_batch(img, _opaque(img)))
    names = {s[0] for s in trace.spans()}
    assert {"tcm.convtrans", "tcm.swin", "tcm.swatten"} <= names


# ----------------------------------------------- the paper's codecs as before

def test_the_paper_codecs_keys_and_entropy_are_unchanged(paper_codec):
    """The paper's codecs keep the reference's state-dict keys, take no
    support transform, and their slice chain gives the benchmark
    reference's y_hat; the lrp reads what it read before: the hyper means,
    the support slices and y_hat."""
    model_ref = _load("paper_reference", BENCH / "reference" / "model.py")
    rgb = paper_codec.rgb_io.model
    pipe_keys = {f"rgb_codec.{k}" for k in rgb.state_dict()} | {
        f"mask_codec.{k}" for k in paper_codec.mask_io.model.state_dict()}
    assert pipe_keys == set(model_ref.RGBAModel().state_dict())
    assert rgb.atten_mean is None and rgb.atten_scale is None
    plain = model_ref.RGBCodec()
    plain.load_state_dict(rgb.state_dict(), strict=False)
    y = torch.randn(1, 80, 8, 8, generator=_gen(29)) * 3.0
    with torch.no_grad():
        got = rgb.entropy_forward(y)["y_hat"]
        want = plain.entropy(y)["y_hat"]
        assert float((got - want).abs().max()) <= 1e-4
        lm = torch.randn(1, 80, 8, 8, generator=_gen(31))
        ls = torch.rand(1, 80, 8, 8, generator=_gen(37))
        support = [torch.randn(1, 8, 8, 8, generator=_gen(41))]
        _, _, ms = rgb.slice_stats(lm, ls, support, 1, (8, 8))
        y_hat = torch.randn(1, 8, 8, 8, generator=_gen(43))
        before = 0.5 * torch.tanh(rgb.lrp_transforms[1](
            torch.cat([lm] + support + [y_hat], 1).contiguous(
                memory_format=torch.channels_last)))
        assert torch.equal(rgb.slice_lrp(ms, y_hat, 1), before)


# ---------------------------------------------------------- GDN at C=256

def _tf32(a):
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return bits.astype(np.uint32).view(np.float32)


def _read_pass(flat, n, k, kc=16):
    """(hi, lo) of one pass's n x k rows: chunks of kc k, each hi then lo,
    8-row groups of kc / 4 core matrices of 8 rows x 4 k."""
    r, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    k0 = kk // kc * kc
    off = (2 * n * k0 + (r // 8) * (kc // 4) * 32 + ((kk - k0) // 4) * 32
           + (r % 8) * 4 + kk % 4)
    return flat[torch.from_numpy(off)], flat[torch.from_numpy(off + n * kc)]


def test_gdn_fp32_layout_at_256_channels():
    """Past 192 channels the fp32 GDN kernel makes its outputs in two
    passes of 128 rows: the layout holds gamma_t's B operand, pass after
    pass, each as the chunks the kernel's ring streams; hi + lo is each
    value within 2^-21 and the emulated 3xTF32 product matches the plain
    GDN to the card's fp32 tolerance."""
    c = 256
    rng = np.random.RandomState(3)
    gt = torch.from_numpy((0.1 * np.eye(c) + 1e-2 * rng.rand(c, c))
                          .astype(np.float32))
    prep = kgdn.kernel_weights(gt, torch.float32)
    assert prep.shape == (2 * 256 * c,) == (kgdn._prepared_numel(c, torch.float32),)
    parts = [_read_pass(p, 128, c) for p in prep.reshape(2, -1)]
    hi = torch.cat([p[0] for p in parts])
    lo = torch.cat([p[1] for p in parts])
    perm = torch.tensor([8 * (k // 8) + kgdn.K_ORDER[k % 8] for k in range(c)])
    want = gt[perm].t()
    assert torch.equal(hi, torch.from_numpy(_tf32(hi.numpy())))
    assert float(((hi + lo) - want).abs().max()) <= 2 ** -21 * float(want.abs().max())
    x = torch.from_numpy(rng.randn(33, c).astype(np.float32))
    beta = torch.from_numpy((1 + 0.1 * rng.rand(c)).astype(np.float32))
    x2 = (x * x)[:, perm]
    x2h = torch.from_numpy(_tf32(x2.numpy()))
    x2l = torch.from_numpy(_tf32((x2 - x2h).numpy()))
    d = x2l.double() @ hi.t().double() + x2h.double() @ lo.t().double() + \
        x2h.double() @ hi.t().double()
    got = (x * torch.rsqrt(d.float() + beta))
    plain = kgdn.gdn_plain(x, gt, beta)
    assert float((got - plain).abs().max()) <= 2e-5 + 2e-5 * float(plain.abs().max())
    # the layout at 192 and below is the one-pass layout it was
    assert kgdn.kernel_weights(gt[:192, :192], torch.float32).shape == (2 * 192 * 192,)
