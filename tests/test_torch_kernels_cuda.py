"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU with nvcc (the kernels have no CPU
mode) and skips without one; the codec test also builds the host rANS
coder with g++.  The file imports no JAX, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

Tolerances, as chip_smoke.py: fp32 2e-5 + 2e-5*|ref| (sums taken in
another order); bf16 2^-5 * max(1, max|ref|), four bf16 ulps at the
largest value (an fp32 sum a hair apart can round qkv, P or the output to
the neighbouring bf16 value).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.precision import SERVE_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.ops.kernels import dse, gate_chain, gdn, win_attn  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
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


def _gdn_args(m, c, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, c, generator=g).to(dev, dtype)
    gt = (0.1 * torch.eye(c) + 1e-3 * torch.rand(c, c, generator=g)).to(dev)
    beta = (1.0 + 0.1 * torch.rand(c, generator=g)).to(dev)
    return x, gt, beta


def _attn_args(nw, n, c, nh, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(nw, n, c, generator=g).to(dev, dtype),
            torch.randint(0, 4, (nw, n), generator=g, dtype=torch.int32).to(dev),
            (torch.arange(nw) % 3 != 0).float().reshape(nw, 1).to(dev),
            (torch.randn(c, 3 * c, generator=g) / c ** 0.5).to(dev, dtype),
            (0.1 * torch.randn(3 * c, generator=g)).to(dev),
            (torch.randn(c, c, generator=g) / c ** 0.5).to(dev, dtype),
            (0.1 * torch.randn(c, generator=g)).to(dev),
            torch.randn(nh, n, n, generator=g).to(dev)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m,c", [(64 * 96, 192), (1001, 192), (300, 16)])
def test_gdn_kernel_matches_plain(card, dtype, inverse, m, c):
    x, gt, beta = _gdn_args(m, c, dtype, card)
    _assert_close(gdn.fused_gdn(x, gt, beta, inverse),
                  gdn.gdn_plain(x, gt, beta, inverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c,nh", [(64, 192, 8), (16, 80, 8), (16, 24, 3)])
def test_window_attention_kernel_matches_plain(card, dtype, n, c, nh):
    args = _attn_args(30, n, c, nh, dtype, card)
    got = win_attn.fused_window_attention(*args, num_heads=nh)
    _assert_close(got, win_attn.window_attention_plain(*args, num_heads=nh),
                  dtype)
    assert not got[0::3].any()          # dead windows are exactly zero


def _within(got, want, dtype):
    try:
        _assert_close(got, want, dtype)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(64, 192), (16, 80)])
@pytest.mark.parametrize("wrong", ["zeroed", "transposed", "other head"])
def test_window_attention_check_sees_a_wrong_rel_bias(card, dtype, n, c,
                                                      wrong):
    """rel_bias at unit scale moves the output by more than the tolerance,
    so the checks above fail a kernel that drops, transposes or mis-indexes
    it: here the kernel is fed such a bias and must miss the plain output."""
    args = _attn_args(30, n, c, 8, dtype, card)
    rb = args[-1]
    bad = {"zeroed": torch.zeros_like(rb),
           "transposed": rb.transpose(1, 2).contiguous(),
           "other head": rb.roll(1, 0).contiguous()}[wrong]
    want = win_attn.window_attention_plain(*args, num_heads=8)
    assert _within(win_attn.fused_window_attention(*args, num_heads=8), want,
                   dtype)
    assert not _within(win_attn.fused_window_attention(
        *args[:-1], bad, num_heads=8), want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_prepared_weights_give_the_same_bits(card, dtype):
    """The module's cached kernel layout gives the bits the wrapper's own
    per-call layout gives, and a layout for the other dtype is refused."""
    args = _attn_args(31, 64, 192, 8, dtype, card)
    wts = win_attn.kernel_weights(*args[3:7], 8, dtype)
    a = win_attn.fused_window_attention(*args, num_heads=8)
    b = win_attn.fused_window_attention(*args, num_heads=8, prepared=wts)
    assert torch.equal(a, b)
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="prepared"):
        win_attn.fused_window_attention(
            *args, num_heads=8,
            prepared=win_attn.kernel_weights(*args[3:7], 8, other))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m", [1, 127, 129, 1001, "loops"])
def test_gdn_kernel_ragged_rows(card, dtype, inverse, m):
    """Row counts around the bf16 kernel's 64-row tiles (a lone row, a
    ragged second tile), and one large enough that every tile stream of
    the persistent grid takes several tiles."""
    if m == "loops":
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        m = 3 * 128 * sms + 77
    x, gt, beta = _gdn_args(m, 192, dtype, card, seed=m % 7)
    _assert_close(gdn.fused_gdn(x, gt, beta, inverse),
                  gdn.gdn_plain(x, gt, beta, inverse), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(64, 192), (16, 80)])
@pytest.mark.parametrize("nw,pattern", [(1, "alive"), (3, "mixed"),
                                        (31, "mixed"), (31, "alive"),
                                        (31, "dead")])
def test_window_attention_kernel_window_counts(card, dtype, n, c, nw,
                                               pattern):
    """Window counts that are not a multiple of the bf16 kernel's windows
    per group (2 at N=64, 8 at N=16), with every window alive, every
    window dead, or a mix."""
    args = _attn_args(nw, n, c, 8, dtype, card, seed=nw)
    alive = {"alive": torch.ones(nw), "dead": torch.zeros(nw),
             "mixed": (torch.arange(nw) % 3 != 0).float()}[pattern]
    args[2] = alive.reshape(nw, 1).to(card)
    got = win_attn.fused_window_attention(*args, num_heads=8)
    _assert_close(got, win_attn.window_attention_plain(*args, num_heads=8),
                  dtype)
    assert not got[alive == 0].any()    # dead windows are exactly zero


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_and_gdn_kernels_are_deterministic(card, dtype):
    """The codec recomputes in separate calls: the same inputs give the
    same bits."""
    x, gt, beta = _gdn_args(3 * 128 * 132 + 5, 192, dtype, card)
    args = _attn_args(301, 64, 192, 8, dtype, card)
    a = gdn.fused_gdn(x, gt, beta)
    b = gdn.fused_gdn(x, gt, beta)
    c = win_attn.fused_window_attention(*args, num_heads=8)
    d = win_attn.fused_window_attention(*args, num_heads=8)
    assert torch.equal(a, b) and torch.equal(c, d)


def test_launch_counts_only_kernel_launches(card):
    x, gt, beta = _gdn_args(256, 192, torch.float32, card)
    args = _attn_args(6, 16, 80, 8, torch.float32, card)
    g0, a0 = gdn.KERNEL.launches, win_attn.KERNEL.launches
    gdn.fused_gdn(x, gt, beta)
    gdn.gdn_plain(x, gt, beta)
    win_attn.fused_window_attention(*args, num_heads=8)
    win_attn.window_attention_plain(*args, num_heads=8)
    assert (gdn.KERNEL.launches - g0, win_attn.KERNEL.launches - a0) == (1, 1)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x, gt, beta = _gdn_args(64, 192, torch.float32, card)
    # a tensor that needs a gradient is not refused: the kernel still runs
    # the forward, and the remat Function supplies the backward
    before = gdn.KERNEL.launches
    out = gdn.fused_gdn(x.clone().requires_grad_(True), gt, beta)
    assert type(out.grad_fn).__name__ == "_FusedPrimalPlainGradBackward"
    assert gdn.KERNEL.launches == before + 1
    with pytest.raises(ValueError, match="multiple of 16"):
        gdn.fused_gdn(torch.zeros(8, 200, device=card),
                      torch.zeros(200, 200, device=card),
                      torch.ones(200, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        gdn.fused_gdn(torch.zeros(192, 8, device=card).t(), gt, beta)
    with pytest.raises(TypeError):
        gdn.fused_gdn(torch.zeros(8, 192, device=card, dtype=torch.float16),
                      gt, beta)
    args = _attn_args(4, 16, 80, 8, torch.float32, card)
    with pytest.raises(ValueError, match="rel_bias shape"):
        win_attn.fused_window_attention(*args[:-1], args[-1][:, :8],
                                        num_heads=8)
    with pytest.raises(ValueError, match="heads"):
        win_attn.fused_window_attention(*args, num_heads=7)


def test_pipeline_on_the_card_goes_through_both_kernels(card):
    policy = dataclasses.replace(SERVE_POLICY, fused_gdn=True)
    pipe = RGBAPipeline(policy, seed=0)
    d = synthetic_rgba_batch(1, 64, 128, seed=0)
    gdn.KERNEL.launches = win_attn.KERNEL.launches = 0
    out = pipe(d["masked_image"], d["alpha"])
    assert (win_attn.KERNEL.launches, gdn.KERNEL.launches) == (4, 12)
    assert out["x_hat"].shape == (1, 64, 128, 3)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def _gate_args(b, h, w, c, dtype, dev, separate, seed=0):
    g = torch.Generator().manual_seed(seed)
    half = c // 2

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)

    def chain():
        return gate_chain.GateChainWeights(
            rnd(3, c, half, scale=c ** -0.5), rnd(3, half, scale=0.1),
            rnd(3, 9 * half, half, scale=(9 * half) ** -0.5),
            rnd(3, half, scale=0.1), rnd(3, half, c, scale=0.5 * half ** -0.5),
            rnd(3, c, scale=0.1))
    x = rnd(b, h, w, c).to(dtype)
    gg = rnd(b, h, w, c).to(dtype) if separate else None
    return (x, gg, chain(), chain(), rnd(c, c, scale=c ** -0.5),
            rnd(c, scale=0.1))


def _dse_args(b, h, w, cio, dtype, dev, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g)).to(dev)
    return (torch.rand(b, h, w, cio, generator=g).to(dev, dtype),
            rnd(cio, 32, scale=cio ** -0.5), rnd(32, scale=0.1),
            rnd(6, 288, 32, scale=288 ** -0.5), rnd(6, 32, scale=0.1),
            rnd(32, cio, scale=32 ** -0.5), rnd(cio, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,post,separate", [("gelu_erf", True, True),
                                               ("gelu_tanh", True, True),
                                               ("relu", False, False)])
@pytest.mark.parametrize("b,h,w,c", [(2, 128, 192, 192), (2, 64, 96, 80),
                                     (1, 13, 21, 64), (1, 5, 7, 16)])
def test_gate_chain_kernel_matches_plain(card, dtype, act, post, separate,
                                         b, h, w, c):
    """The path's shapes and ragged ones (partial tiles, a tile larger than
    the image)."""
    args = _gate_args(b, h, w, c, dtype, card, separate)
    with torch.inference_mode():
        _assert_close(gate_chain.fused_gate_chain(*args, act, post),
                      gate_chain.gate_chain_plain(*args, act, post), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
@pytest.mark.parametrize("b,h,w", [(2, 512, 768), (1, 37, 50), (1, 5, 9)])
def test_dse_kernel_matches_plain(card, dtype, cio, leaky, b, h, w):
    args = _dse_args(b, h, w, cio, dtype, card)
    with torch.inference_mode():
        _assert_close(dse.fused_dse(*args, leaky=leaky),
                      dse.dse_plain(*args, leaky=leaky), dtype)


def test_conv_chain_kernels_are_deterministic(card):
    """The codec rebuilds the alpha in separate calls: the same inputs give
    the same bits."""
    gargs = _gate_args(2, 32, 48, 80, torch.float32, card, True)
    dargs = _dse_args(2, 64, 64, 3, torch.float32, card)
    with torch.inference_mode():
        a = gate_chain.fused_gate_chain(*gargs, "gelu_erf", True)
        b = gate_chain.fused_gate_chain(*gargs, "gelu_erf", True)
        c = dse.fused_dse(*dargs, leaky=False)
        d = dse.fused_dse(*dargs, leaky=False)
    assert torch.equal(a, b) and torch.equal(c, d)


def _all_kernels(policy):
    return dataclasses.replace(policy, fused_win_attn=True, fused_gdn=True,
                               fused_gate_chain=True, fused_dse=True,
                               packed_dse=False)


def _launches():
    return tuple(k.KERNEL.launches for k in (win_attn, gdn, gate_chain, dse))


def test_forward_with_all_four_kernels(card):
    from rgba_tpu_torch.core.precision import BF16_POLICY
    pipe = RGBAPipeline(_all_kernels(BF16_POLICY), seed=0)
    d = synthetic_rgba_batch(1, 64, 128, seed=0)
    before = _launches()
    out = pipe(d["masked_image"], d["alpha"])
    assert tuple(a - b for a, b in zip(_launches(), before)) == (4, 12, 8, 2)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())


def test_codec_round_trip_on_the_card(card):
    """fp32 with all four kernels: bit-exact re-encode, the launches of one
    encode + decode, and the decoded RGB against the codec's forward."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    pipe = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    codec = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                          CodecIO(pipe.mask_codec, "mask"))
    d = synthetic_rgba_batch(2, 64, 128, seed=1)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    before = _launches()
    blobs = codec.encode_batch(img, alpha)
    dec = codec.decode_batch(blobs)
    assert tuple(a - b for a, b in zip(_launches(), before)) == (4, 15, 10, 3)
    assert codec.encode_batch(img, alpha) == blobs
    assert dec.shape == (2, 64, 128, 4)
    rgb_io = codec.rgb_io
    with rgb_io._scope():
        recon = torch.from_numpy(dec[..., 3:]).cuda().permute(0, 3, 1, 2)
        x = torch.from_numpy(img).cuda().float().permute(0, 3, 1, 2) / 255.0
        fwd = rgb_io.model(torch.where(recon > 0, x, recon), recon, recon,
                           mask_pyramid(recon))
        want = torch.clamp(fwd["x_hat"], 0, 1).permute(0, 2, 3, 1).cpu().numpy()
    np.testing.assert_allclose(dec[..., :3], want, atol=1e-5)


# ------------------------------------------------------------- training


def _grad_cases(dev, dtype):
    """name -> (wrapper call, plain call, tensors, index of the input);
    both calls take the tensors in the wrapper's order."""
    x, gt, beta = _gdn_args(2 * 64 * 96, 192, dtype, dev)
    a = _attn_args(30, 64, 192, 8, dtype, dev)
    a[3], a[5] = a[3].float(), a[5].float()        # fp32 parameters
    region, alive = a[1], a[2]
    gx, gg, trunk, gate, fw, fb = _gate_args(2, 32, 48, 80, dtype, dev, True)
    d = _dse_args(2, 64, 96, 3, dtype, dev)
    flat_gate = [gx, gg, *trunk, *gate, fw, fb]

    def gate_call(fn):
        def call(x_, g_, *w):
            return fn(x_, g_, gate_chain.GateChainWeights(*w[:6]),
                      gate_chain.GateChainWeights(*w[6:12]), w[12], w[13],
                      "gelu_tanh", True)
        return call
    return {
        "gdn": (lambda *t: gdn.fused_gdn(*t, inverse=True),
                lambda *t: gdn.gdn_plain(*t, inverse=True), [x, gt, beta]),
        "attention": (
            lambda t, *w: win_attn.fused_window_attention(
                t, region, alive, *w, num_heads=8),
            lambda t, *w: win_attn.window_attention_plain(
                t, region, alive, *w, num_heads=8),
            [a[0], *a[3:]]),
        "gate_chain": (gate_call(gate_chain.fused_gate_chain),
                       gate_call(gate_chain.gate_chain_plain), flat_gate),
        "dse": (lambda *t: dse.fused_dse(*t, leaky=False),
                lambda *t: dse.dse_plain(*t, leaky=False), list(d)),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("needs", ["all", "input only", "weights only"])
@pytest.mark.parametrize("kernel", ["gdn", "attention", "gate_chain", "dse"])
def test_wrapper_under_grad(card, kernel, needs, dtype):
    """Under autograd a wrapper's forward is the kernel's no-grad output
    bit for bit, its backward launches nothing, and its gradients are
    autograd's through the plain version on the same inputs, for every
    subset of inputs that needs one."""
    fused, plain, tensors = _grad_cases(card, dtype)[kernel]
    with torch.no_grad():
        want_out = fused(*tensors)

    def leaves():
        return [t.clone().requires_grad_(
            needs == "all" or (i == 0) == (needs == "input only"))
            for i, t in enumerate(tensors)]
    ins = leaves()
    before = _launches()
    out = fused(*ins)
    assert type(out.grad_fn).__name__ == "_FusedPrimalPlainGradBackward"
    assert torch.equal(out, want_out)
    cot = torch.sin(torch.arange(out.numel(), device=card).reshape(out.shape)
                    .float()).to(out.dtype)
    out.backward(cot)
    assert sum(a - b for a, b in zip(_launches(), before)) == 1
    ref = leaves()
    plain(*ref).backward(cot)
    for i, (got, want) in enumerate(zip(ins, ref)):
        if not want.requires_grad:
            assert got.grad is None
            continue
        assert got.grad is not None and got.grad.dtype == want.grad.dtype
        scale = float(want.grad.float().abs().max())
        assert float((got.grad.float() - want.grad.float()).abs().max()) \
            <= 1e-5 * scale, (kernel, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_layout_follows_an_in_place_update(card, dtype):
    """A stale kernel layout would train silently wrong: after an
    optimizer step the kernel route must agree with the plain path on the
    new weights, and differ from its own output on the old ones."""
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops.attention import MaskedWinBlock
    g = torch.Generator().manual_seed(3)
    kw = dict(device=card, generator=torch.Generator().manual_seed(4))
    on = MaskedWinBlock(192, 8, 8, 4, policy=Policy(dtype, fused_win_attn=True),
                        **kw)
    off = MaskedWinBlock(192, 8, 8, 4, policy=Policy(dtype), **kw)
    x = torch.randn(2, 192, 32, 48, generator=g).to(card)
    alpha = (torch.rand(2, 1, 32, 48, generator=g) > 0.3).float().to(card)
    with torch.no_grad():
        old = on(x, alpha)
    opt = torch.optim.Adam(on.parameters(), lr=0.05)
    out = on(x, alpha)
    torch.sum(out * torch.sin(out.float()).to(out.dtype)).backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in on.parameters())
    opt.step()
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        new, want = on(x, alpha), off(x, alpha)
    _assert_close(new, want, dtype)
    assert not _within(old, want, dtype)


@pytest.mark.parametrize("kind", ["rgb", "mask"])
def test_trainer_step_on_the_card(card, kind, tmp_path):
    """bf16 steps with every kernel on: the launches of a training forward
    and none in backward, finite losses and parameters."""
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.core.precision import BF16_POLICY
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    from rgba_tpu_torch.models.rgb_codec import RGBCodec
    from rgba_tpu_torch.train.loops import MaskTrainer, RGBTrainer
    cfg = TrainConfig(train_lambda=1024, batch_size=2, curriculum_step=0)
    cls, trainer_cls, want = (
        (RGBCodec, RGBTrainer, (4, 6, 4, 1)) if kind == "rgb"
        else (MaskCodec, MaskTrainer, (0, 6, 4, 1)))
    model = cls(policy=_all_kernels(BF16_POLICY), device=card,
                generator=torch.Generator().manual_seed(0))
    trainer = trainer_cls(cfg, str(tmp_path), model=model)
    state = trainer.init_state()
    batch = synthetic_rgba_batch(2, 64, 128, seed=0)
    for step in range(3):
        before = _launches()
        m = trainer.step(state, batch)
        assert tuple(a - b for a, b in zip(_launches(), before)) == want
        assert all(bool(torch.isfinite(v)) for v in m.values())
    assert state.step == 3
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
