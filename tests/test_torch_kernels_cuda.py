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
from rgba_tpu_torch.ops.kernels import dse, gate_chain, gdn, rans_decode, rans_encode, win_attn  # noqa: E402

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
def test_gdn_prepared_gamma_gives_the_same_bits(card, dtype):
    """The module's cached gamma layout gives the bits the wrapper's own
    per-call layout gives, and a layout for the other dtype is refused."""
    x, gt, beta = _gdn_args(1001, 192, dtype, card)
    prep = gdn.kernel_weights(gt, dtype)
    assert torch.equal(gdn.fused_gdn(x, gt, beta),
                       gdn.fused_gdn(x, gt, beta, prepared=prep))
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError, match="prepared"):
        gdn.fused_gdn(x, gt, beta, prepared=gdn.kernel_weights(gt, other))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(64, 192), (16, 80)])
def test_attention_and_gdn_rows_do_not_depend_on_their_batch(card, dtype, n,
                                                             c):
    """The codec's encoder and decoder each rebuild what they need: a window
    alone gives the same bits as in a batch of 16 (at N=16 it sits in
    another place of its group of four), and a GDN row the same bits for
    any M."""
    args = _attn_args(16, n, c, 8, dtype, card, seed=n)
    whole = win_attn.fused_window_attention(*args, num_heads=8)
    for i in (1, 6, 14):
        one = [t[i:i + 1].contiguous() for t in args[:3]] + args[3:]
        assert torch.equal(win_attn.fused_window_attention(*one, num_heads=8)[0],
                           whole[i]), i
    x, gt, beta = _gdn_args(3 * 128 * 132 + 5, 192, dtype, card, seed=c)
    prep = gdn.kernel_weights(gt, dtype)
    y = gdn.fused_gdn(x, gt, beta, prepared=prep)
    for m in (1, 77, 1001, 40000):
        assert torch.equal(gdn.fused_gdn(x[-m:].clone(), gt, beta,
                                         prepared=prep), y[-m:]), m


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


_GATE_FLAVOURS = [("gelu_erf", True, True), ("gelu_tanh", True, True),
                  ("relu", False, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,post,separate", _GATE_FLAVOURS)
@pytest.mark.parametrize("b,h,w,c", [(1, 1, 1, 192), (3, 7, 9, 192),
                                     (1, 33, 47, 192), (3, 33, 47, 80),
                                     (1, 7, 9, 80), (3, 1, 1, 80)])
def test_gate_chain_bf16_ragged_sizes(card, act, post, separate, b, h, w, c,
                                      dtype):
    """The wgmma kernels' tiles (bf16: 8x16 at C=192, 16x16 at C=80; fp32:
    6x8 and 8x16) against images below one tile and with ragged edges, K
    padded at C=80 in bf16."""
    args = _gate_args(b, h, w, c, dtype, card, separate)
    with torch.inference_mode():
        _assert_close(gate_chain.fused_gate_chain(*args, act, post),
                      gate_chain.gate_chain_plain(*args, act, post), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
@pytest.mark.parametrize("b,h,w", [(1, 1, 1), (3, 7, 9), (1, 33, 47),
                                   (3, 33, 47)])
def test_dse_bf16_ragged_sizes(card, cio, leaky, b, h, w, dtype):
    args = _dse_args(b, h, w, cio, dtype, card)
    with torch.inference_mode():
        _assert_close(dse.fused_dse(*args, leaky=leaky),
                      dse.dse_plain(*args, leaky=leaky), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [192, 80])
def test_conv_chain_bf16_kernels_repeat_bit_for_bit(card, c, dtype):
    """Fixed-order sums: two launches give the same bits, and so do the
    weights laid out once (``prepared``) and on every call."""
    gargs = _gate_args(3, 33, 47, c, dtype, card, True)
    dargs = _dse_args(3, 33, 47, 3, dtype, card)
    act = "gelu_tanh" if dtype == torch.bfloat16 else "gelu_erf"
    with torch.inference_mode():
        prep = gate_chain.kernel_weights(*gargs[2:], dtype)
        a = gate_chain.fused_gate_chain(*gargs, act, True)
        b = gate_chain.fused_gate_chain(*gargs, act, True, prep)
        dprep = dse.kernel_weights(*dargs[1:], dtype)
        d0 = dse.fused_dse(*dargs, leaky=False)
        d1 = dse.fused_dse(*dargs, leaky=False, prepared=dprep)
    assert torch.equal(a, b) and torch.equal(d0, d1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [192, 80])
def test_conv_chain_image_does_not_depend_on_its_batch(card, c, dtype):
    """The codec's encoder and decoder each rebuild the mask: image i alone
    gives the same bits as image i in a batch of 16."""
    gargs = _gate_args(16, 29, 43, c, dtype, card, True)
    dargs = _dse_args(16, 45, 70, 3, dtype, card)
    act = "gelu_tanh" if dtype == torch.bfloat16 else "gelu_erf"
    with torch.inference_mode():
        prep = gate_chain.kernel_weights(*gargs[2:], dtype)
        dprep = dse.kernel_weights(*dargs[1:], dtype)
        gate_all = gate_chain.fused_gate_chain(*gargs, act, True, prep)
        dse_all = dse.fused_dse(*dargs, leaky=False, prepared=dprep)
        for i in (0, 7, 15):
            one = gate_chain.fused_gate_chain(
                gargs[0][i:i + 1].contiguous(), gargs[1][i:i + 1].contiguous(),
                *gargs[2:], act, True, prep)
            assert torch.equal(one[0], gate_all[i]), i
            one = dse.fused_dse(dargs[0][i:i + 1].contiguous(), *dargs[1:],
                                leaky=False, prepared=dprep)
            assert torch.equal(one[0], dse_all[i]), i


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["wingate", "simplified", "dse"])
def test_conv_chain_layout_follows_an_in_place_update(card, kind, dtype):
    """After an optimizer step the module's cached kernel layout is that of
    the new weights: its kernel route gives, bit for bit, the kernel fed a
    layout made afresh from the new weights, and no longer its own output
    on the old ones."""
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops import attention as att
    from rgba_tpu_torch.ops.enhance import DSE
    dt = dtype
    g = torch.Generator().manual_seed(5)
    kw = dict(device=card, generator=torch.Generator().manual_seed(6))
    if kind == "dse":
        m = DSE(3, policy=Policy(dt, fused_dse=True), **kw)
    elif kind == "wingate":
        m = att.WinGateAttention(80, 8, 4, 0, policy=Policy(dt, fused_gate_chain=True), **kw)
    else:
        m = att.SimplifiedAttention(80, policy=Policy(dt, fused_gate_chain=True), **kw)
    x = torch.randn(2, 3 if kind == "dse" else 80, 24, 40, generator=g).to(card, dt)

    def rows(t):
        return t.permute(0, 2, 3, 1).contiguous()

    def fresh():
        """The kernel on a layout built now from the current weights."""
        if kind == "dse":
            return dse.fused_dse(rows(x), *m.kernel_weights(), leaky=False)
        gin = rows(m.attn(x)) if kind == "wingate" else None
        return gate_chain.fused_gate_chain(rows(x), gin, *m.gate_chain_weights(),
                                           m.act, m.post_act)
    with torch.no_grad():
        old = rows(m(x))
    opt = torch.optim.Adam(m.parameters(), lr=0.01)
    out = m(x)
    torch.sum(out.float() * torch.sin(out.float())).backward()
    opt.step()
    with torch.no_grad():
        new, want = rows(m(x)), fresh()
    assert torch.equal(new, want)
    assert not torch.equal(new, old)


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
    # a blob decodes the same alone as in its batch (batch-invariant scope)
    alone = codec.decode_batch(blobs[:1])
    assert np.array_equal(alone[0], dec[0])
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


# ------------------------------------------------------------ rANS decode


def _lane_case(dev, path, batch=3, lanes=64, n=9000, seed=0):
    """Lane streams of ``batch`` images (two segments, gated positions,
    bypass escapes), packed on ``dev``; the tables, the inverse (path
    "inverse") and the expected symbols."""
    import numpy as np
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.entropy.gaussian import GaussianConditional, get_scale_table
    from rgba_tpu_torch.native import rans

    gc = GaussianConditional(get_scale_table())
    gc.update()
    tables = dr.pack_tables(gc.quantized_cdfs, gc.cdf_lengths, gc.offsets)
    rng = np.random.RandomState(seed)
    seg_ends = np.array([n // 3, n], np.int64)
    per, want, idxs, alives = [], [], [], []
    for _ in range(batch):
        idx = rng.randint(0, 64, n).astype(np.int32)
        sym = rng.randint(-6, 7, n).astype(np.int32)
        sym[::37] = rng.randint(-3000, 3000, sym[::37].size)
        alive = rng.rand(n) > 0.25
        words, lnw = rans.encode_lanes(sym, idx, seg_ends, lanes,
                                       tables["cdfs"], tables["max_values"] + 2,
                                       tables["offsets"], alive=alive)
        per.append((words, lnw))
        want.append(np.where(alive, sym, 0))
        idxs.append(idx)
        alives.append(alive)
    flat, base, end = dr.pack_streams(per, lanes)
    t = {k: torch.from_numpy(v).to(dev) for k, v in tables.items()}
    inv = None
    if path == "inverse":
        inv = {k: torch.from_numpy(v).to(dev) for k, v in
               dr.build_inverse(gc.quantized_cdfs, gc.cdf_lengths).items()}
    segs = []
    for a, b in zip([0, *seg_ends[:-1]], seg_ends):
        ii = torch.from_numpy(np.stack([i[a:b] for i in idxs])).to(dev)
        aa = torch.from_numpy(np.stack([x[a:b] for x in alives])).to(dev)
        segs.append((dr.to_steps(ii, lanes), dr.to_steps(aa, lanes, fill=False),
                     int(b - a)))
    return dict(words=dr.words_tensor(flat, dev),
                base=torch.from_numpy(base).to(dev),
                end=torch.from_numpy(end).to(dev), tables=t, inverse=inv,
                segs=segs, want=np.stack(want), lanes=lanes)


def _run_lanes(case, fn, words=None):
    from rgba_tpu_torch.entropy import device_rans as dr
    words = case["words"] if words is None else words
    state, ptr = dr.init_lanes(words, case["base"])
    out = []
    for idx, act, n in case["segs"]:
        syms, state, ptr = fn(case["tables"], words, state, ptr, idx, act,
                              case["end"], inverse=case["inverse"])
        out.append(dr.from_steps(syms, n))
    torch.cuda.synchronize()
    return torch.cat(out, dim=-1), state, ptr


@pytest.mark.parametrize("path", ["inverse", "row_search"])
def test_rans_decode_matches_plain_and_the_host(card, path):
    """The kernel gives the plain version's symbols, state and pointer bit
    for bit, and the host coder's symbols; one launch per segment; a word
    flipped in the stream changes the symbols, and kernel and plain still
    agree on it (each lane reads no word past its end)."""
    import numpy as np
    case = _lane_case(card, path)
    before = rans_decode.KERNEL.launches
    got = _run_lanes(case, rans_decode.rans_decode)
    assert rans_decode.KERNEL.launches - before == len(case["segs"])
    want = _run_lanes(case, rans_decode.rans_decode_plain)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    np.testing.assert_array_equal(got[0].cpu().numpy(), case["want"])
    assert torch.equal(got[2].cpu(), case["end"].cpu())
    bad = case["words"].clone()
    bad[int(case["base"][1, 5]) + 1] ^= 0x2AAA
    flipped = _run_lanes(case, rans_decode.rans_decode, bad)
    assert not torch.equal(flipped[0], got[0])
    plain = _run_lanes(case, rans_decode.rans_decode_plain, bad)
    for g, w in zip(flipped, plain):
        assert torch.equal(g.cpu(), w.cpu())


def test_rans_decode_refuses_bad_arguments(card):
    case = _lane_case(card, "inverse", batch=1, n=500)
    from rgba_tpu_torch.entropy import device_rans as dr
    state, ptr = dr.init_lanes(case["words"], case["base"])
    idx, act, _ = case["segs"][0]
    with pytest.raises(TypeError, match="state"):
        rans_decode.rans_decode(case["tables"], case["words"], state.int(), ptr,
                                idx, act, case["end"])
    with pytest.raises(ValueError, match="indexes"):
        rans_decode.rans_decode(case["tables"], case["words"], state, ptr,
                                idx[:, :, :3], act, case["end"])
    with pytest.raises(ValueError, match="device"):
        rans_decode.rans_decode(case["tables"], case["words"], state, ptr,
                                idx.cpu(), act, case["end"])


def test_lane_codec_round_trip_on_the_card(card):
    """Version-3 containers, fp32 with all kernels: the decode launches the
    rANS kernel once per segment (1 + 10 RGB, 1 + 5 mask), re-encodes byte
    for byte, decodes alone as in the batch and gives the v1 decode."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec

    pipe = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    codec = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                          CodecIO(pipe.mask_codec, "mask"))
    d = synthetic_rgba_batch(2, 64, 128, seed=1)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    blobs = codec.encode_batch(img, alpha, stream_format="lanes32")
    before = rans_decode.KERNEL.launches
    dec = codec.decode_batch(blobs)
    assert rans_decode.KERNEL.launches - before == 17
    assert codec.encode_batch(img, alpha, stream_format="lanes32") == blobs
    assert np.array_equal(codec.decode_batch(blobs[:1])[0], dec[0])
    assert np.array_equal(codec.decode_batch(codec.encode_batch(img, alpha)),
                          dec)
    before = rans_decode.KERNEL.launches
    codec.decode_batch(blobs, max_slices=3)
    assert rans_decode.KERNEL.launches - before == 6 + 4


def test_gated_lane_codec_on_the_card(card):
    """Rate-gated version-3 containers whose gate closes cells: 48x112
    images padded to the /64 grid, the first opaque (its decoded alpha is
    0 in the padding).  The kernel's active flags come from the shipped
    gate: the decode re-encodes byte for byte, decodes alone as in the
    batch and equals the gated version-2 decode."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec, unpack_rgba

    pipe = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    codec = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                          CodecIO(pipe.mask_codec, "mask"))
    d = synthetic_rgba_batch(2, 64, 128, seed=1)
    img = np.round(d["image"][:, :48, :112] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"][:, :48, :112] * 255).astype(np.uint8)
    alpha[0] = 255
    v3 = codec.encode_batch(img, alpha, rate_gate=True,
                            stream_format="lanes32")
    gate = np.stack([unpack_rgba(b)["rgb"]["gate"] for b in v3])
    assert not gate[0].all()
    before = rans_decode.KERNEL.launches
    dec = codec.decode_batch(v3)
    assert rans_decode.KERNEL.launches - before == 17
    assert codec.encode_batch(img, alpha, rate_gate=True,
                              stream_format="lanes32") == v3
    assert np.array_equal(codec.decode_batch(v3[:1])[0], dec[0])
    v2 = codec.encode_batch(img, alpha, rate_gate=True)
    assert np.array_equal(np.stack([unpack_rgba(b)["rgb"]["gate"]
                                    for b in v2]), gate)
    assert np.array_equal(codec.decode_batch(v2), dec)


# ------------------------------------------------------------ rANS encode


def _encode_case(dev, rows, gated, batch=3, lanes=64, n=9000, seed=0):
    """One segment's inputs on ``dev`` in the lane layout: indexes on the
    Gaussian rows (y) or the z rows of a merged table, symbols around each
    row's centre with escapes, active flags (gated or only the tail's
    padding off); the tables and the flat arrays the host coder takes."""
    import numpy as np
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.entropy.gaussian import GaussianConditional, get_scale_table

    gc = GaussianConditional(get_scale_table())
    gc.update()
    g = dr.pack_tables(gc.quantized_cdfs, gc.cdf_lengths, gc.offsets)
    rng = np.random.RandomState(seed)
    # rows after the 64 Gaussian ones stand in for z's: a copy of 24 of them
    part = slice(10, 34)
    merged = dr.merge_tables(g, dr.pack_tables(
        gc.quantized_cdfs[part], gc.cdf_lengths[part], gc.offsets[part]))
    lo, hi = (0, 64) if rows == "y" else (64, 64 + 24)
    idx = rng.randint(lo, hi, (batch, n)).astype(np.int32)
    sym = (merged["offsets"][idx] + merged["max_values"][idx] // 2
           + rng.randint(-5, 6, (batch, n))).astype(np.int32)
    sym[:, ::37] = rng.randint(-3000, 3000, sym[:, ::37].shape)
    alive = rng.rand(batch, n) > 0.25 if gated else np.ones((batch, n), bool)
    t = {k: torch.from_numpy(merged[k]).to(dev)
         for k in ("cdfs", "max_values", "offsets")}

    def steps(a, fill=0):
        return dr.to_steps(torch.from_numpy(a).to(dev), lanes, fill=fill)
    return dict(tables=t, idx=steps(idx), sym=steps(sym),
                act=steps(alive, False), merged=merged, flat=(sym, idx, alive),
                batch=batch, lanes=lanes, n=n)


def _encode(case, fn, budget):
    from rgba_tpu_torch.entropy import device_rans as dr
    dev = case["idx"].device
    state, wptr, out = dr.init_encode((case["batch"],), case["lanes"], budget,
                                      dev)
    state, wptr, out = fn(case["tables"], state, wptr, out, case["idx"],
                          case["sym"], case["act"])
    torch.cuda.synchronize()
    return state, wptr, out


@pytest.mark.parametrize("rows", ["y", "z"])
@pytest.mark.parametrize("gated", [False, True], ids=["dense", "gated"])
def test_rans_encode_matches_plain_and_the_host(card, rows, gated):
    """The kernel gives the plain version's state, pointer and words bit for
    bit, one launch a segment; after finish_lanes each image's lanes are
    the host coder's words; a changed symbol changes the finished words."""
    import numpy as np
    from rgba_tpu_torch.entropy import device_rans as dr
    from rgba_tpu_torch.native import rans

    case = _encode_case(card, rows, gated)
    budget = 4096
    before = rans_encode.KERNEL.launches
    got = _encode(case, rans_encode.rans_encode, budget)
    assert rans_encode.KERNEL.launches - before == 1
    want = _encode(case, rans_encode.rans_encode_plain, budget)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    words, nwords, ovf = dr.finish_lanes(*got)
    assert not bool(ovf)
    words, nwords = words.cpu().numpy(), nwords.cpu().numpy()
    sym, idx, alive = case["flat"]
    m = case["merged"]
    for b in range(case["batch"]):
        host, lnw = rans.encode_lanes(sym[b], idx[b], [case["n"]],
                                      case["lanes"], m["cdfs"],
                                      m["max_values"] + 2, m["offsets"],
                                      alive=alive[b])
        np.testing.assert_array_equal(nwords[b], lnw)
        lanes = [words[b, lane, :nwords[b, lane]]
                 for lane in range(case["lanes"])]
        np.testing.assert_array_equal(np.concatenate(lanes), host)
    case["sym"][3, 1, 5] += 1
    changed = _encode(case, rans_encode.rans_encode, budget)
    # a symbol coded among the last may change only the final state: the
    # finished words hold it
    assert not torch.equal(dr.finish_lanes(*changed)[0],
                           dr.finish_lanes(*got)[0])


def test_rans_encode_overflow_stays_in_bounds(card):
    """A budget of 16 words: the lanes run past it, the kernel's pointers
    count on and its writes stay in each lane's last slot (the 8 words
    after the buffer, the last lane's slot W-1, are untouched), as in the
    plain version."""
    from rgba_tpu_torch.entropy import device_rans as dr
    case = _encode_case(card, "y", True, n=4000)
    budget = 16
    size = case["batch"] * case["lanes"] * budget
    flat = torch.full((size + 8,), -7, dtype=torch.int32, device=card)
    out = flat[:size].view(case["batch"], case["lanes"], budget)
    out.zero_()
    state, wptr, _ = dr.init_encode((case["batch"],), case["lanes"], budget,
                                    card)
    got = rans_encode.rans_encode(case["tables"], state, wptr, out,
                                  case["idx"], case["sym"], case["act"])
    assert got[2].data_ptr() == flat.data_ptr()
    want = _encode(case, rans_encode.rans_encode_plain, budget)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    assert bool(dr.finish_lanes(*got)[2])
    assert int(got[1].min()) >= budget
    assert bool((flat[size:] == -7).all())


@pytest.mark.parametrize("rows", ["y", "z"])
def test_rans_encode_reads_narrow_types(card, rows):
    """The codec's types (uint8 y rows, int16 z rows, int16 symbols): the
    kernel widens them itself and gives the int32 launch's state, pointer
    and words, and the plain version's."""
    case = _encode_case(card, rows, True)
    budget = 4096
    want = _encode(case, rans_encode.rans_encode, budget)
    narrow = dict(case, idx=case["idx"].to(
        torch.uint8 if rows == "y" else torch.int16),
        sym=case["sym"].to(torch.int16))
    got = _encode(narrow, rans_encode.rans_encode, budget)
    plain = _encode(narrow, rans_encode.rans_encode_plain, budget)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g.cpu(), p.cpu())


def test_rans_encode_refuses_bad_arguments(card):
    from rgba_tpu_torch.entropy import device_rans as dr
    case = _encode_case(card, "y", False, batch=1, n=500)
    state, wptr, out = dr.init_encode((1,), case["lanes"], 64, card)
    args = (case["idx"], case["sym"], case["act"])
    with pytest.raises(TypeError, match="state"):
        rans_encode.rans_encode(case["tables"], state.int(), wptr, out, *args)
    with pytest.raises(ValueError, match="symbols"):
        rans_encode.rans_encode(case["tables"], state, wptr, out, args[0],
                                args[1][:, :, :3].contiguous(), args[2])
    with pytest.raises(ValueError, match="device"):
        rans_encode.rans_encode(case["tables"], state, wptr, out,
                                args[0].cpu(), *args[1:])
    with pytest.raises(TypeError, match="indexes"):
        rans_encode.rans_encode(case["tables"], state, wptr, out,
                                args[0].long(), *args[1:])
    with pytest.raises(TypeError, match="symbols"):
        rans_encode.rans_encode(case["tables"], state, wptr, out, args[0],
                                args[1].to(torch.uint8), args[2])


def test_device_lane_encode_on_the_card(card, monkeypatch):
    """RGBA_TPU_DEVICE_ENCODE=1: a version-3 container encode launches the
    encode kernel once per segment (1 + 10 RGB, 1 + 5 mask), twice for a
    codec whose lanes overflowed the first budget, and writes the host
    route's bytes, gated and not."""
    import numpy as np
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec

    pipe = RGBAPipeline(_all_kernels(DEFAULT_POLICY), seed=0)
    codec = RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                          CodecIO(pipe.mask_codec, "mask"))
    d = synthetic_rgba_batch(2, 64, 128, seed=1)
    img = np.round(d["image"] * 255).astype(np.uint8)
    alpha = np.round(d["alpha"] * 255).astype(np.uint8)
    for gate in (False, True):
        monkeypatch.setenv("RGBA_TPU_DEVICE_ENCODE", "0")
        host = codec.encode_batch(img, alpha, rate_gate=gate,
                                  stream_format="lanes32")
        monkeypatch.setenv("RGBA_TPU_DEVICE_ENCODE", "1")
        before = rans_encode.KERNEL.launches
        dev = codec.encode_batch(img, alpha, rate_gate=gate,
                                 stream_format="lanes32")
        passes = {k: 2 if getattr(codec, f"{k}_io").last_lane_encode[
            "overflow"] else 1 for k in ("rgb", "mask")}
        assert rans_encode.KERNEL.launches - before == \
            11 * passes["rgb"] + 6 * passes["mask"]
        assert not codec.rgb_io.last_lane_encode["overflow"]
        assert dev == host


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_layout_follows_an_in_place_update(card, dtype):
    """After an optimizer step the GDN module's cached gamma layout is that
    of the new weights: its kernel route gives, bit for bit, the kernel fed
    a layout made afresh from the new gamma, and no longer its own output
    on the old one."""
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops.gdn import GDN
    g = torch.Generator().manual_seed(7)
    m = GDN(192, inverse=True, policy=Policy(dtype, fused_gdn=True),
            device=card, gamma_init=0.1)
    with torch.no_grad():
        m.gamma.add_((0.01 * torch.rand(192, 192, generator=g)).to(card))
    x = torch.randn(2, 192, 24, 40, generator=g).to(card, dtype)
    rows = x.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        old = m(x)
    opt = torch.optim.Adam(m.parameters(), lr=0.01)
    out = m(x)
    torch.sum(out.float() * torch.sin(out.float())).backward()
    opt.step()
    with torch.no_grad():
        beta, gamma = m.reparam()
        want = gdn.fused_gdn(rows, gamma.t(), beta, inverse=True,
                             prepared=gdn.kernel_weights(gamma.t(), dtype))
        new = m(x).permute(0, 2, 3, 1)
    assert torch.equal(new, want)
    assert not torch.equal(new, old.permute(0, 2, 3, 1))


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


# ------------------------------------------------- the kernels as operators


def _op_case(name, dtype, dev):
    """(operator arguments, a direct ctypes launch of the same kernel on
    them) at a small shape of each kernel."""
    import ctypes
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = int(dtype == torch.bfloat16)
    if name == "win_attn":
        t, region, alive, wq, bq, wp, bp, rb = _attn_args(24, 64, 192, 8,
                                                          dtype, dev)
        prep = win_attn.kernel_weights(wq, bq, wp, bp, 8, dtype)
        args = (t, region, alive.float(), *prep, rb, 8)

        def direct(out):
            win_attn.KERNEL.launch(
                t.data_ptr(), region.data_ptr(), args[2].data_ptr(),
                *(w.data_ptr() for w in prep), rb.data_ptr(), out.data_ptr(),
                24, 64, 192, 8, 24 ** -0.5, bf16, stream)
        return args, direct
    if name == "gdn":
        x, gt, beta = _gdn_args(1000, 192, dtype, dev)
        g = gdn.kernel_weights(gt, dtype)
        args = (x, g, beta, True)

        def direct(out):
            gdn.KERNEL.launch(x.data_ptr(), g.data_ptr(), beta.data_ptr(),
                              out.data_ptr(), 1000, 192, 1, bf16, stream)
        return args, direct
    if name == "gate_chain":
        x, gg, trunk, gate, fw, fb = _gate_args(1, 32, 48, 192, dtype, dev,
                                                True)
        prep = gate_chain.kernel_weights(trunk, gate, fw, fb, dtype)
        args = (x, gg, list(prep.trunk), list(prep.gate), prep.fw, prep.fb,
                gate_chain.ACTS.index("gelu_erf"), True)

        def direct(out):
            ptrs = ctypes.c_void_p * 6
            gate_chain.KERNEL.launch(
                x.data_ptr(), gg.data_ptr(),
                ptrs(*[t.data_ptr() for t in prep.trunk]),
                ptrs(*[t.data_ptr() for t in prep.gate]), prep.fw.data_ptr(),
                prep.fb.data_ptr(), out.data_ptr(), 1, 32, 48, 192,
                args[6], 1, bf16, stream)
        return args, direct
    x, *w = _dse_args(1, 40, 56, 3, dtype, dev)
    prep = dse.kernel_weights(*w, dtype)
    args = (x, *prep, False)

    def direct(out):
        dse.KERNEL.launch(x.data_ptr(), *(t.data_ptr() for t in prep),
                          out.data_ptr(), 1, 40, 56, 3, 0, bf16, stream)
    return args, direct


def _fake_of(name, args):
    """The operator's fake on fake copies of ``args``: shape, dtype and
    device of the output, as torch.export sees them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    mode = FakeTensorMode()
    fargs = tree_map(lambda t: mode.from_tensor(t) if torch.is_tensor(t)
                     else t, args)
    with mode:
        out = getattr(torch.ops.rgba_tpu_torch, name)(*fargs)
    return tuple(out.shape), out.dtype, out.device


OPS = ["win_attn", "gdn", "gate_chain", "dse"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", OPS)
def test_the_operator_is_the_direct_launch(card, name, dtype):
    """torch.ops.rgba_tpu_torch.<name> gives the bits of a direct launch of
    its kernel, counts one launch, and its fake gives the output's shape,
    dtype and device."""
    args, direct = _op_case(name, dtype, card)
    kern = {"win_attn": win_attn, "gdn": gdn, "gate_chain": gate_chain,
            "dse": dse}[name].KERNEL
    before = kern.launches
    got = getattr(torch.ops.rgba_tpu_torch, name)(*args)
    assert kern.launches == before + 1
    want = torch.empty_like(args[0])
    direct(want)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _fake_of(name, args) == (tuple(got.shape), got.dtype, got.device)


def test_an_exported_serving_pipeline_launches_the_attention_kernel(card,
                                                                    tmp_path):
    """SERVE_POLICY (bf16, the attention kernel only): the artifact holds
    the operator, runs it 4 times a call after a save and load, and
    equals the eager forward."""
    from rgba_tpu_torch.eval.export import (export_serving_forward,
                                            load_artifact, save_artifact)
    pipe = RGBAPipeline(SERVE_POLICY, seed=0)
    d = synthetic_rgba_batch(2, 64, 128, seed=1)
    x = torch.from_numpy(d["masked_image"]).to(card)
    a = torch.from_numpy(d["alpha"]).to(card)
    eager = pipe(x, a)
    art = export_serving_forward(pipe, (x, a))
    assert art.kernel_ops() == ["rgba_tpu_torch.win_attn.default"]
    path = str(tmp_path / "serve.pt2")
    save_artifact(art, path)
    loaded = load_artifact(path)
    assert loaded.compute_dtype == "bfloat16"
    loaded(x, a)
    before = _launches()
    out = loaded(x, a)
    torch.cuda.synchronize()
    assert tuple(n - b for n, b in zip(_launches(), before)) == (4, 0, 0, 0)
    ref = eager["x_hat"].float()
    err = float((out["x_hat"].float() - ref).abs().max())
    assert err <= 2.0 ** -5 * max(1.0, float(ref.abs().max()))
    assert abs(float(out["bpp"]) - float(eager["bpp"])) <= \
        1e-3 * float(eager["bpp"])


def test_an_unbundled_artifact_lays_out_the_weights_it_is_given(card):
    """Parameters as a runtime argument: the kernel layouts come from the
    weights of each call, not from the weights at export time (a stale
    layout would give the first weights' rate back)."""
    from rgba_tpu_torch.eval.export import export_serving_forward
    pipe = RGBAPipeline(SERVE_POLICY, seed=0)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
    d = synthetic_rgba_batch(1, 64, 128, seed=2)
    x = torch.from_numpy(d["masked_image"]).to(card)
    a = torch.from_numpy(d["alpha"]).to(card)
    art = export_serving_forward(pipe, (x, a), bundle_params=False)
    assert art.kernel_ops() == ["rgba_tpu_torch.win_attn.default"]
    params = {k: v.detach() for k, v in pipe.named_parameters()}
    other = {k: v * 1.5 if ".attn.attn." in k else v
             for k, v in params.items()}
    got, first = art(other, x, a), art(params, x, a)
    with torch.inference_mode():
        want = torch.func.functional_call(pipe, other, (x, a))
    ref = want["x_hat"].float()
    tol = 2.0 ** -5 * max(1.0, float(ref.abs().max()))
    assert float((got["x_hat"].float() - ref).abs().max()) <= tol
    assert abs(float(got["bpp"]) - float(want["bpp"])) <= \
        1e-3 * float(want["bpp"])
    assert float(got["bpp"]) != float(first["bpp"])
