"""The 3x3 stride-1 fp32 kernel's parts that run without a card
(``ops/kernels/conv3x3.py``, ``ops/conv.py``): which convolutions
``conv2d`` routes to it, its weight layout against a reshape of the torch
weight written out here, and its walk (tiles, halos, units, the three
TF32 terms in order) in plain PyTorch against ``F.conv2d``, with two
images in one tile whose padding must not read the other image."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from rgba_tpu_torch.core.precision import (DEFAULT_POLICY,
                                           batch_invariant_scope)
from rgba_tpu_torch.ops import conv as conv_mod
from rgba_tpu_torch.ops.conv import Conv, ConvTranspose, takes_conv3x3
from rgba_tpu_torch.ops.kernels import conv3x3 as k3
from rgba_tpu_torch.ops.kernels.tf32 import round_tf32

F32, BF16 = torch.float32, torch.bfloat16
ROUTED = ("cuda", F32, (3, 3), 1, 1, True, True)


@pytest.mark.parametrize("change,taken", [
    ({}, True),
    ({3: (1, 1), 4: (1, 1)}, True),       # stride and padding as pairs
    ({3: 2}, False),                      # strided 3x3
    ({2: (1, 1), 4: 0}, False),           # 1x1
    ({2: (5, 5), 4: 2}, False),           # 5x5
    ({2: (5, 5), 3: 2, 4: 2}, False),     # 5x5 stride 2
    ({1: BF16}, False),                   # bf16 compute
    ({5: False}, False),                  # a plain path: no module
    ({4: (0, 1)}, False),                 # a height band
    ({6: False}, False),                  # outside batch_invariant_scope
    ({0: "cpu"}, False),                  # the CPU keeps per_image
    ({4: 0}, False),                      # 3x3 without padding
])
def test_routing_predicate(change, taken):
    args = list(ROUTED)
    for i, v in change.items():
        args[i] = v
    assert takes_conv3x3(*args) is taken


def test_conv_modules_ask_with_their_geometry(monkeypatch):
    """What ``Conv`` passes the predicate: its kernel size, stride and
    padding, the policy's dtype and the scope; transposed convolutions
    never ask."""
    seen = []

    def spy(*args):
        seen.append(args)
        return takes_conv3x3(*args)
    monkeypatch.setattr(conv_mod, "takes_conv3x3", spy)
    kw = dict(policy=DEFAULT_POLICY, device="cpu",
              generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 8, 6, 6)
    mods = [Conv(8, 8, 3, 1, **kw), Conv(8, 8, 3, 2, **kw),
            Conv(8, 8, 1, 1, **kw), Conv(8, 8, 5, 2, **kw),
            ConvTranspose(8, 8, 5, 2, **kw)]
    with torch.no_grad(), batch_invariant_scope():
        for m in mods:
            m(x)
    assert len(seen) == 4
    on_card = [takes_conv3x3("cuda", *a[1:]) for a in seen]
    assert on_card == [True, False, False, False]
    assert all(a[0] == "cpu" and a[-1] is True for a in seen)
    with torch.no_grad():
        mods[0](x)
    assert takes_conv3x3("cuda", *seen[-1][1:]) is False   # out of scope


def test_plain_paths_and_int8_keep_per_image(monkeypatch):
    """The kernel sites' plain paths (the gate chain's bottleneck blocks,
    the DSE chain) call ``conv2d`` without a module, so they ask with
    ``cached`` False and keep ``per_image`` on the card too; an int8
    convolution returns before it asks."""
    import dataclasses
    from rgba_tpu_torch.ops.attention import bottleneck_block
    from rgba_tpu_torch.ops.enhance import dse_chain
    seen = []

    def spy(*args):
        seen.append(args)
        return takes_conv3x3(*args)
    monkeypatch.setattr(conv_mod, "takes_conv3x3", spy)
    g = torch.Generator().manual_seed(0)

    def wb(co, ci, k):
        return [torch.randn(co, ci, k, k, generator=g) * 0.1,
                torch.zeros(co)]
    x = torch.randn(2, 8, 6, 6, generator=g)
    with torch.no_grad(), batch_invariant_scope():
        bottleneck_block(x, wb(4, 8, 1) + wb(4, 4, 3) + wb(8, 4, 1),
                         DEFAULT_POLICY, "relu", False)
        dse_chain(x, wb(8, 8, 1) + sum((wb(8, 8, 3) for _ in range(6)), [])
                  + wb(8, 8, 1), DEFAULT_POLICY, False)
    threes = [a for a in seen if tuple(a[2]) == (3, 3)]
    assert len(threes) == 7
    assert not any(takes_conv3x3("cuda", *a[1:]) for a in seen)
    seen.clear()
    int8 = dataclasses.replace(DEFAULT_POLICY, int8_conv=True)
    m = Conv(8, 8, 3, 1, policy=int8, device="cpu", generator=g)
    with torch.no_grad(), batch_invariant_scope():
        m(x)
    assert seen == []


def test_the_cpu_keeps_cudnn_s_arithmetic():
    """On the CPU a routed shape still runs ``F.conv2d`` image by image."""
    kw = dict(policy=DEFAULT_POLICY, device="cpu",
              generator=torch.Generator().manual_seed(0))
    m = Conv(8, 16, 3, 1, **kw)
    x = torch.randn(3, 8, 5, 7)
    with torch.no_grad(), batch_invariant_scope():
        got = m(x)
    want = torch.cat([F.conv2d(x[i:i + 1], m.weight, m.bias, 1, 1)
                      for i in range(3)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("co,ci", [(12, 40), (70, 8), (130, 64)])
def test_weight_layout(co, ci):
    """Unit (N tile, channel block, tap): the hi, then the lo, of
    w[n, c, dy, dx] at (n % bn // 8) * 8 * 32 + (c % 32 // 4) * 32 +
    (n % 8) * 4 + c % 4, zero past Cout and Cin."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(co, ci, 3, 3, generator=g)
    got = k3.kernel_weights(w).numpy()
    bn, kc = k3.block_n(co), k3.KC
    ntn, nb = -(-co // bn), -(-ci // kc)
    assert got.size == 2 * ntn * bn * nb * kc * 9
    hi = round_tf32(w).numpy()
    lo = round_tf32(w - round_tf32(w)).numpy()
    want = np.zeros(got.size, np.float32)
    unit = 2 * bn * kc
    for n in range(co):
        for c in range(ci):
            for dy in range(3):
                for dx in range(3):
                    u = (n // bn * nb + c // kc) * 9 + 3 * dy + dx
                    r, k = n % bn, c % kc
                    off = u * unit + (r // 8) * 8 * kc + (k // 4) * 32 + \
                        (r % 8) * 4 + k % 4
                    want[off] = hi[n, c, dy, dx]
                    want[off + bn * kc] = lo[n, c, dy, dx]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,h,w,ci,co", [(2, 5, 10, 40, 12), (3, 9, 17, 8, 70),
                                         (1, 8, 16, 64, 130)])
def test_the_kernel_s_walk_equals_conv2d(b, h, w, ci, co):
    """The walk over the kernel's tiles and units, the weights read from
    their layout, equals F.conv2d within fp32 rounding.  At 5x10 a tile
    (8x16) holds all of an image and more: the rows below an image are the
    next image's in memory, and must be read as zeros."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, h, w, ci, generator=g) + 3.0   # no zero rows to hide in
    wt = torch.randn(co, ci, 3, 3, generator=g) / (9 * ci) ** 0.5
    bias = torch.randn(co, generator=g)
    got = k3.conv3x3_plain(x, k3.kernel_weights(wt), bias, co)
    ref = F.conv2d(x.permute(0, 3, 1, 2).double(), wt.double(),
                   bias.double(), 1, 1).permute(0, 2, 3, 1)
    assert got.shape == ref.shape
    assert float((got.double() - ref).abs().max()) <= 1e-5 * float(
        ref.abs().max())


def test_shapes_the_kernel_refuses():
    x = torch.zeros(1, 12, 4, 4)
    with pytest.raises(ValueError):
        k3.check_shapes(x, torch.zeros(16, 12, 3, 3), torch.zeros(16))
    with pytest.raises(ValueError):
        k3.check_shapes(torch.zeros(1, 16, 4, 4), torch.zeros(15, 16, 3, 3),
                        torch.zeros(15))
    with pytest.raises(TypeError):
        k3.check_shapes(x.to(BF16), torch.zeros(16, 12, 3, 3), torch.zeros(16))
    with pytest.raises(ValueError):
        k3.conv3x3(torch.zeros(1, 16, 4, 4), torch.zeros(16, 16, 3, 3),
                   torch.zeros(16))          # a CPU tensor never launches
    assert [k3.block_n(c) for c in (8, 12, 16, 64, 128, 224, 1280)] == \
        [16, 16, 16, 64, 128, 128, 128]
