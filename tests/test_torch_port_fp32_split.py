"""The fp32 gate-chain and DSE kernels' 3xTF32 arithmetic, on the CPU.

On the card both kernels take every fp32 product on the tensor cores as
three TF32 products, a_lo b_hi + a_hi b_lo + a_hi b_hi, where hi is the
value rounded to the nearest TF32 number (ties away from zero, the low 13
bits zero) and lo is the remainder rounded the same way.  The weights' hi
and lo come laid out by ``kernel_weights(..., torch.float32)``; the kernels
split the activations in registers by the same rule.

Here the layout is read back with an offset formula written independently
of the code that builds it: hi + lo gives each weight within 2^-21
relative, hi and lo are TF32 values, every padding entry is 0, and the
gate chain's h1 product has its k in the order the kernel's registers hold
h1.  A plain emulation of the kernels' products from what was read back
(activations split by this file's own rule) must match the plain versions
within the card's fp32 tolerance (2e-5 + 2e-5 |ref|) and the Pallas
kernels in interpret mode within tests/test_torch_port_kernels2.py's 1e-4;
the same emulation with one TF32 product (no lo terms) must miss the
tolerance, so the check sees a missing lo term.

Inputs are seeded numpy at a few pixels.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from rgba_tpu.ops.pallas.dse import fused_dse as j_fused_dse  # noqa: E402
from rgba_tpu.ops.pallas.gate_chain import fused_gate_chain as j_fgc  # noqa: E402

from rgba_tpu_torch.ops.kernels import dse as kdse  # noqa: E402
from rgba_tpu_torch.ops.kernels import gate_chain as kgc  # noqa: E402

torch.set_num_threads(2)

FP32 = torch.float32
TOL = 2e-5            # the card's fp32 tolerance: TOL + TOL * |ref|
PALLAS_TOL = 1e-4     # tests/test_torch_port_kernels2.py
PERM = (0, 2, 4, 6, 1, 3, 5, 7)   # h1 channel of k 8j + p: 8j + PERM[p]
HP_CHOICES = (16, 32, 40, 48, 64, 80, 96)


def _tf32(a):
    """Round fp32 to the nearest TF32 value, ties away from zero (numpy)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return bits.astype(np.uint32).view(np.float32)


def _split(t):
    a = t.detach().float().numpy()
    hi = _tf32(a)
    lo = _tf32(a - hi)
    return torch.from_numpy(hi), torch.from_numpy(lo)


def _read(flat, n, k, kc):
    """(hi, lo) n x k matrices from a stream of chunks of kc k (the last
    may be shorter): chunk k0 // kc starts 2 n k0 in and holds hi, then lo
    (n * width further); inside each, 8-row groups of width / 4 core
    matrices of 8 rows x 4 k, 32 elements each."""
    flat = flat.reshape(-1)
    r, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    k0 = kk // kc * kc
    width = np.minimum(kc, k - k0)
    off = (2 * n * k0 + (r // 8) * (width // 4) * 32 + ((kk - k0) // 4) * 32
           + (r % 8) * 4 + kk % 4)
    both = np.concatenate([off.ravel(), (off + n * width).ravel()])
    assert len(np.unique(both)) == 2 * n * k == flat.numel()
    return flat[torch.from_numpy(off)], flat[torch.from_numpy(off + n * width)]


def _check_split(hi, lo, w):
    """hi + lo is w within 2^-21 relative; hi and lo are TF32 values."""
    for t in (hi, lo):
        assert not (t.contiguous().view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())


def _mm(a, w_hi, w_lo, terms):
    """a (..., K) x w (K, N) as the kernel takes it: three TF32 products
    summed in fp32, or only hi x hi."""
    a_hi, a_lo = _split(a)
    a_hi, a_lo = a_hi.reshape(a.shape), a_lo.reshape(a.shape)
    out = a_hi @ w_hi
    if terms == 3:
        out = a_lo @ w_hi + a_hi @ w_lo + out
    return out


def _cols(t):
    """(B, H, W, C) -> (B, H, W, 9 C), k = (dy, dx, c), zero padding."""
    _, h, w, _ = t.shape
    p = F.pad(t, (0, 0, 1, 1, 1, 1))
    return torch.cat([p[:, dy:dy + h, dx:dx + w] for dy in range(3)
                      for dx in range(3)], dim=-1)


def _within(got, want, tol=TOL):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


# --------------------------------------------------------------- gate chain


def _gate_inputs(seed, b, h, w, c, separate):
    rng = np.random.RandomState(seed)
    half = c // 2

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))

    def chain():
        return kgc.GateChainWeights(
            t(3, c, half, scale=c ** -0.5), t(3, half, scale=0.1),
            t(3, 9 * half, half, scale=(9 * half) ** -0.5),
            t(3, half, scale=0.1), t(3, half, c, scale=0.5 * half ** -0.5),
            t(3, c, scale=0.1))
    x = t(b, h, w, c)
    g = t(b, h, w, c) if separate else None
    return x, g, chain(), chain(), t(c, c, scale=c ** -0.5), t(c, scale=0.1)


def _geometry(c):
    half = c // 2
    hp = next(v for v in HP_CHOICES if v >= half)
    return half, hp, -(-c // hp)


def _read_chain(pc, c):
    """One chain's fp32 layout -> (hi, lo) of w0 (3, hp, c), w1 (3, hp,
    9 hp), w2 (3, nb hp, hp) with w2's k as stored."""
    half, hp, nb = _geometry(c)

    def stack(t, n, k, blocks=1):
        pairs = [_read(blk, n, k, 16) for row in t
                 for blk in row.reshape(blocks, -1)]
        return tuple(torch.stack([p[i] for p in pairs]).reshape(3, blocks * n, k)
                     for i in (0, 1))
    return (stack(pc[0], hp, c), stack(pc[2], hp, 9 * hp),
            stack(pc[4], hp, hp, nb))


@pytest.mark.parametrize("c", [16, 40, 80])
def test_gate_chain_fp32_layout_reads_back(c):
    x, g, trunk, gate, fw, fb = _gate_inputs(1, 1, 2, 2, c, True)
    prep = kgc.kernel_weights(trunk, gate, fw, fb, FP32)
    half, hp, nb = _geometry(c)
    perm = torch.tensor([8 * (k // 8) + PERM[k % 8] for k in range(hp)])
    for cw, pc in ((trunk, prep.trunk), (gate, prep.gate)):
        assert all(t.dtype == FP32 for t in pc)
        (w0h, w0l), (w1h, w1l), (w2h, w2l) = _read_chain(pc, c)
        _check_split(w0h[:, :half], w0l[:, :half], cw.w0.transpose(1, 2))
        w1 = cw.w1.reshape(3, 9, half, half).permute(0, 3, 1, 2)  # [o][tap][ci]
        _check_split(w1h.reshape(3, hp, 9, hp)[:, :half, :, :half],
                     w1l.reshape(3, hp, 9, hp)[:, :half, :, :half], w1)
        # k of the h1 product in the order of the kernel's registers
        w2h, w2l = w2h[..., torch.argsort(perm)], w2l[..., torch.argsort(perm)]
        _check_split(w2h[:, :c, :half], w2l[:, :c, :half], cw.w2.transpose(1, 2))
        for t in (w0h, w0l, w1h.reshape(3, hp, 9, hp), w1l.reshape(3, hp, 9, hp)):
            assert not t[:, half:].any()
        for t in (w1h.reshape(3, hp, 9, hp), w1l.reshape(3, hp, 9, hp)):
            assert not t[..., half:].any()
        for t in (w2h, w2l):
            assert not t[:, c:].any() and not t[..., half:].any()
        for got, want in zip(pc[1::2], (cw.b0, cw.b1, cw.b2)):
            assert torch.equal(got, want)
    fwh, fwl = (torch.cat(p) for p in zip(*[_read(blk, hp, c, 16)
                                             for blk in prep.fw.reshape(nb, -1)]))
    _check_split(fwh[:c], fwl[:c], fw.t())
    assert not fwh[c:].any() and not fwl[c:].any()
    assert torch.equal(prep.fb, fb)


def _act(v, act):
    return kgc.activation(v, act)


def _emulated_chain(t, pc, c, act, post_act, terms):
    half, hp, nb = _geometry(c)
    (w0h, w0l), (w1h, w1l), (w2h, w2l) = _read_chain(pc, c)
    perm = torch.tensor([8 * (k // 8) + PERM[k % 8] for k in range(hp)])

    def pad(b, n):
        return F.pad(b.float(), (0, n - b.shape[-1]))
    cur = t
    for blk in range(3):
        h0 = _act(_mm(cur, w0h[blk].t(), w0l[blk].t(), terms) + pad(pc[1][blk], hp), act)
        h1 = _act(_mm(_cols(h0), w1h[blk].t(), w1l[blk].t(), terms)
                  + pad(pc[3][blk], hp), act)
        out = (_mm(h1[..., perm], w2h[blk].t(), w2l[blk].t(), terms)[..., :c]
               + pc[5][blk] + cur)
        cur = _act(out, act) if post_act else out
    return cur


def _emulated_gate(x, g, prep, c, act, post_act, terms=3):
    _, hp, nb = _geometry(c)
    t = _emulated_chain(x, prep.trunk, c, act, post_act, terms)
    a = _emulated_chain(x if g is None else g, prep.gate, c, act, post_act, terms)
    fwh, fwl = (torch.cat(p) for p in zip(*[_read(blk, hp, c, 16)
                                             for blk in prep.fw.reshape(nb, -1)]))
    s = torch.sigmoid(_mm(a, fwh.t(), fwl.t(), terms)[..., :c] + prep.fb)
    return x + t * s


FLAVOURS = {"wingate": ("gelu_erf", True, True), "simplified": ("relu", False, False)}


@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
@pytest.mark.parametrize("c", [16, 40])
def test_gate_chain_3xtf32_matches_plain(flavour, c):
    act, post, separate = FLAVOURS[flavour]
    x, g, trunk, gate, fw, fb = _gate_inputs(2, 2, 5, 7, c, separate)
    prep = kgc.kernel_weights(trunk, gate, fw, fb, FP32)
    want = kgc.gate_chain_plain(x, g, trunk, gate, fw, fb, act, post)
    assert _within(_emulated_gate(x, g, prep, c, act, post), want)
    # one TF32 product misses the tolerance: the check sees a lost lo term
    assert not _within(_emulated_gate(x, g, prep, c, act, post, terms=1), want)


def _jax_gate_params(x_chain, names, keys):
    """GateChainWeights -> the JAX kernel's {name: {key: conv}} tree."""
    c, half = x_chain.w0.shape[1], x_chain.w0.shape[2]
    p = {}
    for i, n in enumerate(names):
        p[n] = {keys[0]: {"kernel": x_chain.w0[i].numpy().reshape(1, 1, c, half),
                          "bias": x_chain.b0[i].numpy()},
                keys[1]: {"kernel": x_chain.w1[i].numpy().reshape(3, 3, half, half),
                          "bias": x_chain.b1[i].numpy()},
                keys[2]: {"kernel": x_chain.w2[i].numpy().reshape(1, 1, half, c),
                          "bias": x_chain.b2[i].numpy()}}
    return p


@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
def test_gate_chain_3xtf32_matches_pallas(flavour):
    act, post, separate = FLAVOURS[flavour]
    c = 80
    x, g, trunk, gate, fw, fb = _gate_inputs(3, 2, 8, 8, c, separate)
    trunk_n, gate_n = ("t0", "t1", "t2"), ("g0", "g1", "g2")
    keys = ("conv0", "conv1", "conv2")
    p = {**_jax_gate_params(trunk, trunk_n, keys),
         **_jax_gate_params(gate, gate_n, keys),
         "final": {"kernel": fw.numpy().reshape(1, 1, c, c), "bias": fb.numpy()}}
    want = j_fgc(jnp.asarray(x.numpy()), None if g is None else jnp.asarray(g.numpy()),
                 p, act=act, post_act=post, trunk_names=trunk_n, gate_names=gate_n,
                 block_keys=keys, final_name="final", interpret=True)
    prep = kgc.kernel_weights(trunk, gate, fw, fb, FP32)
    got = _emulated_gate(x, g, prep, c, act, post)
    err = float((got - torch.from_numpy(np.array(want))).abs().max())
    assert err <= PALLAS_TOL, err


# ---------------------------------------------------------------------- DSE


def _dse_inputs(seed, b, h, w, cio):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))
    return (torch.from_numpy(rng.rand(b, h, w, cio).astype(np.float32)),
            t(cio, 32, scale=cio ** -0.5), t(32, scale=0.1),
            t(6, 288, 32, scale=288 ** -0.5), t(6, 32, scale=0.1),
            t(32, cio, scale=32 ** -0.5), t(cio, scale=0.1))


def _read_dse(prep):
    """(hi, lo) of the six 3x3s as (6, 32 out, 288 in), k = (tap, ci)."""
    assert prep[2].shape == (6, 9 * 2 * 32 * 32) and prep[2].dtype == FP32
    pairs = [_read(tap, 32, 32, 32) for conv in prep[2]
             for tap in conv.reshape(9, -1)]
    return tuple(torch.stack([p[i] for p in pairs]).reshape(6, 9, 32, 32)
                 .permute(0, 2, 1, 3).reshape(6, 32, 288) for i in (0, 1))


@pytest.mark.parametrize("cio", [1, 3])
def test_dse_fp32_layout_reads_back(cio):
    x, w_in, b_in, w3, b3, w_out, b_out = _dse_inputs(4, 1, 2, 2, cio)
    prep = kdse.kernel_weights(w_in, b_in, w3, b3, w_out, b_out, FP32)
    hi, lo = _read_dse(prep)
    _check_split(hi, lo, w3.transpose(1, 2))
    for got, want in zip(prep[:2] + prep[3:], (w_in, b_in, b3, w_out, b_out)):
        assert torch.equal(got, want)


def _emulated_dse(x, prep, leaky, terms=3):
    hi, lo = _read_dse(prep)

    def act(v):
        return F.leaky_relu(v, 0.01) if leaky else F.relu(v)
    first = x @ prep[0] + prep[1]
    y = first
    for blk in range(3):
        i, j = 2 * blk, 2 * blk + 1
        z = act(_mm(_cols(y), hi[i].t(), lo[i].t(), terms) + prep[3][i])
        y = _mm(_cols(z), hi[j].t(), lo[j].t(), terms) + prep[3][j] + y
    return (y + first) @ prep[4] + prep[5] + x


@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
def test_dse_3xtf32_matches_plain(cio, leaky):
    x, *wts = _dse_inputs(5, 2, 9, 11, cio)
    prep = kdse.kernel_weights(*wts, FP32)
    want = kdse.dse_plain(x, *wts, leaky)
    assert _within(_emulated_dse(x, prep, leaky), want)
    assert not _within(_emulated_dse(x, prep, leaky, terms=1), want)


@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
def test_dse_3xtf32_matches_pallas(cio, leaky):
    x, w_in, b_in, w3, b3, w_out, b_out = _dse_inputs(6, 1, 32, 32, cio)
    convs = w3.numpy().reshape(6, 3, 3, 32, 32)
    p = {"input_conv": {"kernel": w_in.numpy().reshape(1, 1, cio, 32),
                        "bias": b_in.numpy()},
         "output_conv": {"kernel": w_out.numpy().reshape(1, 1, 32, cio),
                         "bias": b_out.numpy()}}
    for e, k in enumerate(("enh1", "enh2", "enh3")):
        p[k] = {cv: {"kernel": convs[2 * e + i], "bias": b3[2 * e + i].numpy()}
                for i, cv in enumerate(("conv1", "conv2"))}
    want = j_fused_dse(jnp.asarray(x.numpy()), p, leaky=leaky, interpret=True)
    prep = kdse.kernel_weights(w_in, b_in, w3, b3, w_out, b_out, FP32)
    got = _emulated_dse(x, prep, leaky)
    err = float((got - torch.from_numpy(np.array(want))).abs().max())
    assert err <= PALLAS_TOL, err
