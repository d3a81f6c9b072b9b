"""The fp32 window-attention and GDN kernels' 3xTF32 arithmetic, on the CPU.

On the card both kernels take every fp32 product on the tensor cores as
three TF32 products, a_lo b_hi + a_hi b_lo + a_hi b_hi, where hi is the
value rounded to the nearest TF32 number (ties away from zero, the low 13
bits zero) and lo is the remainder rounded the same way.  The weights' hi
and lo come laid out by ``kernel_weights(..., torch.float32)``; the kernels
split the activations (tokens, q, k, P, v, the head outputs, x^2) in
registers by the same rule.

Here the layouts are read back with an offset formula written
independently of the code that builds them: hi + lo gives each weight
within 2^-21 relative, hi and lo are TF32 values and every padding entry is
0; GDN's k follows the order in which the kernel's registers hold x.  A
plain emulation of the kernels' products from what was read back must
match the plain versions within the card's fp32 tolerance (2e-5 + 2e-5
|ref|) and the Pallas kernels in interpret mode within 1e-4; the same
emulation with one TF32 product (no lo terms) must miss the tolerance, so
the check sees a missing lo term.

Inputs are seeded numpy at a few windows and rows.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.ops.pallas.gdn import fused_gdn as j_fused_gdn  # noqa: E402
from rgba_tpu.ops.pallas.win_attn import fused_window_attention as j_fwa  # noqa: E402

from rgba_tpu_torch.ops.kernels import gdn as kgdn  # noqa: E402
from rgba_tpu_torch.ops.kernels import win_attn as kwa  # noqa: E402

torch.set_num_threads(2)

FP32 = torch.float32
TOL = 2e-5            # the card's fp32 tolerance: TOL + TOL * |ref|
PALLAS_TOL = 1e-4     # tests/test_torch_port_ops.py's kernel tolerance
GDN_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)   # channel of GDN's k 8j + p: 8j + ORDER[p]
GDN_ROWS = 192                          # the kernel's n: one m64n192 wgmma


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


def _read(flat, n, k, kc=16):
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
    """a (..., K) x w (K, N) with w given as hi and lo, as the kernels take
    it: three TF32 products summed in fp32, or only hi x hi."""
    a_hi, a_lo = _split(a)
    a_hi, a_lo = a_hi.reshape(a.shape), a_lo.reshape(a.shape)
    out = a_hi @ w_hi
    if terms == 3:
        out = a_lo @ w_hi + a_hi @ w_lo + out
    return out


def _bmm(a, b, terms):
    """a (..., M, K) x b (..., K, N), both activations split the same way."""
    b_hi, b_lo = _split(b)
    return _mm(a, b_hi.reshape(b.shape), b_lo.reshape(b.shape), terms)


def _within(got, want, tol=TOL):
    return bool(((got - want).abs() <= tol + tol * want.abs()).all())


# ------------------------------------------------------------ window attention


def _attn_inputs(seed, nw, n, c, nh):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))
    alive = (np.arange(nw) % 3 != 1).astype(np.float32).reshape(nw, 1)
    return [t(nw, n, c),
            torch.from_numpy(rng.randint(0, 3, (nw, n)).astype(np.int32)),
            torch.from_numpy(alive),
            t(c, 3 * c, scale=c ** -0.5), t(3 * c, scale=0.1),
            t(c, c, scale=c ** -0.5), t(c, scale=0.1), t(nh, n, n)]


def _attn_geometry(c, nh):
    hd = c // nh
    hdp = -(-hd // 8) * 8
    ns = 3 * hdp
    return hd, hdp, ns, nh * hdp, -(-c // ns)


def _read_attn(wts, c, nh):
    """(hi, lo) of the q|k|v projection as (nh, ns, C) [head][part, d][in]
    and of the output projection as (nco * ns, ko) [out][h * hdp + d]."""
    _, _, ns, ko, nco = _attn_geometry(c, nh)
    assert wts.wqkv.shape == (nh, 2 * ns * c) and wts.wqkv.dtype == FP32
    assert wts.wproj.shape == (nco, 2 * ns * ko) and wts.wproj.dtype == FP32
    q = [_read(w, ns, c) for w in wts.wqkv]
    p = [_read(w, ns, ko) for w in wts.wproj]
    return (tuple(torch.stack([x[i] for x in q]) for i in (0, 1)),
            tuple(torch.cat([x[i] for x in p]) for i in (0, 1)))


@pytest.mark.parametrize("c,nh", [(192, 8), (80, 8), (24, 3), (120, 8)])
def test_attention_fp32_layout_reads_back(c, nh):
    _, _, _, wq, bq, wp, bp, _ = _attn_inputs(1, 1, 16, c, nh)
    wts = kwa.kernel_weights(wq, bq, wp, bp, nh, FP32)
    hd, hdp, ns, ko, nco = _attn_geometry(c, nh)
    (qh, ql), (ph, pl) = _read_attn(wts, c, nh)
    for h in range(nh):
        for part in range(3):
            rows = slice(part * hdp, part * hdp + hd)
            cols = slice(part * c + h * hd, part * c + (h + 1) * hd)
            _check_split(qh[h, rows], ql[h, rows], wq[:, cols].t())
            pad = slice(part * hdp + hd, (part + 1) * hdp)
            assert not qh[h, pad].any() and not ql[h, pad].any()
    # [out][h hdp + d] against wproj [h hd + d][out]
    for h in range(nh):
        ks = slice(h * hdp, h * hdp + hd)
        _check_split(ph[:c, ks], pl[:c, ks], wp[h * hd:(h + 1) * hd].t())
        assert not ph[:, h * hdp + hd:(h + 1) * hdp].any()
        assert not pl[:, h * hdp + hd:(h + 1) * hdp].any()
    assert not ph[c:].any() and not pl[c:].any()
    assert torch.equal(wts.bqkv, bq) and torch.equal(wts.bproj, bp)


def _emulated_attention(args, nh, terms=3):
    """The fp32 kernel's arithmetic from the read-back layout: each product
    in ``terms`` TF32 terms, the scale, rel_bias, mask and softmax in fp32,
    the head outputs padded to hdp as the kernel keeps them."""
    tokens, region, alive, wq, bq, wp, bp, rb = args
    nw, n, c = tokens.shape
    hd, hdp, ns, ko, nco = _attn_geometry(c, nh)
    wts = kwa.kernel_weights(wq, bq, wp, bp, nh, FP32)
    (qh, ql), (ph, pl) = _read_attn(wts, c, nh)
    mask = torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
    outs = []
    for h in range(nh):
        b = torch.zeros(ns)
        for part in range(3):
            b[part * hdp:part * hdp + hd] = bq[part * c + h * hd:part * c + (h + 1) * hd]
        qkv = _mm(tokens, qh[h].t(), ql[h].t(), terms) + b      # (nw, n, ns)
        q, k, v = qkv[..., :hdp], qkv[..., hdp:2 * hdp], qkv[..., 2 * hdp:]
        s = _bmm(q, k.transpose(1, 2), terms) * (hd ** -0.5) + rb[h] + mask
        p = torch.softmax(s, dim=-1)
        outs.append(_bmm(p, v, terms))                           # (nw, n, hdp)
    o = torch.cat(outs, dim=-1)                                  # (nw, n, ko)
    res = _mm(o, ph.t(), pl.t(), terms)[..., :c] + bp
    return res * alive.reshape(nw, 1, 1)


@pytest.mark.parametrize("n,c,nh", [(16, 80, 8), (64, 24, 3), (16, 120, 8)])
def test_attention_3xtf32_matches_plain(n, c, nh):
    args = _attn_inputs(2, 5, n, c, nh)
    want = kwa.window_attention_plain(*args, num_heads=nh)
    got = _emulated_attention(args, nh)
    assert _within(got, want)
    assert not got[1].any()                 # a dead window is exactly zero
    # one TF32 product misses the tolerance: the check sees a lost lo term
    assert not _within(_emulated_attention(args, nh, terms=1), want)


def test_attention_3xtf32_matches_pallas():
    n, c, nh = 16, 48, 3
    args = _attn_inputs(3, 6, n, c, nh)
    want = j_fwa(*(jnp.asarray(t.numpy()) for t in args), num_heads=nh,
                 interpret=True)
    got = _emulated_attention(args, nh)
    err = float((got - torch.from_numpy(np.array(want))).abs().max())
    assert err <= PALLAS_TOL, err


# ----------------------------------------------------------------------- GDN


def _gdn_inputs(seed, m, c):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, c).astype(np.float32))
    gt = torch.from_numpy((0.1 * np.eye(c) + 1e-2 * rng.rand(c, c)).astype(np.float32))
    beta = torch.from_numpy((1.0 + 0.1 * rng.rand(c)).astype(np.float32))
    return x, gt, beta


def _gdn_perm(c):
    return torch.tensor([8 * (k // 8) + GDN_ORDER[k % 8] for k in range(c)])


@pytest.mark.parametrize("c", [16, 80, 192])
def test_gdn_fp32_layout_reads_back(c):
    _, gt, _ = _gdn_inputs(4, 1, c)
    prep = kgdn.kernel_weights(gt, FP32)
    assert prep.dtype == FP32 and prep.shape == (2 * GDN_ROWS * c,)
    hi, lo = _read(prep, GDN_ROWS, c)
    # [out n][k]: k 8j + p is input channel 8j + GDN_ORDER[p]
    _check_split(hi[:c], lo[:c], gt[_gdn_perm(c)].t())
    assert not hi[c:].any() and not lo[c:].any()


def _emulated_gdn(x, gt, beta, inverse, terms=3):
    c = x.shape[-1]
    hi, lo = _read(kgdn.kernel_weights(gt, FP32), GDN_ROWS, c)
    x2 = (x * x)[:, _gdn_perm(c)]
    norm = _mm(x2, hi[:c].t(), lo[:c].t(), terms) + beta
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [16, 192])
def test_gdn_3xtf32_matches_plain(inverse, c):
    x, gt, beta = _gdn_inputs(5, 97, c)
    want = kgdn.gdn_plain(x, gt, beta, inverse)
    assert _within(_emulated_gdn(x, gt, beta, inverse), want)
    assert not _within(_emulated_gdn(x, gt, beta, inverse, terms=1), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_3xtf32_matches_pallas(inverse):
    x, gt, beta = _gdn_inputs(6, 128, 192)
    want = j_fused_gdn(jnp.asarray(x.numpy().reshape(1, 2, 64, 192)),
                       jnp.asarray(gt.numpy()), jnp.asarray(beta.numpy()),
                       inverse=inverse, interpret=True)
    got = _emulated_gdn(x, gt, beta, inverse)
    err = float((got - torch.from_numpy(np.array(want)).reshape(128, 192)).abs().max())
    assert err <= PALLAS_TOL, err
