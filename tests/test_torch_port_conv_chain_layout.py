"""The weight layouts that the bf16 gate-chain and DSE kernels read, on the
CPU.

On the card the two kernels multiply their weights from chunks of K-major
core matrices (``gate_chain.kernel_weights``, ``dse.kernel_weights``): each
matrix [out][in], K padded from C/2 to a multiple of 16 with zero
columns, outputs padded to whole n-blocks with zero rows, the 3x3's k
ordered (tap, ci), cut into chunks of 64 k.  Here the layout is read back
with an offset formula written out independently of the code that builds
it: the matrices come back bit for bit, every padding entry is 0, and the
chain computed in plain PyTorch from what was read back, in the order the
kernel multiplies (padded K, n-blocks, taps), gives the plain version.
The modules' layout caches must follow an in-place update of a parameter,
as an optimizer step makes it: a stale layout would serve and train on the
old weights.

Inputs are seeded numpy.  Tolerance of the recomputed chains: 2 bf16 ulps
of max|ref| (both sides round to bf16 at the same points; an fp32 sum over
a padded K, taken in another order, can round an intermediate to the
neighbouring bf16 value).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from rgba_tpu_torch.ops.kernels import dse as kdse  # noqa: E402
from rgba_tpu_torch.ops.kernels import gate_chain as kgc  # noqa: E402
from rgba_tpu_torch.ops.kernels.nhwc import conv3x3  # noqa: E402

torch.set_num_threads(2)

BF16 = torch.bfloat16
ACTS = {"wingate": ("gelu_erf", True, True), "simplified": ("relu", False, False)}


def _two_ulps(ref) -> float:
    top = float(ref.float().abs().max())
    return 2.0 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(max(top, 2.0 ** -126)))


def _read(flat, n, k, kc=64):
    """Element (r, kk) of an n x k matrix stored as chunks of kc k, each
    K-major core matrices: chunk kk // kc starts n * k0 in; inside it 8-row
    groups are kc / 8 core matrices of 64 elements apart."""
    flat = flat.reshape(-1)
    r, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    k0 = kk // kc * kc
    width = np.minimum(kc, k - k0)
    off = (n * k0 + (r // 8) * (width // 8) * 64 + ((kk - k0) // 8) * 64
           + (r % 8) * 8 + kk % 8)
    assert len(np.unique(off)) == n * k == flat.numel()
    return flat[torch.from_numpy(off)]


def _gate_inputs(seed, b, h, w, c, separate):
    rng = np.random.RandomState(seed)
    half = c // 2

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))

    def chain():
        return kgc.GateChainWeights(
            t(3, c, half, scale=c ** -0.5).to(BF16), t(3, half, scale=0.1),
            t(3, 9 * half, half, scale=(9 * half) ** -0.5).to(BF16),
            t(3, half, scale=0.1), t(3, half, c, scale=0.5 * half ** -0.5).to(BF16),
            t(3, c, scale=0.1))
    x = t(b, h, w, c).to(BF16)
    g = t(b, h, w, c).to(BF16) if separate else None
    return x, g, chain(), chain(), t(c, c, scale=c ** -0.5).to(BF16), t(c, scale=0.1)


def _read_chain(prep, c):
    """One chain's kernel layout -> the padded [out][in] matrices."""
    half = c // 2
    hp = (half + 15) // 16 * 16
    nb = -(-c // hp)
    w0 = torch.stack([_read(prep[0][i], hp, c) for i in range(3)])
    w1 = torch.stack([_read(prep[2][i], hp, 9 * hp) for i in range(3)])
    w2 = torch.stack([torch.stack([_read(blk, hp, hp)
                                   for blk in prep[4][i].reshape(nb, -1)])
                      for i in range(3)])
    return w0, w1, w2


@pytest.mark.parametrize("c", [192, 80])
def test_gate_chain_layout_reads_back_bit_for_bit(c):
    """Every weight at its place, every padding entry 0 (the kernel reads
    the K padding against zero weights; 0 * NaN would be NaN)."""
    x, g, trunk, gate, fw, fb = _gate_inputs(1, 1, 2, 2, c, True)
    prep = kgc.kernel_weights(trunk, gate, fw, fb, BF16)
    half = c // 2
    hp = (half + 15) // 16 * 16
    nb = -(-c // hp)
    for cw, pc in ((trunk, prep.trunk), (gate, prep.gate)):
        assert all(t.dtype == BF16 for t in pc[0::2])
        assert all(t.dtype == torch.float32 for t in pc[1::2])
        w0, w1, w2 = _read_chain(pc, c)
        assert torch.equal(w0[:, :half].transpose(1, 2), cw.w0)
        assert not w0[:, half:].any()
        w1 = w1.reshape(3, hp, 9, hp)               # [o][tap][ci]
        assert torch.equal(w1[:, :half, :, :half].permute(0, 2, 3, 1),
                           cw.w1.reshape(3, 9, half, half))
        assert not w1[:, half:].any() and not w1[:, :, :, half:].any()
        w2 = w2.reshape(3, nb * hp, hp)             # [o][ci]
        assert torch.equal(w2[:, :c, :half].transpose(1, 2), cw.w2)
        assert not w2[:, c:].any() and not w2[:, :, half:].any()
        for got, want in zip(pc[1::2], (cw.b0, cw.b1, cw.b2)):
            assert torch.equal(got, want)
    fwr = torch.cat([_read(blk, hp, c) for blk in prep.fw.reshape(nb, -1)])
    assert torch.equal(fwr[:c].t(), fw) and not fwr[c:].any()
    assert torch.equal(prep.fb, fb)


def _act(v, act):
    return kgc.activation(v, act)


def _chain_from_layout(t, pc, c, act, post_act):
    """A chain computed from the kernel's layout as the kernel multiplies:
    K padded to hp, the 3x3 as one (tap, ci) product, C-wide outputs as
    n-blocks of hp; casts where the kernel casts."""
    half = c // 2
    hp = (half + 15) // 16 * 16
    w0, w1, w2 = _read_chain(pc, c)
    w2 = w2.reshape(3, -1, hp)

    def pad(b, n):
        return F.pad(b.float(), (0, n - b.shape[-1]))
    cur = t
    _, h, w, _ = t.shape
    for blk in range(3):
        h0 = _act(cur.float() @ w0[blk].float().t() + pad(pc[1][blk], hp),
                  act).to(BF16)
        hpd = F.pad(h0.float(), (0, 0, 1, 1, 1, 1))
        cols = torch.cat([hpd[:, dy:dy + h, dx:dx + w] for dy in range(3)
                          for dx in range(3)], dim=-1)
        h1 = _act(cols @ w1[blk].float().t() + pad(pc[3][blk], hp), act).to(BF16)
        out = (h1.float() @ w2[blk].float().t())[..., :c] + pc[5][blk] + cur.float()
        cur = (_act(out, act) if post_act else out).to(BF16)
    return cur


@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
@pytest.mark.parametrize("c", [192, 80])
def test_gate_chain_layout_gives_the_plain_gate(c, flavour):
    act, post, separate = ACTS[flavour]
    x, g, trunk, gate, fw, fb = _gate_inputs(2, 2, 5, 7, c, separate)
    prep = kgc.kernel_weights(trunk, gate, fw, fb, BF16)
    hp = (c // 2 + 15) // 16 * 16
    nb = -(-c // hp)
    t = _chain_from_layout(x, prep.trunk, c, act, post)
    a = _chain_from_layout(x if g is None else g, prep.gate, c, act, post)
    fwr = torch.cat([_read(blk, hp, c) for blk in prep.fw.reshape(nb, -1)])
    s = torch.sigmoid((a.float() @ fwr.float().t())[..., :c] + prep.fb)
    got = (x.float() + t.float() * s).to(BF16)
    want = kgc.gate_chain_plain(x, g, trunk, gate, fw, fb, act, post)
    assert got.dtype == want.dtype == BF16
    err = float((got.float() - want.float()).abs().max())
    assert err <= _two_ulps(want), (err, _two_ulps(want))


def _dse_inputs(seed, b, h, w, cio):
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))
    return (torch.from_numpy(rng.rand(b, h, w, cio).astype(np.float32)).to(BF16),
            t(cio, 32, scale=cio ** -0.5).to(BF16), t(32, scale=0.1),
            t(6, 288, 32, scale=288 ** -0.5).to(BF16), t(6, 32, scale=0.1),
            t(32, cio, scale=32 ** -0.5).to(BF16), t(cio, scale=0.1))


@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
def test_dse_layout_gives_the_plain_tail(cio, leaky):
    """The 3x3s come back bit for bit from the core-matrix order, and the
    tail computed from them, [out][in] with k = (tap, ci), is the plain
    version's."""
    x, w_in, b_in, w3, b3, w_out, b_out = _dse_inputs(3, 2, 9, 11, cio)
    prep = kdse.kernel_weights(w_in, b_in, w3, b3, w_out, b_out, BF16)
    assert prep[2].shape == (6, 32 * 288) and prep[2].dtype == BF16
    w3r = torch.stack([_read(prep[2][i], 32, 288, kc=288) for i in range(6)])
    assert torch.equal(w3r.transpose(1, 2), w3)
    for got, want in zip(prep[:2] + prep[3:], (w_in, b_in, b3, w_out, b_out)):
        assert torch.equal(got, want)

    def act(v):
        return F.leaky_relu(v, 0.01) if leaky else F.relu(v)
    first = (x.float() @ prep[0].float() + prep[1]).to(BF16)
    y = first
    for blk in range(3):
        z = act(conv3x3(y, w3r[2 * blk].t(), b3[2 * blk])).to(BF16)
        y = (conv3x3(z, w3r[2 * blk + 1].t(), b3[2 * blk + 1]) + y.float()).to(BF16)
    merged = (y.float() + first.float()).to(BF16)
    got = (merged.float() @ prep[4].float() + prep[5] + x.float()).to(BF16)
    want = kdse.dse_plain(x, w_in, b_in, w3, b3, w_out, b_out, leaky)
    assert torch.equal(got, want)


def test_chunked_core_cuts_k_into_chunks_of_64():
    """k = 80: a chunk of 64 and one of 16, each contiguous."""
    w = torch.arange(16 * 80, dtype=torch.float32).reshape(16, 80)
    flat = kgc.chunked_core(w)
    assert flat.shape == (16 * 80,)
    assert torch.equal(_read(flat, 16, 80), w)
    assert torch.equal(flat[:16 * 64].sort().values,
                       w[:, :64].reshape(-1).sort().values)


def _gate_module(flavour, c):
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops import attention as att
    kw = dict(policy=Policy(compute_dtype=BF16), device="cpu",
              generator=torch.Generator().manual_seed(0))
    return (att.WinGateAttention(c, 2, 4, 0, **kw) if flavour == "wingate"
            else att.SimplifiedAttention(c, **kw))


def _fresh_gate_layout(m, dtype):
    from rgba_tpu_torch.ops.attention import gate_kernel_weights
    return kgc.kernel_weights(*gate_kernel_weights(m.gate_parameters()), dtype)


def _same_layout(a, b):
    flat_a = [*a.trunk, *a.gate, a.fw, a.fb]
    flat_b = [*b.trunk, *b.gate, b.fw, b.fb]
    return all(torch.equal(u, v) for u, v in zip(flat_a, flat_b))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
def test_gate_layout_cache_follows_an_in_place_update(flavour, dtype):
    """Built once per dtype; an optimizer step on the gate's parameters
    (their versions move) rebuilds it from the new values."""
    m = _gate_module(flavour, 32)
    lay = m.kernel_layout(dtype)
    assert m.kernel_layout(dtype) is lay
    assert _same_layout(lay, _fresh_gate_layout(m, dtype))
    params = m.gate_parameters()
    for p in params:
        p.grad = torch.ones_like(p)
    torch.optim.SGD(params, lr=0.01).step()
    new = m.kernel_layout(dtype)
    assert new is not lay and not _same_layout(new, lay)
    assert _same_layout(new, _fresh_gate_layout(m, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dse_layout_cache_follows_an_in_place_update(dtype):
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops.enhance import DSE
    m = DSE(3, policy=Policy(compute_dtype=dtype), device="cpu",
            generator=torch.Generator().manual_seed(0))
    lay = m.kernel_layout(dtype)
    assert m.kernel_layout(dtype) is lay
    with torch.no_grad():
        m.enh2.conv1.weight.add_(0.5)           # one parameter, in place
    new = m.kernel_layout(dtype)
    assert new is not lay
    fresh = kdse.kernel_weights(*m.kernel_weights(), dtype)
    assert all(torch.equal(u, v) for u, v in zip(new, fresh))
    assert not torch.equal(new[2], lay[2])
