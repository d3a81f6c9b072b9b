"""The bf16 plain versions of the window-attention and GDN kernels against
the JAX package's Pallas kernels in interpret mode, on the CPU.

On the card, the tensor-core kernels (rgba_tpu_torch/csrc/win_attn.cu,
csrc/gdn.cu) are checked against these plain versions; here the plain
versions are held to the reference at the shapes whose head dims the
tensor-core kernel pads (hd=24 to 32, hd=10 to 16), with dead windows.
The padded weight layout that the wrapper hands the bf16 kernel is checked
too: attention computed from it in plain PyTorch equals the plain version,
and the core-matrix order the kernel stages it in is the one it reads.

Inputs are seeded numpy, in bf16 for both frameworks; rel_bias is drawn at
unit scale, so that a bias gone missing or astray moves the output by far
more than the tolerance.  Tolerance: 2 bf16
ulps of max|ref| (2 * 2^-7 * 2^floor(log2 max|ref|)): both sides round at
the same points, and an fp32 sum taken in another order can round an
intermediate (qkv, P, a head output) to the neighbouring bf16 value.
"""

import math

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


def _two_ulps(ref) -> float:
    top = float(np.abs(np.asarray(ref, np.float32)).max())
    return 2.0 * 2.0 ** -7 * 2.0 ** math.floor(math.log2(max(top, 2.0 ** -126)))


def _check(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= _two_ulps(want), (err, _two_ulps(want))


def _bf16(a):
    """Round a float32 array to bf16 and back, so both frameworks see the
    same bf16 values."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _attn_inputs(seed, nw, n, c, heads):
    rng = np.random.RandomState(seed)
    alive = (np.arange(nw) % 3 != 1).astype(np.float32).reshape(nw, 1)
    return dict(
        tokens=_bf16(rng.randn(nw, n, c)),
        region=rng.randint(0, 3, (nw, n)).astype(np.int32),
        alive=alive,
        wqkv=_bf16(rng.randn(c, 3 * c) / np.sqrt(c)),
        bqkv=(rng.randn(3 * c) * 0.1).astype(np.float32),
        wproj=_bf16(rng.randn(c, c) / np.sqrt(c)),
        bproj=(rng.randn(c) * 0.1).astype(np.float32),
        rel_bias=rng.randn(heads, n, n).astype(np.float32))


_BF16_IN = ("tokens", "wqkv", "wproj")
_ORDER = ("tokens", "region", "alive", "wqkv", "bqkv", "wproj", "bproj",
          "rel_bias")


def _torch_args(d):
    return [torch.from_numpy(d[k]).bfloat16() if k in _BF16_IN
            else torch.from_numpy(d[k]) for k in _ORDER]


# hd=24 (padded to 32 on the card) and hd=10 (padded to 16)
ATTN_SHAPES = [(64, 48, 2), (16, 80, 8)]


@pytest.mark.parametrize("n,c,heads", ATTN_SHAPES)
def test_window_attention_plain_bf16_matches_pallas(n, c, heads):
    d = _attn_inputs(31, 7, n, c, heads)
    jargs = [jnp.asarray(d[k], jnp.bfloat16) if k in _BF16_IN
             else jnp.asarray(d[k]) for k in _ORDER]
    want = np.asarray(j_fwa(*jargs, num_heads=heads, interpret=True)
                      .astype(jnp.float32))
    got = kwa.window_attention_plain(*_torch_args(d), num_heads=heads)
    assert got.dtype == torch.bfloat16
    _check(got.float().numpy(), want)
    dead = d["alive"][:, 0] == 0
    assert dead.any() and not got[torch.from_numpy(dead)].float().any()


def _attention_from_mma_weights(tokens, region, alive, wq, bqkv, wp, bproj,
                                rel_bias, heads):
    """Attention computed from the bf16 kernel's padded weight layout:
    wq (nh, 3, hdp, Cp) [head][q|k|v][d][in], wp (C, Cp) [out][in]."""
    dt = tokens.dtype
    nw, n, c = tokens.shape
    hd = c // heads
    hdp, cp = wq.shape[2], wq.shape[3]
    x = torch.nn.functional.pad(tokens.float(), (0, cp - c))
    bq = torch.zeros(heads, 3, hdp)
    bq[:, :, :hd] = bqkv.float().reshape(3, heads, hd).transpose(0, 1)
    qkv = (torch.einsum("wnk,hpdk->whpnd", x, wq.float())
           + bq[None, :, :, None, :]).to(dt).float()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # (nw, nh, n, hdp)
    mask = torch.where(region[:, :, None] != region[:, None, :], -100.0, 0.0)
    s = (q @ k.transpose(-1, -2)) * hd ** -0.5 + rel_bias.float()[None] + \
        mask[:, None]
    p = torch.softmax(s, dim=-1).to(dt).float()
    o = (p @ v).to(dt).float()[..., :hd]                  # zero columns out
    o = o.permute(0, 2, 1, 3).reshape(nw, n, c)
    res = torch.nn.functional.pad(o, (0, cp - c)) @ wp.float().t() + \
        bproj.float()
    return (res * alive.float().reshape(nw, 1, 1)).to(dt)


@pytest.mark.parametrize("n,c,heads", ATTN_SHAPES + [(16, 24, 3)])
def test_mma_weight_layout_leaves_attention_unchanged(n, c, heads):
    """Zero head-dim and channel padding leaves every score and output as
    it was: the padded layout gives the plain version's result."""
    d = _attn_inputs(32, 5, n, c, heads)
    args = _torch_args(d)
    wq, wp = kwa.mma_weights(args[3], args[5], heads)
    hd = c // heads
    assert wq.shape == (heads, 3, (hd + 15) // 16 * 16, (c + 15) // 16 * 16)
    assert wp.shape == (c, (c + 15) // 16 * 16)
    want = kwa.window_attention_plain(*args, num_heads=heads)
    got = _attention_from_mma_weights(args[0], args[1], args[2], wq, args[4],
                                      wp, args[6], args[7], heads)
    _check(got.float().numpy(), want.float().numpy())


def test_core_matrices_is_the_kernels_core_layout():
    """The bf16 attention kernel reads its staged weights as K-major core
    matrices: element (r, k) of an (n, k) matrix at (r // 8) * 8k +
    (k // 8) * 64 + (r % 8) * 8 + k % 8, for every leading index."""
    n, k = 24, 32
    w = torch.arange(2 * n * k, dtype=torch.float32).reshape(2, n, k)
    flat = kwa.core_matrices(w).reshape(2, -1)
    r, kk = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    off = (r // 8) * 8 * k + (kk // 8) * 64 + (r % 8) * 8 + kk % 8
    for lead in range(2):
        assert np.array_equal(flat[lead].numpy()[off], w[lead].numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_module_caches_its_kernel_layout(dtype):
    """WindowAttention lays its weights out for the kernel once per dtype
    and again only after a parameter is written; the cached layout is the
    one ``kernel_weights`` builds from the current values."""
    from rgba_tpu_torch.core.precision import Policy
    from rgba_tpu_torch.ops.attention import WindowAttention

    m = WindowAttention(48, 4, 3, policy=Policy(compute_dtype=dtype),
                        device="cpu", generator=torch.Generator().manual_seed(0))
    wts, rb = m.kernel_inputs(dtype)
    assert m.kernel_inputs(dtype)[0] is wts
    assert torch.equal(rb, m.rel_bias()) and rb.is_contiguous()
    with torch.no_grad():
        m.proj.weight.mul_(2.0)
        m.relative_position_bias_table.add_(1.0)
    wts2, rb2 = m.kernel_inputs(dtype)
    assert wts2 is not wts and torch.equal(rb2, m.rel_bias())
    want = kwa.kernel_weights(m.qkv.weight.t(), m.qkv.bias, m.proj.weight.t(),
                              m.proj.bias, 3, dtype)
    assert all(torch.equal(a, b) for a, b in zip(wts2, want))
    if dtype == torch.bfloat16:
        wq, wp = kwa.mma_weights(m.qkv.weight.t(), m.proj.weight.t(), 3)
        assert torch.equal(wts2.wproj, kwa.core_matrices(wp))
        assert torch.equal(wts2.wqkv, kwa.core_matrices(
            wq.reshape(3, 3 * wq.shape[2], wq.shape[3])))


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_plain_bf16_matches_pallas(inverse):
    rng = np.random.RandomState(33)
    m, c = 1000, 192
    x = _bf16(rng.randn(m, c))
    gamma_t = _bf16(0.1 * np.eye(c) + np.abs(rng.randn(c, c)) * 1e-3)
    beta = (rng.rand(c) + 0.5).astype(np.float32)
    want = np.asarray(j_fused_gdn(jnp.asarray(x.reshape(1, 1, m, c),
                                              jnp.bfloat16),
                                  jnp.asarray(gamma_t), beta,
                                  inverse=inverse, interpret=True)
                      .astype(jnp.float32)).reshape(m, c)
    got = kgdn.gdn_plain(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(gamma_t), torch.from_numpy(beta),
                         inverse=inverse)
    assert got.dtype == torch.bfloat16
    _check(got.float().numpy(), want)
