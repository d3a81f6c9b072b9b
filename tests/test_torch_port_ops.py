"""Ops of the PyTorch port against the JAX package on the CPU, fp32.

Inputs come from seeded numpy and go to both frameworks; weights go from
the port module to the JAX module through the reference's torch layout.
The two kernel modules (GDN, window attention) are held against JAX with
the fused flag on (Pallas in interpret mode, as tests/test_pallas_attn.py
runs it) and off.

Tolerances: 2e-5 for the GDN and attention ops (as tests/test_pallas_attn.py);
1e-4 for conv transforms (fp32 sums of up to 5*5*192 terms taken in another
order); exact where the op is exact (masks, indices, pooling of 8-bit
values, the morphology tests).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.core.precision import DEFAULT_POLICY as J_DEFAULT  # noqa: E402
from rgba_tpu.core.precision import Policy as JPolicy  # noqa: E402
from rgba_tpu.core.precision import policy_from_str as j_policy_from_str  # noqa: E402
from rgba_tpu.entropy.bottleneck import EntropyBottleneck as JEB  # noqa: E402
from rgba_tpu.entropy.gaussian import GaussianConditional as JGC  # noqa: E402
from rgba_tpu.entropy.rate import bpp as j_bpp  # noqa: E402
from rgba_tpu.ops import attention as jatt  # noqa: E402
from rgba_tpu.ops import conv as jconv  # noqa: E402
from rgba_tpu.ops import window as jwin  # noqa: E402
from rgba_tpu.ops.enhance import DSE as JDSE  # noqa: E402
from rgba_tpu.ops.gdn import GDN as JGDN  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402
from rgba_tpu.ops.math import lower_bound as j_lower_bound  # noqa: E402
from rgba_tpu.ops.morphology import constraint_mask as j_cmask  # noqa: E402
from rgba_tpu.ops.morphology import constraint_rgb as j_crgb  # noqa: E402
from rgba_tpu.ops.pallas.gdn import fused_gdn as j_fused_gdn  # noqa: E402
from rgba_tpu.ops.pallas.win_attn import fused_window_attention as j_fwa  # noqa: E402
from rgba_tpu.train.torch_import import (_dse_map, _simp_attn_map,  # noqa: E402
                                         _win_gate_map)

from rgba_tpu_torch.core import precision as tprec  # noqa: E402
from rgba_tpu_torch.entropy.bottleneck import EntropyBottleneck  # noqa: E402
from rgba_tpu_torch.entropy.gaussian import GaussianConditional  # noqa: E402
from rgba_tpu_torch.entropy.rate import bpp as t_bpp  # noqa: E402
from rgba_tpu_torch.ops import attention as tatt  # noqa: E402
from rgba_tpu_torch.ops import conv as tconv  # noqa: E402
from rgba_tpu_torch.ops import window as twin  # noqa: E402
from rgba_tpu_torch.ops.enhance import DSE  # noqa: E402
from rgba_tpu_torch.ops.gdn import GDN  # noqa: E402
from rgba_tpu_torch.ops.kernels import gdn as kgdn  # noqa: E402
from rgba_tpu_torch.ops.kernels import win_attn as kwa  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid as t_pyramid  # noqa: E402
from rgba_tpu_torch.ops.math import lower_bound, ste_round  # noqa: E402
from rgba_tpu_torch.ops.morphology import constraint_mask, constraint_rgb  # noqa: E402

from torch_port_util import (CONV, DECONV, KEY, RAW, close, conv_mapper,  # noqa: E402
                             jax_params_from_torch, leaf_mapper, nchw, nhwc,
                             window_attention_mapper)

torch.set_num_threads(2)

T_DEFAULT = tprec.DEFAULT_POLICY
CPU = dict(device="cpu")
J_FUSED_ATTN = JPolicy(fused_win_attn=True)
J_FUSED_GDN = JPolicy(fused_gdn=True)
T_FUSED = tprec.Policy(fused_win_attn=True, fused_gdn=True)
OPS_TOL = 2e-5
TRANSFORM_TOL = 1e-4


def _rng(seed=0):
    return np.random.RandomState(seed)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------- precision


def test_policy_mirrors_jax():
    assert T_DEFAULT.exact and J_DEFAULT.gelu_kind == "gelu_erf"
    assert not tprec.BF16_POLICY.exact
    for name in ("fp32", "bf16", "serve", "serve-int8"):
        tp, jp = tprec.policy_from_str(name), j_policy_from_str(name)
        assert tp.fused_win_attn == jp.fused_win_attn
        assert tp.fused_gdn == jp.fused_gdn
        assert tp.fused_gate_chain == jp.fused_gate_chain
        assert tp.fused_dse == jp.fused_dse
        assert tp.packed_dse == jp.packed_dse
        assert tp.int8_conv == jp.int8_conv
        assert tp.gelu_kind == jp.gelu_kind
        assert str(tp.compute_dtype).split(".")[-1] == jnp.dtype(jp.compute_dtype).name
    with pytest.raises(ValueError):
        tprec.policy_from_str("nope")
    # every routing flag of the JAX policy has its port (the dtypes and the
    # TPU precision pin are the policy's compute_dtype and precision_scope)
    jax_flags = {f.name for f in dataclasses.fields(JPolicy)} - {
        "param_dtype", "compute_dtype", "entropy_dtype", "precision"}
    assert jax_flags <= {f.name for f in dataclasses.fields(tprec.Policy)}
    with pytest.raises(TypeError):
        tprec.Policy(no_such_flag=True)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_gelu_flavour(policy):
    x = _rng(1).randn(257).astype(np.float32) * 3
    tp = tprec.policy_from_str(policy)
    jp = JPolicy(compute_dtype=jnp.float32 if policy == "fp32" else jnp.bfloat16)
    # compare in fp32: the flavour (erf vs tanh) is the point, not the dtype
    got = tp.gelu(torch.from_numpy(x)).numpy()
    want = np.asarray(jp.gelu(jnp.asarray(x)))
    close(got, want, 1e-6)


def test_precision_scope_pins_tf32_off_and_restores():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with tprec.precision_scope(T_DEFAULT):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# ------------------------------------------------------------------ math


def test_lower_bound_value_and_gradient_gate():
    x = np.array([-2.0, -0.5, 0.0, 0.3, 1.0, 2.0], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0, 1.0, -1.0], np.float32)
    bound = 0.25
    val, vjp = jax.vjp(lambda v: j_lower_bound(v, bound), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = lower_bound(tx, bound)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(val))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jgrad))


def test_ste_round_half_to_even_and_identity_grad():
    x = torch.tensor([-1.5, -0.5, 0.5, 1.5, 2.5, 0.2], requires_grad=True)
    y = ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.round(x.detach().numpy()))
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6, np.float32))


# ------------------------------------------------------------------ conv


@pytest.mark.parametrize("k,stride", [(5, 2), (3, 1), (1, 1)])
def test_conv(k, stride):
    x = _rng(2).randn(2, 16, 16, 8).astype(np.float32)
    tm = tconv.Conv(8, 12, k, stride, policy=T_DEFAULT, generator=_gen(), **CPU)
    jm = jconv.Conv(12, kernel_size=k, stride=stride)
    tmpl = jm.init(KEY, x)["params"]
    params = jax_params_from_torch(tm, tmpl, conv_mapper())
    want = np.asarray(jm.apply({"params": params}, x))
    close(nhwc(tm(nchw(x))), want, TRANSFORM_TOL)


@pytest.mark.parametrize("k,stride,pad,op", [(5, 2, None, None), (1, 1, 0, 0)])
def test_conv_transpose(k, stride, pad, op):
    x = _rng(3).randn(2, 8, 8, 8).astype(np.float32)
    tm = tconv.ConvTranspose(8, 6, k, stride, pad, op, policy=T_DEFAULT,
                             generator=_gen(), **CPU)
    jm = jconv.ConvTranspose(6, kernel_size=k, stride=stride, padding=pad,
                             output_padding=op)
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"],
                                   conv_mapper(kind=DECONV))
    want = np.asarray(jm.apply({"params": params}, x))
    got = nhwc(tm(nchw(x)))
    assert got.shape == want.shape
    close(got, want, TRANSFORM_TOL)


def test_subpel_conv_and_pixel_shuffle():
    x = _rng(4).randn(2, 6, 5, 8).astype(np.float32)
    tm = tconv.SubpelConv(8, 3, 2, policy=T_DEFAULT, generator=_gen(), **CPU)
    jm = jconv.SubpelConv(3, r=2)
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"],
                                   conv_mapper("0."))
    close(nhwc(tm(nchw(x))), np.asarray(jm.apply({"params": params}, x)),
          TRANSFORM_TOL)
    y = _rng(5).randn(1, 3, 4, 12).astype(np.float32)
    np.testing.assert_array_equal(nhwc(torch.nn.functional.pixel_shuffle(
        nchw(y), 2)), np.asarray(jconv.pixel_shuffle(y, 2)))


# ------------------------------------------------------- pyramid, morphology


def _alpha8(rng, b, h, w, density=0.5):
    a = np.round(rng.rand(b, h, w, 1) * 255) / 255
    a[rng.rand(b, h, w, 1) > density] = 0.0
    return a.astype(np.float32)


def test_mask_pyramid():
    a = _alpha8(_rng(6), 2, 64, 128)
    got = t_pyramid(nchw(a))
    want = j_pyramid(jnp.asarray(a))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        # sum/9 of 8-bit values: both frameworks round the same sums
        close(nhwc(g), np.asarray(w), 1e-7)


@pytest.mark.parametrize("variant", ["rgb", "mask"])
def test_constraint(variant):
    rng = _rng(7)
    a = (rng.rand(3, 24, 24, 1) > 0.5).astype(np.float32)
    a[0, 5:8, 5:8] = 1.0
    a[0, 6, 6] = 0.0            # isolated zero
    a[1, 10:13, 10:13] = 0.0
    a[1, 11, 11] = 0.7          # isolated non-zero
    a[2] = np.round(rng.rand(24, 24, 1) * 255) / 255 * (rng.rand(24, 24, 1) > 0.8)
    t_fn, j_fn = (constraint_rgb, j_crgb) if variant == "rgb" else \
        (constraint_mask, j_cmask)
    np.testing.assert_array_equal(nhwc(t_fn(nchw(a))), np.asarray(j_fn(a)))


# ---------------------------------------------------------------- window


def test_window_partition_reverse_alive():
    x = _rng(8).randn(2, 16, 24, 5).astype(np.float32)
    tw = twin.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tw.numpy(),
                                  np.asarray(jwin.window_partition(x, 8)))
    np.testing.assert_array_equal(
        twin.window_reverse(tw, 8, 16, 24).numpy(), x)
    a = _alpha8(_rng(9), 2, 16, 24, density=0.02)
    a[:, :8, :8] = 0.0
    aw = jwin.window_partition(a, 8)
    np.testing.assert_array_equal(
        twin.window_alive(torch.from_numpy(np.asarray(aw))).numpy(),
        np.asarray(jwin.window_alive(aw)))


@pytest.mark.parametrize("ws,ss", [(8, 4), (4, 2), (8, 0)])
def test_window_masks_and_indices(ws, ss):
    np.testing.assert_array_equal(twin.swin_region_ids(32, 48, ws, ss),
                                  jwin.swin_region_ids(32, 48, ws, ss))
    if ss:
        np.testing.assert_array_equal(twin.swin_attention_bias(32, 48, ws, ss),
                                      jwin.swin_attention_bias(32, 48, ws, ss))
    np.testing.assert_array_equal(twin.relative_position_index(ws),
                                  jwin.relative_position_index(ws))


# ------------------------------------------------------------------- GDN


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("fused", [False, True])
def test_gdn_module(inverse, fused):
    rng = _rng(10)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    tm = GDN(32, inverse, policy=T_FUSED if fused else T_DEFAULT, **CPU)
    with torch.no_grad():   # trained-looking reparameterized weights
        tm.beta.copy_(torch.from_numpy(rng.rand(32).astype(np.float32) + 0.5))
        tm.gamma.copy_(torch.from_numpy(
            np.abs(rng.randn(32, 32)).astype(np.float32) * 0.1))
    jm = JGDN(inverse=inverse, policy=J_FUSED_GDN if fused else J_DEFAULT)
    params = jax_params_from_torch(
        tm, jm.init(KEY, x)["params"],
        leaf_mapper({"beta": ("beta", RAW), "gamma": ("gamma", RAW)}))
    want = np.asarray(jm.apply({"params": params}, x))
    close(nhwc(tm(nchw(x))), want, OPS_TOL, OPS_TOL)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_kernel_plain_vs_pallas(inverse):
    rng = _rng(11)
    x = rng.randn(2, 4, 8, 48).astype(np.float32)
    gamma_t = (np.abs(rng.randn(48, 48)) * 0.05).astype(np.float32)
    beta = (rng.rand(48) + 0.2).astype(np.float32)
    want = np.asarray(j_fused_gdn(x, gamma_t, beta, inverse=inverse,
                                  interpret=True))
    got = kgdn.fused_gdn(torch.from_numpy(x), torch.from_numpy(gamma_t),
                         torch.from_numpy(beta), inverse=inverse)
    close(got.numpy(), want, OPS_TOL, OPS_TOL)
    assert kgdn.KERNEL.launches == 0      # CPU tensors never launch


def test_gdn_kernel_plain_bf16_rounds_like_pallas():
    rng = _rng(12)
    x = rng.randn(1, 4, 4, 32).astype(np.float32)
    gamma_t = (np.abs(rng.randn(32, 32)) * 0.05).astype(np.float32)
    beta = (rng.rand(32) + 0.2).astype(np.float32)
    want = np.asarray(j_fused_gdn(jnp.asarray(x, jnp.bfloat16), gamma_t, beta,
                                  interpret=True).astype(jnp.float32))
    got = kgdn.fused_gdn(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(gamma_t), torch.from_numpy(beta))
    # one bf16 ulp: the fp32 sums may round to neighbouring bf16 values
    close(got.float().numpy(), want, 0.0, 2.0 ** -7)


# -------------------------------------------------------- window attention


def _alpha_patterns(b, h, w):
    ones = np.ones((b, h, w, 1), np.float32)
    holes = ones.copy()
    holes[:, :8, :8] = 0.0
    sparse = _alpha8(_rng(13), b, h, w, density=0.01)
    return {"ones": ones, "holes": holes, "sparse": sparse, "none": None}


@pytest.mark.parametrize("pattern", ["ones", "holes", "sparse", "none"])
@pytest.mark.parametrize("shift", [0, 4])
@pytest.mark.parametrize("fused", [False, True])
def test_masked_win_block(pattern, shift, fused):
    dim, heads, ws, b, h, w = 16, 4, 8, 2, 16, 24
    x = _rng(14).randn(b, h, w, dim).astype(np.float32)
    alpha = _alpha_patterns(b, h, w)[pattern]
    tp = T_FUSED if fused else T_DEFAULT
    tm = tatt.MaskedWinBlock(dim, heads, ws, shift, policy=tp,
                             generator=_gen(1), **CPU)
    with torch.no_grad():   # non-zero biases so every term is exercised
        tm.attn.qkv.bias.normal_(0, 0.1, generator=_gen(2))
        tm.attn.proj.bias.normal_(0, 0.1, generator=_gen(3))
    jm = jatt.MaskedWinBlock(dim=dim, num_heads=heads, window_size=ws,
                             shift_size=shift,
                             policy=J_FUSED_ATTN if fused else J_DEFAULT)
    params = jax_params_from_torch(
        tm, jm.init(KEY, x, alpha)["params"],
        window_attention_mapper("attn/", "attn."))
    want = np.asarray(jm.apply({"params": params}, x, alpha))
    ta = None if alpha is None else nchw(alpha)
    close(nhwc(tm(nchw(x), ta)), want, OPS_TOL, OPS_TOL)


@pytest.mark.parametrize("n,c,heads", [(16, 24, 4), (64, 32, 8)])
def test_window_attention_kernel_plain_vs_pallas(n, c, heads):
    rng = _rng(15)
    nw = 6
    tokens = rng.randn(nw, n, c).astype(np.float32)
    region = rng.randint(0, 3, (nw, n)).astype(np.int32)
    alive = np.array([[1], [0], [1], [1], [0], [1]], np.float32)
    wqkv = (rng.randn(c, 3 * c) / np.sqrt(c)).astype(np.float32)
    bqkv = (rng.randn(3 * c) * 0.1).astype(np.float32)
    wproj = (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)
    bproj = (rng.randn(c) * 0.1).astype(np.float32)
    rel = (rng.randn(heads, n, n) * 0.02).astype(np.float32)
    args = (tokens, region, alive, wqkv, bqkv, wproj, bproj, rel)
    want = np.asarray(j_fwa(*args, num_heads=heads, interpret=True))
    got = kwa.fused_window_attention(*map(torch.from_numpy, args),
                                     num_heads=heads).numpy()
    close(got, want, OPS_TOL, OPS_TOL)
    assert not got[1].any() and not got[4].any()   # dead windows exactly 0
    assert kwa.KERNEL.launches == 0


def test_kernel_wrappers_never_reroute_a_device_tensor():
    """A tensor that is not on the CPU launches the kernel or raises; the
    plain version is taken for CPU tensors only."""
    x = torch.empty(4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kgdn.fused_gdn(x, torch.empty(16, 16, device="meta"),
                       torch.empty(16, device="meta"))
    t = torch.empty(2, 16, 12, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kwa.fused_window_attention(t, t, t, t, t, t, t, t, num_heads=3)


# ------------------------------------------------------------ gate blocks


def _win_gate_pair(dim, ws, ss, x, alpha):
    tm = tatt.WinGateAttention(dim, 4, ws, ss, policy=T_DEFAULT,
                               generator=_gen(4), **CPU)
    jm = jatt.WinGateAttention(dim, num_heads=4, window_size=ws, shift_size=ss)
    params = jax_params_from_torch(tm, jm.init(KEY, x, alpha)["params"],
                                   _win_gate_map)
    return tm, jm, params


def test_win_gate_attention():
    x = _rng(16).randn(2, 16, 16, 16).astype(np.float32)
    alpha = _alpha_patterns(2, 16, 16)["holes"]
    tm, jm, params = _win_gate_pair(16, 8, 4, x, alpha)
    want = np.asarray(jm.apply({"params": params}, x, alpha))
    close(nhwc(tm(nchw(x), nchw(alpha))), want, TRANSFORM_TOL)


def test_residual_unit_and_resblock():
    x = _rng(17).randn(2, 8, 8, 16).astype(np.float32)
    tm = tatt.ResidualUnit(16, policy=T_DEFAULT, generator=_gen(5), **CPU)
    jm = jatt.ResidualUnit(16)
    table = {f"conv{j}/{leaf}": (f"conv.{2 * j}.{'weight' if leaf == 'kernel' else 'bias'}",
                                 CONV)
             for j in range(3) for leaf in ("kernel", "bias")}
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"],
                                   leaf_mapper(table))
    close(nhwc(tm(nchw(x))), np.asarray(jm.apply({"params": params}, x)),
          TRANSFORM_TOL)
    tb = tatt.ResBlock(16, policy=T_DEFAULT, generator=_gen(6), **CPU)
    jb = jatt.ResBlock(16)
    table = {f"conv{j}/{leaf}": (f"conv{j}.{'weight' if leaf == 'kernel' else 'bias'}",
                                 CONV)
             for j in (1, 2, 3) for leaf in ("kernel", "bias")}
    params = jax_params_from_torch(tb, jb.init(KEY, x)["params"],
                                   leaf_mapper(table))
    close(nhwc(tb(nchw(x))), np.asarray(jb.apply({"params": params}, x)),
          TRANSFORM_TOL)


def test_simplified_attention():
    x = _rng(18).randn(2, 8, 8, 16).astype(np.float32)
    tm = tatt.SimplifiedAttention(16, policy=T_DEFAULT, generator=_gen(7), **CPU)
    jm = jatt.SimplifiedAttention(16)
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"],
                                   _simp_attn_map)
    close(nhwc(tm(nchw(x))), np.asarray(jm.apply({"params": params}, x)),
          TRANSFORM_TOL)


@pytest.mark.parametrize("in_ch,leaky", [(3, False), (1, True)])
def test_dse(in_ch, leaky):
    x = _rng(19).rand(4, 16, 16, in_ch).astype(np.float32)
    tm = DSE(in_ch, leaky=leaky, policy=T_DEFAULT, generator=_gen(8), **CPU)
    jm = JDSE(in_ch=in_ch, leaky=leaky)
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"], _dse_map)
    close(nhwc(tm(nchw(x))), np.asarray(jm.apply({"params": params}, x)),
          TRANSFORM_TOL)
    # packed_dse is a TPU layout of the same math: the port computes plain DSE
    tp = DSE(in_ch, leaky=leaky, generator=_gen(8), **CPU,
             policy=dataclasses.replace(T_DEFAULT, packed_dse=True))
    np.testing.assert_array_equal(nhwc(tp(nchw(x))), nhwc(tm(nchw(x))))


# --------------------------------------------------------------- entropy


def test_entropy_bottleneck():
    rng = _rng(20)
    z = (rng.randn(2, 2, 3, 16) * 4).astype(np.float32)
    tm = EntropyBottleneck(16, device="cpu", generator=_gen(9))
    with torch.no_grad():
        tm.quantiles[:, 0, 1] = torch.from_numpy(rng.randn(16).astype(np.float32))
    jm = JEB(16)
    tmpl = jm.init(KEY, z)["params"]

    def mapper(path):
        if path == "quantiles":
            return "quantiles", RAW
        return f"_{path}", RAW
    params = jax_params_from_torch(tm, tmpl, mapper)
    jz, jlik = jm.apply({"params": params}, z)
    tz, tlik = tm(nchw(z))
    close(nhwc(tz), np.asarray(jz), 1e-6)
    # softplus: torch returns x itself above 20 (a < 2.1e-9 difference)
    close(nhwc(tlik), np.asarray(jlik), 1e-6, 1e-5)
    np.testing.assert_array_equal(
        tm.medians().detach().numpy(),
        np.asarray(jm.apply({"params": params}, method=lambda m: m.medians())))


def test_gaussian_likelihood_and_rate():
    rng = _rng(21)
    y = (rng.randn(2, 4, 4, 8) * 3).astype(np.float32)
    mu = rng.randn(2, 4, 4, 8).astype(np.float32)
    scale = np.abs(rng.randn(2, 4, 4, 8)).astype(np.float32)   # some < 0.11
    want = np.asarray(JGC().likelihood(y, scale, mu))
    got = GaussianConditional().likelihood(nchw(y), nchw(scale), nchw(mu))
    close(nhwc(got), want, 1e-7, 1e-5)
    close(float(t_bpp(got, 2, 16, 16)), float(j_bpp(want, 2, 16, 16)),
          0.0, 1e-6)
