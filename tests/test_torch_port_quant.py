"""The port's dynamic W8A8 convolution (``rgba_tpu_torch/ops/quant.py``,
``Policy.int8_conv``) against the JAX package's ``rgba_tpu/ops/quant.py``
on the CPU: the twins of ``tests/test_quant.py``.

Inputs and weights are seeded numpy.  Tolerances: the int32 accumulators,
the scales and the outputs are equal, bit for bit, in fp32 and in bf16
(the integer sums are exact, and the dequantize is the same fp32 product
in both packages); int8 against the float convolution 0.03 relative L2,
the RGB codec forward 0.08, as the JAX tests hold them.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.core.precision import Policy as JPolicy  # noqa: E402
from rgba_tpu.ops import quant as jq  # noqa: E402
from rgba_tpu.ops.enhance import DSE as JDSE  # noqa: E402
from rgba_tpu.train.torch_import import _dse_map  # noqa: E402

from rgba_tpu_torch.core import precision as tprec  # noqa: E402
from rgba_tpu_torch.core.precision import DEFAULT_POLICY, Policy  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.ops import quant as tq  # noqa: E402
from rgba_tpu_torch.ops.conv import Conv, ConvTranspose  # noqa: E402
from rgba_tpu_torch.ops.enhance import DSE  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid  # noqa: E402

from torch_port_util import KEY, jax_params_from_torch, nchw, nhwc  # noqa: E402

torch.set_num_threads(2)

INT8_FP32 = Policy(int8_conv=True)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)


def _bf16(a):
    """a rounded to bf16 values, as float32 (both packages see the same)."""
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


# (name, batch, cin, size, cout, k, stride, transposed): each geometry of
# the serving path, the 3-channel input and output convolutions among them
GEOMETRIES = [
    ("conv5x5s2", 2, 16, 16, 24, 5, 2, False),
    ("conv5x5s2_rgb_in", 2, 3, 16, 16, 5, 2, False),
    ("deconv5x5s2", 2, 16, 8, 16, 5, 2, True),
    ("deconv5x5s2_rgb_out", 2, 16, 8, 3, 5, 2, True),
    ("conv3x3", 2, 12, 12, 20, 3, 1, False),
    ("conv1x1", 2, 24, 12, 12, 1, 1, False),
    ("conv1x1_rgb_out", 2, 32, 12, 3, 1, 1, False),
]


def _jax_int8(x, w_hwio, k, s, transposed, dtype):
    """JAX's accumulators (from its own quantized operands), scales and
    int8_conv output, with the call sites' geometry."""
    p = k // 2
    jx = jnp.asarray(x, dtype)
    w = jnp.asarray(w_hwio)
    xq, sx = jq._quantize_activation(jx)
    if transposed:
        lo, hi = k - 1 - p, k - 1 - p + s - 1
        geo = dict(window_strides=(1, 1), padding=((lo, hi), (lo, hi)),
                   lhs_dilation=(s, s))
        wq, sw = jq._quantize_weight(jnp.flip(w, axis=(0, 1)))
        y = jq.int8_conv(jx, w, flip_kernel=True, **geo)
    else:
        geo = dict(window_strides=(s, s), padding=((p, p), (p, p)))
        wq, sw = jq._quantize_weight(w)
        y = jq.int8_conv(jx, w, **geo)
    acc = jax.lax.conv_general_dilated(
        xq, wq, dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32, **geo)
    return (np.asarray(acc), float(sx), np.asarray(sw),
            np.asarray(y.astype(jnp.float32)))


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("geo", GEOMETRIES, ids=[g[0] for g in GEOMETRIES])
def test_int8_conv_equals_jax(geo, bf16):
    _, b, cin, size, cout, k, s, transposed = geo
    rng = np.random.RandomState(sum(map(ord, geo[0])))
    x = rng.randn(b, size, size, cin).astype(np.float32)
    if bf16:
        x = _bf16(x)
    shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    wt = (rng.randn(*shape) / np.sqrt(k * k * cin)).astype(np.float32)
    w_hwio = wt.transpose(2, 3, 0, 1) if transposed else wt.transpose(2, 3, 1, 0)
    acc, sx, sw, y = _jax_int8(x, w_hwio, k, s, transposed,
                               jnp.bfloat16 if bf16 else jnp.float32)

    dt = torch.bfloat16 if bf16 else torch.float32
    tx, tw = nchw(x).to(dt), torch.from_numpy(wt)
    xq, tsx = tq.quantize_activation(tx)
    wq, tsw = tq.quantize_weight(tw, transposed)
    geom = dict(stride=s, padding=k // 2, transposed=transposed,
                output_padding=s - 1 if transposed else 0)
    got_acc = tq.int8_accumulate(xq, wq, **geom)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), acc)
    assert float(tsx) == sx
    np.testing.assert_array_equal(tsw.numpy(), sw)
    got = tq.int8_conv(tx, tw, **geom)
    assert got.dtype == dt
    np.testing.assert_array_equal(nhwc(got.float()), y)


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "deconv"])
def test_int8_modules_close_to_fp32(transposed):
    """Quantization noise only: Conv (5x5 s2) and ConvTranspose (5x5 s2)
    under int8 within 0.03 relative L2 of fp32."""
    rng = np.random.RandomState(4 + transposed)
    x = nchw(rng.randn(1, 16, 16, 8).astype(np.float32))
    cls = ConvTranspose if transposed else Conv
    m = cls(8, 24, 5, 2, policy=DEFAULT_POLICY, device="cpu",
            generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        yf = m(x)
        m.policy = INT8_FP32
        y8 = m(x)
    assert y8.shape == yf.shape == ((1, 24, 32, 32) if transposed
                                    else (1, 24, 8, 8))
    assert _rel_err(y8, yf) < 0.03


def test_serve_int8_policy_wiring():
    p = tprec.policy_from_str("serve-int8")
    assert p is tprec.SERVE_INT8_POLICY
    assert p.int8_conv and p.packed_dse and p.fused_win_attn
    assert p.compute_dtype == torch.bfloat16
    assert tprec.policy_from_str("int8").int8_conv
    assert p == dataclasses.replace(tprec.SERVE_POLICY, int8_conv=True)
    # no training or parity policy quantizes
    for name in ("fp32", "bf16", "serve"):
        assert not tprec.policy_from_str(name).int8_conv
    assert not DEFAULT_POLICY.int8_conv
    # the int8 route refuses a float policy instead of running a float conv
    t = torch.zeros(1, 8, 8, 8)
    with pytest.raises(ValueError, match="int8_conv=False"):
        tq.policy_conv(t, torch.zeros(8, 8, 1, 1), torch.zeros(8),
                       DEFAULT_POLICY)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_plain_int8_dse_equals_jax_packed(bf16):
    """The port's packed_dse computes the plain chain; JAX quantizes the
    block-diagonal packed kernel.  The per-channel scales of kron(I, w) are
    w's and the packed tensor's max is the batch's, so the two agree bit
    for bit."""
    dt = torch.bfloat16 if bf16 else torch.float32
    pol = Policy(compute_dtype=dt, int8_conv=True, packed_dse=True)
    tm = DSE(3, policy=pol, device="cpu", generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for name, prm in tm.named_parameters():
            if name.endswith("bias"):
                prm.normal_(0, 0.1, generator=g)
    x = np.random.RandomState(6).rand(4, 16, 16, 3).astype(np.float32)
    if bf16:
        x = _bf16(x)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jpol = JPolicy(compute_dtype=jdt, int8_conv=True, packed_dse=True)
    jm = JDSE(in_ch=3, policy=jpol)
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"], _dse_map)
    want = jm.apply({"params": params}, jnp.asarray(x, jdt))
    with torch.inference_mode():
        got = tm(nchw(x).to(dt))
    assert got.dtype == dt
    np.testing.assert_array_equal(nhwc(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


def test_int8_rgb_codec_forward_sane():
    """The RGB codec's forward under replace(DEFAULT_POLICY, int8_conv=True)
    with the packed DSE: finite and within 0.08 relative L2 of fp32 on
    random-init weights (quantization noise only)."""
    pol8 = dataclasses.replace(DEFAULT_POLICY, int8_conv=True, packed_dse=True)
    rng = np.random.RandomState(9)
    alpha = (rng.rand(4, 64, 64, 1) > 0.3).astype(np.float32)
    rgb = rng.rand(4, 64, 64, 3).astype(np.float32) * alpha
    a, x = nchw(alpha), nchw(rgb)
    model = RGBCodec(policy=DEFAULT_POLICY, device="cpu",
                     generator=torch.Generator().manual_seed(10))
    with torch.inference_mode():
        me = mask_pyramid(a)
        xf = model(x, a, a, me)["x_hat"]
        model.policy = pol8
        for mod in model.modules():
            if hasattr(mod, "policy"):
                mod.policy = pol8
        x8 = model(x, a, a, me)["x_hat"]
    assert bool(torch.isfinite(x8).all())
    assert _rel_err(x8, xf) < 0.08
