"""The conv-chain kernels of the PyTorch port against the JAX package on the
CPU: the plain versions of the gate-chain and DSE kernels against the
Pallas kernels in interpret mode (as tests/test_pallas_gate.py and
tests/test_pallas_dse.py run them), and the port's WinGateAttention,
SimplifiedAttention and DSE with the new policy flags against the JAX
modules with the same flags, on the same weights.

Inputs and weights are seeded numpy.  Tolerances: fp32 1e-4 absolute (the
chains sum up to 9*C/2 terms per conv in another order, six convs deep);
bf16 2^-5 * max(1, max|ref|), four bf16 ulps at the largest value (an fp32
sum a hair apart can round an intermediate to the neighbouring bf16 value).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.core.precision import Policy as JPolicy  # noqa: E402
from rgba_tpu.ops import attention as jatt  # noqa: E402
from rgba_tpu.ops.enhance import DSE as JDSE  # noqa: E402
from rgba_tpu.ops.pallas.dse import fused_dse as j_fused_dse  # noqa: E402
from rgba_tpu.ops.pallas.gate_chain import fused_gate_chain as j_fgc  # noqa: E402
from rgba_tpu.train.torch_import import (_dse_map, _simp_attn_map,  # noqa: E402
                                         _win_gate_map)

from rgba_tpu_torch.core.precision import Policy  # noqa: E402
from rgba_tpu_torch.ops import attention as tatt  # noqa: E402
from rgba_tpu_torch.ops.enhance import DSE  # noqa: E402
from rgba_tpu_torch.ops.kernels import dse as kdse  # noqa: E402
from rgba_tpu_torch.ops.kernels import gate_chain as kgc  # noqa: E402

from torch_port_util import (KEY, close, jax_params_from_torch, nchw,  # noqa: E402
                             nhwc)

torch.set_num_threads(2)

FP32_TOL = 1e-4
BF16_TOL = 2.0 ** -5


def _rng(seed):
    return np.random.RandomState(seed)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _conv(rng, k, cin, cout, scale=1.0):
    """JAX-layout conv params (HWIO kernel) with a nonzero bias."""
    std = scale / np.sqrt(k * k * cin)
    return {"kernel": (rng.randn(k, k, cin, cout) * std).astype(np.float32),
            "bias": (rng.randn(cout) * 0.1).astype(np.float32)}


def _check(got, want, bf16: bool, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if bf16:
        tol = BF16_TOL * max(1.0, float(np.abs(want).max()))
        assert float(np.abs(got - want).max()) <= tol, what
    else:
        close(got, want, FP32_TOL, 0.0, what)


def _t(a, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if bf16 else t


# --------------------------------------------------------------- gate chain


def _gate_params(rng, c, keys, trunk, gate, final):
    half = c // 2
    p = {}
    for name in trunk + gate:
        p[name] = {keys[0]: _conv(rng, 1, c, half), keys[1]: _conv(rng, 3, half, half),
                   keys[2]: _conv(rng, 1, half, c, 0.5)}
    p[final] = _conv(rng, 1, c, c)
    return p


def _chain_weights(p, names, keys):
    def stack(key, leaf):
        return torch.from_numpy(np.stack([
            p[n][key][leaf].reshape(-1, p[n][key][leaf].shape[-1])
            if leaf == "kernel" else p[n][key][leaf] for n in names]))
    return kgc.GateChainWeights(stack(keys[0], "kernel"), stack(keys[0], "bias"),
                                stack(keys[1], "kernel"), stack(keys[1], "bias"),
                                stack(keys[2], "kernel"), stack(keys[2], "bias"))


FLAVOURS = {
    # (act, post_act, separate g, trunk names, gate names, block keys, final)
    "wingate": ("gelu_erf", True, True, ("conv_a0", "conv_a1", "conv_a2"),
                ("conv_b0", "conv_b1", "conv_b2"), ("conv0", "conv1", "conv2"),
                "conv_b3"),
    "simplified": ("relu", False, False,
                   ("trunk_ResBlock1", "trunk_ResBlock2", "trunk_ResBlock3"),
                   ("attention_ResBlock1", "attention_ResBlock2",
                    "attention_ResBlock3"), ("conv1", "conv2", "conv3"),
                   "conv1"),
}


@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
@pytest.mark.parametrize("c,hw", [(64, (16, 16)), (80, (8, 8))])
@pytest.mark.parametrize("bf16", [False, True])
def test_gate_chain_plain_vs_pallas(flavour, c, hw, bf16):
    act, post, sep, trunk, gate, keys, final = FLAVOURS[flavour]
    if bf16 and act == "gelu_erf":
        act = "gelu_tanh"          # the bf16 policy's GELU
    rng = _rng(30 + c)
    x = rng.randn(2, *hw, c).astype(np.float32)
    g = rng.randn(2, *hw, c).astype(np.float32) if sep else None
    p = _gate_params(rng, c, keys, trunk, gate, final)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = j_fgc(jnp.asarray(x, dt), None if g is None else jnp.asarray(g, dt),
                 p, act=act, post_act=post, trunk_names=trunk, gate_names=gate,
                 block_keys=keys, final_name=final, interpret=True)
    got = kgc.fused_gate_chain(
        _t(x, bf16), None if g is None else _t(g, bf16),
        _chain_weights(p, trunk, keys), _chain_weights(p, gate, keys),
        torch.from_numpy(p[final]["kernel"].reshape(c, c)),
        torch.from_numpy(p[final]["bias"]), act, post)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _check(got.float().numpy(), np.asarray(want.astype(jnp.float32)), bf16,
           f"{flavour} C={c} bf16={bf16}")
    assert kgc.KERNEL.launches == 0        # CPU tensors never launch


@pytest.mark.parametrize("flavour", ["wingate", "simplified"])
def test_gate_modules_with_the_kernel_flag(flavour):
    """The port's gate blocks with fused_gate_chain on against the JAX
    blocks with the same flag (Pallas in interpret mode) and against the
    port's own plain path."""
    dim, b, h, w = 32, 2, 16, 16
    x = _rng(40).randn(b, h, w, dim).astype(np.float32)
    kw = dict(device="cpu", generator=_gen(11))
    fused = Policy(fused_gate_chain=True)
    if flavour == "wingate":
        alpha = (_rng(41).rand(b, h, w, 1) > 0.4).astype(np.float32)
        tm = tatt.WinGateAttention(dim, 4, 8, 4, policy=fused, **kw)
        jm = jatt.WinGateAttention(dim, num_heads=4, window_size=8,
                                   shift_size=4,
                                   policy=JPolicy(fused_gate_chain=True))
        args, targs, mapper = (x, alpha), (nchw(x), nchw(alpha)), _win_gate_map
    else:
        tm = tatt.SimplifiedAttention(dim, policy=fused, **kw)
        jm = jatt.SimplifiedAttention(dim,
                                      policy=JPolicy(fused_gate_chain=True))
        args, targs, mapper = (x,), (nchw(x),), _simp_attn_map
    with torch.no_grad():
        for name, prm in tm.named_parameters():
            if name.endswith("bias"):
                prm.normal_(0, 0.1, generator=_gen(12))
    params = jax_params_from_torch(tm, jm.init(KEY, *args)["params"], mapper)
    want = np.asarray(jm.apply({"params": params}, *args))
    with torch.inference_mode():
        got = nhwc(tm(*targs))
        tm.policy = Policy()
        for m in tm.modules():
            m.policy = tm.policy
        plain = nhwc(tm(*targs))
    close(got, want, FP32_TOL)
    close(got, plain, FP32_TOL)


def test_gate_chain_wrapper_refuses_what_it_does_not_take():
    t = torch.empty(1, 4, 4, 16, device="meta")
    cw = kgc.GateChainWeights(*[torch.empty(1, device="meta")] * 6)
    with pytest.raises(ValueError, match="unsupported device"):
        kgc.fused_gate_chain(t, None, cw, cw, t, t, "relu", False)
    with pytest.raises(ValueError, match="act"):
        kgc.fused_gate_chain(t, None, cw, cw, t, t, "swish", False)


# ---------------------------------------------------------------------- DSE


def _dse_params(rng, cio):
    p = {"input_conv": _conv(rng, 1, cio, 32),
         "output_conv": _conv(rng, 1, 32, cio)}
    for k in ("enh1", "enh2", "enh3"):
        p[k] = {"conv1": _conv(rng, 3, 32, 32), "conv2": _conv(rng, 3, 32, 32, 0.5)}
    return p


def _dse_weights(p, cio):
    convs = [p[k][c] for k in ("enh1", "enh2", "enh3") for c in ("conv1", "conv2")]
    return (torch.from_numpy(p["input_conv"]["kernel"].reshape(cio, 32)),
            torch.from_numpy(p["input_conv"]["bias"]),
            torch.from_numpy(np.stack([c["kernel"].reshape(288, 32) for c in convs])),
            torch.from_numpy(np.stack([c["bias"] for c in convs])),
            torch.from_numpy(p["output_conv"]["kernel"].reshape(32, cio)),
            torch.from_numpy(p["output_conv"]["bias"]))


@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dse_plain_vs_pallas(cio, leaky, bf16):
    rng = _rng(50 + cio)
    x = rng.rand(2, 64, 64, cio).astype(np.float32)
    p = _dse_params(rng, cio)
    dt = jnp.bfloat16 if bf16 else jnp.float32
    want = j_fused_dse(jnp.asarray(x, dt), p, leaky=leaky, interpret=True)
    got = kdse.fused_dse(_t(x, bf16), *_dse_weights(p, cio), leaky=leaky)
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    _check(got.float().numpy(), np.asarray(want.astype(jnp.float32)), bf16,
           f"cio={cio} bf16={bf16}")
    assert kdse.KERNEL.launches == 0


@pytest.mark.parametrize("in_ch,leaky", [(3, False), (1, True)])
def test_dse_module_with_the_kernel_flag(in_ch, leaky):
    x = _rng(60).rand(2, 32, 64, in_ch).astype(np.float32)
    fused = Policy(fused_dse=True)
    tm = DSE(in_ch, leaky=leaky, policy=fused, device="cpu", generator=_gen(13))
    with torch.no_grad():
        for name, prm in tm.named_parameters():
            if name.endswith("bias"):
                prm.normal_(0, 0.1, generator=_gen(14))
    jm = JDSE(in_ch=in_ch, leaky=leaky, policy=JPolicy(fused_dse=True))
    params = jax_params_from_torch(tm, jm.init(KEY, x)["params"], _dse_map)
    want = np.asarray(jm.apply({"params": params}, x))
    with torch.inference_mode():
        got = nhwc(tm(nchw(x)))
        tm.policy = Policy()
        plain = nhwc(tm(nchw(x)))
    close(got, want, FP32_TOL)
    close(got, plain, FP32_TOL)


def test_packed_dse_wins_over_fused_dse_as_in_jax():
    """packed_dse with B % 4 == 0 takes the (plain) packed path in both
    packages; fused_dse runs only otherwise."""
    both = Policy(fused_dse=True, packed_dse=True)
    tm = DSE(3, policy=both, device="cpu", generator=_gen(15))
    calls = []
    tm._kernel = lambda x: calls.append(x.shape[0]) or x
    with torch.inference_mode():
        tm(torch.zeros(4, 3, 8, 8))
        tm(torch.zeros(2, 3, 8, 8))
        tm.policy = dataclasses.replace(both, packed_dse=False)
        tm(torch.zeros(4, 3, 8, 8))
    assert calls == [2, 4]


def test_dse_wrapper_refuses_what_it_does_not_take():
    t = torch.empty(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        kdse.fused_dse(t, t, t, t, t, t, t, leaky=False)
