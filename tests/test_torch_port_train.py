"""Training through the PyTorch port, on the CPU in fp32, against the JAX
package on the same weights and the same noise.

* remat: gradients through a kernel-routed module equal gradients through
  the plain module for each of the four ops (the twin of
  tests/test_remat_vjp.py, same shapes, rtol = atol = 2e-4; forward 2e-5).
  On the CPU the forward is the kernel's plain version, so the tests also
  assert that the autograd Function was taken and saved its inputs only.
* entropy: ``aux_loss`` and its quantile gradient (1e-5), training
  likelihoods under injected noise (1e-6 + 1e-4 relative, as the eval
  likelihoods in tests/test_torch_port_models.py).
* one step: the RD loss (1e-4 relative) and every gradient leaf (2e-4 *
  max|g| of the leaf) of MaskCodec and RGBCodec at 64x64 against
  ``jax.grad``, with ``training=False`` (the STE and round path, no noise)
  and with ``training=True`` under injected noise.
* optimizer: two train steps against optax on the same gradients (1e-6).
* loops, checkpoints, loader, config: twins of tests/test_train.py.

Noise: the two packages' generators cannot agree, so a numpy stream stands
in for both.  On the JAX side the test replaces ``jax.random.uniform``
while the loss is traced; the port takes a callable as its noise source.
Weights are drawn by the JAX modules' own initializers, made live with
seeded numpy noise (biases, a gain of 10 on the encoders' last 1x1 conv,
DSE output bias 0.5: latents then span several quantization bins) and
carried into the port with ``weights.load_jax_params``.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.core.config import TrainConfig as JTrainConfig  # noqa: E402
from rgba_tpu.entropy.bottleneck import EntropyBottleneck as JBottleneck  # noqa: E402
from rgba_tpu.entropy.gaussian import GaussianConditional as JGaussian  # noqa: E402
from rgba_tpu.models.hyperprior import ChannelARPrior as JPrior  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402
from rgba_tpu.train import state as jstate  # noqa: E402
from rgba_tpu.train.torch_import import _prior_map  # noqa: E402

from rgba_tpu_torch import weights  # noqa: E402
from rgba_tpu_torch.core.config import TrainConfig, load_config  # noqa: E402
from rgba_tpu_torch.core.precision import DEFAULT_POLICY, Policy  # noqa: E402
from rgba_tpu_torch.data.loader import BatchLoader  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy.bottleneck import EntropyBottleneck  # noqa: E402
from rgba_tpu_torch.entropy.gaussian import GaussianConditional  # noqa: E402
from rgba_tpu_torch.models.hyperprior import ChannelARPrior  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.ops import attention as tatt  # noqa: E402
from rgba_tpu_torch.ops import enhance as tenh  # noqa: E402
from rgba_tpu_torch.ops.enhance import DSE  # noqa: E402
from rgba_tpu_torch.ops.gdn import GDN  # noqa: E402
from rgba_tpu_torch.ops.kernels import gdn as kgdn  # noqa: E402
from rgba_tpu_torch.ops.kernels import win_attn as kattn  # noqa: E402
from rgba_tpu_torch.ops.kernels.remat import fused_primal_plain_grad  # noqa: E402
from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid  # noqa: E402
from rgba_tpu_torch.train import state as tstate  # noqa: E402
from rgba_tpu_torch.train.checkpoint import (latest_checkpoint,  # noqa: E402
                                             load_checkpoint, save_checkpoint,
                                             save_rotating, step_from_path)
from rgba_tpu_torch.train.loops import (MaskTrainer, RGBTrainer,  # noqa: E402
                                        _rgb_loss_fn)
from rgba_tpu_torch.train.meters import AverageMeter, WeightedMeter  # noqa: E402
from rgba_tpu_torch.utils.trace import trace  # noqa: E402

from torch_port_util import (KEY, close, jax_params_from_torch,  # noqa: E402
                             nchw, nhwc)

torch.set_num_threads(2)

REMAT_TOL = 2e-4        # rtol = atol, gradients through kernel-routed modules
REMAT_FWD_TOL = 2e-5
LOSS_RTOL = 1e-4
GRAD_TOL = 2e-4         # x max|g| of the leaf
AUX_TOL = 1e-5
OPT_TOL = 1e-6


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ remat


def _function_nodes(out):
    """The remat Function's nodes in the graph that made ``out``."""
    found, seen, todo = [], set(), [out.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if type(node).__name__ == "_FusedPrimalPlainGradBackward":
            found.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return found


def _remat_compare(make, flag, inputs, n_sites=1):
    """Gradients (inputs and parameters) and outputs of ``make(policy)``
    with ``flag`` on against off, on the same weights."""
    plain = make(DEFAULT_POLICY)
    fused = make(Policy(**{flag: True}))
    g = _gen(11)
    with torch.no_grad():       # biases start at 0: make them count
        for name, p in plain.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    fused.load_state_dict(plain.state_dict())
    res = []
    for mod in (plain, fused):
        ins = [t.clone().requires_grad_(i == 0) for i, t in enumerate(inputs)]
        out = mod(*ins)
        # what each Function node keeps for backward (freed by backward)
        saved = [[tuple(t.shape) for t in node.saved_tensors if t is not None]
                 for node in _function_nodes(out)]
        # nonlinear reduction so cotangents vary over positions
        torch.sum(out * torch.sin(out)).backward()
        res.append((out, ins[0].grad,
                    {n: p.grad for n, p in mod.named_parameters()}, saved))
    (o_p, gx_p, gp_p, saved_p), (o_f, gx_f, gp_f, saved) = res
    assert not saved_p
    assert len(saved) == n_sites, "the kernel route was not taken"
    close(o_f.detach(), o_p.detach(), REMAT_FWD_TOL, REMAT_FWD_TOL, "forward")
    close(gx_f, gx_p, REMAT_TOL, REMAT_TOL, "grad of the input")
    for name, want in gp_p.items():
        assert gp_f[name] is not None, name
        close(gp_f[name], want, REMAT_TOL, REMAT_TOL, f"grad of {name}")
    return saved


def test_grad_through_fused_win_attention():
    rng = np.random.RandomState(0)
    x = nchw(rng.randn(2, 16, 16, 16).astype(np.float32))
    alpha = torch.ones(2, 1, 16, 16)
    alpha[:, :, :8, :8] = 0.0
    saved = _remat_compare(
        lambda p: tatt.MaskedWinBlock(16, 4, 8, 4, policy=p, device="cpu",
                                      generator=_gen(0)),
        "fused_win_attn", (x, alpha))
    # tokens, wqkv, bqkv, wproj, bproj, rel_bias: the inputs and no more
    assert sorted(saved[0]) == sorted([(8, 64, 16), (16, 48), (48,), (16, 16), (16,),
                             (4, 64, 64)])


def test_grad_through_fused_gate_chain_wingate():
    rng = np.random.RandomState(1)
    x = nchw(rng.randn(1, 32, 64, 32).astype(np.float32))
    alpha = nchw((rng.rand(1, 32, 64, 1) > 0.4).astype(np.float32))
    saved = _remat_compare(
        lambda p: tatt.WinGateAttention(32, 4, 8, 4, policy=p, device="cpu",
                                        generator=_gen(1)),
        "fused_gate_chain", (x, alpha))
    # x, the attention output and the 38 conv parameters of the gate
    assert len(saved[0]) == 2 + 38


def test_grad_through_fused_simplified_attention():
    rng = np.random.RandomState(2)
    x = nchw(rng.randn(2, 32, 64, 32).astype(np.float32))
    saved = _remat_compare(
        lambda p: tatt.SimplifiedAttention(32, policy=p, device="cpu",
                                           generator=_gen(2)),
        "fused_gate_chain", (x,))
    assert len(saved[0]) == 1 + 38


@pytest.mark.parametrize("cio,leaky", [(3, False), (1, True)])
def test_grad_through_fused_dse(cio, leaky):
    rng = np.random.RandomState(3)
    x = nchw(rng.randn(1, 64, 64, cio).astype(np.float32))
    saved = _remat_compare(
        lambda p: DSE(cio, leaky=leaky, policy=p, device="cpu",
                      generator=_gen(3)),
        "fused_dse", (x,))
    assert len(saved[0]) == 1 + 16


@pytest.mark.parametrize("inverse", [False, True])
def test_grad_through_fused_gdn(inverse):
    rng = np.random.RandomState(4)
    x = nchw(rng.randn(2, 16, 24, 32).astype(np.float32))

    def make(p):
        m = GDN(32, inverse=inverse, policy=p, device="cpu")
        with torch.no_grad():       # off the identity: gamma's gradient counts
            m.gamma.add_(0.02 * torch.rand(32, 32, generator=_gen(4)))
        return m
    saved = _remat_compare(make, "fused_gdn", (x,))
    assert sorted(saved[0]) == sorted([(2, 16, 24, 32), (32, 32), (32,)])


def test_remat_saves_inputs_only_and_honours_needs_input_grad():
    """The Function keeps exactly the tensors it was given, returns no
    gradient for an input that needs none, and is bypassed when nothing
    needs one."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(40, 16).astype(np.float32))
    gt = torch.from_numpy((0.1 * np.eye(16) + 1e-3 * rng.rand(16, 16))
                          .astype(np.float32))
    beta = torch.ones(16)
    assert kgdn.fused_gdn(x, gt, beta).grad_fn is None
    x.requires_grad_(True)
    beta.requires_grad_(True)                   # gamma_t stays frozen
    out = kgdn.fused_gdn(x, gt, beta)
    (node,) = _function_nodes(out)
    assert [t.data_ptr() for t in node.saved_tensors] == [
        t.data_ptr() for t in (x, gt, beta)]
    out.sum().backward()
    want = torch.autograd.grad(
        kgdn.gdn_plain(x, gt, beta).sum(), (x, beta))
    close(x.grad, want[0], 1e-6)
    close(beta.grad, want[1], 1e-5)
    with torch.no_grad():
        assert kgdn.fused_gdn(x, gt, beta).grad_fn is None


def test_remat_takes_tuples_and_none():
    calls = []

    def fused(a, pair, nothing):
        calls.append("fused")
        assert nothing is None and isinstance(pair, tuple)
        return a * pair[0] + pair[1]

    def plain(a, pair, nothing):
        calls.append("plain")
        return a * pair[0] + pair[1]

    a = torch.arange(3.0, requires_grad=True)
    b = torch.full((3,), 2.0, requires_grad=True)
    c = torch.ones(3)
    out = fused_primal_plain_grad(fused, plain, (a, (b, c), None))
    assert calls == ["fused"]
    out.sum().backward()
    assert calls == ["fused", "plain"]
    close(a.grad, [2.0, 2.0, 2.0], 0)
    close(b.grad, [0.0, 1.0, 2.0], 0)


@pytest.mark.parametrize("site", ["wingate", "simplified", "dse"])
def test_kernel_site_plain_path_is_a_pure_function_of_its_weights(site):
    """The backward differentiates ``gate_plain`` / ``dse_chain`` on copies
    of the saved weights: they must read the weights they are handed, not
    the module's, and equal the module's own path on the module's."""
    kw = dict(policy=DEFAULT_POLICY, device="cpu", generator=_gen(8))
    rng = np.random.RandomState(8)
    if site == "dse":
        m = DSE(3, **kw)
        x = nchw(rng.randn(1, 16, 16, 3).astype(np.float32))
        params, own = list(m.parameters()), m.chain(x)

        def pure(ps):
            return tenh.dse_chain(x, ps, m.policy, m.leaky)
    else:
        m = (tatt.WinGateAttention(16, 4, 8, 0, **kw) if site == "wingate"
             else tatt.SimplifiedAttention(16, **kw))
        x = nchw(rng.randn(1, 16, 16, 16).astype(np.float32))
        g = None if site == "simplified" else 0.5 * x.flip(1)
        params, own = m.gate_parameters(), m.gate(x, g)

        def pure(ps):
            return tatt.gate_plain(x, g, ps, m.policy, m.act, m.post_act)
    assert torch.equal(pure(params), own)
    other = [(1.5 * p + 0.01).detach().requires_grad_(True) for p in params]
    out = pure(other)
    assert not torch.allclose(out, own)
    grads = torch.autograd.grad(out.sum(), other)
    assert all(bool(gr.abs().sum() > 0) for gr in grads)
    assert all(p.grad is None for p in m.parameters())


def test_attention_kernel_layout_follows_an_optimizer_step():
    """``WindowAttention`` keeps its weights in the kernel's layout; an
    in-place update of a parameter must rebuild it."""
    m = tatt.WindowAttention(16, 4, 4, policy=DEFAULT_POLICY, device="cpu",
                             generator=_gen(6))
    before, _ = m.kernel_inputs(torch.bfloat16)
    assert m.kernel_inputs(torch.bfloat16)[0] is before       # cached
    opt = torch.optim.Adam(m.parameters(), lr=0.1)
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    after, rel_bias = m.kernel_inputs(torch.bfloat16)
    want = kattn.kernel_weights(m.qkv.weight.t(), m.qkv.bias,
                                m.proj.weight.t(), m.proj.bias, 4,
                                torch.bfloat16)
    assert not torch.equal(after.wqkv, before.wqkv)
    for got, ref in zip(after, want):
        assert torch.equal(got, ref)
    assert torch.equal(rel_bias, m.rel_bias())


# ---------------------------------------------------------------- entropy


class NoiseStream:
    """One numpy stream of U(-0.5, 0.5) for both packages: the JAX side
    draws through ``jax_uniform`` (in place of ``jax.random.uniform``),
    which records NHWC arrays in draw order; the port side replays them,
    transposed to NCHW, through ``torch_source``."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)
        self.drawn = []
        self.replayed = 0
        self.real = jax.random.uniform

    def jax_uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0,
                    maxval=1.0):
        if len(shape) != 4:     # a parameter initializer (flax traces
            return self.real(key, shape, dtype, minval, maxval)   # them)
        assert (minval, maxval) == (-0.5, 0.5)
        a = (self.rng.rand(*shape) - 0.5).astype(np.float32)
        self.drawn.append(a)
        return jnp.asarray(a)

    def torch_source(self, shape):
        a = self.drawn[self.replayed]
        self.replayed += 1
        t = torch.from_numpy(a)
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2)
        assert tuple(t.shape) == tuple(shape)
        return t


def _bottlenecks(seed, channels=8):
    tm = EntropyBottleneck(channels, device="cpu", generator=_gen(seed))
    rng = np.random.RandomState(seed)
    with torch.no_grad():       # off the init: factors 0, quantiles +-10
        for name, p in tm.named_parameters():
            p.add_(torch.from_numpy(
                (0.1 * rng.randn(*p.shape)).astype(np.float32)))
    jm = JBottleneck(channels)
    tmpl = jm.init({"params": KEY, "noise": KEY},
                   np.zeros((1, 2, 2, channels), np.float32))["params"]
    params = {k: tm.state_dict()[("" if k == "quantiles" else "_") + k]
              .numpy().copy() for k in tmpl}
    return tm, jm, params


def test_aux_loss_and_its_gradient():
    tm, jm, params = _bottlenecks(7)
    val, grads = jax.value_and_grad(lambda p: jm.apply(
        {"params": p}, method=lambda m: m.aux_loss()))(params)
    got = tm.aux_loss()
    got.backward()
    close(float(got.detach()), float(val), 0.0, AUX_TOL)
    close(tm.quantiles.grad, np.asarray(grads["quantiles"]), AUX_TOL)
    assert float(np.abs(np.asarray(grads["quantiles"])).max()) > 0
    for name, p in tm.named_parameters():
        if name != "quantiles":
            assert p.grad is None, name           # the chain is detached
            assert not np.asarray(grads[name.lstrip("_")]).any()


def test_bottleneck_training_likelihoods(monkeypatch):
    tm, jm, params = _bottlenecks(8)
    z = (np.random.RandomState(9).randn(2, 3, 4, 8) * 4).astype(np.float32)
    noise = NoiseStream(10)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)
    want_hat, want_lik = jm.apply({"params": params}, z, training=True,
                                  rngs={"noise": KEY})
    got_hat, got_lik = tm(nchw(z), training=True,
                          generator=noise.torch_source)
    assert noise.replayed == len(noise.drawn) == 1
    close(nhwc(got_hat), np.asarray(want_hat), 1e-6)
    close(nhwc(got_lik), np.asarray(want_lik), 1e-6, 1e-4)
    with pytest.raises(ValueError, match="noise generator"):
        tm(nchw(z), training=True)


def test_gaussian_training_likelihoods(monkeypatch):
    rng = np.random.RandomState(11)
    y = (rng.randn(2, 4, 4, 6) * 3).astype(np.float32)
    scales = (rng.rand(2, 4, 4, 6) * 2).astype(np.float32)   # some below 0.11
    means = rng.randn(2, 4, 4, 6).astype(np.float32)
    noise = NoiseStream(12)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)
    want = JGaussian().likelihood(y, scales, means, training=True, rng=KEY)
    got = GaussianConditional().likelihood(
        nchw(y), nchw(scales), nchw(means), training=True,
        generator=noise.torch_source)
    close(nhwc(got), np.asarray(want), 1e-6, 1e-4)


def test_channel_ar_prior_training(monkeypatch):
    """The 5-slice head at M=40 with noise: z first, then slice by slice."""
    y = (np.random.RandomState(13).randn(1, 8, 8, 40) * 3).astype(np.float32)
    tm = ChannelARPrior(40, 5, policy=DEFAULT_POLICY, device="cpu",
                        generator=_gen(3))
    jm = JPrior(latent_channels=40, num_slices=5)
    tmpl = jm.init({"params": KEY, "noise": KEY}, y)["params"]
    params = jax_params_from_torch(tm, tmpl, _prior_map)
    noise = NoiseStream(14)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)
    want = jm.apply({"params": params}, y, training=True,
                    rngs={"noise": KEY})
    got = tm(nchw(y), training=True, generator=noise.torch_source)
    assert noise.replayed == len(noise.drawn) == 6
    close(nhwc(got["y_hat"]), np.asarray(want["y_hat"]), 1e-4)
    for k in ("y_likelihoods", "z_likelihoods"):
        close(nhwc(got[k]), np.asarray(want[k]), 1e-6, 1e-4, k)


# --------------------------------------------------------------- one step


def _liven(params, seed):
    """Seeded bias noise, DSE output biases at 0.5 and a gain of 10 on the
    encoder's last 1x1 conv, on a JAX param tree (numpy leaves)."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        a = np.array(node, np.float32)
        if path.endswith("/bias"):
            a = a + (0.02 * rng.randn(*a.shape)).astype(np.float32)
        if path.endswith("output_conv/bias"):
            a[:] = 0.5
        if path in ("/encoder/x4/kernel", "/encoder/conv7/kernel"):
            a = a * 10.0
        return a
    return walk(params, "")


def _assert_grads(model, kind, j_grads):
    """Every gradient leaf of the port against the JAX tree, brought into
    the port's keys and layouts."""
    want = weights.state_dict_from_jax(j_grads, kind)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        assert got[name] is not None, name
        scale = float(w.abs().max())
        close(got[name], w, GRAD_TOL * scale + 1e-9, 0.0, f"grad of {name}")


@pytest.fixture(scope="module")
def mask_models():
    a = synthetic_rgba_batch(2, 64, 64, seed=3)["alpha"]
    jm = JMaskCodec()
    params = _liven(jax.jit(lambda: jm.init(
        {"params": KEY, "noise": KEY}, a, training=False))()["params"], 1)
    tm = MaskCodec(policy=DEFAULT_POLICY, device="cpu", generator=_gen(0))
    weights.load_jax_params(tm, params, "mask")
    return tm, jm, params, a


@pytest.fixture(scope="module")
def rgb_models():
    d = synthetic_rgba_batch(1, 64, 64, seed=4)
    x, a = d["masked_image"], d["alpha"]
    jm = JRGBCodec()
    params = _liven(jax.jit(lambda: jm.init(
        {"params": KEY, "noise": KEY}, x, a, a, j_pyramid(a),
        training=False))()["params"], 2)
    tm = RGBCodec(policy=DEFAULT_POLICY, device="cpu", generator=_gen(0))
    weights.load_jax_params(tm, params, "rgb")
    return tm, jm, params, x, a


LAMBDA = 1024.0


@pytest.mark.parametrize("training", [False, True])
def test_mask_codec_step_matches_jax(mask_models, training, monkeypatch):
    tm, jm, params, a = mask_models
    noise = NoiseStream(20)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)

    def j_loss(p):
        out = jm.apply({"params": p}, a, training=training,
                       rngs={"noise": KEY})
        return LAMBDA * out["mse_loss"] + out["bpp"]
    want, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    tm.zero_grad()
    out = tm(nchw(a), training=training, generator=noise.torch_source)
    rd = LAMBDA * out["mse_loss"] + out["bpp"]
    rd.backward()
    assert noise.replayed == len(noise.drawn) == (6 if training else 0)
    close(float(rd.detach()), float(want), 0.0, LOSS_RTOL)
    _assert_grads(tm, "mask", j_grads)


@pytest.mark.parametrize("training", [False, True])
def test_rgb_codec_step_matches_jax(rgb_models, training, monkeypatch):
    tm, jm, params, x, a = rgb_models
    noise = NoiseStream(21)
    monkeypatch.setattr(jax.random, "uniform", noise.jax_uniform)

    def j_loss(p):
        out = jm.apply({"params": p}, x, a, a, j_pyramid(a),
                       training=training, rngs={"noise": KEY})
        return LAMBDA * out["mse_loss"] + out["bpp"]
    want, j_grads = jax.jit(jax.value_and_grad(j_loss))(params)
    tm.zero_grad()
    ta = nchw(a)
    out = tm(nchw(x), ta, ta, mask_pyramid(ta), training=training,
             generator=noise.torch_source)
    rd = LAMBDA * out["mse_loss"] + out["bpp"]
    rd.backward()
    assert noise.replayed == len(noise.drawn) == (11 if training else 0)
    close(float(rd.detach()), float(want), 0.0, LOSS_RTOL)
    _assert_grads(tm, "rgb", j_grads)


# -------------------------------------------------------------- optimizer


def test_train_step_matches_optax():
    """Two steps on the same gradients: loss = sum(p * G) has gradient G
    whatever p is.  G reaches beyond +-5 (the clamp) and the aux step
    follows the main update.  The quantiles' G is 0, as in training, where
    the straight-through rounding cancels the RD loss's gradient to them:
    optax's ``masked`` hands a masked-out leaf its raw gradient as the
    update, so only there do "excluded" and "included" agree."""
    tm, jm, params = _bottlenecks(15, channels=4)
    rng = np.random.RandomState(16)
    grads = {k: (rng.randn(*np.shape(v)) * 4).astype(np.float32)
             for k, v in params.items()}
    grads["quantiles"][:] = 0.0
    kw = dict(base_lr=1e-2, aux_lr=1e-2, decay_interval=1, grad_clip=5.0)

    jcfg = JTrainConfig(**kw)
    jstep = jstate.make_train_step(
        jcfg,
        lambda p, batch, rng_: (sum(jnp.sum(p[k] * grads[k]) for k in p), {}),
        lambda p: jm.apply({"params": p}, method=lambda m: m.aux_loss()))
    main_tx, aux_tx = jstate.make_optimizers(jcfg)
    js = jstate.make_train_state(jcfg, params)

    cfg = TrainConfig(**kw)
    tstep = tstate.make_train_step(
        cfg,
        lambda m, batch, gen: (sum(torch.sum(p * torch.from_numpy(
            grads[n.lstrip("_")])) for n, p in m.named_parameters()), {}),
        lambda m: m.aux_loss())
    ts = tstate.make_train_state(cfg, tm)

    for step in range(2):       # the second step runs at the decayed rate
        js, jmet = jstep(js, None, KEY, main_tx, aux_tx)
        tmet = tstep(ts, None, None)
        assert ts.step == int(js.step) == step + 1
        close(float(tmet["rd_loss"]), float(jmet["rd_loss"]), 0.0, 1e-5)
        close(float(tmet["aux_loss"]), float(jmet["aux_loss"]), 0.0, 1e-5)
        for name, p in tm.named_parameters():
            close(p.detach(), np.asarray(js.params[name.lstrip("_")]),
                  OPT_TOL, 0.0, f"{name} after step {step + 1}")
    moved = np.abs(tm.quantiles.detach().numpy()
                   - params["quantiles"]).max()
    assert 0 < moved < 0.05         # two aux steps of lr 1e-2, no main step


def test_aux_optimizer_off_leaves_the_quantiles():
    tm, _, params = _bottlenecks(17, channels=4)
    cfg = TrainConfig(aux_lr=0.0)
    step = tstate.make_train_step(
        cfg, lambda m, b, g: (sum(p.sum() for p in m.parameters()), {}),
        lambda m: m.aux_loss())
    met = step(tstate.make_train_state(cfg, tm), None, None)
    assert "aux_loss" not in met
    close(tm.quantiles.detach(), params["quantiles"], 0)
    assert not np.allclose(tm._bias0.detach().numpy(), params["bias0"])


def test_lr_schedule_matches_jax():
    kw = dict(base_lr=1e-4, decay_interval=220, decay_interval2=500,
              warmup_step=10)
    fn, jfn = (tstate.lr_schedule_fn(TrainConfig(**kw)),
               jstate.lr_schedule_fn(JTrainConfig(**kw)))
    for s in (0, 5, 219, 220, 499, 500, 600):
        close(fn(s), float(jfn(jnp.asarray(s))), 0.0, 1e-6, f"step {s}")
    assert abs(fn(300) - 1e-5) < 1e-12 and abs(fn(500) - 1e-6) < 1e-12


# ------------------------------------------------- config, loops, storage


def test_config_json_and_parity_preset(tmp_path):
    path = tmp_path / "config.json"
    path.write_text('{"train_lambda": 4096, "tot_step": 1500000, '
                    '"batch_size": 8, "lr": {"base": 0.0001, "decay": 0.1, '
                    '"decay_interval": 1000000, "decay_interval2": 1200000},'
                    ' "distortion": "msssim"}')
    cfg = load_config(str(path))
    want = JTrainConfig()
    assert (cfg.train_lambda, cfg.tot_step, cfg.batch_size) == (4096, 1500000, 8)
    assert (cfg.decay_interval, cfg.decay_interval2) == (1000000, 1200000)
    assert cfg.distortion == "msssim"
    assert cfg.lr_at(999_999) == 1e-4
    assert abs(cfg.lr_at(1_000_000) - 1e-5) < 1e-12
    assert abs(cfg.lr_at(1_200_000) - 1e-6) < 1e-12
    # every default is the JAX package's
    import dataclasses
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(want)
    par = load_config(str(path), parity=True)
    assert (par.compute_dtype, par.aux_lr, par.train_lambda) == (
        "float32", 0.0, 4096)
    assert load_config(parity=True, aux_lr=1e-3).aux_lr == 1e-3
    with pytest.raises(KeyError):
        load_config(no_such_key=1)


def test_trainer_model_policy_follows_config(tmp_path):
    t_bf16 = MaskTrainer(TrainConfig(batch_size=1), str(tmp_path),
                         device="cpu")
    assert t_bf16.model.policy.compute_dtype == torch.bfloat16
    t_par = MaskTrainer(TrainConfig(batch_size=1, compute_dtype="float32"),
                        str(tmp_path), device="cpu")
    assert t_par.model.policy.compute_dtype == torch.float32
    explicit = t_par.model
    t_exp = MaskTrainer(TrainConfig(batch_size=1), str(tmp_path),
                        model=explicit, device="cpu")
    assert t_exp.model is explicit
    assert t_exp.model.policy.compute_dtype == torch.float32


def test_trainers_default_to_cuda_and_raise_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MaskTrainer(TrainConfig(), str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RGBTrainer(TrainConfig(), str(tmp_path))


class SynthDataset:
    def __init__(self, n=16, hw=64):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def get(self, idx, epoch_seed=0):
        b = synthetic_rgba_batch(1, self.hw, self.hw, seed=idx)
        return {k: v[0] for k, v in b.items()}


def test_batch_loader():
    loader = BatchLoader(SynthDataset(n=10), batch_size=4, shuffle=True,
                         num_workers=2)
    batches = list(loader)
    assert len(batches) == len(loader) == 2            # drop_last
    assert batches[0]["alpha"].shape == (4, 64, 64, 1)
    assert len(list(loader)) == 2                      # a second epoch
    assert len(list(BatchLoader(SynthDataset(n=10), batch_size=4,
                                drop_last=False, num_workers=1))) == 3


def test_batch_loader_hands_a_fetch_error_to_the_consumer():
    class Broken(SynthDataset):
        def get(self, idx, epoch_seed=0):
            raise OSError(f"sample {idx} is unreadable")
    with pytest.raises(OSError, match="unreadable"):
        list(BatchLoader(Broken(n=4), batch_size=2, num_workers=1))


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    d = str(tmp_path)
    src = EntropyBottleneck(4, device="cpu", generator=_gen(18))
    p = save_checkpoint(src.state_dict(), d, 5000)
    assert step_from_path(p) == 5000 and p.endswith("iter_5000.ckpt")
    dst = EntropyBottleneck(4, device="cpu", generator=_gen(19))
    assert load_checkpoint(dst, p) == []
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    save_rotating(src.state_dict(), d, 10000, interval=5000,
                  keep_after=1_000_000)
    assert not os.path.exists(os.path.join(d, "iter_5000.ckpt"))
    assert latest_checkpoint(d).endswith("iter_10000.ckpt")
    save_rotating(src.state_dict(), d, 15000, interval=5000, keep_after=10000)
    assert os.path.exists(os.path.join(d, "iter_10000.ckpt"))   # past keep_after
    assert not [n for n in os.listdir(d) if n.endswith(".tmp")]
    assert latest_checkpoint(os.path.join(d, "absent")) is None
    assert step_from_path("weights.ckpt") == 0


def test_checkpoint_partial_and_reference_format(tmp_path):
    """Only keys present on both sides with the same shape are restored; a
    reference ``.pth.tar`` may wrap and prefix its weights."""
    src = EntropyBottleneck(4, device="cpu", generator=_gen(20))
    sd = {k: v + 1.0 for k, v in src.state_dict().items()}
    del sd["_bias1"]
    sd["_factor0"] = torch.zeros(5, 3, 1)          # another shape
    sd["not_a_key"] = torch.zeros(1)
    path = str(tmp_path / "iter_7.pth.tar")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    dst = EntropyBottleneck(4, device="cpu", generator=_gen(20))
    assert load_checkpoint(dst, path) == ["_bias1", "_factor0"]
    assert step_from_path(path) == 7
    own = src.state_dict()
    for k, v in dst.state_dict().items():
        want = own[k] if k in ("_bias1", "_factor0") else own[k] + 1.0
        assert torch.equal(v, want), k


def test_mask_trainer_takes_steps(tmp_path, caplog):
    cfg = TrainConfig(train_lambda=1024, batch_size=2, cal_step=1,
                      print_freq=2, tot_step=100, snapshot_freq=2,
                      save_model_freq=10 ** 9, aux_lr=1e-3,
                      compute_dtype="float32")
    trainer = MaskTrainer(cfg, str(tmp_path), device="cpu")
    loader = BatchLoader(SynthDataset(n=4), batch_size=2, num_workers=1,
                         seed=0)
    state = trainer.init_state()
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    with caplog.at_level("INFO", logger="rgba_tpu_torch"):
        state = trainer.train(loader, state, max_steps=5)
    assert state.step == 5
    assert [r for r in caplog.messages if r.startswith("Step [4/5=80.00%]")]
    after = trainer.model.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in after.values())
    assert not torch.equal(after["EncoderMask.0.weight"],
                           before["EncoderMask.0.weight"])
    assert not torch.equal(after["entropy_bottleneck.quantiles"],
                           before["entropy_bottleneck.quantiles"])
    # rotating snapshots at 2 and 4 (2 removed), the final checkpoint at 5
    assert sorted(os.listdir(tmp_path)) == ["iter_4.ckpt", "iter_5.ckpt"]
    m = trainer.step(state, next(iter(loader)))
    assert state.step == 6 and np.isfinite(float(m["rd_loss"]))


def test_rgb_trainer_curriculum_and_kernel_routes(tmp_path):
    """Before curriculum_step the full image and an all-ones mask go in;
    with every kernel flag on, a step on the CPU matches the step of the
    plain policy (the routes differ only in rounding)."""
    cfg = TrainConfig(train_lambda=1024, batch_size=1, tot_step=2,
                      curriculum_step=2, aux_lr=1e-3, snapshot_freq=10 ** 9,
                      save_model_freq=10 ** 9, compute_dtype="float32")
    seen = []

    class Spy(RGBTrainer):
        def step(self, state, batch):
            seen.append(batch)
            return super().step(state, batch)

    routed = Policy(fused_win_attn=True, fused_gdn=True,
                    fused_gate_chain=True, fused_dse=True)
    losses = []
    for policy in (DEFAULT_POLICY, routed):
        model = RGBCodec(policy=policy, device="cpu", generator=_gen(5))
        trainer = Spy(cfg, str(tmp_path), model=model, device="cpu")
        state = trainer.init_state()
        trainer.train(BatchLoader(SynthDataset(n=2), batch_size=1,
                                  shuffle=False, num_workers=1), state)
        assert state.step == 2
        losses.append(float(trainer.step(state, seen[-1])["rd_loss"]))
    first, second = seen[0], seen[1]
    assert np.all(first["alpha"] == 1.0)
    assert np.array_equal(first["masked_image"], first["image"])
    assert second["alpha"].min() == 0.0                # step 2: the real mask
    close(losses[1], losses[0], 0.0, 1e-4)


def test_rgb_loss_fn_unknown_distortion_rejected():
    with pytest.raises(ValueError, match="l1"):
        _rgb_loss_fn(TrainConfig(distortion="l1"))


def test_meters_match_jax():
    from rgba_tpu.train import meters as jmeters
    vals = [3.0, 1.0, 4.0, 1.0, 5.0, 9.0]
    for length in (0, 4):
        a, b = AverageMeter(length), jmeters.AverageMeter(length)
        for v in vals:
            a.update(v)
            b.update(v)
        assert (a.val, a.avg) == (b.val, b.avg)
    a, b = WeightedMeter(), jmeters.WeightedMeter()
    for i, v in enumerate(vals):
        a.update(v, i + 1)
        b.update(v, i + 1)
    assert (a.val, a.avg, a.count) == (b.val, b.avg, b.count)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any(e.key == "aten::sum" for e in prof.key_averages())
