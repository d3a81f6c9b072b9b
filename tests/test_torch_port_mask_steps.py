"""Twenty fp32 training steps of the mask codec through the PyTorch port
against the JAX package, on the CPU, on the same weights, data and noise.

On the card, 20 bf16 ``MaskTrainer`` steps with the kernels on and with
them off agree on steps 1-3 and then split (chip_smoke.py prints the
gap).  This test asks whether the port itself splits from the reference:
both packages start from the JAX initializers' weights made live as in
tests/test_torch_port_train.py, take the same batch every step with fresh
numpy noise (JAX reads it from the batch inside its jitted step; the port
from a callable), and step with their own Adam (lr 1e-4, aux lr 1e-3,
grad clamp 5, as the trainers).

The mask codec's loss is chaotic from the fourth step on (it jumps tenfold
at step 7 here), so a difference of one ulp grows to percents within 20
steps.  The yardstick is therefore the reference against itself: JAX run
again from weights moved by about one ulp (2^-23 relative, random sign).
Held: the first three losses agree to FIRST_RTOL (a wrong gradient or
optimizer shows there), and at every step the port's gap to JAX stays
within SPREAD times the largest gap the nudged JAX run has shown so far
(+ FIRST_RTOL).  Measured when written: steps 1-3 within 4.2e-7; the
port's gap peaks at 4.5e-2 and the nudged run's at 1.1e-2.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.core.config import TrainConfig as JTrainConfig  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.train import loops as jloops  # noqa: E402
from rgba_tpu.train import state as jstate  # noqa: E402

from rgba_tpu_torch import weights  # noqa: E402
from rgba_tpu_torch.core.config import TrainConfig  # noqa: E402
from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.train import loops as tloops  # noqa: E402
from rgba_tpu_torch.train import state as tstate  # noqa: E402

from test_torch_port_train import _liven  # noqa: E402
from torch_port_util import KEY, nchw  # noqa: E402

torch.set_num_threads(2)

STEPS = 20
FIRST_RTOL = 1e-5   # steps 1-3: fp32 sums in another order
SPREAD = 10.0       # x the reference's own spread from a one-ulp nudge
CFG = dict(train_lambda=1024.0, aux_lr=1e-3)


class _Noise:
    """The patched ``jax.random.uniform`` hands out the arrays of the
    current batch's noise in draw order (tracers inside the jitted step);
    parameter initializers pass through."""

    def __init__(self):
        self.queue = []
        self.shapes = []
        self.real = jax.random.uniform

    def uniform(self, key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if len(shape) != 4:
            return self.real(key, shape, dtype, minval, maxval)
        assert (minval, maxval) == (-0.5, 0.5)
        if not self.queue:          # the shape-recording pass
            self.shapes.append(tuple(shape))
            return jnp.zeros(shape, dtype)
        a = self.queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return a


def test_mask_training_tracks_jax_for_20_steps(monkeypatch):
    noise = _Noise()
    monkeypatch.setattr(jax.random, "uniform", noise.uniform)
    alpha = synthetic_rgba_batch(2, 64, 64, seed=3)["alpha"]
    jm = JMaskCodec()
    params = _liven(jax.jit(lambda: jm.init(
        {"params": KEY, "noise": KEY}, alpha, training=False))()["params"], 1)
    tm = MaskCodec(policy=DEFAULT_POLICY, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    weights.load_jax_params(tm, params, "mask")

    jm.apply({"params": params}, alpha, training=True, rngs={"noise": KEY})
    shapes = list(noise.shapes)
    assert len(shapes) == 6

    jcfg = JTrainConfig(**CFG)
    j_loss = jloops._mask_loss_fn(jm, jcfg)

    def loss_fn(p, batch, rng):
        noise.queue = list(batch["noise"])
        return j_loss(p, batch, rng)
    main_tx, aux_tx = jstate.make_optimizers(jcfg)
    jstep = jax.jit(jstate.make_train_step(
        jcfg, loss_fn, lambda p: jm.apply({"params": p},
                                          method=lambda m: m.aux_loss())),
        static_argnums=(3, 4))
    js = jstate.make_train_state(jcfg, params)
    # the control: JAX again from weights moved by about one ulp
    prng = np.random.RandomState(31)
    nudged = jax.tree_util.tree_map(
        lambda a: (a * (1.0 + 2.0 ** -23 * prng.choice([-1.0, 1.0], a.shape))
                   ).astype(np.float32), params)
    jc = jstate.make_train_state(jcfg, nudged)

    cfg = TrainConfig(**CFG)
    tstep = tstate.make_train_step(cfg, tloops._mask_loss_fn(cfg),
                                   lambda m: m.aux_loss())
    ts = tstate.make_train_state(cfg, tm)
    t_batch = {"alpha": nchw(alpha)}

    rng = np.random.RandomState(30)
    j_losses, t_losses, c_losses = [], [], []
    for _ in range(STEPS):
        draws = [(rng.rand(*s) - 0.5).astype(np.float32) for s in shapes]
        js, jmet = jstep(js, {"alpha": jnp.asarray(alpha),
                              "noise": [jnp.asarray(d) for d in draws]},
                         KEY, main_tx, aux_tx)
        jc, cmet = jstep(jc, {"alpha": jnp.asarray(alpha),
                              "noise": [jnp.asarray(d) for d in draws]},
                         KEY, main_tx, aux_tx)
        c_losses.append(float(cmet["rd_loss"]))
        feed = iter(draws)
        tmet = tstep(ts, t_batch,
                     lambda shape: torch.from_numpy(next(feed)).permute(0, 3, 1, 2))
        j_losses.append(float(jmet["rd_loss"]))
        t_losses.append(float(tmet["rd_loss"]))
    gaps = [abs(t - j) / abs(j) for t, j in zip(t_losses, j_losses)]
    print("jax ", [round(v, 4) for v in j_losses])
    print("port", [round(v, 4) for v in t_losses])
    control = [abs(c - j) / abs(j) for c, j in zip(c_losses, j_losses)]
    print("gaps", [f"{g:.2e}" for g in gaps])
    print("ctrl", [f"{g:.2e}" for g in control])
    assert j_losses[-1] < j_losses[0] and t_losses[-1] < t_losses[0]
    assert max(gaps[:3]) <= FIRST_RTOL, gaps[:3]
    for i, gap in enumerate(gaps):
        assert gap <= SPREAD * max(control[:i + 1]) + FIRST_RTOL, (i, gaps, control)
