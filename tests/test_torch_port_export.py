"""Serving artifacts of the port (``rgba_tpu_torch/eval/export.py``,
``torch.export``) on the CPU, after tests/test_export.py: a ``MaskCodec``
artifact round-trips through save and load and equals the eager forward:
the rates exactly, x_hat and y_hat within 1e-5 (the exported graph is the
eager one functionalized, and a few of its values land an ulp apart:
measured 2.8e-7 and 9.5e-7); it equals itself loaded in a fresh process
exactly, and the JAX package's ``model.apply`` within the forward
tolerance (x_hat 2e-4, bpp 2e-5 relative: fp32 sums in another order); the parameters can be a runtime
argument; another input shape is refused; ``allow_custom_ops=False``
refuses a kernel-routed model.  On the CPU the kernel wrappers take their
plain versions, so the operators themselves are exported on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import BF16_POLICY, DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.eval import export  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402

from torch_port_util import KEY, close, torch_sd  # noqa: E402

torch.set_num_threads(2)

XHAT_TOL = 2e-4
EAGER_TOL = 1e-5
RATE_RTOL = 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mask_batch(b=1, hw=64):
    rng = np.random.default_rng(0)
    a = (rng.random((b, hw, hw, 1)) > 0.5).astype(np.float32)
    return torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()


@pytest.fixture(scope="module")
def model():
    m = MaskCodec(policy=DEFAULT_POLICY, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in m.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
        m.EncoderMask[7].weight.mul_(10.0)
    return m.eval()


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("art") / "mask.pt2")
    art = export.export_serving_forward(model, (_mask_batch(),))
    assert export.save_artifact(art, path) > 0
    return path


def test_mask_codec_artifact_round_trip(model, artifact):
    x = _mask_batch()
    art = export.load_artifact(artifact)
    assert art.compute_dtype == "float32" and art.kernel_ops() == []
    got = art(x)
    with torch.no_grad():
        want = model(x, training=False)
    for k in ("bpp", "bpp_y", "bpp_z", "mse_loss"):
        assert torch.equal(got[k], want[k]), k
    for k in ("x_hat", "y_hat"):
        close(got[k].numpy(), want[k].numpy(), EAGER_TOL, what=k)
    # and the JAX package's forward on the same weights
    tmpl = jax.eval_shape(lambda: JPipeline().init(
        {"params": KEY, "noise": KEY}, np.zeros((1, 64, 64, 3), np.float32),
        np.zeros((1, 64, 64, 1), np.float32), training=False))["params"]
    params = convert_state_dict(torch_sd(model), tmpl["mask_codec"],
                                kind="mask")
    j = JMaskCodec().apply({"params": params},
                           x.permute(0, 2, 3, 1).numpy(), training=False)
    close(got["x_hat"].permute(0, 2, 3, 1).numpy(), np.asarray(j["x_hat"]),
          XHAT_TOL)
    close(float(got["bpp"]), float(j["bpp"]), 0.0, RATE_RTOL, "bpp")
    assert float(got["bpp"]) > 0.1


def test_artifact_loads_in_a_fresh_process(model, artifact):
    """A process that imports only rgba_tpu_torch.ops.kernels runs it."""
    x = _mask_batch()
    script = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"            # the sums' split, as here
        "import rgba_tpu_torch.ops.kernels\n"
        "ep = torch.export.load(sys.argv[1])\n"
        "x = torch.load(sys.argv[2])\n"
        "with torch.inference_mode():\n"
        "    out = ep.module()(x)\n"
        "torch.save(out['x_hat'], sys.argv[3])\n"
        "mods = [m for m in sys.modules if m.startswith('rgba_tpu')]\n"
        "print(sorted(m for m in mods if not m.startswith("
        "'rgba_tpu_torch.ops.kernels') and m not in ('rgba_tpu_torch', "
        "'rgba_tpu_torch.ops')))\n")
    d = os.path.dirname(artifact)
    xin, xout = os.path.join(d, "x.pt"), os.path.join(d, "xhat.pt")
    torch.save(x, xin)
    proc = subprocess.run([sys.executable, "-c", script, artifact, xin, xout],
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
    want = export.load_artifact(artifact)(x)["x_hat"]
    assert torch.equal(torch.load(xout), want)


def test_params_as_a_runtime_argument(model, tmp_path):
    x = _mask_batch()
    art = export.export_serving_forward(model, (x,), bundle_params=False)
    path = str(tmp_path / "mask_p.pt2")
    nbytes = export.save_artifact(art, path)
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert nbytes < param_bytes / 10
    art = export.load_artifact(path)
    params = dict(model.named_parameters())
    with torch.no_grad():
        want = model(x, training=False)
    close(art(params, x)["x_hat"].numpy(), want["x_hat"].numpy(), EAGER_TOL)
    # other weights through the same program
    other = {k: v.detach() * 1.01 for k, v in params.items()}
    with torch.no_grad():
        want2 = torch.func.functional_call(model, other, (x,),
                                           {"training": False})
    got2 = art(other, x)
    close(got2["x_hat"].numpy(), want2["x_hat"].numpy(), EAGER_TOL)
    assert torch.equal(got2["bpp"], want2["bpp"])
    assert not torch.equal(got2["x_hat"], want["x_hat"])


def test_another_shape_is_refused(artifact):
    art = export.load_artifact(artifact)
    with pytest.raises(RuntimeError, match="equal to 64, but got 128"):
        art(torch.zeros(1, 1, 128, 128))


def test_allow_custom_ops_false_refuses_a_kernel_route(model):
    x = _mask_batch()
    routed = MaskCodec(policy=dataclasses.replace(DEFAULT_POLICY,
                                                  fused_gdn=True,
                                                  fused_dse=True),
                       device="cpu", generator=torch.Generator().manual_seed(4))
    with pytest.raises(ValueError, match="fused_dse', 'fused_gdn"):
        export.export_serving_forward(routed, (x,), allow_custom_ops=False)
    # the plain model exports with the flag off
    art = export.export_serving_forward(model, (x,), allow_custom_ops=False)
    assert art.kernel_ops() == []
    # a program that calls a kernel operator: export traces it through the
    # operator's fake (no launch), and the flag off refuses it by name
    x = torch.randn(2, 4, 4, 16)
    g, b = torch.rand(2 * 192 * 16), torch.rand(16)

    def fn(x, g, b):
        with torch.no_grad():        # a subgraph of its own in the program
            return torch.ops.rgba_tpu_torch.gdn(x, g, b, False) * 2.0
    art = export.export_function(fn, (x, g, b))
    assert art.kernel_ops() == ["rgba_tpu_torch.gdn.default"]
    with pytest.raises(ValueError, match="rgba_tpu_torch.gdn"):
        export.export_function(fn, (x, g, b), allow_custom_ops=False)


def test_a_traced_forward_caches_no_kernel_layout():
    """Under torch.export a module lays its kernel weights out from the
    parameters in the graph and keeps nothing (a layout cached from a trace
    would hold fake tensors, and one cached from eager weights would go
    stale in the artifact); an eager call fills the cache as before."""
    from rgba_tpu_torch.ops.gdn import GDN
    routed = MaskCodec(policy=dataclasses.replace(DEFAULT_POLICY,
                                                  fused_gdn=True),
                       device="cpu", generator=torch.Generator().manual_seed(4))
    gdns = [m for m in routed.modules() if isinstance(m, GDN)]
    assert len(gdns) == 6
    export.export_serving_forward(routed, (_mask_batch(),))
    assert all(m._kernel_cache == (None, None) for m in gdns)
    with torch.no_grad():
        routed(_mask_batch(), training=False)
    assert all(m._kernel_cache[0] is not None for m in gdns)


def test_a_bf16_model_records_its_dtype(tmp_path):
    m = MaskCodec(policy=BF16_POLICY, device="cpu",
                  generator=torch.Generator().manual_seed(4))
    x = _mask_batch()
    art = export.export_serving_forward(m, (x,))
    path = str(tmp_path / "bf16.pt2")
    export.save_artifact(art, path)
    loaded = export.load_artifact(path)
    assert loaded.compute_dtype == "bfloat16"
    with torch.no_grad():
        want = m(x, training=False)
    assert torch.equal(loaded(x)["bpp"], want["bpp"])
