"""Weights, isolation and entry-point rules of the PyTorch port.

* The port's state-dict keys are exactly the torch keys the JAX package's
  importer maps (rgba_tpu/train/torch_import.py).
* A port state dict goes through the JAX importer and back through
  ``state_dict_from_jax`` bit for bit, and loads with ``strict=True``.
* ``rgba_tpu_torch`` and ``chip_smoke.py`` import no jax, flax or rgba_tpu.
* Entry points run on CUDA unless the caller passes ``device="cpu"``.
* The numpy-only synthetic data equals the JAX package's (Pillow) data.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rgba_tpu.data.synthetic import synthetic_rgba_batch as j_synthetic  # noqa: E402
from rgba_tpu.entropy.bottleneck import EntropyBottleneck as JEB  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.ops.gdn import GDN as JGDN  # noqa: E402
from rgba_tpu.ops.mask_pyramid import mask_pyramid as j_pyramid  # noqa: E402
from rgba_tpu.train.torch_import import (convert_state_dict,  # noqa: E402
                                         flax_path_to_torch_mask,
                                         flax_path_to_torch_rgb)

from rgba_tpu_torch import weights  # noqa: E402
from rgba_tpu_torch.core import precision  # noqa: E402
from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch  # noqa: E402
from rgba_tpu_torch.entropy.bottleneck import EntropyBottleneck  # noqa: E402
from rgba_tpu_torch.models.mask_codec import MaskCodec  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.models.rgb_codec import RGBCodec  # noqa: E402
from rgba_tpu_torch.ops.conv import Conv, ConvTranspose  # noqa: E402
from rgba_tpu_torch.ops.gdn import GDN  # noqa: E402
from rgba_tpu_torch.ops.kernels import build, gdn as kgdn, win_attn as kwa  # noqa: E402

from torch_port_util import KEY, flat_paths, torch_sd  # noqa: E402

torch.set_num_threads(2)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


ROOT = Path(__file__).resolve().parents[1]
POLICY = precision.DEFAULT_POLICY


def _codec(kind, seed=0):
    cls = RGBCodec if kind == "rgb" else MaskCodec
    return cls(policy=POLICY, device="cpu", generator=_gen(seed))


def _jax_template(kind):
    """Shapes of the JAX codec's param tree (traced, not computed)."""
    if kind == "mask":
        m = jnp.zeros((1, 64, 64, 1))
        return jax.eval_shape(lambda: JMaskCodec().init(
            {"params": KEY, "noise": KEY}, m, training=False))["params"]
    x, m = jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 1))
    return jax.eval_shape(lambda: JRGBCodec().init(
        {"params": KEY, "noise": KEY}, x, m, m, j_pyramid(m),
        training=False))["params"]


@pytest.fixture(scope="module")
def codecs():
    return {kind: (_codec(kind), _jax_template(kind)) for kind in ("rgb", "mask")}


MAPPERS = {"rgb": flax_path_to_torch_rgb, "mask": flax_path_to_torch_mask}


@pytest.mark.parametrize("kind", ["rgb", "mask"])
def test_state_dict_keys_are_the_reference_keys(codecs, kind):
    module, tmpl = codecs[kind]
    want = {MAPPERS[kind](p)[0] for p, _ in flat_paths(tmpl)}
    assert set(module.state_dict()) == want
    # buffers are rebuilt, never loaded
    assert not any("relative_position_index" in k for k in module.state_dict())


@pytest.mark.parametrize("kind", ["rgb", "mask"])
def test_round_trip_through_the_jax_importer_is_bit_exact(codecs, kind):
    module, tmpl = codecs[kind]
    sd = torch_sd(module)
    tree = convert_state_dict(sd, tmpl, kind=kind)      # the JAX importer
    back = weights.state_dict_from_jax(tree, kind)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    fresh = _codec(kind, seed=1)
    weights.load_jax_params(fresh, tree, kind)
    for k, v in torch_sd(fresh).items():
        np.testing.assert_array_equal(v, sd[k], err_msg=k)


def test_load_is_strict(codecs):
    module, tmpl = codecs["mask"]
    tree = convert_state_dict(torch_sd(module), tmpl, kind="mask")
    del tree["encoder"]["conv0"]["bias"]
    with pytest.raises(RuntimeError, match="Missing key"):
        weights.load_jax_params(_codec("mask"), tree, "mask")
    tree["encoder"]["conv0"]["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        weights.state_dict_from_jax(tree, "mask")


def test_pipeline_kind_loads_both_codecs(codecs):
    trees = {sub: convert_state_dict(torch_sd(codecs[kind][0]),
                                     codecs[kind][1], kind=kind)
             for sub, kind in (("rgb_codec", "rgb"), ("mask_codec", "mask"))}
    pipe = RGBAPipeline(POLICY, device="cpu", seed=3)
    weights.load_jax_params(pipe, trees, "pipeline")
    for k, v in torch_sd(pipe.rgb_codec).items():
        np.testing.assert_array_equal(v, torch_sd(codecs["rgb"][0])[k])


# -------------------------------------------------------------- init


def test_init_distributions_match_the_jax_initializers():
    x = np.zeros((1, 8, 8, 16), np.float32)
    jg = JGDN().init(KEY, x)["params"]
    tg = GDN(16, policy=POLICY, device="cpu")
    np.testing.assert_allclose(tg.beta.detach().numpy(), np.asarray(jg["beta"]),
                               rtol=1e-7)
    np.testing.assert_allclose(tg.gamma.detach().numpy(),
                               np.asarray(jg["gamma"]), rtol=1e-6)
    z = np.zeros((1, 2, 2, 8), np.float32)
    jb = JEB(8).init(KEY, z)["params"]
    tb = EntropyBottleneck(8, device="cpu", generator=_gen(0))
    for i in range(5):
        np.testing.assert_allclose(getattr(tb, f"_matrix{i}").detach().numpy(),
                                   np.asarray(jb[f"matrix{i}"]), rtol=1e-6)
        b = getattr(tb, f"_bias{i}").detach().numpy()
        assert b.shape == jb[f"bias{i}"].shape and np.abs(b).max() <= 0.5
    np.testing.assert_array_equal(tb.quantiles.detach().numpy(),
                                  np.asarray(jb["quantiles"]))
    conv = Conv(32, 64, 5, 2, policy=POLICY, device="cpu",
                generator=_gen(0))
    bound = math.sqrt(1 / (5 * 5 * 32))
    w = conv.weight.detach().numpy()
    assert np.abs(w).max() <= bound and np.abs(w).max() > 0.95 * bound
    assert not conv.bias.detach().numpy().any()
    deconv = ConvTranspose(32, 3, 5, 2, policy=POLICY, device="cpu",
                           generator=_gen(0))
    assert np.abs(deconv.weight.detach().numpy()).max() <= bound


def test_seeded_init_is_reproducible():
    a = torch_sd(_codec("mask", seed=7))
    b = torch_sd(_codec("mask", seed=7))
    c = torch_sd(_codec("mask", seed=8))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not all(np.array_equal(a[k], c[k]) for k in a)


# --------------------------------------------------- isolation, devices


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_flax_or_rgba_tpu():
    files = sorted((ROOT / "rgba_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "rgba_tpu"), \
                f"{f.relative_to(ROOT)} imports {name}"


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        precision.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        precision.resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RGBAPipeline()
    assert precision.resolve_device("cpu").type == "cpu"


def test_kernel_build_lives_in_the_checkout():
    for k in (kgdn.KERNEL, kwa.KERNEL):
        lib = k.library
        assert lib.parent == build.BUILD_DIR
        assert (build.CSRC / k.source).is_file()
    assert build.BUILD_DIR.is_relative_to(ROOT / "build")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


@pytest.mark.parametrize("shape", [(2, 64, 64, 0), (1, 64, 128, 3),
                                   (1, 96, 160, 7)])
def test_synthetic_batch_equals_the_jax_package(shape):
    b, h, w, seed = shape
    want = j_synthetic(b, h, w, seed=seed)
    got = synthetic_rgba_batch(b, h, w, seed=seed)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
