"""The trained-weight tools of the port (``rgba_tpu_torch/tools``,
``rgba_tpu_torch/examples/quickstart.py``) on the CPU, at full width and
small sizes (64x64 training, a 64x128 Kodak tree):

* ``train_one``: steps, the latest checkpoint kept, a resume that skips a
  model at its budget and one that continues it;
* the crash-resume check, within 1e-6 relative on the CPU;
* ``eval_point`` on the JAX package's msgpack checkpoints of the same
  weights against the JAX package's ``evaluate_kodak(real_codec=True)``,
  within tests/test_torch_port_eval.py's tolerances (PSNR 1e-3 dB, rates
  2e-5 relative, real bytes 64 an image, codec_err 1e-5);
* ``QUALITY.json``'s point keys, the JAX sweep's (.rd_sweep/QUALITY.json);
* the decode check of the full-workflow proof and ``chip_smoke.py``
  (``eval.kodak.hold_codec_err``, which ``check_point`` calls) failing on
  an alpha patch planted between the decode and the eval step, deep and
  small (the JAX tool's average bound) or shallow and wide (the share of
  pixels off);
* the quickstart with ``--device cpu``;
* every entry point, and ``parallel.launch.Ranks``, raising without CUDA
  unless the CPU is asked for.
"""

import importlib
import json
import os
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.eval import kodak as jkodak  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.train import checkpoint as jcheckpoint  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.eval import kodak  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.parallel.launch import Ranks, run_ranks  # noqa: E402
from rgba_tpu_torch.tools import _common as c  # noqa: E402
from rgba_tpu_torch.tools.rd_sweep_proof import sweep_runs  # noqa: E402

from torch_port_util import KEY, torch_sd  # noqa: E402

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PSNR_DB, RATE_RTOL, REAL_BYTES, CODEC_ERR = 1e-3, 2e-5, 64, 1e-5
RESUME_RTOL = 1e-6
TREE_HW = (64, 128)
ENTRY_POINTS = ["examples.quickstart"] + [
    f"tools.{n}" for n in ("rd_sweep_proof", "msssim_proof",
                           "full_workflow_proof", "train_proof", "train_pair",
                           "int8_quality_probe", "deadzone_probe",
                           "rate_gate_codec_probe", "preview_probe")]


@pytest.fixture(scope="module")
def data():
    return c.synth_data(4, 64, "cpu")


def _train(kind, outdir, data, steps=3, **kw):
    return c.train_one(kind, kind, 1024, steps, str(outdir), data=data,
                       batch_size=2, dtype="float32", **kw)


def test_train_one_checkpoints_and_resumes(tmp_path, data):
    run = _train("mask", tmp_path, data, ckpt_every=2)
    ckdir = Path(run["ckdir"])
    # the step-2 checkpoint gave way to the final one
    assert sorted(p.name for p in ckdir.iterdir()) == ["iter_3.ckpt"]
    assert [p["step"] for p in run["curve"]] == [0, 1, 2]
    assert all(np.isfinite(p["rd_loss"]) for p in run["curve"])
    assert run["state"].step == 3
    trained = {k: v.clone() for k, v in run["trainer"].model.state_dict()
               .items()}

    again = _train("mask", tmp_path, data)
    assert again["trainer"] is None and again["start"] == 3
    assert again["curve"] == []

    more = _train("mask", tmp_path, data, steps=4)
    assert more["start"] == 3 and [p["step"] for p in more["curve"]] == [3]
    assert sorted(p.name for p in ckdir.iterdir()) == ["iter_4.ckpt"]
    # the resumed trainer started from the step-3 params, not a fresh init
    fresh = c.make_trainer("mask", more["trainer"].cfg, str(ckdir), "cpu")
    c.load_checkpoint(fresh.model, str(ckdir / "iter_4.ckpt"))
    moved = [k for k, v in fresh.model.state_dict().items()
             if not torch.equal(v, trained[k])]
    assert moved and all(
        float((fresh.model.state_dict()[k] - trained[k]).abs().max()) < 1e-2
        for k in moved)


@pytest.mark.parametrize("kind", ["mask", "rgb"])
def test_crash_resume_reproduces_the_loss(tmp_path, data, kind):
    run = _train(kind, tmp_path, data, steps=2)
    batch = {k: data[k][:2] for k in run["trainer"].batch_keys}
    parity = c.resume_parity(kind, run, batch)
    assert parity["step"] == 2
    assert np.isfinite(parity["pre_crash"])
    assert parity["rel"] <= RESUME_RTOL, parity


def _perturb(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10 (as in
    tests/test_torch_port_eval.py)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in pipe.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        pipe.rgb_codec.Encoder.x4.weight.mul_(10.0)
        pipe.mask_codec.EncoderMask[7].weight.mul_(10.0)


@pytest.fixture(scope="module")
def jax_checkpoint_points(tmp_path_factory):
    """(the port's eval_point, the JAX evaluate_kodak averages) on the JAX
    msgpack checkpoints of the same perturbed weights."""
    work = tmp_path_factory.mktemp("jax_ckpt")
    src = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(src, 1)
    x = np.zeros((1, 64, 64, 3), np.float32)
    m = np.zeros((1, 64, 64, 1), np.float32)
    tmpl = jax.eval_shape(lambda: JPipeline().init(
        {"params": KEY, "noise": KEY}, x, m, training=False))["params"]
    sd = torch_sd(src)
    params, ck = {}, {}
    for sub, kind in (("mask_codec", "mask"), ("rgb_codec", "rgb")):
        params[sub] = convert_state_dict(
            {k[len(sub) + 1:]: v for k, v in sd.items()
             if k.startswith(sub + ".")}, tmpl[sub], kind=kind)
        ck[sub] = jcheckpoint.save_checkpoint(params[sub],
                                              str(work / f"{kind}_ck"), 7)
    tree = c.kodak_tree(str(work), 2, TREE_HW)
    codec = c.make_codec("cpu")
    try:
        point = c.eval_point(codec, tree, ck["rgb_codec"], ck["mask_codec"])
    finally:
        codec.rgb_io.close()
        codec.mask_io.close()
    want = jkodak.evaluate_kodak(JRGBCodec(), params["rgb_codec"],
                                 JMaskCodec(), params["mask_codec"], tree,
                                 real_codec=True)
    return point, want


def test_eval_point_on_jax_checkpoints_gives_the_jax_averages(
        jax_checkpoint_points):
    got, want = jax_checkpoint_points
    assert got["step"] == 7
    assert set(got) - {"step"} == set(want)
    assert got["codec_err"] <= CODEC_ERR and want["codec_err"] <= CODEC_ERR
    for k in ("psnr", "psnr_real"):
        assert abs(got[k] - want[k]) <= PSNR_DB, k
    assert abs(got["bpp"] - want["bpp"]) <= RATE_RTOL * abs(want["bpp"])
    h, w = TREE_HW
    assert abs(got["real_bpp"] - want["real_bpp"]) <= REAL_BYTES * 8 / (h * w)
    assert 0.5 * got["bpp"] < got["real_bpp"] < 1.5 * got["bpp"] + 0.1


def test_quality_json_has_the_jax_sweeps_point_keys(tmp_path,
                                                    jax_checkpoint_points):
    point = jax_checkpoint_points[0]
    runs = sweep_runs(10, 10, 10)
    c.write_points(str(tmp_path), {"rgb_1024": point, "msssim": point}, runs)
    with open(ROOT / ".rd_sweep" / "QUALITY.json") as f:
        jax_points = json.load(f)["points"]
    with open(tmp_path / "QUALITY.json") as f:
        qual = json.load(f)
    with open(tmp_path / "rd_points.json") as f:
        assert json.dumps(json.load(f)["rgb_1024"]) == json.dumps(point)
    for name in ("rgb_1024", "msssim"):
        assert set(qual["points"][name]) == set(jax_points[name]), name
    row = qual["points"]["msssim"]
    assert (row["lambda"], row["distortion"]) == (64, "msssim")
    assert row["real_vs_est_bpp_pct"] == pytest.approx(
        (point["real_bpp"] - point["bpp"]) / point["real_bpp"] * 100,
        abs=1e-3)


@pytest.fixture(scope="module")
def live_codec(tmp_path_factory):
    """The fp32 codec over the perturbed weights, and a one-image tree."""
    src = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(src, 1)
    codec = c.make_codec("cpu")
    codec.rgb_io.set_params(src.rgb_codec.state_dict())
    codec.mask_io.set_params(src.mask_codec.state_dict())
    tree = c.kodak_tree(str(tmp_path_factory.mktemp("live")), 1, TREE_HW)
    yield codec, tree
    codec.rgb_io.close()
    codec.mask_io.close()


# (rows, columns, shift) of the eval step's alpha, against which the
# decoded alpha is held: None, the honest step; a deep 8x8 patch
# (0.78% of the pixels, mean |d| 3.9e-4: within the per-image parts) that
# only the average bound sees; a shallow 32x64 one (25% of the pixels)
PLANTS = {"none": None, "deep_patch": (8, 8, 0.05),
          "wide_patch": (32, 64, 0.003)}


@pytest.mark.parametrize("plant", PLANTS)
def test_decode_check_fails_on_a_planted_alpha_patch(
        live_codec, monkeypatch, plant):
    codec, tree = live_codec
    make = kodak.make_eval_step

    def planted_step(rgb_model, mask_model):
        step = make(rgb_model, mask_model)

        def run(x, a):
            out = dict(step(x, a))
            if PLANTS[plant]:
                h, w, shift = PLANTS[plant]
                delta = torch.zeros_like(out["recon_mask"])
                delta[:, :h, :w] = shift
                out["recon_mask"] = out["recon_mask"] + delta
            return out
        return run

    monkeypatch.setattr(kodak, "make_eval_step", planted_step)
    point = kodak.evaluate_kodak(codec.rgb_io.model, codec.mask_io.model,
                                 tree, real_codec=True, codec=codec)
    if plant == "none":
        assert point["codec_err"] <= kodak.CODEC_ERR_MAX
        assert kodak.hold_codec_err(codec, tree, point["codec_err"]) is None
        return
    h, w, shift = PLANTS[plant]
    assert point["codec_err"] == pytest.approx(shift, abs=1e-5)
    parts = kodak.codec_err_parts(codec, tree)
    assert parts[0]["rgb"]["ok"]
    assert parts[0]["alpha"]["ok"] == (plant == "deep_patch"), parts
    with pytest.raises(AssertionError,
                       match="codec_err" if plant == "deep_patch"
                       else "beyond a rounded tie"):
        kodak.hold_codec_err(codec, tree, point["codec_err"])


def test_quickstart_runs_on_the_cpu(tmp_path):
    from rgba_tpu_torch.examples import quickstart
    out = quickstart.main(["--device", "cpu", "--steps", "2", "--outdir",
                           str(tmp_path)])
    assert out["rgba"].shape == (1, 64, 64, 4)
    assert np.isfinite(out["eval"]["psnr"]) and out["eval"]["bpp"] > 0
    assert out["bitstream_bytes"] > 0
    assert (tmp_path / "out" / "1img.png").exists()


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("module", ENTRY_POINTS)
def test_entry_points_need_cuda_unless_asked_for_the_cpu(no_cuda, tmp_path,
                                                         module):
    mod = importlib.import_module(f"rgba_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--outdir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_ranks_need_cuda_unless_asked_for_the_cpu(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Ranks("torch_port_spatial_util:ops_checks", 2, space=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ranks("torch_port_spatial_util:ops_checks", 2, space=2)
