"""The port's CLIs on the CPU (``main(argv, device="cpu")``), after
tests/test_cli.py: the mask and RGB trainers take two steps from a config
and write ``iter_2.ckpt``; ``--test -p`` with the JAX package's msgpack
checkpoints gives the JAX evals' averages; the codec CLI round-trips a
file, previews, keeps the legacy trailer, checks its flags, and its
directory modes write ``RGBAFileCodec.encode_batch``'s bytes and
``decode_batch(output="uint8")``'s pixels.

Weights: the port's seeded weights made live (as in
tests/test_torch_port_eval.py), written as the port's checkpoints for the
codec CLI and carried into the JAX layout, saved by the JAX package's
``save_checkpoint``, for ``-p`` / ``-pm``.  Tolerances of the JAX
comparisons as there: PSNR 1e-3 dB, bpp 2e-5 relative (fp32 sums in
another order).
"""

import json
import logging
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from rgba_tpu.cli.train_mask import evaluate_mask as j_evaluate_mask  # noqa: E402
from rgba_tpu.eval.kodak import evaluate_kodak as j_evaluate_kodak  # noqa: E402
from rgba_tpu.models.mask_codec import MaskCodec as JMaskCodec  # noqa: E402
from rgba_tpu.models.pipeline import RGBAPipeline as JPipeline  # noqa: E402
from rgba_tpu.models.rgb_codec import RGBCodec as JRGBCodec  # noqa: E402
from rgba_tpu.train import checkpoint as jckpt  # noqa: E402
from rgba_tpu.train.torch_import import convert_state_dict  # noqa: E402

from rgba_tpu_torch.cli import codec, train_mask, train_rgb  # noqa: E402
from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.data import png  # noqa: E402
from rgba_tpu_torch.data.synthetic import (synthetic_rgba_batch,  # noqa: E402
                                           write_synthetic_kodak_tree)
from rgba_tpu_torch.eval.buckets import choose_buckets  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

from torch_port_util import KEY, torch_sd  # noqa: E402

torch.set_num_threads(2)

PSNR_DB = 1e-3
RATE_RTOL = 2e-5


def _perturb(pipe, seed):
    """Seeded bias noise, DSE output biases at 0.5, encoder gain 10."""
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
def weights(tmp_path_factory):
    """Paths: the port's rgb / mask checkpoints, the JAX package's
    (iter_1000 for the RGB codec: inside the curriculum phase; iter_600000
    for the mask codec), and the JAX trees."""
    root = tmp_path_factory.mktemp("weights")
    src = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _perturb(src, 2)
    x = np.zeros((1, 64, 64, 3), np.float32)
    m = np.zeros((1, 64, 64, 1), np.float32)
    tmpl = jax.eval_shape(lambda: JPipeline().init(
        {"params": KEY, "noise": KEY}, x, m, training=False))["params"]
    sd = torch_sd(src)
    out = {}
    for sub, kind in (("rgb_codec", "rgb"), ("mask_codec", "mask")):
        part = {k[len(sub) + 1:]: torch.from_numpy(v) for k, v in sd.items()
                if k.startswith(sub + ".")}
        out[kind] = save_checkpoint(part, str(root / kind), 5)
        tree = convert_state_dict({k: v.numpy() for k, v in part.items()},
                                  tmpl[sub], kind=kind)
        step = 1000 if kind == "rgb" else 600_000
        out[f"jax_{kind}"] = jckpt.save_checkpoint(tree, str(root / f"j{kind}"),
                                                   step)
        out[f"tree_{kind}"] = tree
    return out


@pytest.fixture(scope="module")
def kodak_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kodak"))
    write_synthetic_kodak_tree(root, n_images=2, height=64, width=128, seed=6)
    return root


def _write_rgba(path, h, w, seed):
    b = synthetic_rgba_batch(1, h, w, seed=seed)
    rgba = np.concatenate([b["image"][0], b["alpha"][0]], -1)
    png.write_png(str(path), (rgba * 255).astype(np.uint8))


def _train_tree(root, n=4, hw=64):
    coco = os.path.join(root, "COCOdata")
    os.makedirs(coco, exist_ok=True)
    for i in range(n):
        _write_rgba(os.path.join(coco, f"img{i:03d}.png"), hw, hw, i)
    return coco


def _config(root):
    cfg = {"tot_epoch": 10, "tot_step": 2, "train_lambda": 256,
           "batch_size": 1, "print_freq": 1, "save_model_freq": 10 ** 9,
           "lr": {"base": 1e-4, "decay": 0.1, "decay_interval": 1000}}
    path = os.path.join(root, "cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.mark.parametrize("cli", [train_mask, train_rgb])
def test_a_trainer_takes_two_steps(tmp_path, monkeypatch, cli):
    root = str(tmp_path)
    coco = _train_tree(root)
    monkeypatch.chdir(root)
    cli.main(["--config", _config(root), "-n", "smoke", "--train-coco", coco,
              "--train-p3m", "", "--kodak", os.path.join(root, "nokodak")],
             device="cpu")
    ckpts = os.listdir(os.path.join(root, "checkpoints", "smoke"))
    assert "iter_2.ckpt" in ckpts, ckpts


def test_train_mask_test_mode_reads_a_jax_checkpoint(weights, kodak_tree):
    got = train_mask.main(["--test", "-p", weights["jax_mask"], "--kodak",
                           kodak_tree], device="cpu")
    want = j_evaluate_mask(JMaskCodec(), weights["tree_mask"], kodak_tree,
                           logging.getLogger("test"))
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_DB
    assert got["bpp"] == pytest.approx(want["bpp"], rel=RATE_RTOL)
    assert np.isnan(got["msssim"]) == np.isnan(want["msssim"])


def test_train_rgb_test_mode_reads_jax_checkpoints(weights, kodak_tree,
                                                   tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = train_rgb.main(["--test", "-p", weights["jax_rgb"], "-pm",
                          weights["jax_mask"], "--kodak", kodak_tree],
                         device="cpu")
    # iter_1000 lies inside the curriculum phase: eval unmasked
    want = j_evaluate_kodak(JRGBCodec(), weights["tree_rgb"], JMaskCodec(),
                            weights["tree_mask"], kodak_tree, curriculum=True)
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_DB
    assert got["bpp"] == pytest.approx(want["bpp"], rel=RATE_RTOL)
    assert png.read_png(str(tmp_path / "outputKodak" / "1img.png"))[1] == "RGB"


def _codec_args(weights):
    return ["-r", weights["rgb"], "-m", weights["mask"]]


def test_codec_round_trip(tmp_path, weights, capsys):
    src = tmp_path / "in.png"
    _write_rgba(src, 96, 72, 5)          # not /64: padded, then cropped
    blob, recon = tmp_path / "out.rgbc", tmp_path / "recon.png"
    codec.main(["encode", str(src), str(blob)] + _codec_args(weights),
               device="cpu")
    assert "bpp" in capsys.readouterr().out and blob.stat().st_size > 16
    codec.main(["decode", str(blob), str(recon)] + _codec_args(weights),
               device="cpu")
    px, mode = png.read_png(str(recon))
    assert mode == "RGBA" and px.shape == (96, 72, 4)
    # the same as the codec's own uint8 decode
    c = codec._load_codecs(weights["rgb"], weights["mask"], "cpu")
    want = c.decode(blob.read_bytes(), output="uint8")[0]
    np.testing.assert_array_equal(px, want)
    # and a preview from the same blob: the alpha is decoded in full
    prev = tmp_path / "prev.png"
    codec.main(["decode", str(blob), str(prev), "--preview-slices", "3"]
               + _codec_args(weights), device="cpu")
    p = png.load(str(prev), "RGBA")
    assert p.shape == px.shape
    np.testing.assert_array_equal(p[..., 3], px[..., 3])
    assert not np.array_equal(p[..., :3], px[..., :3])


def test_codec_flag_validation(capsys):
    for argv, flag in ((["encode", "a", "b", "--preview-slices", "3"],
                        "--preview-slices"),
                       (["encode-dir", "a", "b", "--preview-slices", "3"],
                        "--preview-slices"),
                       (["decode", "a", "b", "--preview-slices", "-1"],
                        "--preview-slices"),
                       (["decode", "a", "b", "--preview-slices", "11"],
                        "--preview-slices"),
                       (["decode", "a", "b", "--interleave", "2"],
                        "--interleave"),
                       (["decode-dir", "a", "b", "--interleave", "0"],
                        "--interleave")):
        with pytest.raises(SystemExit):
            codec.main(argv, device="cpu")
        assert flag in capsys.readouterr().err


def test_codec_legacy_trailer(tmp_path, weights):
    src = tmp_path / "in.png"
    _write_rgba(src, 96, 72, 9)
    blob_path = tmp_path / "out.rgbc"
    codec.main(["encode", str(src), str(blob_path)] + _codec_args(weights),
               device="cpu")
    blob = blob_path.read_bytes()
    legacy = tmp_path / "legacy.rgbc"
    legacy.write_bytes(blob + (80).to_bytes(4, "little")
                       + (64).to_bytes(4, "little"))
    out = tmp_path / "legacy.png"
    codec.main(["decode", str(legacy), str(out)] + _codec_args(weights),
               device="cpu")
    assert png.png_size(str(out)) == (80, 64)
    bad = tmp_path / "bad.rgbc"
    bad.write_bytes(blob + b"xyz")
    with pytest.raises(SystemExit, match="trailing"):
        codec.main(["decode", str(bad), str(tmp_path / "bad.png")]
                   + _codec_args(weights), device="cpu")
    # a directory decode refuses the legacy form
    d = tmp_path / "legacy_dir"
    d.mkdir()
    (d / "x.rgbc").write_bytes(legacy.read_bytes())
    with pytest.raises(SystemExit, match="legacy"):
        codec.main(["decode-dir", str(d), str(tmp_path / "o")]
                   + _codec_args(weights), device="cpu")


@pytest.mark.parametrize("fmt", ["v64", "lanes32"])
def test_codec_dir_modes(tmp_path, weights, fmt):
    """Sizes grouped, batched with a repeated tail, pipelined: every blob is
    encode_batch's and every PNG decode_batch's uint8."""
    src, enc, rec = tmp_path / "src", tmp_path / "enc", tmp_path / "rec"
    src.mkdir()
    sizes = [(64, 64), (64, 64), (64, 64), (96, 72)]
    for i, (h, w) in enumerate(sizes):
        _write_rgba(src / f"im{i}.png", h, w, 20 + i)
    codec.main(["encode-dir", str(src), str(enc), "-b", "2",
                "--stream-format", fmt] + _codec_args(weights), device="cpu")
    assert sorted(os.listdir(enc)) == [f"im{i}.rgbc" for i in range(4)]
    codec.main(["decode-dir", str(enc), str(rec), "-b", "2"]
               + _codec_args(weights), device="cpu")

    c = codec._load_codecs(weights["rgb"], weights["mask"], "cpu")
    buckets = choose_buckets(set(sizes))
    groups = ([0, 1], [2, 2], [3, 3])       # -b 2, a tail repeats its last
    for idx in groups:
        arrs = [png.load(str(src / f"im{i}.png"), "RGBA") for i in idx]
        x = np.stack(arrs).astype(np.float32) / 255.0
        blobs = c.encode_batch(x[..., :3], x[..., 3:], stream_format=fmt,
                               bucket=buckets[sizes[idx[0]]])
        dec = c.decode_batch(blobs, output="uint8")
        for k, i in enumerate(dict.fromkeys(idx)):
            assert (enc / f"im{i}.rgbc").read_bytes() == blobs[k], i
            np.testing.assert_array_equal(
                png.load(str(rec / f"im{i}.png"), "RGBA"), dec[k], str(i))
    assert png.png_size(str(rec / "im3.png")) == (96, 72)
    # sub-batch interleaving decodes the same
    if fmt == "v64":
        rec2 = tmp_path / "rec2"
        codec.main(["decode-dir", str(enc), str(rec2), "-b", "2",
                    "--interleave", "2"] + _codec_args(weights), device="cpu")
        for i in range(4):
            np.testing.assert_array_equal(
                png.load(str(rec2 / f"im{i}.png"), "RGBA"),
                png.load(str(rec / f"im{i}.png"), "RGBA"), str(i))


@pytest.mark.parametrize("kind", ["mask", "rgb"])
def test_trainers_dump_reconstructions(tmp_path, kind):
    """``image_dump_dir``: at each snapshot the first image's eval-forward
    reconstruction goes to ``<step><name>.png`` through the port's PNG
    writer (the RGB trainer also writes the batch's alpha)."""
    from rgba_tpu_torch.core.config import TrainConfig
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid
    from rgba_tpu_torch.train.loops import MaskTrainer, RGBTrainer
    cfg = TrainConfig(tot_step=2, batch_size=1, print_freq=1, cal_step=1,
                      snapshot_freq=2, save_model_freq=10 ** 9,
                      train_lambda=256, compute_dtype="float32",
                      curriculum_step=0)
    dump = tmp_path / "dump"
    cls = MaskTrainer if kind == "mask" else RGBTrainer
    trainer = cls(cfg, str(tmp_path / "ck"), device="cpu",
                  image_dump_dir=str(dump))
    batches = [synthetic_rgba_batch(1, 64, 64, seed=i) for i in range(2)]
    trainer.train(batches, trainer.init_state())
    names = ["2mask.png"] if kind == "mask" else ["2image.png", "2mask.png"]
    assert sorted(os.listdir(dump)) == names
    last = batches[1]
    a = torch.from_numpy(last["alpha"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        if kind == "mask":
            x_hat = trainer.model(a, training=False)["x_hat"]
        else:
            x = torch.from_numpy(last["masked_image"]).permute(0, 3, 1, 2)
            x_hat = trainer.model(x, a, a, mask_pyramid(a),
                                  training=False)["x_hat"]
    recon = np.clip(x_hat[0].permute(1, 2, 0).numpy(), 0, 1)
    alpha8 = (last["alpha"][0] * 255).astype(np.uint8)
    if kind == "mask":
        want = {"2mask.png": (recon[..., 0] * 255).astype(np.uint8)}
    else:
        want = {"2image.png": np.concatenate(
                    [(recon * 255).astype(np.uint8), alpha8], -1),
                "2mask.png": alpha8[..., 0]}
    for name, px in want.items():
        got, mode = png.read_png(str(dump / name))
        assert mode == ("RGBA" if px.ndim == 3 else "L")
        np.testing.assert_array_equal(got, px, err_msg=name)
