"""The benchmark's own arithmetic and generators: the FLOP count against
``torch.utils.flop_counter`` on the reference, the live-window
correction, determinism by seed, and the reference against the
program's plain float32 path on the CPU."""

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import work  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import outputs as refout  # noqa: E402

GAINS = {"rgb": 3.0, "mask": 1.0}


@pytest.fixture(scope="module")
def model():
    m = ref.RGBAModel().eval()
    m.load_state_dict(work.make_state(5, GAINS, "cpu"))
    return m


def test_flops_match_the_flop_counter_with_every_window_alive(model):
    b, h, w = 1, 64, 128
    x = torch.rand(b, h, w, 3)
    a = torch.ones(b, h, w, 1)
    with FlopCounterMode(display=False) as counter:
        refout.forward(model, x, a)
    ones = torch.ones(b, 1, h, w)
    assert work.forward_flops(ones, ones) == counter.get_total_flops()


def test_dead_windows_leave_their_attention_out():
    b, h, w = 1, 64, 128
    ones = torch.ones(b, 1, h, w)
    half = ones.clone()
    half[..., :, w // 2:] = 0.0
    saved = work.attention_saved(half, half)
    assert saved > 0
    assert work.forward_flops(half, half) == work.forward_flops(ones, ones) - saved
    dead = work.dead_windows(half, 1, 8, 4)       # H/4 = 16 rows, 32 cols
    assert 0 < dead < (16 // 8) * (32 // 8)


def test_weights_and_images_are_deterministic_by_seed():
    a, b = work.make_state(2 ** 40 + 7, GAINS, "cpu"), \
        work.make_state(2 ** 40 + 7, GAINS, "cpu")
    c = work.make_state(2 ** 40 + 8, GAINS, "cpu")
    k = "rgb_codec.Encoder.x1.weight"
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a[k], c[k])
    i1, i2 = work.make_images(9, 2, 64, 64, "cpu"), work.make_images(9, 2, 64, 64, "cpu")
    assert all(torch.equal(i1[n], i2[n]) for n in i1)
    assert not torch.equal(i1["image"], work.make_images(10, 2, 64, 64, "cpu")["image"])


def test_reference_is_deterministic(model):
    d = work.make_images(3, 1, 64, 64, "cpu")
    r1 = refout.codec(model, d["image"], d["alpha"])
    r2 = refout.codec(model, d["image"], d["alpha"])
    assert torch.equal(r1["rgba"], r2["rgba"]) and torch.equal(r1["bits"], r2["bits"])


def test_reference_matches_the_programs_plain_path(model):
    from rgba_tpu_torch.core.precision import DEFAULT_POLICY
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    pipe = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    pipe.load_state_dict(model.state_dict())
    d = work.make_images(4, 2, 64, 128, "cpu")
    a = d["alpha"].float() / 255.0
    got, want = pipe(d["masked_image"], a), refout.forward(model, d["masked_image"], a)
    assert float((got["x_hat"] - want["x_hat"]).abs().max()) < 1e-4
    for k in ("bpp", "bpp_rgb", "bpp_mask"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * float(want[k])
