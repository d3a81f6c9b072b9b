"""Each cell's window loop runs a tiny size on the CPU through the
program's plain path, and ``correct`` comes out false when the timed path
alters an answer where it is produced; ``run.py`` itself refuses to run
without a card and loads nothing of JAX or the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run  # noqa: E402

TINY = {"codec-b16-v64": {"batch": 2, "height": 64, "width": 64,
                          "distinct": 2, "warmup": 1},
        "sticker-b1-v64": {"height": 64, "width": 64, "distinct": 3,
                           "warmup": 1},
        "forward-b16": {"batch": 2, "height": 64, "width": 64,
                        "distinct": 2, "warmup": 1}}
BENCH = run.benchmark(staged=True)


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_on_the_cpu(cell, trace):
    out = run.run_cell(cell, 2 ** 33 + 5, 0.5, bool(trace), device="cpu",
                       overrides=TINY[cell], bench=BENCH)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.cell_metrics(BENCH, cell, kind)}
    if not trace:
        assert set(out["metrics"]) == names
    else:
        assert set(out["metrics"]) <= names and out["metrics"]
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(run.resolve(BENCH, cell)["config"]["limits"])


def _alter_decode(monkeypatch):
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    decode = RGBAFileCodec.decode_batch

    def altered(self, *a, **k):
        out = decode(self, *a, **k).copy()
        out[:, : out.shape[1] // 2, :, :3] ^= 0x80      # half the rows
        return out
    monkeypatch.setattr(RGBAFileCodec, "decode_batch", altered)


def _alter_forward(monkeypatch):
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    forward = RGBAPipeline.forward

    def altered(self, *a, **k):
        out = dict(forward(self, *a, **k))
        out["x_hat"] = 1.0 - out["x_hat"]
        out["bpp"] = out["bpp"] * 1.5
        return out
    monkeypatch.setattr(RGBAPipeline, "forward", altered)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    (_alter_forward if cell == "forward-b16" else _alter_decode)(monkeypatch)
    out = run.run_cell(cell, 77, 0.2, False, device="cpu",
                       overrides=TINY[cell], bench=BENCH)
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_run_refuses_without_a_card():
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "codec-b16-v64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                      "PATH": "/usr/bin:/bin"}, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA device" in p.stderr


PROBE = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch; torch.set_num_threads(2)
import run
run.run_cell("codec-b16-v64", 3, 0.2, False, device="cpu",
             overrides=json.loads(sys.argv[3]))
run.run_cell("forward-b16", 3, 0.2, True, device="cpu",
             overrides=json.loads(sys.argv[4]), bench=run.benchmark(True))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REF_PROBE = """
import json, sys
sys.path[:0] = [sys.argv[1]]
import torch, work
from reference import model, outputs
m = model.RGBAModel(); m.load_state_dict(work.make_state(1, {"rgb": 3, "mask": 1}, "cpu"))
d = work.make_images(1, 1, 64, 64, "cpu")
outputs.codec(m, d["image"], d["alpha"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_names(code, *args):
    p = subprocess.run([sys.executable, "-c", code, *args],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_names(PROBE, str(HERE), str(ROOT),
                       json.dumps(TINY["codec-b16-v64"]),
                       json.dumps(TINY["forward-b16"]))
    assert "rgba_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "rgba_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_names(REF_PROBE, str(HERE))
    assert not names & {"jax", "jaxlib", "flax", "rgba_tpu", "rgba_tpu_torch"}
