"""The TCM cell (``tcm-b16-opaque``) on the CPU: its loop runs batch 1 of
256x256 at the published widths through the program's plain path, traced
and untraced, and comes out ``correct``; an altered decode does not; the
reference loads nothing of the program; its FLOPs and kernel bounds count
what the shapes give."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run  # noqa: E402

CELL = "tcm-b16-opaque"
TINY = {"batch": 1, "height": 256, "width": 256, "distinct": 1, "warmup": 1}
BENCH = run.benchmark()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu(trace):
    out = run.run_cell(CELL, 2 ** 33 + 5, 0.2, bool(trace), device="cpu",
                       overrides=TINY, bench=BENCH)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in run.cell_metrics(BENCH, CELL, kind)}
    if trace:
        # no device activity and no CUDA graph on the CPU: the rooflines
        # and the replays read nothing
        assert set(out["metrics"]) == names - {
            "win_attn_roofline.tcm", "gdn_roofline.tcm",
            "gate_chain_roofline.tcm", "graph_replays.tcm"}
        assert out["metrics"]["round_trips.tcm"]["value"] == 7.0
    else:
        assert set(out["metrics"]) == names == {"codec_img_per_s", "setup_s"}
    assert out["checks"]["alpha_off_share"]["value"] == 0.0
    assert set(out["checks"]) == {"rgb_mean_levels", "alpha_off_share",
                                  "rate_gap"}


def test_an_altered_answer_is_not_correct(monkeypatch):
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    decode = RGBAFileCodec.decode_batch

    def altered(self, *a, **k):
        out = decode(self, *a, **k).copy()
        out[:, : out.shape[1] // 2, :, :3] ^= 0x80      # half the rows
        return out
    monkeypatch.setattr(RGBAFileCodec, "decode_batch", altered)
    out = run.run_cell(CELL, 77, 0.2, False, device="cpu", overrides=TINY,
                       bench=BENCH)
    assert not out["correct"]
    assert out["checks"]["rgb_mean_levels"]["value"] > \
        out["checks"]["rgb_mean_levels"]["limit"]


REF_PROBE = """
import json, sys
sys.path[:0] = [sys.argv[1]]
import torch
from reference import tcm
m = tcm.TCM(N=16, M=40, head_dim=(8,) * 6, hyper_head_dim=8, atten_dim=16,
            atten_head_dim=8).eval()
tcm.codec(m, torch.zeros(1, 256, 256, 3, dtype=torch.uint8))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_the_reference_loads_nothing_of_the_program():
    p = subprocess.run([sys.executable, "-c", REF_PROBE, str(HERE)],
                       capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    names = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "rgba_tpu", "rgba_tpu_torch",
                        "work", "program"}


def test_work_counts_from_the_shapes():
    import tcm_work
    widths = run.resolve(BENCH, CELL)["config"]["model"]
    one = tcm_work.codec_flops(widths, 1, 512, 768)
    # ~1.55 TFLOP a round trip of one 512x768 image (g_a 543, g_s 812 GFLOP)
    assert 1.4e12 < one < 1.7e12
    assert tcm_work.codec_flops(widths, 2, 512, 768) == pytest.approx(2 * one)
    bounds = tcm_work.kernel_bounds(widths, 16, 512, 768)
    assert set(bounds) == {"win_attn", "gdn", "gate_chain"}
    assert all(v > 0 for v in bounds.values())
    assert tcm_work.kernel_bounds(widths, 1, 512, 768)["gdn"] == \
        pytest.approx(bounds["gdn"] / 16)


def test_replayed_steps_are_read_per_call(monkeypatch):
    """With the graph replays' stand-in for CUDA graphs, a traced run reads
    8 replays a call: the encode pass, the chain's first step, 5 serial
    slice steps and the image."""
    from test_bench_graph_replays import _StandIn
    from rgba_tpu_torch.eval import step_graphs
    monkeypatch.setattr(step_graphs, "backend", lambda device: _StandIn())
    out = run.run_cell(CELL, 2 ** 33 + 29, 0.5, True, device="cpu",
                       overrides=dict(TINY, warmup=2), bench=BENCH)
    assert out["correct"] and out["failed"] == 0
    assert out["metrics"]["graph_replays.tcm"]["value"] == 8
