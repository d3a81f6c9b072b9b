"""The reader of the program's replay spans (``metrics/graph_replays.py``)
on tiny runs of each cell on the CPU.  The program captures nothing on
the CPU, so a traced run there leaves the metric out; with a stand-in
for CUDA graphs in the program's place (a capture that hands back
outputs filled with a sentinel, a replay that runs the step again) a
traced run reads 24 replays a call, the steps of one encode + decode of
a batch with an alpha to code, and stays correct.  A reader with nothing
to read returns None."""

import contextlib
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run  # noqa: E402
from test_bench_runs import TINY  # noqa: E402

from rgba_tpu_torch.eval import step_graphs  # noqa: E402

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


class _Graph:
    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        for o, new in zip(self.outputs, self.fn(*self.inputs)):
            o.copy_(new)


class _StandIn:
    def capture(self, fn, inputs):
        outputs = tuple(torch.full_like(o, 7) for o in fn(*inputs))
        return _Graph(fn, inputs, outputs), outputs

    def ordered(self):
        return contextlib.nullcontext()

    def reset(self):
        pass


def steps_per_call(model: dict) -> int:
    """Device steps of one encode + decode of a batch with an alpha to
    code: the mask pass, the alpha chain, the alpha image and the RGB
    pass; the RGB chain, the mask chain and both images.  A chain is its
    first step, a step per serial slice and one for the parallel tail."""
    def chain(c):
        tail = c["num_slices"] - c["max_support_slices"]
        return 1 + c["num_slices"] - max(0, tail) + int(tail > 0)
    rgb, mask = model["rgb"], model["mask"]
    return (1 + chain(mask) + 1 + 1) + (chain(rgb) + chain(mask) + 2)


def _metric(out, suffix_of):
    return {k: v["value"] for k, v in out["metrics"].items()}.get(
        f"graph_replays.{suffix_of}")


def _suffix(out):
    return next(k for k in out["metrics"]
                if k.startswith("encode_ms.")).split(".")[1]


@pytest.mark.parametrize("cell", CELLS)
def test_a_cpu_run_replays_nothing(cell):
    out = run.run_cell(cell, 2 ** 33 + 23, 0.3, True, device="cpu",
                       overrides=TINY[cell], bench=BENCH)
    assert out["correct"]
    assert _metric(out, _suffix(out)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_replayed_steps_are_read_per_call(cell, monkeypatch):
    monkeypatch.setattr(step_graphs, "backend", lambda device: _StandIn())
    out = run.run_cell(cell, 2 ** 33 + 29, 0.5, True, device="cpu",
                       overrides=dict(TINY[cell], warmup=2), bench=BENCH)
    assert out["correct"] and out["failed"] == 0
    model = run.resolve(BENCH, cell)["config"]["model"]
    assert steps_per_call(model) == 24
    assert _metric(out, _suffix(out)) == steps_per_call(model)


def test_the_reader_with_nothing_to_read_returns_none():
    mod = run.load_file(run.reader_path("graph_replays"), "m_graph_replays")
    assert mod.read(SimpleNamespace(calls=[])) is None
    assert mod.read(SimpleNamespace(calls=[(0, 1, 2, 1)])) is None
