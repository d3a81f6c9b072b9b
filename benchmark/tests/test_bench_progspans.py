"""The readers of the program's own spans (``progspans.py`` and
``metrics/{rans_ms,transfer_ms,host_other_ms,round_trips}.py``) on tiny
runs of each cell on the CPU: a traced run reports them, and they add up
to the benchmark's own spans around the calls; an untraced run records no
program span; a reader with nothing to read returns None."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run  # noqa: E402
from test_bench_runs import TINY  # noqa: E402

from rgba_tpu_torch.utils import trace  # noqa: E402

BENCH = run.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = ("rans_ms", "transfer_ms", "host_other_ms", "round_trips")


def fetches_per_call(model: dict) -> int:
    """Device-to-host waits of one encode + decode of a batch with an alpha
    to code: the encode fetches the mask's symbols, the mask decode's
    serial slices, the RGB symbols; the decode each codec's serial slices,
    the RGB tail's indexes at once, and the RGBA."""
    def serial(c):
        return c["num_slices"] - max(0, c["num_slices"]
                                     - c["max_support_slices"])

    def tail(c):
        return int(c["num_slices"] > c["max_support_slices"])
    rgb, mask = model["rgb"], model["mask"]
    return (1 + serial(mask) + 1) + \
        (serial(rgb) + tail(rgb) + serial(mask) + 1)


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_splits_each_call(cell):
    out = run.run_cell(cell, 2 ** 33 + 17, 0.5, True, device="cpu",
                       overrides=TINY[cell], bench=BENCH)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    suffix = next(k for k in m if k.startswith("encode_ms.")).split(".")[1]
    parts = [m[f"{r}.{suffix}"] for r in READERS]
    assert all(p >= 0 for p in parts)
    model = run.resolve(BENCH, cell)["config"]["model"]
    assert fetches_per_call(model) == 19
    assert m[f"round_trips.{suffix}"] == fetches_per_call(model)
    calls = m[f"encode_ms.{suffix}"] + m[f"decode_ms.{suffix}"]
    assert sum(parts[:3]) == pytest.approx(calls, rel=0.05)


def test_an_untraced_run_records_no_program_span():
    before = trace.spans()
    out = run.run_cell(CELLS[0], 2 ** 33 + 19, 0.3, False, device="cpu",
                       overrides=TINY[CELLS[0]], bench=BENCH)
    assert out["attempted"] > 0
    assert trace.spans() == before


@pytest.mark.parametrize("reader", READERS)
def test_a_reader_with_nothing_to_read_returns_none(reader):
    mod = run.load_file(run.reader_path(reader), f"m_{reader}")
    assert mod.read(SimpleNamespace(calls=[])) is None
    # a window in which the program recorded nothing
    assert mod.read(SimpleNamespace(calls=[(0, 1, 2, 1)])) is None
