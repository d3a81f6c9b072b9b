"""Every cell, configuration, traffic mix, loop and metric of
``BENCHMARK.json`` and of ``staged.json`` resolves from its files, and
``BENCHMARK.json`` keeps to the benchmark's contract."""

import json
import re
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]

import run  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ALL = run.benchmark(staged=True)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in ALL["workloads"]])
def test_cell_resolves(cell):
    c = run.resolve(ALL, cell)
    for fn in ("setup", "call", "call_input", "free", "check", "control"):
        assert callable(getattr(c["loop"], fn)), fn
    assert c["config"]["name"] == c["entry"]["config"]
    reported = run.cell_metrics(ALL, cell, "end_to_end")
    assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
    assert run.cell_metrics(ALL, cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    ALL["end_to_end"] + ALL["per_layer"]])
def test_metric_resolves(metric):
    reader = run.load_file(run.reader_path(metric), "m")
    assert callable(reader.read)


def test_every_reader_is_used():
    names = {m["name"].split(".")[0]
             for m in ALL["end_to_end"] + ALL["per_layer"]}
    assert {p.stem for p in (HERE / "metrics").glob("*.py")} == names


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in METRICS:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        for cell in m.get("workloads", ()):
            assert cell in CELLS
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        # every cell that reports a per-layer metric reports what it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
