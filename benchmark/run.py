#!/usr/bin/env python3
"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the NVIDIA cards the cell
asks for.  The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration is ``benchmark/configs/<config>.json`` (the route, the
weights' gains, the limits of the comparison), its traffic
``benchmark/traffic/<traffic>.json`` (the window loop
``benchmark/loops/<loop>.py`` and its parameters), and each metric
``benchmark/metrics/<name>.py`` (the name up to its first dot).

A run: builds the program's kernels (inside the checkout's ``build/``),
makes the weights and inputs on the card from ``--seed``, warms up the
cell's shapes, then calls the window loop, one request after another,
for ``--seconds`` (with ``--trace 1`` under the profiler), reads the peak memory, frees the
program, and compares what the window produced with the plain reference
(``benchmark/reference``).  The last line of standard output is one JSON
object; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.  Exits 1, with no result,
without enough cards, and if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rgba_tpu")


def _process_start() -> float:
    """The wall-clock time at which this process started (Linux)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start / ticks
    except (OSError, ValueError, StopIteration):
        return time.time()


HOST_THREADS = "2"    # one process, few threads: a steadier host


def _environment() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths,
    and few host threads for the numerical libraries."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def load_file(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(staged: bool = False) -> dict:
    """``BENCHMARK.json``; with ``staged``, its lists extended by those of
    ``staged.json``: cells built but held out of the benchmark (run by
    ``calibrate.py`` and the CPU tests, never by a check)."""
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    if staged:
        with open(HERE / "staged.json") as f:
            extra = json.load(f)
        for k in ("configs", "workloads", "end_to_end", "per_layer"):
            bench[k] = bench[k] + extra[k]
    return bench


def reader_path(metric: str) -> Path:
    """A metric's reader: ``metrics/<name up to its first dot>.py``, so one
    reader serves every cell's suffix (``.bulk``, ``.request``)."""
    return HERE / "metrics" / f"{metric.split('.')[0]}.py"


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that ``cell``
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def resolve(bench: dict, cell: str) -> dict:
    """The cell's entry, configuration, traffic and loop, by name."""
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    with open(HERE / "configs" / f"{entry['config']}.json") as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{entry['traffic']}.json") as f:
        traffic = json.load(f)
    loop = load_file(HERE / "loops" / f"{traffic['loop']}.py",
                       f"loop_{traffic['loop']}")
    return {"entry": entry, "config": config, "traffic": traffic,
            "loop": loop}


class Run:
    """What one run knows: the cell, its loop's state and what the window
    recorded.  Metric readers read it."""

    def __init__(self, cell: dict, seed: int, device):
        self.entry, self.config = cell["entry"], cell["config"]
        self.traffic, self.loop = cell["traffic"], cell["loop"]
        self.seed, self.device = seed, device
        self.calls = []          # (input index, start_ns, end_ns, images)
        self.spans = []          # (name, start_ns, end_ns)
        self.failed = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.trace = None
        self.program = self.reference = None

    def span_ms(self, name: str):
        """Mean host milliseconds of the spans named ``name``."""
        d = [(e - s) / 1e6 for n, s, e in self.spans if n == name]
        return statistics.fmean(d) if d else None

    def images(self) -> int:
        return sum(c[3] for c in self.calls)

    def latencies_ms(self) -> list:
        """Every call's milliseconds, a failed call's as infinite."""
        return [(e - s) / 1e6 for _, s, e, _ in self.calls] + \
            [float("inf")] * self.failed


def window(run: Run, seconds: float) -> None:
    """Calls the window loop, one request after another, until ``seconds``
    have passed; the window closes when the last call returns."""
    loop, i = run.loop, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        s = time.time_ns()
        try:
            rec = loop.call(run, i)
        except Exception as e:       # a failed request counts, the loop goes on
            print(f"call {i} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            run.failed += 1
            if run.failed > 3 and not run.calls:
                raise
        else:
            run.calls.append((loop.call_input(run, i), s, time.time_ns(),
                              rec["images"]))
            run.spans.extend(rec["spans"])
        i += 1
    run.window_s = time.perf_counter() - t0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, start: float | None = None,
             overrides: dict | None = None, bench: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line as a dict.
    ``overrides``: traffic parameters replaced (the CPU tests' tiny
    sizes); ``bench``: the cells to find it among (``benchmark()``)."""
    import torch
    bench = bench or benchmark()
    cell = resolve(bench, workload)
    cell["traffic"].update(overrides or {})
    dev = torch.device(device or "cuda")
    run = Run(cell, seed, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run.loop.setup(run)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prof = None
    if trace:
        from devtrace import profiler
        prof = profiler(dev.type == "cuda")
        prof.start()
    lo = time.time_ns()
    run.setup_s = time.time() - (start if start is not None else time.time())
    window(run, seconds)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    hi = time.time_ns()
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    run.loop.free(run)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if prof is not None:
        from devtrace import device_events, summarize
        run.trace = summarize(device_events(prof), run.spans, lo, hi)
        del prof
    numbers = run.loop.check(run)
    limits = dict(run.config["limits"], **run.traffic.get("limits", {}))
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    correct = (bool(run.calls) and run.failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload, kind):
        reader = load_file(reader_path(m["name"]), f"metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": int(cell["entry"]["chips"]),
                "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": run.images() + run.failed,
           "failed": run.failed, "metrics": metrics, "device": dev_info}
    if run.trace is not None:
        dev_info.update(busy_s=run.trace["busy_s"],
                        window_s=run.trace["window_s"])
        out["breakdown"] = {"device_ops": run.trace["device_ops"],
                            "idle_gaps": run.trace["idle_gaps"]}
    out["checks"] = checks
    return out


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def main(argv=None) -> int:
    start = _process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch
    torch.set_num_threads(int(HOST_THREADS))
    cell = resolve(benchmark(), args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 1
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   start=start)
    bad = loaded_forbidden()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 1
    print(json.dumps(out), flush=True)
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
