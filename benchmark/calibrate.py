#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control] [--out FILE]

For each seed, in one process: the cell's set-up, then one call of the
timed path on each distinct input of the traffic (a short window that
covers the whole mix), the program freed, and every number the cell's
loop can compare, against the reference; with ``--control`` also the
control's numbers (the reference in the next lower precision, or the
program's own lower-precision path, in the program's place).  One JSON
line per seed on standard output, and appended to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def readings(workload: str, seed: int, control: bool, device=None,
             overrides: dict | None = None) -> dict:
    import torch
    import run as harness
    cell = harness.resolve(harness.benchmark(staged=True), workload)
    cell["traffic"].update(overrides or {})
    cell["traffic"]["keep"] = cell["traffic"]["distinct"]
    dev = torch.device(device or "cuda")
    r = harness.Run(cell, seed, dev)
    t = time.perf_counter()
    r.loop.setup(r)
    for i in range(cell["traffic"]["distinct"]):
        s = time.time_ns()
        rec = r.loop.call(r, i)
        r.calls.append((r.loop.call_input(r, i), s, time.time_ns(),
                        rec["images"]))
    r.loop.free(r)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"workload": workload, "seed": seed,
           "program": r.loop.check(r),
           "calls_s": sum(c[2] - c[1] for c in r.calls) / 1e9}
    if control:
        out["control"] = r.loop.control(r)
    out["seconds"] = time.perf_counter() - t
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(args.workload, seed, args.control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
