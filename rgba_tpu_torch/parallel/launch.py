"""Run a function on every rank of a process group, one process each.

    from rgba_tpu_torch.parallel.launch import run_ranks
    results = run_ranks("pkg.module:fn", world=4, space=2, args=(...,))

Each process runs on ``device``, ``cuda`` unless the caller asks for the
CPU (``device="cpu"``; ``core.precision.resolve_device``), joins a
``torch.distributed`` group of ``world`` ranks on a free localhost port
(``distributed.initialize``: gloo on the CPU, NCCL on cards unless
``backend`` says otherwise), builds the (``space``, ``data``) mesh
(``mesh.make_process_mesh``), calls ``fn(mesh, *args)`` and hands its
result back (``torch.save`` into a temporary directory, read by the
caller); the list of results is in rank order.  The processes inherit the
environment, less torchrun's variables, with the repository on
``PYTHONPATH`` and, on the CPU, two threads each.  A rank that fails ends
the run: the others are killed (a peer blocked in an exchange would wait
for it for ever), and so are all of them at ``timeout``; either raises
with the failing rank's output.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from ..core.precision import resolve_device

_ROOT = Path(__file__).resolve().parents[2]
_TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                  "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` processes running ``fn`` (see the module docstring),
    started at construction; ``join`` waits for them.  Use as a context
    manager so that no process outlives the caller."""

    def __init__(self, fn: str, world: int, *, space: int = 1,
                 device: str = None, backend: str = None, args=(),
                 env: dict = None):
        device = str(resolve_device(device))
        self._tmp = tempfile.TemporaryDirectory()
        tmp = Path(self._tmp.name)
        torch.save(tuple(args), tmp / "args.pt")
        environ = dict(os.environ if env is None else env)
        for k in _TORCHRUN_VARS:   # the ranks are placed by their arguments
            environ.pop(k, None)
        environ["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + [p for p in environ.get("PYTHONPATH", "")
                            .split(os.pathsep) if p])
        if device == "cpu":
            environ.setdefault("OMP_NUM_THREADS", "2")
        port = free_port()
        self.world, self.procs, self.logs = world, [], []
        for rank in range(world):
            cmd = [sys.executable, "-m", "rgba_tpu_torch.parallel.launch",
                   fn, "--world", str(world), "--rank", str(rank),
                   "--port", str(port), "--space", str(space),
                   "--device", device, "--dir", str(tmp)]
            if backend:
                cmd += ["--backend", backend]
            log = open(tmp / f"rank{rank}.log", "w+")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                cmd, env=environ, stdout=log, stderr=subprocess.STDOUT))

    def _log(self, rank: int) -> str:
        log = self.logs[rank]
        log.flush()
        log.seek(0)
        return log.read()[-6000:]

    def join(self, timeout: float = 600.0) -> list:
        """The ranks' results, in rank order; raises RuntimeError when a
        rank fails and TimeoutError at ``timeout`` seconds."""
        end = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in self.procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(
                        f"rank {bad[0]} of {self.world} failed ({codes[bad[0]]})"
                        f":\n{self._log(bad[0])}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > end:
                    raise TimeoutError(
                        f"ranks still running after {timeout:.0f} s; rank 0:"
                        f"\n{self._log(0)}")
                time.sleep(0.05)
            tmp = Path(self._tmp.name)
            return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                    for r in range(self.world)]
        finally:
            self.close()

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        for log in self.logs:
            log.close()
        self._tmp.cleanup()


def run_ranks(fn: str, world: int, *, timeout: float = 600.0, **kw) -> list:
    """Start ``Ranks(fn, world, **kw)`` and join them."""
    with Ranks(fn, world, **kw) as ranks:
        return ranks.join(timeout)


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("fn")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--space", type=int, default=1)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", default=None)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args(argv)
    import torch.distributed as dist
    from .distributed import initialize
    from .mesh import make_process_mesh

    module, name = a.fn.split(":")
    fn = getattr(importlib.import_module(module), name)
    initialize(f"localhost:{a.port}", a.world, a.rank, device=a.device,
               backend=a.backend)
    try:
        mesh = make_process_mesh(a.space)
        args = torch.load(Path(a.dir) / "args.pt", weights_only=False)
        out = fn(mesh, *args)
        torch.save(out, Path(a.dir) / f"rank{a.rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main()
