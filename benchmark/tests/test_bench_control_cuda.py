"""The controls fail the limits, on the card: each codec cell's numbers
with the reference computed with TF32 on in the program's place, and the
forward cell's with the program's own int8 path, at a size a test run
holds.  Run on the card with ``python -m pytest benchmark/tests -m cuda``."""

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

import calibrate  # noqa: E402
import run  # noqa: E402

SMALL = {"codec-b16-v64": {"batch": 4, "height": 256, "width": 384,
                           "distinct": 1},
         "sticker-b1-v64": {"height": 256, "width": 256, "distinct": 4},
         "forward-b16": {"batch": 4, "height": 256, "width": 384,
                         "distinct": 1}}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13])
def test_the_control_fails_and_the_program_passes(cell, seed, card):
    r = calibrate.readings(cell, seed, True, card, SMALL[cell])
    c = run.resolve(run.benchmark(staged=True), cell)
    limits = c["config"]["limits"]
    print(json.dumps(r))
    assert all(r["program"][k] <= v for k, v in limits.items())
    assert any(r["control"][k] > v for k, v in limits.items())
