"""The PyTorch port's timing and health canary (``utils/benchmark.py``,
``utils/health.py``): on the CPU the loop and the keys, on a card (marked
``cuda``, skipped here) CUDA-event timing and the canary's rate.

The JAX twins time through a host fetch of a TPU runtime
(``rgba_tpu/utils/benchmark.py``); nothing of that is ported, so these
tests hold the port to the contract, not to JAX numbers.  Tolerance: a
sleep of 20 ms timed within 20%.
"""

import time

import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.utils import health  # noqa: E402
from rgba_tpu_torch.utils.benchmark import device_time  # noqa: E402


def test_device_time_on_the_cpu_times_the_loop():
    sec = device_time(lambda: time.sleep(0.02), [()], iters=5, warmup=1,
                      device="cpu")
    assert isinstance(sec, float)
    assert 0.8 * 0.02 <= sec <= 1.2 * 0.02


def test_device_time_takes_the_inputs_in_turn():
    seen = []
    a, b = torch.zeros(2), torch.ones(2)
    device_time(lambda t: seen.append(float(t[0])), [(a,), (b,)], iters=4,
                warmup=2)                        # the CPU, from the inputs
    assert seen == [0.0, 1.0, 0.0, 1.0, 0.0, 1.0]


def test_device_time_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_time(lambda: None, [()])          # no tensors: cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        health.chip_health(n=64)


def test_chip_health_keys_on_the_cpu():
    out = health.chip_health(n=256, iters=2, device="cpu")
    assert set(out) == {"matmul_tflops", "sync_ms", "healthy_frac",
                        "degraded"}
    assert isinstance(out["matmul_tflops"], float) and out["matmul_tflops"] >= 0
    assert isinstance(out["sync_ms"], float) and out["sync_ms"] >= 0
    assert isinstance(out["healthy_frac"], float)
    assert isinstance(out["degraded"], bool)
    assert health.DEGRADED_BELOW == 0.6 and health.HEALTHY_TFS > 0


@pytest.mark.cuda
def test_device_time_and_chip_health_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    sec = device_time(torch.matmul, [(x, x)], iters=10)
    tflops = 2 * 4096 ** 3 / sec / 1e12
    assert 50 < tflops < 1000                    # a bf16 product on the card
    # the card held busy while the host enqueues gives the same device time
    held = device_time(torch.matmul, [(x, x)], iters=10,
                       hold_cycles=10_000_000)
    assert abs(held - sec) / sec < 0.2
    out = health.chip_health(n=4096, iters=8)
    assert out["matmul_tflops"] > 0 and out["sync_ms"] > 0
    assert out["healthy_frac"] == pytest.approx(
        out["matmul_tflops"] / health.HEALTHY_TFS, abs=2e-3)
