"""The banded training step of the PyTorch port on the CPU:
``dryrun_multichip(4, device="cpu")`` (the JAX dry run's 2-D mesh: space 2
by data 2, five gloo processes with the single one) must meet the dry
run's bounds (gradients within 1e-5 * mean|g| + 1e-7 per parameter, loss
1e-6 relative), and two faults must fail a check: ``--zero-halo`` (every
band padded with zero rows instead of its neighbours'), and region ids
keyed on the band's own shape (the band taken for the whole image, so
that every band gets the last band's wrap labels), which moves a banded
``WinGateAttention`` far past its 2e-5 against the unbanded module.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from rgba_tpu_torch.parallel.launch import run_ranks  # noqa: E402

import torch_port_spatial_util as u  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


def test_dryrun_multichip_space_by_data_equals_one_process():
    res = dryrun_multichip(4, device="cpu", timeout=300)
    assert res["space"] == 2 and res["n_devices"] == 4
    assert res["grad_worst_ratio"] <= 1.0 and res["loss_rel"] <= 1e-6
    assert res["params"] > 400 and np.isfinite(res["rd_loss"])


def test_dryrun_zero_halo_fails_the_check():
    with pytest.raises(AssertionError, match="differs"):
        dryrun_multichip(4, device="cpu", zero_halo=True, timeout=300)


@pytest.mark.parametrize("stale", [False, True])
def test_region_ids_of_the_band(stale):
    env = dict(os.environ, PYTHONPATH=TESTS)
    got = run_ranks("torch_port_spatial_util:win_gate_band", 2, space=2,
                    device="cpu", env=env, args=(stale,), timeout=120)
    x, alpha = u.win_gate_inputs()
    with torch.no_grad():
        want = u.make_win_gate()(u._nchw(x), u._nchw(alpha))
    err = float((torch.cat(got, dim=2) - want).abs().max())
    if stale:
        assert err > 1e-2, err
    else:
        assert err <= 2e-5, err
