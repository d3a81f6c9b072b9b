"""Height (``space``) sharding of the PyTorch port on the CPU: the exchanges
of ``parallel/spatial.py`` and every band-aware op, over gloo in 2 and 4
processes (bands of 32 and 16 rows of a 64-row image; 4 bands have
interior ones).  The ranks start once per group size for the whole file
(``parallel/launch.py``: a free port, two threads each, every process
killed on a failure or at the timeout) and run
``torch_port_spatial_util.ops_checks``.

Tolerances: the halo, the ring shift (NCHW and NHWC), ``gather_rows``,
``scatter_rows`` and ``space_sum`` are exact copies, forward and backward,
and their backward is the adjoint: a banded objective's gradient equals
the unbanded slicing's (``gather_rows``' backward sums the ranks'
gradients in the all-reduce's order: 1e-5).  Every convolution geometry
of ``ops/conv.py`` (5x5 s2, 3x3, 1x1, the 5x5 s2 transposed one and the
1x1 transposed one, with their input gradients), GDN and IGDN, both gate
chains (plain), both DSE tails (plain) and ``WinGateAttention``, banded
against unbanded: rtol = atol = 1e-5 in fp32 (a convolution over another
height may sum in another order).  The alpha pyramid's levels and
``constraint_rgb`` (isolated pixels on both sides of every cut) equal the
unbanded rows bit for bit.
"""

import os
import types

import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core.precision import DEFAULT_POLICY  # noqa: E402
from rgba_tpu_torch.models.pipeline import RGBAPipeline  # noqa: E402
from rgba_tpu_torch.parallel import spatial  # noqa: E402
from rgba_tpu_torch.parallel.launch import run_ranks  # noqa: E402

from torch_port_spatial_util import CHECKS  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def results():
    env = dict(os.environ, PYTHONPATH=TESTS)
    return {world: run_ranks("torch_port_spatial_util:ops_checks", world,
                             space=world, device="cpu", env=env, timeout=240)
            for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("check", CHECKS)
def test_banded_op_matches_unbanded(results, world, check):
    for rank, res in enumerate(results[world]):
        r = res[check]
        assert r["ok"], (f"{check}, band {rank} of {world}: max |d| "
                         f"{r['max_abs']:.3g} (largest |ref| {r['ref_max']:.3g})")
        assert r["ref_max"] > 0.1     # not a comparison of zeros


def test_pyramid_levels_of_a_band(results):
    """A band of 32 rows holds five levels, one of 16 four."""
    assert {r["pyramid"]["levels"] for r in results[2]} == {5}
    assert {r["pyramid"]["levels"] for r in results[4]} == {4}


def _fake_mesh(space, index=0):
    return types.SimpleNamespace(space=space, space_index=index)


@pytest.mark.parametrize("band,space,ok", [(32, 2, True), (64, 4, True),
                                           (48, 2, False), (16, 4, False),
                                           (32, 3, False)])
def test_band_geometry(band, space, ok):
    """Bands of a multiple of 32 rows of an image of a multiple of 64."""
    mesh = _fake_mesh(space)
    if ok:
        spatial.check_band(band, mesh)
    else:
        with pytest.raises(ValueError, match="multiple of"):
            spatial.check_band(band, mesh)


def test_pipeline_refuses_a_band_of_48_rows():
    """The entry point checks the band before any exchange."""
    pipe = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    x = torch.zeros(1, 48, 64, 3)
    with spatial.space_scope(_fake_mesh(2)), \
            pytest.raises(ValueError, match="multiple of 32"):
        pipe(x, x[..., :1])


@pytest.mark.parametrize("transposed", [False, True])
def test_int8_refuses_bands(transposed):
    """One activation scale per batch: a band's would differ."""
    from rgba_tpu_torch.core.precision import SERVE_INT8_POLICY
    from rgba_tpu_torch.ops.conv import Conv, ConvTranspose
    cls = ConvTranspose if transposed else Conv
    m = cls(4, 4, 1, 1, policy=SERVE_INT8_POLICY, device="cpu",
            generator=torch.Generator().manual_seed(0), padding=0,
            **({"output_padding": 0} if transposed else {}))
    x = torch.randn(1, 4, 8, 8)
    m(x)                                     # unbanded: runs
    with spatial.space_scope(_fake_mesh(2)), \
            pytest.raises(ValueError, match="int8_conv under height"):
        m(x)


def test_no_scope_changes_nothing():
    """Outside a scope (or with one band) the helpers are the plain ops."""
    x = torch.randn(2, 3, 8, 5)
    with spatial.space_scope(None):
        assert spatial.current() is None
        assert spatial.roll(x, 3, 2).equal(torch.roll(x, 3, 2))
        assert spatial.gather_rows(x) is x and spatial.space_sum(x) is x
        assert spatial.halo(x, 2, 1).equal(
            torch.nn.functional.pad(x, (0, 0, 2, 1)))
        assert spatial.extend(x, 3) == (x, 0)
    assert spatial.mean(x).equal(x.mean())
