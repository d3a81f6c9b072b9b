"""The codec's device steps run inside ``batch_invariant_scope``, on the CPU.

Encoder and decoder recompute the CDF indexes apart, so an image's result
must not depend on the batch it runs in: a blob must decode the same alone
or in any batch.  cuDNN (oneDNN on the CPU) picks a convolution's
algorithm by the batch size, and an fp32 sum in another order can move a
CDF index, so inside the scope the convolutions (``ops.conv.per_image``)
run each image of a batch on their own.  The card test ``test_codec_round_trip_on_the_card`` and
chip_smoke.py decode blobs apart against their batch; here the scope's
plumbing is checked.
"""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from rgba_tpu_torch.core import precision  # noqa: E402
from rgba_tpu_torch.eval.codec_io import CodecIO  # noqa: E402


def test_scope_nests_and_closes():
    assert not precision.batch_invariant()
    with precision.batch_invariant_scope():
        with precision.batch_invariant_scope():
            assert precision.batch_invariant()
        assert precision.batch_invariant()
    assert not precision.batch_invariant()
    with pytest.raises(RuntimeError):
        with precision.batch_invariant_scope():
            raise RuntimeError("a failed step")
    assert not precision.batch_invariant()


def test_codec_device_steps_are_batch_invariant():
    """Every device step of ``CodecIO`` enters ``_scope``: inference mode,
    TF32 off, deterministic cuDNN, and the batch-invariant scope."""
    io = SimpleNamespace(model=SimpleNamespace(policy=precision.DEFAULT_POLICY))
    cudnn = torch.backends.cudnn
    with CodecIO._scope(io):
        assert precision.batch_invariant()
        assert cudnn.deterministic and not cudnn.benchmark
        assert torch.is_inference_mode_enabled()
    assert not precision.batch_invariant()
