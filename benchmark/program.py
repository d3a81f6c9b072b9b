"""The system under test, as a configuration's ``route`` names it: the
port's ``RGBAPipeline`` with the route's precision and kernels, loaded
with the benchmark's state dict, and the bitstream codec over it.  The
only module of the benchmark besides the loops that imports the
program, and it does so inside its functions.
"""

from __future__ import annotations

import dataclasses

KERNEL_FLAGS = {"win_attn": "fused_win_attn", "gdn": "fused_gdn",
                "gate_chain": "fused_gate_chain", "dse": "fused_dse"}


def policy(route: dict):
    """The program's policy: ``route["dtype"]`` ("float32" or "bfloat16")
    with the kernels of ``route["kernels"]`` on (the DSE kernel's TPU lane
    layout ``packed_dse`` off, so the DSE kernel runs), or the program's
    own ``route["policy"]`` by name ("serve-int8")."""
    from rgba_tpu_torch.core.precision import policy_from_str
    if "policy" in route:
        return policy_from_str(route["policy"])
    flags = {KERNEL_FLAGS[k]: True for k in route.get("kernels", ())}
    return dataclasses.replace(policy_from_str(route["dtype"]),
                               packed_dse=False, **flags)


def build_kernels(device) -> None:
    """On the card, build every kernel library and the host rANS coder at
    once (one compiler per source), before the first call."""
    if device.type != "cuda":
        return
    from rgba_tpu_torch.native import rans
    from rgba_tpu_torch.ops.kernels import (build, dse, gate_chain, gdn,
                                            rans_decode, rans_encode,
                                            win_attn)
    build.build_all([k.KERNEL for k in (win_attn, gdn, gate_chain, dse,
                                        rans_decode, rans_encode)])
    rans.build()


def pipeline(route: dict, state: dict, device):
    """``RGBAPipeline`` under the route's policy with ``state`` loaded."""
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    pipe = RGBAPipeline(policy(route), device=device, seed=0)
    pipe.load_state_dict(state, strict=True)
    return pipe.eval()


def codec(pipe):
    """The RGBA container codec over the pipeline's two codecs (their
    entropy tables built from the loaded weights)."""
    from rgba_tpu_torch.eval.codec_io import CodecIO
    from rgba_tpu_torch.eval.container import RGBAFileCodec
    return RGBAFileCodec(CodecIO(pipe.rgb_codec, "rgb"),
                         CodecIO(pipe.mask_codec, "mask"))


def close_codec(c) -> None:
    c.rgb_io.close()
    c.mask_io.close()
