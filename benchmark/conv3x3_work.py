"""The 3x3 stride-1 convolutions of one TCM codec call, as the program's
3x3 kernel runs them: counted from the reference (``reference/tcm.py``)
on the meta device at the cell's shapes, as ``tcm_work`` counts the model,
and the least time the card could take for them.  It imports nothing of
the program.

A call (``tcm_work.codec_flops``) runs g_a, h_a, both hyper syntheses and
the slice chain to encode, and both hyper syntheses, the slice chain and
g_s to decode.  Every 3x3 convolution at stride 1 and padding 1 counts
once per call of its part over the whole batch, as the kernel takes the
batch in one launch, except those inside the slices' ``SWAtten`` blocks,
which the gate-chain kernel runs.  Operations: 2 B H W Cout 9 Cin each;
bytes: the input and the output once, the weights' TF32 hi and lo and the
bias once (fp32).
"""

from __future__ import annotations

import torch

import tcm_work
import work

_CONVS = {}


def _is_class(mod) -> bool:
    return (isinstance(mod, torch.nn.Conv2d) and mod.kernel_size == (3, 3)
            and mod.stride == (1, 1) and mod.padding == (1, 1))


def _part_convs(widths: dict, part: str, b: int, h: int, w: int) -> list:
    """(B, Cin, Cout, H, W) of each convolution of the class that ``part``
    runs once, in order."""
    from reference import tcm as ref
    seen = []
    with torch.device("meta"):
        m = tcm_work.model(widths)
        hooks = [mod.register_forward_hook(
            lambda mod, args, out: seen.append(
                (out.shape[0], mod.in_channels, mod.out_channels,
                 out.shape[2], out.shape[3])))
            for name, mod in m.named_modules()
            if _is_class(mod) and not name.startswith(("atten_mean",
                                                       "atten_scale"))]
        y = torch.zeros(b, m.g_a[-1].out_channels, h // 16, w // 16)
        z = torch.zeros(b, ref.Z_CH, h // 64, w // 64)
        run = {"g_a": lambda: m.g_a(torch.zeros(b, 3, h, w)),
               "g_s": lambda: m.g_s(y), "h_a": lambda: m.h_a(y),
               "h_s": lambda: (m.h_mean_s(z), m.h_scale_s(z)),
               "slices": lambda: tcm_work._slices(m, y)}[part]
        with torch.no_grad():
            run()
        for hk in hooks:
            hk.remove()
    return seen


def convs(widths: dict, b: int, h: int, w: int) -> list:
    """Every convolution of the class in one encode and decode of b images
    of h x w."""
    key = (tuple(sorted((k, str(v)) for k, v in widths.items())), b, h, w)
    if key not in _CONVS:
        p = {part: _part_convs(widths, part, b, h, w)
             for part in ("g_a", "h_a", "h_s", "slices", "g_s")}
        _CONVS[key] = (p["g_a"] + p["h_a"] + 2 * (p["h_s"] + p["slices"])
                       + p["g_s"])
    return _CONVS[key]


def conv_work(b: int, cin: int, cout: int, h: int, w: int) -> tuple:
    """(FLOPs, bytes) of one launch over b images of h x w."""
    flops = 2.0 * b * h * w * cout * 9 * cin
    nbytes = 4 * (b * h * w * (cin + cout) + 2 * 9 * cin * cout + cout)
    return flops, nbytes


def bound_s(widths: dict, b: int, h: int, w: int) -> float:
    """Seconds of the bound of one call's launches: each launch's larger of
    its operations at the TF32 peak and its bytes at the memory rate."""
    return sum(work.bound_s(*conv_work(*c), work.PEAK_TF32)
               for c in convs(widths, b, h, w))
