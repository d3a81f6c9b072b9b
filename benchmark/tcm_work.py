"""What the benchmark makes and counts itself for TCM, the mixed
Transformer-CNN codec of ``configs/tcm-large-codec-fp32.json``: its
weights from the seed, its model FLOPs and each kernel's work from the
shapes.  It imports nothing of the program.

Weights: the published code's init distributions (torch's defaults:
uniform within +-sqrt(1/fan_in) for convolutions and linears, the
LayerNorms at 1 and 0, the relative-position tables a normal of 0.02
truncated at two sigma, compressai's GDN and entropy bottleneck starts),
drawn on the device from one generator in a few large calls, every bias
at 0, then made live as ``work.make_state`` makes the paper codec: seeded
bias noise (0.02), a gain on the analysis transform's last convolution
(the configuration's ``gains["g_a"]``), so that the latents span several
bins, and the synthesis's last convolution's biases at 0.5, so that the
decoded image sits inside [0, 1] and not at its clip (as the paper codec's
DSE output biases do).

Operations: ``codec_flops`` counts what ``torch.utils.flop_counter``
counts (convolutions, linears, the attention's products) in the reference
(``reference/tcm.py``) on the meta device at the cell's shapes; every
window is alive, so nothing is taken out.  ``kernel_bounds`` gives each
hand-written kernel's least time for one call from its operations and
bytes (``work.bound_s``, fp32 at the TF32 peak).
"""

from __future__ import annotations

import math

import torch

import work
from reference import tcm as ref


def model(widths: dict):
    """The reference TCM at the configuration's ``model`` widths."""
    return ref.TCM(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in widths.items()})


def _kinds(m):
    """Each parameter's init: ("uniform", bound), ("trunc", std), or a
    fixed start ("zeros", "ones", "gdn_beta", "gdn_gamma", "full",
    "quantiles")."""
    out = {}
    for mname, mod in m.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Linear)):
            fan_in = mod.weight[0].numel()
            out[pre + "weight"] = ("uniform", math.sqrt(1.0 / fan_in))
            out[pre + "bias"] = ("zeros", None)
        elif isinstance(mod, torch.nn.LayerNorm):
            out[pre + "weight"] = ("ones", None)
            out[pre + "bias"] = ("zeros", None)
        elif isinstance(mod, ref.WMSA):
            out[pre + "relative_position_params"] = ("trunc", 0.02)
        elif isinstance(mod, ref.GDN):
            out[pre + "beta"] = ("gdn_beta", None)
            out[pre + "gamma"] = ("gdn_gamma", None)
        elif isinstance(mod, ref.EntropyBottleneck):
            fs = (1,) + mod.FILTERS + (1,)
            scale = 10.0 ** (1 / (len(mod.FILTERS) + 1))
            for i in range(len(mod.FILTERS) + 1):
                out[f"{pre}_matrix{i}"] = (
                    "full", math.log(math.expm1(1 / scale / fs[i + 1])))
                out[f"{pre}_bias{i}"] = ("uniform", 0.5)
                if i < len(mod.FILTERS):
                    out[f"{pre}_factor{i}"] = ("zeros", None)
            out[pre + "quantiles"] = ("quantiles", 10.0)
    return out


def make_state(seed: int, widths: dict, gains: dict, device) -> dict:
    """The live float32 state dict of TCM at ``widths`` for ``seed``, made
    on ``device`` in one draw per distribution; ``gains["g_a"]``: the gain
    on the analysis transform's last convolution."""
    with torch.device("meta"):
        shapes = model(widths)
    kinds = _kinds(shapes)
    params = dict(shapes.named_parameters())
    missing = set(params) - set(kinds)
    if missing:
        raise ValueError(f"no init for {sorted(missing)[:5]}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    sizes = {k: params[k].numel() for k in params}

    def pool(kind):
        names = [k for k in params if kinds[k][0] == kind]
        return names, sum(sizes[k] for k in names)

    state = {}
    names, total = pool("uniform")
    flat = torch.empty(total, device=device).uniform_(-1.0, 1.0,
                                                      generator=gen)
    for k, part in zip(names, flat.split([sizes[k] for k in names])):
        state[k] = (part * kinds[k][1]).reshape(params[k].shape)
    names, total = pool("trunc")
    flat = torch.empty(total, device=device)
    torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    for k, part in zip(names, flat.split([sizes[k] for k in names])):
        state[k] = (part * kinds[k][1]).reshape(params[k].shape)
    pedestal = (2.0 ** -18) ** 2
    for k, (kind, arg) in kinds.items():
        shape = params[k].shape
        if kind == "zeros":
            state[k] = torch.zeros(shape, device=device)
        elif kind == "ones":
            state[k] = torch.ones(shape, device=device)
        elif kind == "full":
            state[k] = torch.full(shape, arg, device=device)
        elif kind == "gdn_beta":
            state[k] = torch.full(shape, math.sqrt(1.0 + pedestal),
                                  device=device)
        elif kind == "gdn_gamma":
            state[k] = torch.sqrt(0.1 * torch.eye(shape[0], device=device)
                                  + pedestal)
        elif kind == "quantiles":
            q = torch.tensor([-arg, 0.0, arg], device=device)
            state[k] = q.reshape(1, 1, 3).repeat(shape[0], 1, 1)
    # make the model live: bias noise, the analysis transform's gain
    biases = [k for k in state if k.endswith(".bias")]
    noise = torch.randn(sum(sizes[k] for k in biases), device=device,
                        generator=gen)
    for k, part in zip(biases, noise.split([sizes[k] for k in biases])):
        state[k] = state[k] + 0.02 * part.reshape(state[k].shape)
    last = f"g_a.{len(shapes.g_a) - 1}.weight"
    state[last] = state[last] * float(gains["g_a"])
    out = f"g_s.{len(shapes.g_s) - 1}.0.bias"
    state[out] = torch.full_like(state[out], 0.5)
    return {k: state[k].contiguous() for k in params}


def make_images(seed: int, n: int, h: int, w: int, device) -> dict:
    """``n`` opaque images from ``seed``: "image" (n, h, w, 3) uint8, the
    smooth noise of ``work.make_images``, and "alpha" (n, h, w, 1) at 255,
    on ``device``."""
    image = work.make_images(seed, n, h, w, device)["image"]
    alpha = torch.full((n, h, w, 1), 255, dtype=torch.uint8, device=device)
    return {"image": image, "alpha": alpha}


# ----------------------------------------------------------- operations

_DENSE = {}


def _meta_flops(widths: dict, part: str, b: int, h: int, w: int) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        m = model(widths)
        mm, s = m.g_a[-1].out_channels, 16
        x = torch.zeros(b, 3, h, w)
        y = torch.zeros(b, mm, h // s, w // s)
        z = torch.zeros(b, ref.Z_CH, h // 64, w // 64)
        run = {"g_a": lambda: m.g_a(x), "g_s": lambda: m.g_s(y),
               "h_a": lambda: m.h_a(y),
               "h_s": lambda: (m.h_mean_s(z), m.h_scale_s(z)),
               "slices": lambda: _slices(m, y)}[part]
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            run()
    return counter.get_total_flops()


def _slices(m, y):
    """The entropy head's slice chain on latents y, the hyper means and
    scales stood in by y."""
    y_hats = []
    for i in range(m.num_slices):
        support = y_hats[:m.max_support_slices]
        ms = m.atten_mean[i](torch.cat([y] + support, 1))
        mu = m.cc_mean_transforms[i](ms)
        m.cc_scale_transforms[i](m.atten_scale[i](torch.cat([y] + support, 1)))
        y_hats.append(mu + m.lrp_transforms[i](torch.cat([ms, mu], 1)))
    return y_hats


def dense(widths: dict, part: str, b: int, h: int, w: int) -> int:
    key = (tuple(sorted((k, str(v)) for k, v in widths.items())), part, b,
           h, w)
    if key not in _DENSE:
        _DENSE[key] = _meta_flops(widths, part, b, h, w)
    return _DENSE[key]


def codec_flops(widths: dict, b: int, h: int, w: int) -> int:
    """One encode and decode of b opaque images of h x w through the
    container: the encode runs g_a, h_a, both hyper syntheses and the slice
    chain; the decode both hyper syntheses, the slice chain and g_s."""
    d = lambda part: dense(widths, part, b, h, w)  # noqa: E731
    return d("g_a") + d("h_a") + 2 * (d("h_s") + d("slices")) + d("g_s")


# ---------------------------------------------------------- kernel work

def win_attn_work(windows: int, n: int, c: int, heads: int) -> tuple:
    """(FLOPs, bytes) of one fp32 launch over ``windows`` windows of n
    tokens at c channels, every window alive: the qkv and output
    projections, scores and the weighted sum (``work.window_flops``); the
    tokens read and the output written once, the weights' TF32 hi and lo
    (2 x 4 c^2 floats), the biases, rel_bias (heads x n x n), the region ids
    and the gates once."""
    flops = windows * work.window_flops(c, int(round(n ** 0.5)))
    nbytes = 4 * (2 * windows * n * c + 2 * 4 * c * c + 4 * c
                  + heads * n * n + windows * (n + 1))
    return flops, nbytes


def gdn_work(rows: int, c: int) -> tuple:
    """(FLOPs, bytes) of one fp32 GDN launch over ``rows`` rows of c
    channels: x^2 @ gamma_t (2 rows c^2), x read and y written once, gamma's
    TF32 hi and lo and beta once."""
    return 2.0 * rows * c * c, 2 * rows * c * 4 + (2 * c * c + c) * 4


def kernel_bounds(widths: dict, b: int, h: int, w: int) -> dict:
    """Seconds of the bound of one call's (encode + decode of b images of
    h x w) launches of each kernel, one image a launch as the codec runs
    them: window attention in every transformer block (g_a and g_s: two
    blocks a stage at H/2, H/4, H/8, window 8; the hyper transforms: two
    blocks at H/32, window 4, h_a once and each hyper synthesis twice; the
    entropy head: two blocks in each SWAtten at H/16, window 8, two
    SWAttens a slice on each side), GDN at 2N channels (g_a's three, g_s's
    three, h_a's one, each hyper synthesis's one on each side) and the gate
    chain at SWAtten's width (two a slice on each side, with g)."""
    n2, cfg, hd = 2 * widths["N"], widths["config"], widths["head_dim"]
    ws, hws = widths["window_size"], widths["hyper_window"]
    c_t, c_a = widths["N"], widths["atten_dim"]
    hhd, ahd = widths["hyper_head_dim"], widths["atten_head_dim"]
    peak = work.PEAK_TF32

    def attn(level, window, blocks, c, head_dim):
        nwin = ((h >> level) // window) * ((w >> level) // window)
        return blocks * work.bound_s(*win_attn_work(
            nwin, window * window, c, c // head_dim), peak)

    def gdn_at(level):
        return work.bound_s(*gdn_work((h >> level) * (w >> level), n2), peak)

    slices = widths["num_slices"]
    per_image = {
        "win_attn": (sum(attn(lv, ws, cfg[i], c_t, hd[i])
                         for i, lv in enumerate((1, 2, 3, 3, 2, 1)))
                     + attn(5, hws, cfg[0], c_t, hhd)
                     + 4 * attn(5, hws, cfg[3], c_t, hhd)
                     + 4 * slices * attn(4, ws, 2, c_a, ahd)),
        "gdn": 2 * sum(gdn_at(lv) for lv in (1, 2, 3)) + 5 * gdn_at(5),
        "gate_chain": 4 * slices * work.bound_s(*work.gate_chain_work(
            1, h >> 4, w >> 4, c_a, True, 4), peak),
    }
    return {k: b * v for k, v in per_image.items()}
