"""What the benchmark makes and counts itself, from the seed and the
cell's shapes: the weights, the inputs, the model's operations and each
kernel's work.  It imports nothing of the program.

Weights: the reference's init distributions (uniform within
+-sqrt(1/fan_in) for convolutions, a normal truncated at two sigma for the
attention's tables (0.02) and projections (lecun), the GDN and entropy
bottleneck's fixed starts), drawn on the device from one generator in a
few large calls, then made live: random weights leave the latents within
one bin of the prior's mean, so every rate would be the same constant.
Seeded bias noise, the DSE output biases at 0.5 and a gain on both
encoders' last 1x1 convolution give latents that span several bins.  The
gains are the configuration's ``gains``.

Inputs: smooth images of three octaves of upsampled noise, with alpha
mattes of three elliptic blobs rounded to 8 bits, made on the device.

Operations: ``forward_flops`` and ``codec_flops`` count what
``torch.utils.flop_counter``
counts (convolutions, matrix products) in the reference, run on the meta
device at the cell's shapes, and then takes out the window attention of
every window whose alpha is all 0: the program skips those windows, so
the count is what these inputs need.  The count does not depend on what
computes the model.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import model as ref

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor cores, FLOP/s
PEAK_TF32 = 495e12      # dense TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
_TRUNC_STD = 0.87962566103423978   # std of a unit normal cut at +-2


# -------------------------------------------------------------- weights

def _kinds(model):
    """Each parameter's init: ("uniform", bound), ("trunc", std), or a
    fixed start ("zeros", "full", "gdn_beta", "gdn_gamma", "quantiles")."""
    out = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(mod, (ref.Conv, ref.ConvT)):
            cin = mod.weight.shape[1 if isinstance(mod, ref.Conv) else 0]
            fan_in = cin * mod.weight.shape[-1] ** 2
            out[pre + "weight"] = ("uniform", math.sqrt(1.0 / fan_in))
            out[pre + "bias"] = ("zeros", None)
        elif isinstance(mod, ref.WindowAttention):
            out[pre + "relative_position_bias_table"] = ("trunc", 0.02)
            for lin in ("qkv", "proj"):
                fan_in = getattr(mod, lin).weight.shape[1]
                out[f"{pre}{lin}.weight"] = (
                    "trunc", math.sqrt(1.0 / fan_in) / _TRUNC_STD)
                out[f"{pre}{lin}.bias"] = ("zeros", None)
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


def make_state(seed: int, gains: dict, device) -> dict:
    """The live float32 state dict of ``RGBAModel`` for ``seed``, made on
    ``device`` in one draw per distribution; ``gains`` {"rgb", "mask"}:
    the gain on each encoder's last 1x1 convolution."""
    with torch.device("meta"):
        shapes = ref.RGBAModel()
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
    for k, (kind, arg) in kinds.items():
        shape = params[k].shape
        if kind == "zeros":
            state[k] = torch.zeros(shape, device=device)
        elif kind == "full":
            state[k] = torch.full(shape, arg, device=device)
        elif kind == "gdn_beta":
            state[k] = torch.full(shape, math.sqrt(1.0 + ref._PEDESTAL),
                                  device=device)
        elif kind == "gdn_gamma":
            state[k] = torch.sqrt(0.1 * torch.eye(shape[0], device=device)
                                  + ref._PEDESTAL)
        elif kind == "quantiles":
            q = torch.tensor([-arg, 0.0, arg], device=device)
            state[k] = q.reshape(1, 1, 3).repeat(shape[0], 1, 1)
    # make the model live: bias noise, DSE output biases, encoder gains
    biases = [k for k in state if k.endswith(".bias")]
    noise = torch.randn(sum(sizes[k] for k in biases), device=device,
                        generator=gen)
    for k, part in zip(biases, noise.split([sizes[k] for k in biases])):
        state[k] = state[k] + 0.02 * part.reshape(state[k].shape)
    for k in state:
        if k.endswith("output_conv.bias"):
            state[k] = torch.full_like(state[k], 0.5)
    for part, k in (("rgb", "rgb_codec.Encoder.x4.weight"),
                    ("mask", "mask_codec.EncoderMask.7.weight")):
        state[k] = state[k] * float(gains[part])
    return {k: state[k].contiguous() for k in params}


# --------------------------------------------------------------- inputs

def _smooth_noise(gen, b, h, w, device, octaves=3):
    img = torch.zeros(b, 3, h, w, device=device)
    for o in range(octaves):
        sh = max(2, h >> (octaves - o + 1))
        sw = max(2, w >> (octaves - o + 1))
        base = torch.rand(b, 3, sh, sw, device=device, generator=gen)
        base = torch.floor(base * 255.0) / 255.0
        up = F.interpolate(base, size=(h, w), mode="bilinear",
                           align_corners=False)
        img += up * 0.5 ** o
    img = img / (img.amax((1, 2, 3), keepdim=True) + 1e-6)
    return img.clamp(0.0, 1.0)


def _blob_alpha(gen, b, h, w, device, blobs=3):
    u = torch.rand(b, blobs, 4, device=device, generator=gen)
    cy, cx = (0.2 + 0.6 * u[..., 0]) * h, (0.2 + 0.6 * u[..., 1]) * w
    ry, rx = (0.1 + 0.25 * u[..., 2]) * h, (0.1 + 0.25 * u[..., 3]) * w
    yy = torch.arange(h, device=device, dtype=torch.float32)
    xx = torch.arange(w, device=device, dtype=torch.float32)
    d = ((yy[None, None, :, None] - cy[..., None, None]) / ry[..., None, None]) ** 2 \
        + ((xx[None, None, None, :] - cx[..., None, None]) / rx[..., None, None]) ** 2
    alpha = torch.clamp(1.5 - d, 0.0, 1.0).amax(1, keepdim=True)
    return torch.round(alpha * 255.0) / 255.0


def make_images(seed: int, n: int, h: int, w: int, device) -> dict:
    """``n`` RGBA images from ``seed``: "image" (n, h, w, 3) and "alpha"
    (n, h, w, 1) uint8 NHWC, and "masked_image" float32 (the RGB where the
    alpha is positive, else 0), all on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    img = _smooth_noise(gen, n, h, w, device)
    alpha = _blob_alpha(gen, n, h, w, device)
    image_u8 = torch.round(img * 255.0).to(torch.uint8)
    alpha_u8 = torch.round(alpha * 255.0).to(torch.uint8)
    masked = torch.where(alpha > 0, image_u8.float() / 255.0, alpha)
    nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
    return {"image": nhwc(image_u8), "alpha": nhwc(alpha_u8),
            "masked_image": nhwc(masked)}


# ----------------------------------------------------------- operations

def _meta_flops(fn, *shapes) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with torch.device("meta"):
        model = ref.RGBAModel()
        args = [torch.zeros(s) for s in shapes]
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            fn(model, *args)
    return counter.get_total_flops()


_DENSE = {}


def _dense(part: str, b: int, h: int, w: int) -> int:
    """Dense FLOPs of one part of the model on b images of h x w, every
    window alive, by ``torch.utils.flop_counter`` on the meta device."""
    key = (part, b, h, w)
    if key in _DENSE:
        return _DENSE[key]
    rgb, mask = (b, 3, h, w), (b, 1, h, w)
    y = (b, ref.M, h // 8, w // 8)
    zz = (b, ref.Z_CH, h // 64, w // 64)
    p = [(b, 1, h >> k, w >> k) for k in (1, 2, 3)]
    parts = {
        "mask_analysis": (lambda m, a: m.mask_codec.EncoderMask(a), mask),
        "mask_synthesis": (lambda m, t: m.mask_codec.DecoderMask(t), y),
        "rgb_analysis": (lambda m, x, a1, a2, a3: m.rgb_codec.Encoder(
            x, a2, a3), rgb, *p),
        "rgb_synthesis": (lambda m, t, a1, a2, a3: m.rgb_codec.Decoder(
            t, a2, a3), y, *p),
        "mask_h_a": (lambda m, t: m.mask_codec.h_a(t), y),
        "rgb_h_a": (lambda m, t: m.rgb_codec.h_a(t), y),
        "mask_h_s": (lambda m, t: (m.mask_codec.h_mean_s(t),
                                   m.mask_codec.h_scale_s(t)), zz),
        "rgb_h_s": (lambda m, t: (m.rgb_codec.h_mean_s(t),
                                  m.rgb_codec.h_scale_s(t)), zz),
        "mask_slices": (lambda m, t: _slices(m.mask_codec, t), y),
        "rgb_slices": (lambda m, t: _slices(m.rgb_codec, t), y),
        "mask_z": (lambda m, t: m.mask_codec.entropy_bottleneck(t), zz),
        "rgb_z": (lambda m, t: m.rgb_codec.entropy_bottleneck(t), zz),
    }
    fn, *shapes = parts[part]
    _DENSE[key] = _meta_flops(fn, *shapes)
    return _DENSE[key]


def _slices(codec, y):
    """The channel-AR head's slice transforms on latents y, with the hyper
    means and scales stood in by y."""
    sw = y.shape[1] // codec.slices
    y_hats = []
    for i in range(codec.slices):
        support = y_hats[:ref.MAX_SUPPORT]
        mu = codec.cc_mean_transforms[i](torch.cat([y] + support, 1))
        codec.cc_scale_transforms[i](torch.cat([y] + support, 1))
        y_hat = mu + codec.lrp_transforms[i](torch.cat([y] + support + [mu], 1))
        y_hats.append(y_hat[:, :sw])
    return y_hats


# (transform, channels, window, index in the alpha pyramid [H/2, H/4, H/8])
ATTENTION_SITES = (("analysis", 192, 8, 1), ("analysis", 80, 4, 2),
                   ("synthesis", 80, 4, 2), ("synthesis", 192, 8, 1))


def window_flops(c: int, ws: int) -> int:
    """One window's attention: the qkv and output projections, scores and
    the weighted sum (2 per multiply-add)."""
    n = ws * ws
    return 2 * n * c * 3 * c + 2 * 2 * n * n * c + 2 * n * c * c


def dead_windows(alpha, level: int, ws: int, shift: int) -> int:
    """Windows of level ``level`` of the alpha pyramid (H / 2^(level + 1))
    of the (B, 1, H, W) alpha whose alpha sums to 0 after the cyclic
    shift."""
    a = ref.pyramid(alpha.float())[level]
    if shift:
        a = torch.roll(a, (-shift, -shift), (2, 3))
    b, _, h, w = a.shape
    s = a.reshape(b, h // ws, ws, w // ws, ws).sum((2, 4))
    return int((s == 0).sum())


def attention_saved(alpha_enc, alpha_dec, transforms=("analysis",
                                                      "synthesis")) -> int:
    """FLOPs of the dead windows' attention, which the count leaves out:
    the analysis gated by ``alpha_enc``, the synthesis by ``alpha_dec``
    (both (B, 1, H, W))."""
    total = 0
    for where, c, ws, level in ATTENTION_SITES:
        if where not in transforms:
            continue
        alpha = alpha_enc if where == "analysis" else alpha_dec
        total += dead_windows(alpha, level, ws, ws // 2) * window_flops(c, ws)
    return total


def forward_flops(alpha, recon) -> int:
    """The eval forward of a batch: alpha the given (B, 1, H, W) alpha that
    gates the RGB analysis, recon the decoded one that gates the
    synthesis."""
    b, _, h, w = alpha.shape
    dense = sum(_dense(p, b, h, w) for p in (
        "mask_analysis", "mask_h_a", "mask_z", "mask_h_s", "mask_slices",
        "mask_synthesis", "rgb_analysis", "rgb_h_a", "rgb_z", "rgb_h_s",
        "rgb_slices", "rgb_synthesis"))
    return dense - attention_saved(alpha, recon)


def codec_flops(recon, coded_masks: int) -> int:
    """One encode and decode of a batch through the container, counted as
    the model's work: the encode runs the mask codec's analysis, hyper
    analysis, hyper synthesis, slices and synthesis (the decoded alpha
    gates the RGB codec) and the RGB codec's analysis, hyper analysis,
    hyper synthesis and slices; the decode runs both hyper syntheses and
    slice chains and both syntheses.  ``recon`` (B, 1, H, W) is the
    decoded alpha, which gates both RGB transforms; ``coded_masks`` the
    images that are not opaque."""
    b, _, h, w = recon.shape
    mask = coded_masks * (
        (_dense("mask_analysis", 1, h, w) + _dense("mask_h_a", 1, h, w))
        + 2 * (_dense("mask_h_s", 1, h, w) + _dense("mask_slices", 1, h, w)
               + _dense("mask_synthesis", 1, h, w)))
    rgb = (_dense("rgb_analysis", b, h, w) + _dense("rgb_h_a", b, h, w)
           + 2 * (_dense("rgb_h_s", b, h, w) + _dense("rgb_slices", b, h, w))
           + _dense("rgb_synthesis", b, h, w))
    return mask + rgb - attention_saved(recon, recon)


# ---------------------------------------------------------- kernel work

def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the card could take: the larger of the operations
    over the peak and the bytes over the memory rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def gate_chain_work(b: int, h: int, w: int, c: int, with_g: bool,
                    elem: int) -> tuple:
    """(FLOPs, bytes) of one gate-chain launch on b images of h x w
    pixels at c channels: two chains of three bottlenecks (1x1 to c/2,
    3x3, 1x1 back) and the final 1x1, 41 c^2 FLOPs a pixel; x (and g) read
    and the output written once, the weights once."""
    pix = b * h * w
    weights = 2 * 3 * (c * c + 9 * c * c / 4) + c * c
    nbytes = ((3 if with_g else 2) * pix * c * elem + weights * elem
              + 4 * (2 * 3 * (2 * c) + c))
    return pix * 41.0 * c * c, nbytes


def dse_work(b: int, h: int, w: int, cio: int, elem: int) -> tuple:
    """(FLOPs, bytes) of one DSE launch: 1x1 in and out at 32 filters and
    six 3x3 convolutions of 32 filters at full resolution."""
    pix = b * h * w
    flops = pix * (4.0 * cio * 32 + 6 * 2.0 * 9 * 32 * 32)
    nbytes = (2 * pix * cio * elem + (2 * cio * 32 + 6 * 9 * 1024) * elem
              + 4 * (32 + 6 * 32 + cio))
    return flops, nbytes


def forward_kernel_bounds(b: int, h: int, w: int, elem: int = 2,
                          peak: float = PEAK_BF16) -> dict:
    """Seconds of the bound of one eval forward's launches of each kernel:
    the gate chain at its eight sites (the RGB codec's four WinGate blocks
    with g, the mask codec's four Simplified blocks without; C=192 at
    H/4, C=80 at H/8, two of each) and the DSE at its two (RGB cio=3, mask
    cio=1)."""
    gate = 0.0
    for with_g in (True, False):
        for c, k in ((192, 2), (80, 3)):
            f, n = gate_chain_work(b, h >> k, w >> k, c, with_g, elem)
            gate += 2 * bound_s(f, n, peak)
    dse = sum(bound_s(*dse_work(b, h, w, cio, elem), peak) for cio in (3, 1))
    return {"gate_chain": gate, "dse": dse}
