"""What the reference computes for a cell: the eval forward of the joint
pipeline, and the round trip of the bitstream codec, from the same
inputs and the same state dict the program gets.

``forward`` follows the joint RGBA eval pipeline: the mask codec on the
given alpha, its decoded alpha clipped, rounded to 8 bits and cleaned by
``constraint_rgb``, then the RGB codec, whose encoder is gated by the
pyramid of the given alpha and whose decoder by that of the decoded one.

``codec`` follows the RGBA container: the mask codec codes the alpha of
every image that is not opaque; the decoded alpha (8 bits,
``constraint_rgb``; 1 for an opaque image) masks the RGB input and gates
both RGB transforms; the output is the decoded RGB and alpha rounded to
8 bits.  It gives each image's estimated bits beside: the code length of
its latents under the entropy models.
"""

from __future__ import annotations

import contextlib

import torch

from .model import constraint_rgb, pyramid, round8


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 on or off for convolutions and matrix products while the block
    runs (the reference is float32: off; the lower-precision control:
    on)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _codec_pass(codec, y):
    ent = codec.entropy(y)
    return ent["y_hat"], ent["y_bits"].sum((1, 2, 3)) + \
        ent["z_bits"].sum((1, 2, 3))


@torch.no_grad()
def forward(model, masked_image, alpha, block: int = 16) -> dict:
    """The eval forward on NHWC float inputs, ``block`` images at a time.
    Returns NHWC x_hat and recon_mask and the three rates of the whole
    batch (bits per pixel), all float32 on the inputs' device."""
    xs, recons, rgb_bits, mask_bits = [], [], [], []
    b, h, w, _ = masked_image.shape
    for s in range(0, b, block):
        x = masked_image[s:s + block].float().permute(0, 3, 1, 2)
        a = alpha[s:s + block].float().permute(0, 3, 1, 2)
        y_m, mb = _codec_pass(model.mask_codec, model.mask_codec.EncoderMask(a))
        recon = constraint_rgb(round8(model.mask_codec.DecoderMask(y_m)))
        me, md = pyramid(a), pyramid(round8(recon))
        y, rb = _codec_pass(model.rgb_codec,
                            model.rgb_codec.Encoder(x, me[1], me[2]))
        x_hat = model.rgb_codec.Decoder(y, md[1], md[2])
        xs.append(torch.clamp(x_hat, 0.0, 1.0).permute(0, 2, 3, 1))
        recons.append(recon.permute(0, 2, 3, 1))
        rgb_bits.append(rb)
        mask_bits.append(mb)
    pixels = b * h * w
    bpp_rgb = torch.cat(rgb_bits).sum() / pixels
    bpp_mask = torch.cat(mask_bits).sum() / pixels
    opaque = bool((alpha == 1.0).all())
    return {"x_hat": torch.cat(xs), "recon_mask": torch.cat(recons),
            "bpp": bpp_rgb + (0.0 if opaque else bpp_mask),
            "bpp_rgb": bpp_rgb, "bpp_mask": bpp_mask}


@torch.no_grad()
def codec(model, image_u8, alpha_u8, block: int = 16) -> dict:
    """The container's round trip of uint8 NHWC tensors whose sides are
    multiples of 64.  Returns "rgba" (B, H, W, 4) uint8 and "bits" (B,)
    float64: each image's estimated code length, both codecs."""
    b, h, w, _ = image_u8.shape
    if h % 64 or w % 64:
        raise ValueError("the reference codes sides that are multiples of 64")
    outs, est = [], []
    for s in range(0, b, block):
        x = image_u8[s:s + block].float().permute(0, 3, 1, 2) / 255.0
        a = alpha_u8[s:s + block].float().permute(0, 3, 1, 2) / 255.0
        n = x.shape[0]
        recon = torch.ones_like(a)
        nbits = torch.zeros(n, dtype=torch.float64, device=x.device)
        live = [i for i in range(n) if not bool((a[i] == 1.0).all())]
        if live:
            mc = model.mask_codec
            y_m, mb = _codec_pass(mc, mc.EncoderMask(a[live]))
            recon[live] = constraint_rgb(round8(mc.DecoderMask(y_m)))
            nbits[live] += mb.double()
        masked = torch.where(recon > 0, x, recon)
        p = pyramid(recon)
        y, rb = _codec_pass(model.rgb_codec,
                            model.rgb_codec.Encoder(masked, p[1], p[2]))
        rgb = torch.clamp(model.rgb_codec.Decoder(y, p[1], p[2]), 0.0, 1.0)
        rgba = torch.cat([rgb, recon], 1).permute(0, 2, 3, 1)
        outs.append(torch.round(rgba * 255.0).to(torch.uint8))
        est.append(nbits + rb.double())
    return {"rgba": torch.cat(outs), "bits": torch.cat(est)}
