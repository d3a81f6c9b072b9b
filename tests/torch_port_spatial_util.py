"""Rank functions of the height-sharding tests (tests/test_torch_port_spatial_*.py).

Each runs in every process of a gloo group started by
``rgba_tpu_torch.parallel.launch`` (``fn(mesh, *args)``), imports no JAX,
and returns what the test process compares: every rank makes the same
whole inputs from a seed, takes its band, and runs the banded op inside
``space_scope``; the unbanded op runs in the same process on the whole
input, or in the test process (against JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from rgba_tpu_torch.core.precision import DEFAULT_POLICY
from rgba_tpu_torch.parallel import spatial

CPU = dict(device="cpu")
OP_TOL = 1e-5     # rtol = atol of a banded op against the unbanded one, fp32

CHECKS = ("halo_zeros", "halo_none", "ring_up", "ring_down", "ring_nhwc",
          "gather_rows", "scatter_rows", "space_sum",
          "conv_k5s2", "conv_k3s1", "conv_1x1", "deconv_k5s2", "deconv_1x1",
          "gdn", "igdn", "gate_wingate", "gate_simplified", "dse_rgb",
          "dse_mask", "win_gate", "pyramid", "constraint_rgb")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _band(t, mesh, dim=-2):
    h = t.shape[dim] // mesh.space
    return t.narrow(dim, mesh.space_index * h, h)


def _grad(fn, x):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    g, = torch.autograd.grad(out, x)
    return out.detach(), g


def _cmp(got, want, exact=False):
    """got against want: ``ok`` when equal bit for bit (``exact``: copies
    and fixed-order arithmetic) or within OP_TOL (sums in another order)."""
    got, want = got.detach().float(), want.detach().float()
    d = (got - want).abs()
    ok = (bool(torch.equal(got, want)) if exact
          else bool((d <= OP_TOL + OP_TOL * want.abs()).all()))
    return {"max_abs": float(d.max()) if d.numel() else 0.0,
            "ref_max": float(want.abs().max()) if want.numel() else 0.0,
            "ok": ok}


def _merge(*parts):
    """Several comparisons as one: the worst of each measure."""
    return {"max_abs": max(p["max_abs"] for p in parts),
            "ref_max": max(p["ref_max"] for p in parts),
            "ok": all(p["ok"] for p in parts)}


def _weights(mesh, shape):
    """One random weight tensor per band (seeded by band): the rank's
    objective is sum(w[s] * its output)."""
    return [torch.randn(shape, generator=_gen(100 + s)) for s in range(mesh.space)]


def _adjoint(mesh, banded, whole, x, out_rows, exact=True, exact_grad=None):
    """banded(band) inside the scope against whole(x) on the whole input:
    the band's output equals ``out_rows(whole(x), s)``, and the band's
    gradient of its objective equals the band's rows of the gradient of
    the sum of every band's objective through ``whole`` (bit for bit with
    ``exact``, ``exact_grad``: the same by default)."""
    s = mesh.space_index
    with torch.no_grad():
        full = whole(x)
    w = [torch.randn(out_rows(full, r).shape, generator=_gen(100 + r))
         for r in range(mesh.space)]
    with spatial.space_scope(mesh):
        got, g_band = _grad(lambda t: (w[s] * banded(t)).sum(), _band(x, mesh))
        out_band = banded(_band(x, mesh))

    def total(t):
        full = whole(t)
        return sum((w[r] * out_rows(full, r)).sum() for r in range(mesh.space))
    _, g_whole = _grad(total, x)
    return _merge(_cmp(out_band, out_rows(whole(x), s), exact),
                  _cmp(g_band, _band(g_whole, mesh),
                       exact if exact_grad is None else exact_grad))


def _rows(mesh):
    """out_rows for an op whose band output of band r is rows
    [r * hb, (r + 1) * hb) of the whole output."""
    def out_rows(full, r):
        hb = full.shape[-2] // mesh.space
        return full.narrow(-2, r * hb, hb)
    return out_rows


def _module_check(mesh, m, x, extra=()):
    """A module's forward on the band against its rows of the module's
    forward on the whole input."""
    with torch.no_grad():
        want = m(x, *extra)
        with spatial.space_scope(mesh):
            got = m(_band(x, mesh), *[_band(e, mesh) for e in extra])
    return _cmp(got, _band(want, mesh))


def _gate_module(kind, c):
    from rgba_tpu_torch.ops import attention as att
    kw = dict(policy=DEFAULT_POLICY, generator=_gen(3), **CPU)
    m = (att.WinGateAttention(c, 4, 8, 4, **kw) if kind == "wingate"
         else att.SimplifiedAttention(c, **kw))
    _bias_noise(m, 4)
    return m


def _bias_noise(module, seed):
    g = _gen(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.add_(0.1 * torch.randn(p.shape, generator=g))


def ops_checks(mesh):
    """Every check of CHECKS on this rank's band: {name: comparison}."""
    from rgba_tpu_torch.ops import conv, enhance, gdn, morphology
    from rgba_tpu_torch.ops import attention as att
    from rgba_tpu_torch.ops.mask_pyramid import mask_pyramid

    torch.manual_seed(0)
    b, c, hh, w = 2, 8, 64, 24
    x = torch.randn(b, c, hh, w, generator=_gen(1))
    rows = _rows(mesh)
    n, o = mesh.space, mesh.space_index
    out = {}

    def padded(t, a, z):
        return torch.nn.functional.pad(t, (0, 0, a, z))

    def halo_rows(a, z, edges):
        def out_rows(full, r):
            hb = hh // n
            if edges == "zeros":
                return full.narrow(-2, r * hb, hb + a + z)
            lo, hi = max(r * hb - a, 0), min((r + 1) * hb + z, hh)
            return full.narrow(-2, lo, hi - lo)
        whole = (lambda t: padded(t, a, z)) if edges == "zeros" else \
            (lambda t: t)
        return out_rows, whole

    for name, (a, z, edges) in (("halo_zeros", (2, 1, "zeros")),
                                ("halo_none", (3, 3, "none"))):
        out_rows, whole = halo_rows(a, z, edges)
        out[name] = _adjoint(mesh, lambda t: spatial.halo(t, a, z,
                                                          edges=edges),
                             whole, x, out_rows)
    for name, k in (("ring_up", -3), ("ring_down", 2)):
        out[name] = _adjoint(mesh, lambda t: spatial.roll(t, k, 2),
                             lambda t: torch.roll(t, k, 2), x, rows)
    xn = x.permute(0, 2, 3, 1).contiguous()      # NHWC, height on dim 1

    def rows_nhwc(full, r):
        hb = full.shape[1] // n
        return full.narrow(1, r * hb, hb)
    with spatial.space_scope(mesh):
        got, g_band = _grad(lambda t: (_weights(mesh, (b, hh // n, w, c))[o]
                                       * spatial.roll(t, -4, 1)).sum(),
                            _band(xn, mesh, 1))
    ws_ = _weights(mesh, (b, hh // n, w, c))
    _, g_whole = _grad(lambda t: sum(
        (ws_[r] * rows_nhwc(torch.roll(t, -4, 1), r)).sum()
        for r in range(n)), xn)
    with spatial.space_scope(mesh):
        fwd = spatial.roll(_band(xn, mesh, 1), -4, 1)
    out["ring_nhwc"] = _merge(
        _cmp(fwd, rows_nhwc(torch.roll(xn, -4, 1), o), True),
        _cmp(g_band, _band(g_whole, mesh, 1), True))
    # the backward sums the ranks' gradients in the all-reduce's order
    out["gather_rows"] = _adjoint(mesh, spatial.gather_rows, lambda t: t, x,
                                  lambda full, r: full, exact_grad=False)
    # scatter_rows: a replicated tensor's band rows; its adjoint puts each
    # band's gradient back in its rows
    wsc = _weights(mesh, (b, c, hh // n, w))
    with spatial.space_scope(mesh):
        got, g = _grad(lambda t: (wsc[o] * spatial.scatter_rows(t)).sum(), x)
    want_g = torch.zeros_like(x)
    want_g.narrow(-2, o * (hh // n), hh // n).copy_(wsc[o])
    out["scatter_rows"] = _merge(_cmp(spatial.scatter_rows(x, mesh=mesh),
                                      _band(x, mesh), True),
                                 _cmp(g, want_g, True))
    v = torch.arange(3.0) + 10.0 * o
    with spatial.space_scope(mesh):
        got, g = _grad(lambda t: (spatial.space_sum(t) * (o + 1.0)).sum(), v)
    out["space_sum"] = _merge(
        _cmp(got, sum((torch.arange(3.0) + 10.0 * r).sum() * (o + 1.0)
                      for r in range(n)), True),
        _cmp(g, torch.full((3,), sum(r + 1.0 for r in range(n))), True))

    kw = dict(policy=DEFAULT_POLICY, generator=_gen(2), **CPU)
    for name, m in (
            ("conv_k5s2", conv.Conv(c, 12, 5, 2, **kw)),
            ("conv_k3s1", conv.Conv(c, 12, 3, 1, **kw)),
            ("conv_1x1", conv.Conv(c, 12, 1, 1, **kw)),
            ("deconv_k5s2", conv.ConvTranspose(c, 12, 5, 2, **kw)),
            ("deconv_1x1", conv.ConvTranspose(c, 12, 1, 1, padding=0,
                                              output_padding=0, **kw))):
        _bias_noise(m, 5)
        out[name] = _adjoint(mesh, m, m, x, rows, exact=False)
    xg = torch.rand(b, 16, hh, w, generator=_gen(6)) - 0.3
    for name, inverse in (("gdn", False), ("igdn", True)):
        m = gdn.GDN(16, inverse=inverse, policy=DEFAULT_POLICY, **CPU)
        out[name] = _module_check(mesh, m, xg)
    g16 = torch.randn(b, 16, hh, w, generator=_gen(7))
    for name, kind in (("gate_wingate", "wingate"),
                       ("gate_simplified", "simplified")):
        m = _gate_module(kind, 16)
        extra = (g16,) if kind == "wingate" else ()
        with torch.no_grad():
            want = m.gate(xg, *extra)
            with spatial.space_scope(mesh):
                got = m.banded(_band(xg, mesh),
                               *[_band(e, mesh) for e in extra])
        out[name] = _cmp(got, _band(want, mesh))
    for name, cio, leaky in (("dse_rgb", 3, False), ("dse_mask", 1, True)):
        m = enhance.DSE(cio, leaky=leaky, **kw)
        _bias_noise(m, 8)
        xd = torch.rand(b, cio, hh, w, generator=_gen(9))
        out[name] = _module_check(mesh, m, xd)
    m = att.WinGateAttention(16, 4, 8, 4, **kw)
    alpha = (torch.rand(b, 1, hh, w, generator=_gen(10)) > 0.5).float()
    alpha[:, :, :, : w // 2] = 0.0     # dead windows too
    out["win_gate"] = _module_check(mesh, m, xg, extra=(alpha,))

    # the alpha pyramid and the cleanup: bit for bit
    a = torch.round(torch.rand(b, 1, hh, w, generator=_gen(11)) * 3) / 3
    with spatial.space_scope(mesh):
        levels = mask_pyramid(_band(a, mesh))
    whole = mask_pyramid(a)
    out["pyramid"] = _merge(*[_cmp(lv, _band(wl, mesh), True)
                              for lv, wl in zip(levels, whole)])
    out["pyramid"]["levels"] = len(levels)
    m = (torch.rand(b, 1, hh, w, generator=_gen(12)) > 0.5).float()
    m *= torch.randint(1, 256, m.shape, generator=_gen(13)) / 255.0
    hb = hh // n
    for r in range(1, n):     # isolated pixels on both sides of each cut
        m[:, :, r * hb - 2:r * hb + 2, 3:6] = 1.0
        m[:, :, r * hb - 1, 4] = 0.0
        m[:, :, r * hb - 2:r * hb + 2, 10:13] = 0.0
        m[:, :, r * hb, 11] = 0.5
    with spatial.space_scope(mesh):
        got = morphology.constraint_rgb(_band(m, mesh))
    out["constraint_rgb"] = _cmp(got, _band(morphology.constraint_rgb(m),
                                            mesh), True)
    return out


# ------------------------------------------------------------ models

WIN_GATE = dict(dim=32, heads=4, window=8, shift=4, batch=4, size=32)
MASK_SIZE, PIPE_HW, MODEL_BATCH = 128, (64, 128), 2


def win_gate_inputs():
    """x (B, H, W, C) and a binary alpha (B, H, W, 1), NHWC numpy, as
    ``tests/test_spatial_sharding.py`` shapes them."""
    rng = np.random.RandomState(0)
    b, s, c = WIN_GATE["batch"], WIN_GATE["size"], WIN_GATE["dim"]
    x = rng.randn(b, s, s, c).astype(np.float32)
    alpha = (rng.rand(b, s, s, 1) > 0.4).astype(np.float32)
    return x, alpha


def make_win_gate():
    from rgba_tpu_torch.ops.attention import WinGateAttention
    g = WIN_GATE
    return WinGateAttention(g["dim"], g["heads"], g["window"], g["shift"],
                            policy=DEFAULT_POLICY, generator=_gen(4), **CPU)


def _liven(named_parameters, scale_weight):
    """Seeded bias noise, DSE output biases at 0.5 and a gain of 10 on the
    encoder's last 1x1 conv: latents over several bins and an x_hat inside
    [0, 1], so that the comparisons below compare something."""
    g = _gen(1)
    with torch.no_grad():
        for name, p in named_parameters:
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            if name.endswith("output_conv.bias"):
                p.fill_(0.5)
        for w in scale_weight:
            w.mul_(10.0)


def make_mask_codec(live: bool):
    """The mask codec, at its random init (``live=False``, as
    ``tests/test_spatial_sharding.py`` runs it) or made live."""
    from rgba_tpu_torch.models.mask_codec import MaskCodec
    m = MaskCodec(policy=DEFAULT_POLICY, generator=_gen(0), **CPU)
    if live:
        _liven(m.named_parameters(), [m.EncoderMask[7].weight])
    return m.eval()


def mask_input():
    rng = np.random.RandomState(1)
    return (rng.rand(MODEL_BATCH, MASK_SIZE, MASK_SIZE, 1) > 0.5).astype(
        np.float32)


def make_pipeline():
    from rgba_tpu_torch.models.pipeline import RGBAPipeline
    p = RGBAPipeline(DEFAULT_POLICY, device="cpu", seed=0)
    _liven(p.named_parameters(), [p.rgb_codec.Encoder.x4.weight,
                                  p.mask_codec.EncoderMask[7].weight])
    return p


def pipeline_inputs():
    from rgba_tpu_torch.data.synthetic import synthetic_rgba_batch
    d = synthetic_rgba_batch(MODEL_BATCH, *PIPE_HW, seed=5)
    return d["masked_image"], d["alpha"]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def win_gate_band(mesh, stale_regions: bool = False):
    """The band of ``WinGateAttention`` on ``win_gate_inputs`` (NCHW).
    ``stale_regions``: the fault of keying the region ids on the band's
    own shape, as if the band were the whole image (every band then takes
    the wrap labels of the image's last rows)."""
    from rgba_tpu_torch.ops import attention
    if stale_regions:
        real = attention.MaskedWinBlock._static

        def stale(self, kind, h, w, b, device, offset=0, global_h=0):
            return real(self, kind, h, w, b, device)
        attention.MaskedWinBlock._static = stale
    m = make_win_gate()
    x, alpha = win_gate_inputs()
    with torch.no_grad(), spatial.space_scope(mesh):
        return m(_band(_nchw(x), mesh), _band(_nchw(alpha), mesh))


def model_bands(mesh):
    """The bands of ``WinGateAttention``, ``MaskCodec`` (eval) and
    ``RGBAPipeline`` on their seeded inputs, with the scalars."""
    out = {"win_gate": win_gate_band(mesh)}
    for live in (False, True):
        m = make_mask_codec(live)
        with torch.inference_mode(), spatial.space_scope(mesh):
            r = m(_band(_nchw(mask_input()), mesh))
        out[f"mask_codec_{'live' if live else 'init'}"] = {
            k: r[k] for k in ("x_hat", "bpp", "bpp_y", "bpp_z", "mse_loss")}
    p = make_pipeline()
    x, a = pipeline_inputs()
    with spatial.space_scope(mesh):
        r = p(_band(torch.from_numpy(x), mesh, 1),
              _band(torch.from_numpy(a), mesh, 1))
    out["pipeline"] = dict(r)
    return out
