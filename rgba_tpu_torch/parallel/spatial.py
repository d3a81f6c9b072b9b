"""Height (``space``) sharding: the exchanges that GSPMD inserts in the JAX
package, written by hand.

The JAX package shards image height over the ``space`` axis of a 2-D
(``space``, ``data``) mesh (``__graft_entry__.dryrun_multichip``) and lets
GSPMD insert the convolutions' halo exchanges, the cyclic shift's
collective permute and the entropy head's all-gather.  PyTorch has none of
that; this module is its counterpart over ``torch.distributed``.

Geometry.  ``space`` cuts H into S equal contiguous bands, band s on the
rank at space index s of a ``ProcessMesh`` (``parallel/mesh.py``).  Every
scale of the model keeps the split: a band of h rows at some scale holds
rows [s*h, (s+1)*h) of a global height of S*h there.  A band is a multiple
of 32 rows at full resolution and H a multiple of 64 (``check_band``): the
shifted windows, 8 rows at H/4 and 4 rows at H/8, must not straddle bands.

Scope.  Inside ``space_scope(mesh)`` the model's modules are band-aware
(``ops/conv.py``, ``ops/attention.py``, ``ops/enhance.py``,
``ops/mask_pyramid.py``, ``ops/morphology.py``, ``models/*``); outside it,
or with S = 1, nothing changes.  ``suspended()`` runs replicated code, the
entropy head on the whole latent, unbanded inside it.  Only forward passes
read the scope: each exchange keeps its mesh for its backward.

Gradients.  Each exchange is an ``autograd.Function`` whose backward is its
adjoint under one convention: the objective of a space group is the sum of
its ranks' objectives.  A halo's rows send their gradient back to their
owner, who adds it to its edge rows; the ring shift's backward is the
inverse shift; ``gather_rows`` (the whole tensor on every rank) sums the
ranks' gradients and keeps the band's rows; ``scatter_rows`` (the band's
rows of a replicated tensor) puts the band's gradient back in its rows;
``space_sum`` sums forward and backward.  A replicated scalar (a global
loss) that every rank back-propagates therefore gives the parameters S
times its gradient, summed over the group; DDP's mean over the whole world
(S x D ranks) turns that into the mean over the ``data`` axis
(``train/loops.py``).

Transport.  Halo and shift rows go by ``batch_isend_irecv`` between
neighbours.  gloo's point-to-point operations read and write host memory,
so over a gloo group CUDA rows are staged through the host (``staged``);
gloo's all-reduce and all-gather take CUDA tensors themselves.  NCCL moves
them card to card.  Two ranks on one card must use gloo: NCCL refuses two
ranks on one device.  ``traffic`` counts the bytes this process sends and
the host seconds its exchanges take (with NCCL the seconds are enqueue
time: the copies run on the card).
"""

from __future__ import annotations

import contextlib
import contextvars
import time

import torch
import torch.distributed as dist

BAND_MULTIPLE = 32     # rows of a band at full resolution
HEIGHT_MULTIPLE = 64   # rows of the image

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "rgba_tpu_torch_space", default=None)


@contextlib.contextmanager
def space_scope(mesh):
    """The model's modules run on bands of ``mesh``'s space axis while the
    scope is open (a ``ProcessMesh``; one of space size 1, or None, changes
    nothing)."""
    token = _CURRENT.set(mesh if mesh is not None and mesh.space > 1
                         else None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def suspended():
    """Unbanded inside an open scope: for replicated code (the entropy head
    on the gathered latent)."""
    token = _CURRENT.set(None)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current():
    """The mesh whose bands the modules run on, or None."""
    return _CURRENT.get()


def check_band(h: int, mesh=None) -> None:
    """Raises ValueError unless a full-resolution band of ``h`` rows and
    the image it belongs to fit the geometry above."""
    mesh = mesh if mesh is not None else current()
    if mesh is None:
        return
    gh = h * mesh.space
    if h % BAND_MULTIPLE or gh % HEIGHT_MULTIPLE:
        raise ValueError(
            f"height sharding needs bands of a multiple of {BAND_MULTIPLE} "
            f"rows and an image height of a multiple of {HEIGHT_MULTIPLE}: "
            f"a band of {h} rows over {mesh.space} bands (H = {gh})")


def global_height(h: int) -> int:
    """The image's height at the scale of a band of ``h`` rows."""
    mesh = current()
    return h if mesh is None else h * mesh.space


def band_offset(h: int) -> int:
    """The band's first row in the image at the scale of ``h`` rows."""
    mesh = current()
    return 0 if mesh is None else h * mesh.space_index


def is_first() -> bool:
    mesh = current()
    return mesh is None or mesh.space_index == 0


# ------------------------------------------------------------ transport


class Traffic:
    """What this process's exchanges sent: point-to-point bytes (halos and
    ring shifts), collective bytes (gathers and sums) and host seconds."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.p2p_bytes = 0
        self.collective_bytes = 0
        self.seconds = 0.0

    def as_dict(self) -> dict:
        return {"p2p_bytes": self.p2p_bytes,
                "collective_bytes": self.collective_bytes,
                "seconds": self.seconds}


traffic = Traffic()


@contextlib.contextmanager
def _timed(collective_bytes: int = 0):
    t = time.perf_counter()
    try:
        yield
    finally:
        traffic.collective_bytes += collective_bytes
        traffic.seconds += time.perf_counter() - t


def staged(mesh, device) -> bool:
    """Rows on a CUDA device go through the host over a gloo group: gloo's
    point-to-point operations address host memory."""
    return torch.device(device).type == "cuda" and mesh.space_backend == "gloo"


def _swap(mesh, sends, recvs):
    """Point-to-point exchange over the space group.  sends: [(tensor,
    band)], recvs: [((shape, dtype, device), band)]; returns the received
    tensors in order.  Every pair of bands holds at most one message each
    way."""
    with _timed():
        ops, out = [], []
        for t, band in sends:
            t = (t.cpu() if staged(mesh, t.device) else t).contiguous()
            traffic.p2p_bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, mesh.space_ranks[band],
                                  mesh.space_group))
        for (shape, dtype, device), band in recvs:
            buf = torch.empty(shape, dtype=dtype, device="cpu" if staged(
                mesh, device) else device)
            out.append((buf, device))
            ops.append(dist.P2POp(dist.irecv, buf, mesh.space_ranks[band],
                                  mesh.space_group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [buf.to(device) for buf, device in out]


def _rows_shape(t, dim: int, n: int):
    shape = list(t.shape)
    shape[dim] = n
    return tuple(shape)


def _spec(t, dim, n):
    return (_rows_shape(t, dim, n), t.dtype, t.device)


def _memory_like(out, x):
    """``out`` in ``x``'s memory format (the kernels read NHWC views of
    channels_last NCHW tensors without a copy)."""
    if (x.dim() == 4 and not x.is_contiguous()
            and x.is_contiguous(memory_format=torch.channels_last)):
        return out.contiguous(memory_format=torch.channels_last)
    return out


def halo_rows(mesh, x, above: int, below: int, dim: int):
    """The rows a band needs from its neighbours: the last ``above`` rows
    of the band above and the first ``below`` rows of the band below (None
    at the image's top and bottom)."""
    s, n = mesh.space_index, mesh.space
    sends, recvs, want = [], [], []
    if s > 0:
        if below:
            sends.append((x.narrow(dim, 0, below), s - 1))
        if above:
            recvs.append((_spec(x, dim, above), s - 1))
            want.append("above")
    if s < n - 1:
        if above:
            sends.append((x.narrow(dim, x.shape[dim] - above, above), s + 1))
        if below:
            recvs.append((_spec(x, dim, below), s + 1))
            want.append("below")
    got = dict(zip(want, _swap(mesh, sends, recvs)))
    return got.get("above"), got.get("below")


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, above, below, dim, zero_edges):
        up, down = halo_rows(mesh, x, above, below, dim)
        if zero_edges:
            up = up if up is not None or not above else x.new_zeros(
                _rows_shape(x, dim, above))
            down = down if down is not None or not below else x.new_zeros(
                _rows_shape(x, dim, below))
        parts = [t for t in (up, x, down) if t is not None]
        ctx.mesh, ctx.dim = mesh, dim
        ctx.above, ctx.below = above, below
        ctx.top = 0 if up is None else up.shape[dim]
        ctx.h = x.shape[dim]
        return _memory_like(torch.cat(parts, dim), x)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, h = ctx.mesh, ctx.dim, ctx.h
        s, n = mesh.space_index, mesh.space
        gx = g.narrow(dim, ctx.top, h).clone()
        sends, recvs, want = [], [], []
        # the gradient of the rows a neighbour lent goes back to it; the
        # gradient of the rows this band lent comes back from them
        if s > 0:
            if ctx.above:
                sends.append((g.narrow(dim, 0, ctx.above), s - 1))
            if ctx.below:
                recvs.append((_spec(g, dim, ctx.below), s - 1))
                want.append("top")
        if s < n - 1:
            if ctx.below:
                sends.append((g.narrow(dim, ctx.top + h, ctx.below), s + 1))
            if ctx.above:
                recvs.append((_spec(g, dim, ctx.above), s + 1))
                want.append("bottom")
        got = dict(zip(want, _swap(mesh, sends, recvs)))
        if "top" in got:
            gx.narrow(dim, 0, ctx.below).add_(got["top"])
        if "bottom" in got:
            gx.narrow(dim, h - ctx.above, ctx.above).add_(got["bottom"])
        return gx, None, None, None, None, None


def halo(x, above: int, below: int, dim: int = -2, edges: str = "zeros"):
    """x's band extended by ``above`` rows of the band above and ``below``
    rows of the band below.  At the image's top and bottom ``edges``
    "zeros" adds zero rows (a linear convolution's own padding), "none"
    adds nothing (a chain of convolutions that pads each layer itself).
    Outside a scope: x, or x zero-padded with ``edges="zeros"``."""
    mesh = current()
    dim = dim % x.dim()
    if mesh is None:
        if edges == "none" or not (above or below):
            return x
        pad = [0, 0] * (x.dim() - 1 - dim) + [above, below]
        return torch.nn.functional.pad(x, pad)
    if max(above, below) > x.shape[dim]:
        raise ValueError(f"a halo of {max(above, below)} rows needs a band "
                         f"of as many rows, not {x.shape[dim]}")
    return _Halo.apply(x, mesh, above, below, dim, edges == "zeros")


def extend(x, rows: int, dim: int = -2):
    """(x's band with ``rows`` rows of each neighbour and none past the
    image's edges, the number of rows added at the top): the input of a
    chain of ``rows`` 3x3 convolutions whose own zero padding acts at the
    image's edges; ``crop`` takes the band back out of its result."""
    return halo(x, rows, rows, dim, edges="none"), \
        0 if is_first() else rows


def crop(y, top: int, h: int, dim: int = -2):
    return y if y.shape[dim] == h else y.narrow(dim, top, h)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, shift, dim):
        ctx.mesh, ctx.shift, ctx.dim = mesh, shift, dim
        return _ring(mesh, x, shift, dim)

    @staticmethod
    def backward(ctx, g):
        return _ring(ctx.mesh, g, -ctx.shift, ctx.dim), None, None, None


def _ring(mesh, x, shift: int, dim: int):
    """torch.roll(x, shift, dim) of the whole image on its bands: the band
    keeps h - |shift| of its rows and takes |shift| rows from the next band
    up or down the ring (the last band's wrap from band 0 among them)."""
    s, n, h = mesh.space_index, mesh.space, x.shape[dim]
    k = abs(shift)
    if k > h:
        raise ValueError(f"a shift of {k} rows needs bands of as many rows, "
                         f"not {h}")
    if shift < 0:     # rows move up: the first k go to the band above
        got, = _swap(mesh, [(x.narrow(dim, 0, k), (s - 1) % n)],
                     [(_spec(x, dim, k), (s + 1) % n)])
        out = torch.cat([x.narrow(dim, k, h - k), got], dim)
    else:             # rows move down: the last k go to the band below
        got, = _swap(mesh, [(x.narrow(dim, h - k, k), (s + 1) % n)],
                     [(_spec(x, dim, k), (s - 1) % n)])
        out = torch.cat([got, x.narrow(dim, 0, h - k)], dim)
    return _memory_like(out, x)


def roll(x, shift: int, dim: int):
    """``torch.roll(x, shift, dim)`` over the image's rows: on the bands in
    a scope (``dim`` is the height axis), plain outside it."""
    mesh = current()
    if mesh is None or shift == 0:
        return torch.roll(x, shift, dim)
    return _RingShift.apply(x, mesh, shift, dim % x.dim())


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.h = mesh, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.space)]
        with _timed(x.numel() * x.element_size()):
            dist.all_gather(parts, x, group=mesh.space_group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        _all_reduce(g, ctx.mesh)
        return (g.narrow(ctx.dim, ctx.mesh.space_index * ctx.h, ctx.h),
                None, None)


def gather_rows(x, dim: int = -2):
    """The whole image's rows on every rank of the space group (a copy of
    each band); backward: the ranks' gradients summed, the band's rows
    kept.  Outside a scope: x."""
    mesh = current()
    if mesh is None:
        return x
    return _GatherRows.apply(x, mesh, dim % x.dim())


def _all_reduce(t, mesh) -> None:
    with _timed(t.numel() * t.element_size()):
        dist.all_reduce(t, group=mesh.space_group)


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        h = x.shape[dim] // mesh.space
        ctx.dim, ctx.full, ctx.start = dim, x.shape, mesh.space_index * h
        return x.narrow(dim, ctx.start, h).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.full)
        out.narrow(ctx.dim, ctx.start, g.shape[ctx.dim]).copy_(g)
        return out, None, None


def scatter_rows(x, dim: int = -2, mesh=None):
    """The band's rows of a tensor replicated over the space group (the
    whole image's rows on every rank); backward: the band's gradient in its
    rows, zero elsewhere.  Without a mesh (outside a scope): x."""
    mesh = mesh if mesh is not None else current()
    if mesh is None:
        return x
    return _ScatterRows.apply(x, mesh, dim % x.dim())


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        out = x.clone()
        _all_reduce(out, mesh)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        _all_reduce(g, ctx.mesh)
        return g, None


def space_sum(x):
    """The sum of x over the bands (each rank's x a partial sum of its
    band), on every rank; outside a scope: x."""
    mesh = current()
    if mesh is None:
        return x
    return _SpaceSum.apply(x, mesh)


def mean(x):
    """The whole image's mean of a banded tensor: ``x.mean()`` outside a
    scope."""
    mesh = current()
    if mesh is None:
        return x.mean()
    return space_sum(x.sum()) / (x.numel() * mesh.space)
