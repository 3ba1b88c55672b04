"""Spatial partitioning: image height over the spatial axis of the mesh, the
port of ``supervised_dispnet_tpu/training/train_step.py::_spatial_constrain``
and the halo exchanges that GSPMD inserts for it.

The steps keep, of each image (and its depth and mask), the band of rows
that this rank's spatial rank owns (``shard_rows``), and every op with a
spatial window takes the rows it reads from the ranks above and below
(``halo``). So each rank's activations shrink with the number of shards,
and the step computes what it computes on whole images.

**Rows.** The split is made at the deepest level, the stride-``max_stride``
map: its D = H / max_stride rows go to the S shards as evenly as the count
allows (the first D mod S shards take one more), and at a level of stride
max_stride / s a shard owns s times its deep rows. So the boundaries line
up at every level, and a strided op's output rows are exactly the rows of
its input's owner. The guard ``H >= max_stride * S`` (at least one deep row a
shard; JAX's, below which its partitioner silently degraded the gradients)
and ``H % max_stride == 0`` raise ``ValueError`` before any collective.

**Halo.** ``halo(x, top, bottom, pad)`` returns a rank's rows with ``top``
rows of the rank above and ``bottom`` rows of the rank below, in one
all-gather of the edge rows over the spatial group (``Mesh.exchange``; it
runs on gloo and NCCL alike, CPU or card). At the image's own top and
bottom it adds ``pad`` rows (zeros for a conv, -inf for a max-pool) or,
with ``pad=None``, none: the op then meets the image edge as it does on a
whole image. Its backward sends each halo row's gradient back in one more
all-gather and adds it to the row it came from. The ops here take halos by
their geometry: a conv of kernel k, stride s and padding p reads p rows
above and k - s - p below (the 7x7/2 stem: 3 and 2), a transposed conv
(k - 1 - p) // s above and (p - 1 + s) // s below, and the bilinear 2^n
upsample and the fused decoder stage one row each side, at the input's
resolution.

Outside a step on a mesh with a spatial axis (``active``), every function
here is the plain op, called as it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.modules.utils import _pair

from supervised_dispnet_tpu_torch.parallel.mesh import Mesh, active_mesh

DEFAULT_MAX_STRIDE = 32


def active() -> Mesh | None:
    """The mesh of the running step when it has a spatial axis, else None."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.spatial > 1 else None


def max_stride(model: torch.nn.Module) -> int:
    """The deepest feature map's stride: 128 for DispNetS and the pose nets
    (seven stride-2 stages), 32 for the ResNet, VGG and FCRN encoders (the
    JAX package's ``_model_max_stride``)."""
    return getattr(model, "max_stride", DEFAULT_MAX_STRIDE)


def check_height(height: int, stride: int, shards: int) -> None:
    """The guard: at least one row of the deepest map a shard, and whole
    deep rows. Raises ``ValueError``."""
    if height < stride * shards:
        raise ValueError(
            f"spatial partitioning needs height {height} >= max_stride {stride} * spatial "
            f"shards {shards} (>= 1 row per shard at the deepest conv level); lower "
            "--spatial-shards or raise the input height")
    if height % stride:
        raise ValueError(
            f"spatial partitioning needs a height divisible by max_stride {stride}, got "
            f"{height}: the shards' rows line up at every level only then")


def deep_split(rows: int, shards: int) -> list[tuple[int, int]]:
    """``rows`` deep rows over ``shards``: each shard's [start, stop), the
    first ``rows % shards`` one row longer."""
    q, extra = divmod(rows, shards)
    bounds, at = [], 0
    for r in range(shards):
        n = q + (r < extra)
        bounds.append((at, at + n))
        at += n
    return bounds


def shard_rows(height: int, stride: int, mesh: Mesh) -> slice:
    """This rank's rows of an image of ``height`` rows (after the guard)."""
    check_height(height, stride, mesh.spatial)
    a, b = deep_split(height // stride, mesh.spatial)[mesh.spatial_rank]
    return slice(a * stride, b * stride)


def _fill(x: torch.Tensor, rows: int, pad: str | None) -> torch.Tensor:
    """``rows`` rows of ``pad`` in ``x``'s batch, channels and width."""
    if pad is None or rows == 0:
        return x[:, :, :0]
    value = {"zeros": 0.0, "neg_inf": float("-inf")}[pad]
    return x.new_full((x.shape[0], x.shape[1], rows, x.shape[3]), value)


class _Halo(torch.autograd.Function):
    """``x``'s rows with ``top`` rows of the rank above and ``bottom`` of the
    rank below (``pad`` at the image's top and bottom); its backward adds
    each halo row's gradient to the row it came from, on its rank."""

    @staticmethod
    def forward(ctx, x, mesh, top, bottom, pad):
        n, r, last = x.shape[2], mesh.spatial_rank, mesh.spatial - 1
        if n < max(top, bottom):
            raise RuntimeError(f"spatial partitioning: a halo of {top} + {bottom} rows "
                               f"reaches past a neighbour's {n} rows")
        parts = mesh.exchange(torch.cat([x[:, :, :bottom], x[:, :, n - top:]], dim=2))
        above = parts[r - 1][:, :, bottom:] if r > 0 else _fill(x, top, pad)
        below = parts[r + 1][:, :, :bottom] if r < last else _fill(x, bottom, pad)
        ctx.mesh, ctx.top, ctx.bottom, ctx.n = mesh, top, bottom, n
        ctx.added = above.shape[2]
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g):
        mesh, top, bottom, n = ctx.mesh, ctx.top, ctx.bottom, ctx.n
        r, last = mesh.spatial_rank, mesh.spatial - 1
        g_x = g[:, :, ctx.added:ctx.added + n].clone()
        # the rows this rank took from its neighbours, sent back: zeros where
        # they were padding (the image's edges)
        g_above = g[:, :, :top] if r > 0 else g.new_zeros(*g.shape[:2], top, g.shape[3])
        g_below = (g[:, :, ctx.added + n:] if r < last
                   else g.new_zeros(*g.shape[:2], bottom, g.shape[3]))
        parts = mesh.exchange(torch.cat([g_above, g_below], dim=2))
        if r < last and top:
            g_x[:, :, n - top:] += parts[r + 1][:, :, :top]
        if r > 0 and bottom:
            g_x[:, :, :bottom] += parts[r - 1][:, :, top:]
        return g_x, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, pad: str | None,
         mesh: Mesh | None = None) -> torch.Tensor:
    """NCHW ``x`` (this rank's rows) with ``top`` rows of the rank above and
    ``bottom`` rows of the rank below; at the image's top and bottom ``pad``
    rows ("zeros" or "neg_inf"), or none for ``pad=None``. No exchange (and
    ``x`` itself) where both are 0."""
    mesh = mesh or active()
    if mesh is None or top == bottom == 0:
        return x
    return _Halo.apply(x, mesh, top, bottom, pad)


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
           stride=1, padding=0, dilation=1, groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` over this rank's rows: the halo the window needs (zeros
    at the image's edges), then the conv unpadded along the height."""
    mesh = active()
    if mesh is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    (sh, sw), (ph, pw), (dh, dw) = _pair(stride), _pair(padding), _pair(dilation)
    k = dh * (weight.shape[2] - 1) + 1
    xh = halo(x, ph, max(k - sh - ph, 0), "zeros", mesh)
    y = F.conv2d(xh, weight, bias, (sh, sw), (0, pw), (dh, dw), groups)
    return y[:, :, : x.shape[2] // sh]


def conv_transpose2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                     stride=1, padding=0, output_padding=0, groups: int = 1,
                     dilation=1) -> torch.Tensor:
    """``F.conv_transpose2d`` over this rank's rows, for a transposed conv
    whose output is ``stride`` times its input: the input rows that reach
    this rank's output rows (zeros past the image), the full transposed
    conv along the height, and this rank's rows of it."""
    mesh = active()
    if mesh is None:
        return F.conv_transpose2d(x, weight, bias, stride, padding, output_padding, groups,
                                  dilation)
    (sh, sw), (ph, pw), (oh, ow), (dh, dw) = (_pair(stride), _pair(padding),
                                              _pair(output_padding), _pair(dilation))
    k = dh * (weight.shape[2] - 1) + 1
    if k + oh - 2 * ph != sh:
        raise ValueError(f"spatial partitioning: a transposed conv of kernel {k}, padding "
                         f"{ph} and output padding {oh} does not scale the height by {sh}")
    top = max((k - 1 - ph) // sh, 0)
    xh = halo(x, top, (ph - 1 + sh) // sh, "zeros", mesh)
    y = F.conv_transpose2d(xh, weight, bias, (sh, sw), (0, pw), (0, ow), groups, (dh, dw))
    start = sh * top + ph
    return y[:, :, start:start + sh * x.shape[2]]


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding=0) -> torch.Tensor:
    """``F.max_pool2d`` over this rank's rows (-inf past the image)."""
    mesh = active()
    if mesh is None:
        return F.max_pool2d(x, kernel_size, stride, padding)
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    xh = halo(x, ph, max(kh - sh - ph, 0), "neg_inf", mesh)
    return F.max_pool2d(xh, (kh, kw), (sh, sw), (0, pw))[:, :, : x.shape[2] // sh]


def upsample_rows(fn, x: torch.Tensor, scale: int) -> torch.Tensor:
    """``fn(x)`` for an op that scales the height by ``scale`` and whose
    output row i reads input rows within one of i / scale, taking care of
    the image's top and bottom itself (the bilinear upsample, the fused
    decoder stage): ``fn`` of this rank's rows with a row of each neighbour
    (none at the image's edges), cropped to this rank's output rows."""
    mesh = active()
    if mesh is None:
        return fn(x)
    top = 1 if mesh.spatial_rank > 0 else 0
    y = fn(halo(x, 1, 1, None, mesh))
    return y[:, :, top * scale:(top + x.shape[2]) * scale]


def crop_rows_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Crop NCHW ``x`` to ``ref``'s height and width; on the spatial axis
    only the shard that holds the image's bottom edge may lose rows."""
    mesh = active()
    if (mesh is not None and x.shape[2] != ref.shape[2]
            and mesh.spatial_rank != mesh.spatial - 1):
        raise RuntimeError(f"spatial partitioning: a shard above the bottom one would crop "
                           f"{x.shape[2]} rows to {ref.shape[2]}")
    return x[:, :, : ref.shape[2], : ref.shape[3]]
