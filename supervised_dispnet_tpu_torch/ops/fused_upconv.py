"""Fused (2x bilinear upsample -> 3x3 zero-padded conv), exact at the
borders too: the port of ``supervised_dispnet_tpu/ops/fused_upconv.py`` in
its pixel-shuffle form, NCHW with OIHW weights.

The DispResNet decoder upsamples each stage 2x and convolves the result.
Composing the upsample's per-axis taps g = [1/4, 3/4, 3/4, 1/4] into the 3x3
kernel gives a 6x6 kernel on the half-resolution input dilated by 2. Each of
the four output phases (row parity py, column parity px) of that dilated
conv is a dense 3x3 conv of the edge-padded input, so the whole is one
conv with 4 * Cout outputs followed by ``F.pixel_shuffle``: the upsampled
tensor never exists.

At the 1-pixel output border the composed conv reads phantom upsample rows
and columns past the edge where the 3x3 conv's zero padding read zeros;
four 1-D border convs subtract them, each corner phantom once. The result
equals ``conv3x3(interpolate_bilinear(x, 2x))`` to fp rounding. Plain
differentiable torch, so training gets gradients for free.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

# half-pixel 2x bilinear as a transposed conv, per axis
_TENT = (0.25, 0.75, 0.75, 0.25)


@functools.lru_cache(maxsize=16)
def _tent(ndim: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The tent taps as a transposed-conv kernel, (1, 1, 4) for ``ndim`` 1
    and their outer product (1, 1, 4, 4) for 2, made once a device and
    dtype: a copy from the host each call would wait for the card. Made
    wholly outside inference mode, whatever mode the first caller is in, and
    cloned, so the cached tensor is never an inference tensor nor a view of
    one: autograd may save it in any later call."""
    with torch.inference_mode(False):
        g = torch.tensor(_TENT, dtype=dtype)
        k = g if ndim == 1 else g[:, None] * g[None, :]
        return k.to(device)[None, None].clone()


def compose_upsample_kernel(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (Cout, Cin, 6, 6): the kernel convolved with the
    2x bilinear tent taps along each spatial axis (q[m] = sum_s k[s] g[m-s]),
    one transposed conv of each 3x3 tap grid with the 4x4 tent."""
    Cout, Cin = weight.shape[:2]
    kc = F.conv_transpose2d(weight.reshape(Cout * Cin, 1, 3, 3),
                            _tent(2, weight.device, weight.dtype))
    return kc.reshape(Cout, Cin, 6, 6)


def compose_to_phase_kernels(kc: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 6, 6) composed kernel -> (4 * Cout, Cin, 3, 3) phase
    kernels in ``F.pixel_shuffle``'s channel order, c * 4 + py * 2 + px.

    Output row m = 2i + p of the dilated conv over the edge-padded input
    ``xp`` draws composed-kernel rows of parity 1 - p over ``xp[i : i + 3]``:
    phase p = 0 takes rows kc[1::2], p = 1 rows kc[0::2]; the same holds for
    columns."""
    rows = (kc[:, :, 1::2], kc[:, :, 0::2])  # output-row parity 0, 1
    phases = [rows[py][:, :, :, 1 - px::2] for py in range(2) for px in range(2)]
    return torch.stack(phases, dim=1).flatten(0, 1)


def lhs_dilated_conv_ps(xp: torch.Tensor, kc: torch.Tensor) -> torch.Tensor:
    """The composed kernel's conv of the half-resolution input dilated by 2
    (padding 1), as one dense conv and a depth-to-space.

    xp: (B, Cin, H + 2, W + 2) edge-padded input; kc: (Cout, Cin, 6, 6).
    Returns (B, Cout, 2H, 2W)."""
    return F.pixel_shuffle(F.conv2d(xp, compose_to_phase_kernels(kc)), 2)


def _strip_up_phantom(v: torch.Tensor, ends: bool = True) -> torch.Tensor:
    """(..., L) strips -> (..., 2L + 2): their clamped half-pixel 2x
    upsample with the phantom samples u[-1] = v[0] and u[2L] = v[L - 1] at
    the ends, the values the composed conv reads past the edge; zeros there
    with ``ends=False``.

    One transposed conv of the edge-padded strip with the tent taps, stride
    2: its output m = k + 3 is u[k], for k = -1 .. 2L."""
    shape, L = v.shape[:-1], v.shape[-1]
    vp = F.pad(v.reshape(-1, 1, L), (1, 1), mode="replicate")
    u = F.conv_transpose1d(vp, _tent(1, v.device, v.dtype), stride=2)
    u = u[..., 2:2 * L + 4] if ends else F.pad(u[..., 3:2 * L + 3], (1, 1))
    return u.reshape(*shape, 2 * L + 2)


def _border_conv(strips: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """VALID 1-D convs of two phantom-extended strips (B, Cin, 2, 2L + 2),
    each with its own kernel row or column, taps (Cout, Cin, 2, 3), as one
    grouped conv -> (B, 2, Cout, 2L)."""
    B, Cin, _, L = strips.shape
    w = taps.permute(2, 0, 1, 3).reshape(-1, Cin, 1, 3)  # (2 * Cout, Cin, 1, 3)
    out = F.conv2d(strips.transpose(1, 2).reshape(B, 2 * Cin, 1, L), w, groups=2)
    return out.view(B, 2, -1, L - 2)


def border_corrections(x: torch.Tensor, weight: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the composed conv adds at the 1-pixel output border over the
    3x3 conv of the upsample: the phantom rows (B, 2, Cout, 2W: top, bottom)
    and columns (B, 2, Cout, 2H: left, right), each through its kernel row or
    column. The four corner phantoms lie in a phantom row and a phantom
    column: the rows' strips leave them out, so that each is subtracted once
    (JAX's corner restore, folded into the strips)."""
    rows = _border_conv(
        _strip_up_phantom(torch.cat([x[:, :, :1], x[:, :, -1:]], dim=2), ends=False),
        weight[:, :, ::2])
    cols = _border_conv(
        _strip_up_phantom(torch.cat([x[..., :1], x[..., -1:]], dim=3).transpose(2, 3)),
        weight[..., ::2].transpose(2, 3))
    return rows, cols


def upconv2x_fused(x: torch.Tensor, weight: torch.Tensor,
                   composed_kernel: torch.Tensor | None = None) -> torch.Tensor:
    """Exactly ``F.conv2d(interpolate_bilinear(x, 2H, 2W), weight, padding=1)``
    without the upsampled tensor.

    x: (B, Cin, H, W) half-resolution input; weight: (Cout, Cin, 3, 3).
    ``composed_kernel`` (Cout, Cin, 6, 6), if given, replaces
    ``compose_upsample_kernel(weight)`` in the main conv (QAT passes the
    quantize-dequantized composed kernel, as the JAX function takes it); the
    border corrections use ``weight``. Returns (B, Cout, 2H, 2W). Bias and
    activation are the caller's."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    kc = compose_upsample_kernel(weight) if composed_kernel is None else composed_kernel
    y = lhs_dilated_conv_ps(xp, kc)
    rows, cols = border_corrections(x, weight)
    y[:, :, 0].sub_(rows[:, 0])
    y[:, :, -1].sub_(rows[:, 1])
    y[..., 0].sub_(cols[:, 0])
    y[..., -1].sub_(cols[:, 1])
    return y
