"""int8 convolution with a fused epilogue: the hand-written kernel in
``csrc/int8_conv.cu`` on the card, its plain PyTorch version on the CPU.

The port's counterpart of the int8 convolutions that the JAX package leaves
to XLA (``supervised_dispnet_tpu/ops/quant.py::_conv_q`` / ``_int8_conv``:
``lax.conv_general_dilated`` of int8 with an int32 result) and of the
elementwise epilogue XLA fuses into them (``_requant``, the chains' residual
adds). ``ops/quant.py`` builds the int8 serving path on it.

Layouts: activations NHWC, weights packed by ``pack_weight`` as (Cout, Kp)
int8, each row the (ky, kx, ci) taps of one output channel zero-padded to
``Kp``, a multiple of 32. ``Geometry`` holds the kernel size, strides, the
low and high padding of each axis and the input (lhs) and kernel (rhs)
dilations, in ``lax.conv_general_dilated``'s meaning.

The epilogue, per output channel c (float32, each operation rounded as the
JAX package's XLA graph rounds it):
``y = float(acc) * mult[c]``, then a float32 residual added before the bias
(``res_before_bias``), ``+ bias[c]``, then an int8 residual times its scale or
a bf16 residual (both sides rounded to bf16 before the add), the activation
(``none``, ``relu``, ``elu``), and the output: ``f32``, ``bf16``, ``s8``
(``clip(rint(y / out_scale), -127, 127)``, a true division) or ``s32`` (the
raw accumulator).

``int8_conv`` is the entry: a ``torch.library`` custom op
(``torch.ops.sdtpu.int8_conv``), so ``torch.export`` can trace it. On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
``int8_conv_plain``, which computes the same function exactly (the sums in
float64, exact below 2^53, the epilogue in float32 in the same order). A
process that loads an exported int8 program imports this module to have
the op.

``int8_conv_launches`` counts the kernel's launches, and
``int8_conv_variants`` each epilogue variant's (``"s8/relu/res-q8"``, ...).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from supervised_dispnet_tpu_torch.ops.cuda import _build

ACTS = {"none": 0, "relu": 1, "elu": 2}
OUTS = {"f32": 0, "bf16": 1, "s8": 2, "s32": 3}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.int8, torch.int32)
# residual modes: none, int8 (after bias, times res_scale), bf16 (after
# bias, both rounded), float32 (before bias)
RES_NAMES = ("", "res-q8", "res-bf16", "res-f32")
K_STEP = 32  # csrc/int8_conv.cu kBK

_P = ctypes.c_void_p
_SIGNATURES = {
    # x, w, mult, bias, res, out, dims, res_scale, out_scale, device, stream
    "int8_conv": [_P, _P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float, ctypes.c_int, _P],
}

int8_conv_launches = 0
int8_conv_variants: dict[str, int] = {}


def reset_counts() -> None:
    global int8_conv_launches
    int8_conv_launches = 0
    int8_conv_variants.clear()


@dataclass(frozen=True)
class Geometry:
    """A conv's window: kernel (kh, kw), strides, padding (top, bottom,
    left, right), input (lhs) dilation and kernel (rhs) dilation."""

    kh: int
    kw: int
    stride: tuple[int, int] = (1, 1)
    padding: tuple[int, int, int, int] = (0, 0, 0, 0)
    lhs_dilation: tuple[int, int] = (1, 1)
    rhs_dilation: tuple[int, int] = (1, 1)

    @classmethod
    def square(cls, k: int, stride: int = 1, pad: int = 0) -> Geometry:
        return cls(k, k, (stride, stride), (pad, pad, pad, pad))

    def out_hw(self, h: int, w: int) -> tuple[int, int]:
        pt, pb, pl, pr = self.padding
        (sh, sw), (dh, dw), (rh, rw) = self.stride, self.lhs_dilation, self.rhs_dilation
        ho = ((h - 1) * dh + 1 + pt + pb - ((self.kh - 1) * rh + 1)) // sh + 1
        wo = ((w - 1) * dw + 1 + pl + pr - ((self.kw - 1) * rw + 1)) // sw + 1
        return ho, wo

    def as_list(self) -> list[int]:
        return [self.kh, self.kw, *self.stride, *self.padding, *self.lhs_dilation,
                *self.rhs_dilation]


def _geometry(g: list[int]) -> Geometry:
    return Geometry(g[0], g[1], (g[2], g[3]), (g[4], g[5], g[6], g[7]), (g[8], g[9]),
                    (g[10], g[11]))


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 (Cout, kh, kw, Cin) -> the kernel's (Cout, Kp): rows of the
    (ky, kx, ci) taps, zero-padded to a multiple of 32."""
    if wq.dtype is not torch.int8 or wq.dim() != 4:
        raise TypeError(f"int8 conv: weight must be int8 (Cout, kh, kw, Cin), got "
                        f"{wq.dtype} {tuple(wq.shape)}")
    cout = wq.shape[0]
    w = wq.reshape(cout, -1)
    k = w.shape[1]
    return F.pad(w, (0, -k % K_STEP)).contiguous()


def conv_acc_plain(x: torch.Tensor, w: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """The int32 accumulator of the int8 conv, exactly: NHWC int8 x, packed
    w -> (B, Ho, Wo, Cout) int32. The sums run in float64 (|sum| stays far
    below 2^53), over the zero-stuffed, padded input."""
    B, H, W, C = x.shape
    cout = w.shape[0]
    k = geom.kh * geom.kw * C
    wt = w[:, :k].reshape(cout, geom.kh, geom.kw, C).permute(0, 3, 1, 2).to(torch.float64)
    xf = x.permute(0, 3, 1, 2).to(torch.float64)
    dh, dw = geom.lhs_dilation
    if (dh, dw) != (1, 1):
        xd = xf.new_zeros(B, C, (H - 1) * dh + 1, (W - 1) * dw + 1)
        xd[:, :, ::dh, ::dw] = xf
        xf = xd
    pt, pb, pl, pr = geom.padding
    xf = F.pad(xf, (pl, pr, pt, pb))
    acc = F.conv2d(xf, wt, stride=geom.stride, dilation=geom.rhs_dilation)
    return acc.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def epilogue_plain(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None, act: int, out_mode: int, res_mode: int,
                   res_scale: float, out_scale: float) -> torch.Tensor:
    """The kernel's epilogue on an int32 NHWC accumulator, in float32, in the
    kernel's order (``csrc/int8_conv.cu::emit``)."""
    if out_mode == 3:
        return acc
    y = acc.to(torch.float32) * mult
    if res_mode == 3:
        y = y + residual
    y = y + bias
    if res_mode == 1:
        y = y + residual.to(torch.float32) * _scalar(res_scale, y)
    elif res_mode == 2:
        y = (y.to(torch.bfloat16) + residual).to(torch.float32)
    if act == 1:
        y = torch.clamp_min(y, 0.0)
    elif act == 2:
        y = torch.where(y > 0, y, torch.expm1(y))
    if out_mode == 0:
        return y
    if out_mode == 1:
        return y.to(torch.bfloat16)
    # a 0-dim tensor on y's device: a true division (CUDA's div by a host
    # scalar multiplies by its reciprocal)
    return torch.clamp(torch.round(y / _scalar(out_scale, y)), -127.0, 127.0).to(torch.int8)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def _res_mode(residual: torch.Tensor | None, res_before_bias: bool) -> int:
    if residual is None:
        return 0
    if residual.dtype is torch.int8:
        return 1
    if residual.dtype is torch.bfloat16:
        return 2
    if residual.dtype is torch.float32 and res_before_bias:
        return 3
    raise TypeError("int8 conv: a residual is int8 or bf16 (added after the bias) or "
                    f"float32 (before it, res_before_bias=True), got {residual.dtype}")


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, geom: Geometry, mult: torch.Tensor,
                    bias: torch.Tensor, residual: torch.Tensor | None = None, act: str = "none",
                    out: str = "f32", out_scale: float = 1.0, res_scale: float = 0.0,
                    res_before_bias: bool = False) -> torch.Tensor:
    """The plain version of ``int8_conv`` (same arguments), on any device."""
    return epilogue_plain(conv_acc_plain(x, w, geom), mult, bias, residual, ACTS[act],
                          OUTS[out], _res_mode(residual, res_before_bias), res_scale, out_scale)


@torch.library.custom_op("sdtpu::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None, geom: list[int], act: int, out_mode: int,
                  res_mode: int, res_scale: float, out_scale: float) -> torch.Tensor:
    """The op's CPU (and default) implementation: the plain version."""
    if x.is_cuda:
        raise RuntimeError("int8 conv: the CUDA implementation is the kernel")
    return epilogue_plain(conv_acc_plain(x, w, _geometry(geom)), mult, bias, residual, act,
                          out_mode, res_mode, res_scale, out_scale)


@_int8_conv_op.register_fake
def _(x, w, mult, bias, residual, geom, act, out_mode, res_mode, res_scale, out_scale):
    ho, wo = _geometry(geom).out_hw(x.shape[1], x.shape[2])
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]), dtype=OUT_DTYPES[out_mode])


def _lib() -> ctypes.CDLL:
    return _build.load_library("int8_conv", _SIGNATURES)


@_int8_conv_op.register_kernel("cuda")
def _(x, w, mult, bias, residual, geom, act, out_mode, res_mode, res_scale, out_scale):
    global int8_conv_launches
    g = _geometry(geom)
    B, H, W, C = x.shape
    ho, wo = g.out_hw(H, W)
    cout = w.shape[0]
    out = torch.empty((B, ho, wo, cout), dtype=OUT_DTYPES[out_mode], device=x.device)
    dims = (ctypes.c_int * 21)(B, H, W, C, ho, wo, cout, g.kh, g.kw, *g.stride,
                               g.padding[0], g.padding[2], *g.lhs_dilation,
                               *g.rhs_dilation, w.shape[1], act, out_mode, res_mode)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8 conv: x and w must be 16-byte aligned on the card")
    index = x.get_device()
    lib = _lib()
    code = lib.int8_conv(x.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                         0 if residual is None else residual.data_ptr(), out.data_ptr(),
                         dims, res_scale, out_scale, index,
                         torch.cuda.current_stream(index).cuda_stream)
    _build.check(lib, "int8_conv", "int8_conv", code)
    int8_conv_launches += 1
    name = "/".join(s for s in (list(OUTS)[out_mode], list(ACTS)[act], RES_NAMES[res_mode]) if s)
    int8_conv_variants[name] = int8_conv_variants.get(name, 0) + 1
    return out


def _check(x, w, geom, mult, bias, residual, act, out):
    if x.dtype is not torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f"int8 conv: x must be a contiguous NHWC int8 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    cout, kp = w.shape if w.dim() == 2 else (None, None)
    k = geom.kh * geom.kw * x.shape[3]
    if (w.dtype is not torch.int8 or cout is None or kp % K_STEP or not k <= kp < k + K_STEP
            or not w.is_contiguous()):
        raise ValueError(f"int8 conv: w must be pack_weight's (Cout, Kp) int8 for K = {k}, "
                         f"got {w.dtype} {tuple(w.shape)}")
    for name, v in (("mult", mult), ("bias", bias)):
        if v.dtype is not torch.float32 or v.shape != (cout,) or not v.is_contiguous():
            raise ValueError(f"int8 conv: {name} must be ({cout},) float32, got {v.dtype} "
                             f"{tuple(v.shape)}")
    if act not in ACTS or out not in OUTS:
        raise ValueError(f"int8 conv: act in {list(ACTS)}, out in {list(OUTS)}; got {act}, {out}")
    ho, wo = geom.out_hw(x.shape[1], x.shape[2])
    if ho < 1 or wo < 1:
        raise ValueError(f"int8 conv: empty output for input {tuple(x.shape)} and {geom}")
    if residual is not None and (residual.shape != (x.shape[0], ho, wo, cout)
                                 or not residual.is_contiguous()):
        raise ValueError(f"int8 conv: residual must be contiguous {(x.shape[0], ho, wo, cout)}, "
                         f"got {tuple(residual.shape)}")
    tensors = [x, w, mult, bias] + ([] if residual is None else [residual])
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"int8 conv: tensors on {sorted({str(t.device) for t in tensors})}")


def int8_conv(x: torch.Tensor, w: torch.Tensor, geom: Geometry, mult: torch.Tensor,
              bias: torch.Tensor, residual: torch.Tensor | None = None, act: str = "none",
              out: str = "f32", out_scale: float = 1.0, res_scale: float = 0.0,
              res_before_bias: bool = False) -> torch.Tensor:
    """The int8 conv of NHWC int8 ``x`` with packed ``w`` (``pack_weight``)
    and its epilogue (module docstring) -> (B, Ho, Wo, Cout) of the ``out``
    type. On the card the kernel, on the CPU the plain version."""
    _check(x, w, geom, mult, bias, residual, act, out)
    return torch.ops.sdtpu.int8_conv(
        x, w, mult, bias, residual, geom.as_list(), ACTS[act], OUTS[out],
        _res_mode(residual, res_before_bias), float(res_scale), float(out_scale))
