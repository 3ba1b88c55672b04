"""int8 convolution with a fused epilogue: the hand-written kernel in
``csrc/int8_conv.cu`` on the card, its plain PyTorch version on the CPU.

The port's counterpart of the int8 convolutions that the JAX package leaves
to XLA (``supervised_dispnet_tpu/ops/quant.py::_conv_q`` / ``_int8_conv``:
``lax.conv_general_dilated`` of int8 with an int32 result) and of the
elementwise epilogue XLA fuses into them (``_requant``, the chains' residual
adds). ``ops/quant.py`` builds the int8 serving path on it.

Layouts: activations NHWC int8; ``Geometry`` holds the kernel size, strides,
the low and high padding of each axis and the input (lhs) and kernel (rhs)
dilations, in ``lax.conv_general_dilated``'s meaning. ``plan(x_shape, geom,
cout)`` decides how the kernel runs the conv, in Python, so the CPU tests
reach every decision:
- the channel pad: C is padded with zero channels to ``cp``, a multiple of
  16, so that every 16-byte gather lies in one tap (``pad_channels``, in
  ``launch`` and in the plain versions: callers pass the true channels);
- the phases: an lhs-dilated conv (dilation 2, stride 1) is split by the
  output's parity (oy mod 2, ox mod 2) into 4 convs over the undilated
  input, each with only the taps that land on input pixels (FCRN's 5x5 unpool
  conv at padding (2, 3): 3x3 / 3x2 / 2x3 / 2x2; the fused decoder stage's
  6x6 at padding 1: four 3x3); any other conv is one phase;
- the tile: ``bn`` output channels (16, 32, 64 or 128, the least that holds
  Cout) by 64 or 128 output pixels (one or two warpgroups: two where the
  128-pixel tiles still fill a wave and bn <= 64, or for a split K of at
  least ``DEEP_K_TILES`` 128-byte tiles, whose weights then stream from L2
  to half as many blocks, where they pad no more rows or let K split);
- split-K: where the output tiles fill at most half a wave of the card's
  132 SMs, each tile's K is cut into ``splits`` slices of whole 128-byte K
  tiles (at most a wave of blocks; each slice at least ``MIN_SPLIT_TILES``
  K tiles), one block a slice; the last block to finish a tile adds the
  slices.
``pack_weight(wq, geom)`` packs the int8 (Cout, kh, kw, Cin) weight once, as
the plan reads it: Cin padded to ``cp``, then for each phase a block of
(Cout, Kp) rows, the phase's (ty, tx, ci) taps zero-padded to a multiple of
128 bytes, the blocks side by side in one (Cout, width) tensor.

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
``int8_conv_plain``, which computes the same function exactly, through the
same channel pad and phases (``conv_acc_phases_plain``: the sums in
float64, exact below 2^53, the epilogue in float32 in the same order).
``conv_acc_plain`` is the reference the two are held to: the conv over the
zero-stuffed, padded input with the unpacked weight. A process that loads
an exported int8 program imports this module to have the op.

``int8_conv_launches`` counts the kernel's launches, and
``int8_conv_variants`` each epilogue variant's (``"s8/relu/res-q8"``, ...).
"""

from __future__ import annotations

import ctypes
import functools
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
CHANNEL_STEP = 16  # C padded to a multiple of it: one 16-byte gather a tap
K_TILE = 128  # csrc/int8_conv.cu kBK: bytes of K a ring stage
N_TILES = (16, 32, 64, 128)  # the kernel's output-channel tiles
MAX_PHASES = 4  # csrc/int8_conv.cu kMaxPhases
WAVE = 132  # the H100's SMs: fewer output tiles than this are split along K
MIN_SPLIT_TILES = 4  # K tiles a split walks at least
MAX_SPLITS = 16
DEEP_K_TILES = 32  # K tiles from which a 128 x 128 tile halves the weights' L2 traffic

_P = ctypes.c_void_p
_N_DIMS = 23 + 18 * MAX_PHASES
_SIGNATURES = {
    # x, w, mult, bias, res, out, ws, counters, dims, res_scale, out_scale, device, stream
    "int8_conv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, ctypes.c_float,
                  ctypes.c_int, _P],
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


def fast_divisor(d: int) -> tuple[int, int]:
    """(mul, shift) with n // d == (n * mul >> 32) >> shift for 0 <= n <
    2^31 (the kernel's FastDiv): mul = ceil(2^(31 + l) / d), l =
    ceil(log2 d), shift = l - 1; (0, 0), the identity, for d = 1."""
    if d < 1:
        raise ValueError(f"int8 conv: a divisor must be positive, got {d}")
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()
    return -(-(1 << (31 + log2)) // d), log2 - 1


def _c_int(v: int) -> int:
    """An unsigned 32-bit value as the C int with its bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_STEP) * CHANNEL_STEP


def pad_channels(x: torch.Tensor) -> torch.Tensor:
    """NHWC ``x`` with zero channels appended up to a multiple of 16 (``x``
    itself where it has them)."""
    c = x.shape[-1]
    return x if c % CHANNEL_STEP == 0 else F.pad(x, (0, padded_channels(c) - c)).contiguous()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Phase:
    """One phase of a conv: the outputs (oy, ox) = (j * osy + py, i * osx +
    px) for j < ho, i < wo, from input pixel (j * sy + off_y + t * ty, i * sx +
    off_x + u * tx) times the phase's tap (t, u), t < nty, u < ntx (the steps
    are the plan's; ``pack_weight`` puts the kernel's taps that land on input
    pixels there). Its K is nty * ntx * cp bytes, zero-padded to kp, at byte
    column w_off of a packed weight row; split s walks K tiles ``slices[s]``
    (the kernel's split * nk / splits to (split + 1) * nk / splits)."""

    py: int
    px: int
    nty: int
    ntx: int
    off_y: int
    off_x: int
    ho: int
    wo: int
    k: int
    kp: int
    w_off: int
    mtiles: int
    tile_base: int
    slices: tuple[tuple[int, int], ...]


@dataclass(frozen=True)
class Plan:
    """How the kernel runs one conv (module docstring): the padded channel
    count, the tile (``bn`` channels by ``64 * wg`` pixels), the K splits,
    the input step of an output index (``sy``, ``sx``), of a tap index
    (``ty``, ``tx``) and the output step of an output index (``osy``,
    ``osx``), the phases, the packed weight's row width and the output
    tiles (over all phases)."""

    cp: int
    bn: int
    wg: int
    splits: int
    sy: int
    sx: int
    ty: int
    tx: int
    osy: int
    osx: int
    phases: tuple[Phase, ...]
    width: int
    tiles: int

    @property
    def bm(self) -> int:
        return 64 * self.wg




def _axis_taps(k: int, stride: int, pad: int, lhs: int, rhs: int):
    """One axis's phases, each (first output, first tap, taps, input offset),
    and its (input step of an output index, of a tap index, output step)."""
    if lhs == 1:
        return [(0, 0, k, -pad)], (stride, rhs, 1)
    if stride != 1 or rhs != 1:
        raise ValueError("int8 conv: an lhs-dilated conv takes stride 1 and rhs dilation 1, "
                         f"got stride {stride}, rhs dilation {rhs}")
    # output p + lhs * j reads the dilated input at p + lhs * j - pad + tap: a
    # pixel where that is a multiple of lhs, i.e. for taps t0, t0 + lhs, ...
    return [(p, (pad - p) % lhs, len(range((pad - p) % lhs, k, lhs)),
             (p - pad + (pad - p) % lhs) // lhs) for p in range(lhs)], (1, 1, lhs)


def _phase_taps(geom: Geometry):
    """A conv's phases, each a (row phase, column phase) pair of
    ``_axis_taps``' tuples, and the two axes' steps."""
    ys, ysteps = _axis_taps(geom.kh, geom.stride[0], geom.padding[0], geom.lhs_dilation[0],
                            geom.rhs_dilation[0])
    xs, xsteps = _axis_taps(geom.kw, geom.stride[1], geom.padding[2], geom.lhs_dilation[1],
                            geom.rhs_dilation[1])
    if len(ys) * len(xs) > MAX_PHASES:
        raise ValueError(f"int8 conv: lhs dilation {geom.lhs_dilation} makes more than "
                         f"{MAX_PHASES} phases")
    return [(y, x) for y in ys for x in xs], ysteps, xsteps


@functools.lru_cache(maxsize=256)
def packed_width(c: int, geom: Geometry) -> int:
    """Bytes of a packed weight row (``pack_weight``) for input channels
    ``c`` (any; padded to a multiple of 16) and ``geom``: each phase's taps
    padded to whole K tiles."""
    cp = padded_channels(c)
    return sum(-(-y[2] * x[2] * cp // K_TILE) * K_TILE for y, x in _phase_taps(geom)[0])


@functools.lru_cache(maxsize=1024)
def plan(x_shape: tuple[int, ...], geom: Geometry, cout: int, splits: int | None = None) -> Plan:
    """The kernel's plan for NHWC input ``x_shape`` (any C), ``geom`` and
    ``cout`` (module docstring). ``splits`` overrides the split count (to
    hold split-K against no split)."""
    B, H, W, C = (int(v) for v in x_shape)
    ho, wo = geom.out_hw(H, W)
    cp = padded_channels(C)
    raw, (sy, ty, osy), (sx, tx, osx) = _phase_taps(geom)
    outs = [(len(range(y[0], ho, osy)), len(range(x[0], wo, osx))) for y, x in raw]
    bn = next((n for n in N_TILES if cout <= n), N_TILES[-1])
    ntn = -(-cout // bn)

    def mtiles(bm: int) -> list[int]:
        return [-(-B * h * w // bm) for h, w in outs]

    ks = [y[2] * x[2] * cp for y, x in raw]
    nks = [-(-k // K_TILE) for k in ks]
    shallowest = min((n for n in nks if n), default=0)
    # two warpgroups (128 pixels) where that still fills a wave; with 128
    # channels only for a deep K that is then split (its registers leave one
    # block an SM), where the weights stream from L2 to half the blocks, if
    # the 128-pixel tiles pad no more rows than the 64-pixel ones or let a K
    # split that those do not
    tiles64, tiles128 = sum(mtiles(64)) * ntn, sum(mtiles(128)) * ntn
    wide = bn <= 64 and tiles128 >= WAVE
    deep = (bn == 128 and 2 * tiles128 <= WAVE and shallowest >= DEEP_K_TILES
            and (2 * tiles128 <= tiles64 or 2 * tiles64 > WAVE))
    wg = 2 if wide or deep else 1
    mt = mtiles(64 * wg)
    tiles = sum(mt) * ntn
    if splits is None:
        splits = 1
        if 2 * tiles <= WAVE and shallowest >= 2 * MIN_SPLIT_TILES:
            splits = min(WAVE // tiles, shallowest // MIN_SPLIT_TILES, MAX_SPLITS)
    phases, w_off, tile_base = [], 0, 0
    for (y, x), (h, w), k, nk, m in zip(raw, outs, ks, nks, mt):
        phases.append(Phase(
            py=y[0], px=x[0], nty=y[2], ntx=x[2], off_y=y[3], off_x=x[3],
            ho=h, wo=w, k=k, kp=nk * K_TILE, w_off=w_off, mtiles=m, tile_base=tile_base,
            slices=tuple((s * nk // splits, (s + 1) * nk // splits) for s in range(splits))))
        w_off += nk * K_TILE
        tile_base += m
    return Plan(cp=cp, bn=bn, wg=wg, splits=splits, sy=sy, sx=sx, ty=ty, tx=tx, osy=osy,
                osx=osx, phases=tuple(phases), width=w_off, tiles=tiles)


def pack_weight(wq: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """int8 (Cout, kh, kw, Cin) -> the kernel's (Cout, width): Cin padded to
    a multiple of 16, then each phase's taps (``plan``) a block of rows,
    zero-padded to a multiple of 128 bytes."""
    if wq.dtype is not torch.int8 or wq.dim() != 4 or tuple(wq.shape[1:3]) != (geom.kh, geom.kw):
        raise TypeError(f"int8 conv: weight must be int8 (Cout, {geom.kh}, {geom.kw}, Cin), "
                        f"got {wq.dtype} {tuple(wq.shape)}")
    cout = wq.shape[0]
    w = pad_channels(wq.contiguous())
    dh, dw = geom.lhs_dilation
    blocks = []
    for y, x in _phase_taps(geom)[0]:
        taps = w[:, y[1]::dh, x[1]::dw][:, :y[2], :x[2]].reshape(cout, -1)
        blocks.append(F.pad(taps, (0, -taps.shape[1] % K_TILE)))
    return torch.cat(blocks, dim=1).contiguous()


def unpack_weight(w: torch.Tensor, geom: Geometry, cp: int) -> torch.Tensor:
    """``pack_weight``'s inverse: (Cout, width) -> (Cout, kh, kw, cp)."""
    cout = w.shape[0]
    dh, dw = geom.lhs_dilation
    out = w.new_zeros(cout, geom.kh, geom.kw, cp)
    col = 0
    for y, x in _phase_taps(geom)[0]:
        k = y[2] * x[2] * cp
        out[:, y[1]::dh, x[1]::dw][:, :y[2], :x[2]] = w[:, col:col + k].reshape(
            cout, y[2], x[2], cp)
        col += -(-k // K_TILE) * K_TILE
    return out


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------


def conv_acc_plain(x: torch.Tensor, w: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """The reference int32 accumulator of the int8 conv, exactly: NHWC int8
    x (any C), packed w -> (B, Ho, Wo, Cout) int32. The sums run in float64
    (|sum| stays far below 2^53), over the zero-stuffed, padded input and
    the unpacked weight."""
    B, H, W, C = x.shape
    wt = unpack_weight(w, geom, padded_channels(C))[..., :C]
    wt = wt.permute(0, 3, 1, 2).to(torch.float64)
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


def _window(xf: torch.Tensor, dim: int, off: int, n: int, step: int, taps: int, tstep: int
            ) -> torch.Tensor:
    """Rows ``off .. off + (n - 1) * step + (taps - 1) * tstep`` of ``xf``
    along ``dim``, zeros outside it."""
    length = (n - 1) * step + (taps - 1) * tstep + 1
    if off < 0:
        xf, off = F.pad(xf, [0, 0] * (xf.dim() - dim - 1) + [-off, 0]), 0
    off = min(off, xf.shape[dim])
    xf = xf.narrow(dim, off, min(length, xf.shape[dim] - off))
    if xf.shape[dim] < length:
        xf = F.pad(xf, [0, 0] * (xf.dim() - dim - 1) + [0, length - xf.shape[dim]])
    return xf


def _check_packed(w: torch.Tensor, pl: Plan, x_shape, geom: Geometry) -> None:
    """Raise unless ``w`` has ``pack_weight``'s width for the plan: a weight
    packed in another layout (an int8 program exported before Cin was padded
    to 16 and each phase's block to 128 bytes) would be read wrongly."""
    if w.dim() != 2 or w.shape[1] != pl.width:
        raise ValueError(f"int8 conv: w must be pack_weight's ({w.shape[0]}, {pl.width}) for "
                         f"x {tuple(x_shape)} and {geom}, got {tuple(w.shape)}; an int8 "
                         "program exported with another packed layout must be exported again")


def conv_acc_phases_plain(x: torch.Tensor, w: torch.Tensor, geom: Geometry) -> torch.Tensor:
    """The int32 accumulator the way the kernel computes it: ``x`` padded to
    the plan's channels, each phase's conv over the undilated input with
    the phase's block of the packed ``w``, written at the phase's outputs.
    Exact (float64 sums), equal to ``conv_acc_plain``."""
    B, H, W, C = x.shape
    cout = w.shape[0]
    pl = plan(tuple(x.shape), geom, cout, 1)
    _check_packed(w, pl, x.shape, geom)
    ho, wo = geom.out_hw(H, W)
    xf = pad_channels(x).permute(0, 3, 1, 2).to(torch.float64)
    acc = torch.zeros(B, ho, wo, cout, dtype=torch.int32, device=x.device)
    for ph in pl.phases:
        if not (ph.k and ph.ho and ph.wo):
            continue
        wt = w[:, ph.w_off:ph.w_off + ph.k].reshape(cout, ph.nty, ph.ntx, pl.cp)
        xp = _window(xf, 2, ph.off_y, ph.ho, pl.sy, ph.nty, pl.ty)
        xp = _window(xp, 3, ph.off_x, ph.wo, pl.sx, ph.ntx, pl.tx)
        a = F.conv2d(xp, wt.permute(0, 3, 1, 2).to(torch.float64), stride=(pl.sy, pl.sx),
                     dilation=(pl.ty, pl.tx))
        acc[:, ph.py::pl.osy, ph.px::pl.osx] = a.round().to(torch.int32).permute(0, 2, 3, 1)
    return acc


def epilogue_plain(acc: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None, act: int, out_mode: int, res_mode: int,
                   res_scale: float, out_scale: float) -> torch.Tensor:
    """The kernel's epilogue on an int32 NHWC accumulator, in float32, in the
    kernel's order (``csrc/int8_conv.cu::epilogue`` and ``code``)."""
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
    return epilogue_plain(conv_acc_phases_plain(x, w, geom), mult, bias, residual, ACTS[act],
                          OUTS[out], _res_mode(residual, res_before_bias), res_scale, out_scale)


# ---------------------------------------------------------------------------
# the op and the kernel's launch
# ---------------------------------------------------------------------------


@torch.library.custom_op("sdtpu::int8_conv", mutates_args=())
def _int8_conv_op(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None, geom: list[int], act: int, out_mode: int,
                  res_mode: int, res_scale: float, out_scale: float) -> torch.Tensor:
    """The op's CPU (and default) implementation: the plain version."""
    if x.is_cuda:
        raise RuntimeError("int8 conv: the CUDA implementation is the kernel")
    return epilogue_plain(conv_acc_phases_plain(x, w, _geometry(geom)), mult, bias, residual,
                          act, out_mode, res_mode, res_scale, out_scale)


@_int8_conv_op.register_fake
def _(x, w, mult, bias, residual, geom, act, out_mode, res_mode, res_scale, out_scale):
    ho, wo = _geometry(geom).out_hw(x.shape[1], x.shape[2])
    return x.new_empty((x.shape[0], ho, wo, w.shape[0]), dtype=OUT_DTYPES[out_mode])


def _lib() -> ctypes.CDLL:
    return _build.load_library("int8_conv", _SIGNATURES)


@functools.lru_cache(maxsize=1024)
def _launch_record(x_shape: tuple[int, ...], geom: Geometry, cout: int, act: int, out_mode: int,
                   res_mode: int, splits: int | None = None):
    """What a launch needs, worked out once a shape: (plan, the C entry's
    ``dims`` (``csrc/int8_conv.cu::int8_conv``), the output's shape, the
    epilogue variant's name)."""
    pl = plan(x_shape, geom, cout, splits)
    B, H, W, _ = x_shape
    ho, wo = geom.out_hw(H, W)
    def div(d: int) -> list[int]:
        mul, shift = fast_divisor(max(d, 1))
        return [_c_int(mul), shift]

    head = [B, H, W, pl.cp, ho, wo, cout, pl.width, pl.sy, pl.sx, pl.ty, pl.tx, pl.osy,
            pl.osx, act, out_mode, res_mode, pl.splits, len(pl.phases), pl.bn, pl.wg,
            *div(pl.cp)]
    rows = []
    for ph in pl.phases:
        rows += [ph.py, ph.px, ph.nty, ph.ntx, ph.off_y, ph.off_x, ph.ho, ph.wo,
                 ph.kp // K_TILE, ph.w_off, ph.mtiles, ph.tile_base,
                 *div(ph.ho * ph.wo), *div(ph.wo), *div(ph.ntx)]
    rows += [0] * (18 * (MAX_PHASES - len(pl.phases)))
    name = "/".join(s for s in (list(OUTS)[out_mode], list(ACTS)[act], RES_NAMES[res_mode]) if s)
    return pl, (ctypes.c_int * _N_DIMS)(*head, *rows), (B, ho, wo, cout), name


_counters: dict[tuple[int, int], torch.Tensor] = {}


def _tile_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Zeroed split-K arrival counters of one device and stream, at least
    ``n``: the kernel's last block at a tile sets its counter back to 0."""
    key = (device.index, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = _counters[key] = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
    return c


def launch(x: torch.Tensor, w: torch.Tensor, mult: torch.Tensor, bias: torch.Tensor,
           residual: torch.Tensor | None, geom: Geometry, act: int, out_mode: int,
           res_mode: int, res_scale: float, out_scale: float,
           splits: int | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors that ``int8_conv`` has checked (any
    C: padded here where it is not a multiple of 16) with ``plan``'s choice,
    or ``splits`` K slices; returns the output."""
    global int8_conv_launches
    x = pad_channels(x)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("int8 conv: x and w must be 16-byte aligned on the card")
    if x.numel() >= 2**31:
        raise ValueError(f"int8 conv: x {tuple(x.shape)} holds 2^31 bytes or more")
    pl, dims, shape, name = _launch_record(tuple(x.shape), geom, w.shape[0], act, out_mode,
                                           res_mode, splits)
    _check_packed(w, pl, x.shape, geom)
    out = torch.empty(shape, dtype=OUT_DTYPES[out_mode], device=x.device)
    index = x.get_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    ws = counters = None
    if pl.splits > 1:
        # the counters first, and the workspace held to the launch: a block
        # freed before it could be handed out again as the counters
        counters = _tile_counters(x.device, stream, pl.tiles)
        ws = torch.empty(pl.tiles * pl.splits * pl.bm * pl.bn, dtype=torch.int32,
                         device=x.device)
    lib = _lib()
    code = lib.int8_conv(x.data_ptr(), w.data_ptr(), mult.data_ptr(), bias.data_ptr(),
                         0 if residual is None else residual.data_ptr(), out.data_ptr(),
                         0 if ws is None else ws.data_ptr(),
                         0 if counters is None else counters.data_ptr(), dims, res_scale,
                         out_scale, index, stream)
    _build.check(lib, "int8_conv", "int8_conv", code)
    int8_conv_launches += 1
    int8_conv_variants[name] = int8_conv_variants.get(name, 0) + 1
    return out


@_int8_conv_op.register_kernel("cuda")
def _(x, w, mult, bias, residual, geom, act, out_mode, res_mode, res_scale, out_scale):
    return launch(x, w, mult, bias, residual, _geometry(geom), act, out_mode, res_mode,
                  res_scale, out_scale)


def _check(x, w, geom, mult, bias, residual, act, out):
    if x.dtype is not torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise TypeError(f"int8 conv: x must be a contiguous NHWC int8 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")
    cout, width = w.shape if w.dim() == 2 else (None, None)
    # C, H and W are static where a program is exported with a dynamic batch
    want = packed_width(int(x.shape[3]), geom)
    if w.dtype is not torch.int8 or cout is None or width != want or not w.is_contiguous():
        raise ValueError(f"int8 conv: w must be pack_weight's (Cout, Kp) int8 of width {want} "
                         f"for C = {x.shape[3]} and {geom}, got {w.dtype} {tuple(w.shape)}")
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
    """The int8 conv of NHWC int8 ``x`` (any C; padded to the plan's
    channels where it is not) with ``w`` packed for ``geom``
    (``pack_weight``) and its epilogue (module docstring) -> (B, Ho, Wo,
    Cout) of the ``out`` type. On the card the kernel, on the CPU the plain
    version."""
    _check(x, w, geom, mult, bias, residual, act, out)
    res_mode = _res_mode(residual, res_before_bias)
    if x.is_cuda and type(x) is torch.Tensor and not torch.compiler.is_compiling():
        # eager, plain tensors: the op's CUDA implementation without the
        # dispatcher's round trip (tens of µs a call on the host); a traced
        # or exported program goes through the op
        return launch(x, w, mult, bias, residual, geom, ACTS[act], OUTS[out], res_mode,
                      float(res_scale), float(out_scale))
    return torch.ops.sdtpu.int8_conv(
        x, w, mult, bias, residual, geom.as_list(), ACTS[act], OUTS[out], res_mode,
        float(res_scale), float(out_scale))
