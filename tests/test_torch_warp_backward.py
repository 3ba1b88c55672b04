"""The image+coordinate warp backward (``csrc/warp.cu::warp_backward_kernel``,
``ops/cuda/warp.py::warp_backward``) on the CPU: the coordinates its shared
window has to survive, through the port's ``ops.warp.sample(...,
diff_img=True)`` (the plain sampler on CPU tensors) against the JAX
package's XLA sampler and its Pallas op in interpret mode; and the host's
tile plan, read with the kernel's own thread-to-pixel map and window rule.

Tolerances: values rtol 1e-5 / atol 1e-6; dimg, dx, dy rtol 1e-4 / atol
1e-5 (both sides sum the same products in other orders; a clamped pile sums
hundreds of them into one pixel)."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.ops.pallas.warp import bilinear_sample_pallas
from supervised_dispnet_tpu.ops.sampling import bilinear_sample as jax_sample
from supervised_dispnet_tpu_torch.ops import warp as port_warp
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

CSRC = Path(kw.__file__).resolve().parents[2] / "csrc" / "warp.cu"


def _road_coords(rng, B, Ho, Wo, H, W, near=0.0, tz=-0.5, shift=0.05):
    """Where a (Ho, Wo) target's pixels land in an (H, W) source: a road
    scene's depth (far above the horizon, falling towards the bottom rows,
    times 1 + 5% noise), ``near`` of the pixels at a tenth of their depth,
    moved by a forward translation ``tz`` (m; negative zooms in, throwing
    the bottom corners out of view), a sideways ``shift`` and a small yaw."""
    v, u = np.meshgrid(np.arange(Ho, dtype=np.float64), np.arange(Wo, dtype=np.float64),
                       indexing="ij")
    fy, cy = 1.92 * Ho, Ho / 2
    depth = np.clip(1.65 * fy / np.maximum(v - cy, 0.5), 3.0, 80.0)
    depth = depth * (1.0 + 0.05 * rng.standard_normal((B, Ho, Wo)))
    depth = np.where(rng.uniform(size=depth.shape) < near, 0.1 * depth, depth)
    fx, cx = 0.58 * Wo, Wo / 2
    X, Y = (u - cx) / fx * depth, (v - cy) / fy * depth
    yaw = 0.01 * rng.standard_normal((B, 1, 1))
    Xs = np.cos(yaw) * X + np.sin(yaw) * depth + shift
    Zs = np.maximum(-np.sin(yaw) * X + np.cos(yaw) * depth + tz, 1e-3)
    # no coordinate an exact integer, where the XLA form's subgradient is
    # another one (``test_torch_sampling.py`` checks those apart): the
    # source's principal point off the pixel grid, and a chance integer
    # moved to the next float
    x = (0.58 * W * Xs / Zs + W / 2 + 0.41).astype(np.float32)
    y = (1.92 * H * Y / Zs + H / 2 - 0.29).astype(np.float32)
    return tuple(np.where(a == np.round(a), np.nextafter(a, np.float32(np.inf)), a)
                 for a in (x, y))


# name: (B, H, W, C, Ho, Wo, coordinate options, padding modes)
CASES = {
    "smooth-depth projection": (2, 32, 64, 3, 32, 64, {}, ("zeros", "border")),
    "near points thrown far": (2, 32, 64, 3, 32, 64, {"near": 0.1}, ("zeros", "border")),
    "border piles on the edges": (2, 32, 64, 3, 32, 64, {"tz": -2.0, "shift": 0.6},
                                  ("border",)),
    "Ho != H, ragged tiles": (1, 32, 64, 3, 19, 45, {}, ("zeros", "border")),
    "C=1": (2, 32, 64, 1, 32, 64, {}, ("border",)),
    "C=4, Ho != H": (1, 32, 64, 4, 27, 50, {"near": 0.05}, ("zeros",)),
}
PARAMS = [(name, mode) for name, case in CASES.items() for mode in case[-1]]


def _case(name, seed=0):
    B, H, W, C, Ho, Wo, opts, _ = CASES[name]
    rng = np.random.default_rng(seed)
    x, y = _road_coords(rng, B, Ho, Wo, H, W, **opts)
    img = rng.uniform(-1.0, 1.0, (B, H, W, C)).astype(np.float32)
    cot = rng.uniform(-1.0, 1.0, (B, Ho, Wo, C)).astype(np.float32)
    return img, x, y, cot


@pytest.mark.parametrize("name,padding_mode", PARAMS)
def test_image_and_coordinate_gradients_match_jax_xla_and_pallas(name, padding_mode):
    img, x, y, cot = _case(name)
    H, W = img.shape[1:3]
    inside = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    if name == "border piles on the edges":  # many pixels clamp onto one edge pixel
        assert 0.2 < 1 - inside.mean() < 0.9
    launches = (kw.warp_fwd_launches, kw.warp_bwd_launches, kw.warp_bwd_coords_launches)
    ti, tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (img, x, y))
    out = port_warp.sample(ti, tx, ty, padding_mode, diff_img=True)
    (out * torch.from_numpy(cot)).sum().backward()
    assert (kw.warp_fwd_launches, kw.warp_bwd_launches,
            kw.warp_bwd_coords_launches) == launches  # CPU tensors: the plain version
    got = [t.grad.numpy() for t in (ti, tx, ty)]
    refs = {
        "xla": lambda i, a, b: jax_sample(i, a, b, padding_mode=padding_mode),
        "pallas": lambda i, a, b: bilinear_sample_pallas(
            i, a, b, padding_mode=padding_mode, interpret=True),
    }
    args = (jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    for ref_name, fn in refs.items():
        ref = jax.jit(fn)(*args)
        grads = jax.jit(jax.grad(lambda i, a, b: jnp.sum(fn(i, a, b) * cot),
                                 argnums=(0, 1, 2)))(*args)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=ref_name)
        for a, b, which in zip(got, grads, ("img", "x", "y")):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{ref_name} d{which}")


def _csrc_constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", CSRC.read_text()).group(1)


def test_the_plan_constants_are_the_kernels():
    """``TILE_PIXELS`` and ``WIN_FLOATS`` are ``csrc/warp.cu``'s
    kThreads x kTilePixelsPerThread and kWinFloats; the window and the
    block's reduction arrays (a word a warp each, as the kernel declares
    them) fit the 48 KB of static shared memory."""
    threads = int(_csrc_constant("kThreads"))
    assert kw.TILE_PIXELS == threads * int(_csrc_constant("kTilePixelsPerThread"))
    assert kw.WIN_FLOATS == eval(_csrc_constant("kWinFloats"), {})  # an integer expression
    kernel = CSRC.read_text().split("warp_backward_kernel(", 1)[1]
    arrays = re.findall(r"__shared__ (?:int|unsigned|float) \w+((?:\[\d+\])?)\[kWarps\];",
                        kernel.split("\n\n", 1)[0])
    assert len(arrays) >= 4
    words = sum(int(a[1:-1]) if a else 1 for a in arrays)
    assert 4 * kw.WIN_FLOATS + 4 * words * threads // 32 <= 48 * 1024


def _kernel_window(bw, bh, C, win_w, win_floats=kw.WIN_FLOATS):
    """``csrc/warp.cu::warp_backward_kernel``'s window for a tile whose
    corners span a bw x bh box: the box where it fits, else at most win_w
    wide and as tall as the floats allow; (w, h), or None for no window."""
    if bh * kw.window_stride(bw, C) <= win_floats:
        return bw, bh
    w = min(bw, win_w)
    stride = kw.window_stride(w, C)
    h = min(bh, win_floats // stride) if w > 0 and stride <= win_floats else 0
    return (w, h) if h > 0 else None


SHAPES = [(128, 416), (64, 208), (32, 104), (16, 52), (37, 53), (19, 29), (1, 5000),
          (3, 4), (1, 1), (100, 300), (2000, 1), (33, 1025)]


@pytest.mark.parametrize("C", [1, 3, 4, 64])
@pytest.mark.parametrize("Ho,Wo", SHAPES)
def test_tile_plan_covers_every_pixel_once_within_the_shared_budget(Ho, Wo, C):
    """The plan for an (Ho, Wo) output, read with the kernel's map (thread t
    of a block takes tile pixels t + k * 256, row (t + k * 256) / tile_w): a
    block is one tile_w x tile_h tile, a warp's 32 lanes lie on one row;
    every output pixel falls in exactly one thread of one block; the window
    the kernel forms for any box of corners stays within ``WIN_FLOATS``; for
    C <= 4 an identity warp's box (the tile and one more column and row)
    fits whole, and a clipped window keeps at least the tile's width."""
    tile_w, tile_h, win_w = kw.tile_plan(Ho, Wo, C)
    assert tile_w * tile_h == kw.TILE_PIXELS and tile_w >= 32
    assert tile_w & (tile_w - 1) == 0
    t = np.arange(kw.TILE_PIXELS)
    rows, cols = t // tile_w, t % tile_w
    assert all(len(set(rows[w:w + 32])) == 1 for w in range(0, kw.TILE_PIXELS, 32))
    covered = np.zeros((Ho, Wo), int)
    for by in range(-(-Ho // tile_h)):
        for bx in range(-(-Wo // tile_w)):
            oy, ox = by * tile_h + rows, bx * tile_w + cols
            keep = (oy < Ho) & (ox < Wo)
            np.add.at(covered, (oy[keep], ox[keep]), 1)
    assert (covered == 1).all()
    rng = np.random.default_rng(Ho * 7919 + Wo + C)
    boxes = [(tile_w + 1, tile_h + 1), (1, 1), (Wo + 1, Ho + 1)]
    boxes += [tuple(int(v) for v in rng.integers(1, 3000, 2)) for _ in range(50)]
    for bw, bh in boxes:
        win = _kernel_window(bw, bh, C, win_w)
        if win is not None:
            w, h = win
            assert 1 <= w <= bw and 1 <= h <= bh
            assert h * kw.window_stride(w, C) <= kw.WIN_FLOATS
    if C <= 4:
        assert _kernel_window(tile_w + 1, tile_h + 1, C, win_w) == (tile_w + 1, tile_h + 1)
        assert win_w >= tile_w + 1


def test_warp_backward_passes_the_tiled_shape(monkeypatch):
    """The wrapper hands the C entry (B, H, W, C, Ho, Wo) with Wo the
    coordinates' last dimension, and the tile plan of that output: one
    argument for each of the entry's ``argtypes``; flat (B, P) coordinates
    are one row of P pixels. (CPU tensors stand in for the card's, with the
    device checks and the library replaced.)"""
    calls = []

    class FakeLib:
        def warp_backward(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(kw, "_check_inputs", lambda img, x, y, g, index: (
        img.shape[0], img.shape[1], img.shape[2], img.shape[3], x.numel() // img.shape[0]))
    monkeypatch.setattr(kw, "_lib", FakeLib)
    monkeypatch.setattr(kw, "_stream", lambda index: 0)
    monkeypatch.setattr(torch.Tensor, "get_device", lambda self: 0)
    monkeypatch.setattr(kw, "warp_bwd_launches", 0)
    img = torch.zeros(2, 32, 64, 3)
    for shape, mode in (((2, 19, 45), "zeros"), ((2, 855), "border")):
        x, y = torch.zeros(shape), torch.zeros(shape)
        kw.warp_backward(img, x, y, torch.zeros(*shape, 3), mode)
        args = calls[-1]
        assert len(args) == len(kw._SIGNATURES["warp_backward"])
        Ho, Wo = (19, 45) if len(shape) == 3 else (1, 855)
        assert args[7:15] == (2, 32, 64, 3, Ho, Wo, *kw.tile_plan(Ho, Wo, 3)[::2])
        assert args[15] == int(mode == "border")
    assert kw.warp_bwd_launches == 2
