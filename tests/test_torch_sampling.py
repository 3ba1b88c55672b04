"""The port's plain bilinear sampler (``ops/sampling.py``) against the JAX
package's XLA sampler (``ops/sampling.py::bilinear_sample``) and its Pallas
warp op in interpret mode (``ops/pallas/warp.py::bilinear_sample_pallas``),
on the CPU in fp32: values rtol 1e-5, gradients in img, x and y rtol 1e-4
(both sum the same four products in other orders). Coordinates are uniform
random, so none is an exact integer: there the XLA form's tent weights and
the floor-based corners have other subgradients (checked apart, against the
Pallas op, which uses the floor-based form as the port does)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.ops.pallas.warp import bilinear_sample_pallas
from supervised_dispnet_tpu.ops.sampling import bilinear_sample as jax_sample
from supervised_dispnet_tpu.ops.sampling import grid_sample as jax_grid_sample
from supervised_dispnet_tpu_torch.ops import warp as port_warp
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample, grid_sample

# (B, H, W, C, Ho, Wo, spread): spread > 1 puts many coordinates well out of
# bounds, some by several image widths
CASES = {
    "C3": (2, 32, 64, 3, 32, 64, 1.3),
    "C1 Ho!=H": (1, 32, 64, 1, 16, 40, 1.3),
    "far out of bounds": (2, 32, 64, 3, 8, 12, 8.0),
}


def _case(B, H, W, C, Ho, Wo, spread, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, H, W, C)).astype(np.float32)
    x = (rng.uniform(-0.2, 1.2, (B, Ho, Wo)) * (W - 1) * spread - 2).astype(np.float32)
    y = (rng.uniform(-0.2, 1.2, (B, Ho, Wo)) * (H - 1) * spread - 2).astype(np.float32)
    cot = rng.standard_normal((B, Ho, Wo, C)).astype(np.float32)
    return img, x, y, cot


def _jax_value_and_grads(fn, img, x, y, cot):
    def loss(i, a, b):
        return jnp.sum(fn(i, a, b) * cot)
    args = (jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    out = jax.jit(fn)(*args)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_value_and_grads(img, x, y, cot, padding_mode, diff_img=True):
    ti, tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (img, x, y))
    out = port_warp.sample(ti, tx, ty, padding_mode, diff_img=diff_img)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [None if t.grad is None else t.grad.numpy()
                                  for t in (ti, tx, ty)]


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("case", list(CASES))
def test_sampler_matches_jax_xla_and_pallas(case, padding_mode):
    img, x, y, cot = _case(*CASES[case])
    launches = (kw.warp_fwd_launches, kw.warp_bwd_launches, kw.warp_bwd_coords_launches)
    got, g_got = _port_value_and_grads(img, x, y, cot, padding_mode)
    assert (kw.warp_fwd_launches, kw.warp_bwd_launches,
            kw.warp_bwd_coords_launches) == launches  # CPU tensors: the plain version
    refs = {
        "xla": lambda i, a, b: jax_sample(i, a, b, padding_mode=padding_mode),
        "pallas": lambda i, a, b: bilinear_sample_pallas(
            i, a, b, padding_mode=padding_mode, interpret=True),
    }
    for name, fn in refs.items():
        ref, g_ref = _jax_value_and_grads(fn, img, x, y, cot)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6, err_msg=name)
        for a, b, which in zip(g_got, g_ref, ("img", "x", "y")):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} d{which}")


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_coordinate_only_gradients_equal_the_full_ones(padding_mode):
    """``diff_img=False`` (the photometric loss's refs): the same value and
    the same x, y gradients, and no gradient reaches img."""
    img, x, y, cot = _case(*CASES["C3"], seed=4)
    out_f, (gi_f, gx_f, gy_f) = _port_value_and_grads(img, x, y, cot, padding_mode)
    out_c, (gi_c, gx_c, gy_c) = _port_value_and_grads(img, x, y, cot, padding_mode,
                                                      diff_img=False)
    assert gi_c is None and gi_f is not None
    np.testing.assert_array_equal(out_c, out_f)
    np.testing.assert_array_equal(gx_c, gx_f)
    np.testing.assert_array_equal(gy_c, gy_f)


def test_integer_coordinate_subgradient_matches_the_pallas_op():
    """At exact integer coordinates, and at x = W-1 / y = H-1 on the border,
    the floor-based corners give the Pallas op's coordinate subgradient
    (forward difference; zero where 'border' clamps)."""
    rng = np.random.default_rng(2)
    img = rng.standard_normal((1, 8, 10, 2)).astype(np.float32)
    x = np.array([[[2.0, 3.5, 9.0, 0.0, 9.0]]], np.float32)
    y = np.array([[[4.0, 1.0, 7.0, 0.0, 3.25]]], np.float32)
    cot = rng.standard_normal((1, 1, 5, 2)).astype(np.float32)
    for padding_mode in ("zeros", "border"):
        got, g_got = _port_value_and_grads(img, x, y, cot, padding_mode)
        ref, g_ref = _jax_value_and_grads(
            lambda i, a, b: bilinear_sample_pallas(i, a, b, padding_mode=padding_mode,
                                                   interpret=True), img, x, y, cot)
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        for a, b in zip(g_got, g_ref):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=padding_mode)


def test_huge_coordinates_sample_zeros_and_stay_finite():
    """Coordinates beyond the int range (cam2pixel keeps Z >= 1e-3, not x in
    view) are clamped before the integer cast: zeros, finite gradients."""
    img = np.ones((1, 4, 5, 3), np.float32)
    x = np.array([[[3e9, -3e9, 1e30, 2.5]]], np.float32)
    y = np.array([[[1.5, 1.5, -1e30, 4e9]]], np.float32)
    got, grads = _port_value_and_grads(img, x, y, np.ones((1, 1, 4, 3), np.float32),
                                       "zeros")
    np.testing.assert_array_equal(got, np.zeros_like(got))
    assert all(np.isfinite(g).all() for g in grads)
    border, _ = _port_value_and_grads(img, x, y, np.ones((1, 1, 4, 3), np.float32),
                                      "border")
    np.testing.assert_array_equal(border, np.ones_like(border))


@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_matches_jax_and_torch(align_corners):
    """Normalised-grid wrapper: against JAX's ``grid_sample`` and against
    ``F.grid_sample`` (NCHW) with the same convention, rtol 1e-5."""
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 32, 64, 3)).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (2, 12, 20, 2)).astype(np.float32)
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid),
                      align_corners=align_corners).numpy()
    ref = jax_grid_sample(jnp.asarray(img), jnp.asarray(grid), align_corners=align_corners)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-6)
    tg = torch.nn.functional.grid_sample(
        torch.from_numpy(img).permute(0, 3, 1, 2), torch.from_numpy(grid),
        mode="bilinear", padding_mode="zeros", align_corners=align_corners)
    np.testing.assert_allclose(got, tg.permute(0, 2, 3, 1).numpy(), rtol=1e-5, atol=1e-6)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; they never fall back. The
    image+coordinate backward refuses before its tile plan, with (B, Ho, Wo)
    coordinates and flat (B, P) ones, in both padding modes."""
    img, x, y, cot = _case(*CASES["C1 Ho!=H"])
    t = [torch.from_numpy(a) for a in (img, x, y, cot)]
    launches = (kw.warp_fwd_launches, kw.warp_bwd_launches, kw.warp_bwd_coords_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.warp_forward(*t[:3])
    B, C = img.shape[0], img.shape[3]
    flat = [t[0], t[1].reshape(B, -1), t[2].reshape(B, -1), t[3].reshape(B, -1, C)]
    for args in (t, flat):
        for mode in ("zeros", "border"):
            with pytest.raises(ValueError, match="CUDA tensor"):
                kw.warp_backward(*args, mode)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.warp_backward_coords(*t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.bilinear_sample_cuda(*t[:3])
    assert (kw.warp_fwd_launches, kw.warp_bwd_launches,
            kw.warp_bwd_coords_launches) == launches


# the grouped sampler (ops/warp.py::sample_many): (B, H, W, C, Ho, Wo) of a
# mixed group, the 4 scales of a 2-ref pyramid, a C=1 and a ragged Ho != H
GROUP = [(2, 32 >> s, 64 >> s, 3, 32 >> s, 64 >> s) for s in range(4) for _ in range(2)]
GROUP += [(1, 32, 64, 1, 16, 40), (3, 37, 53, 3, 19, 29)]


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_sample_many_on_the_cpu_equals_the_plain_sampler_per_problem(padding_mode):
    """``sample_many`` on CPU tensors is ``bilinear_sample`` problem by
    problem: samples and x, y gradients equal bit for bit; no gradient
    reaches an image; no kernel counter moves."""
    cases = [_case(B, H, W, C, Ho, Wo, 1.3, seed=20 + i)
             for i, (B, H, W, C, Ho, Wo) in enumerate(GROUP)]
    counters = (kw.warp_fwd_launches, kw.warp_bwd_coords_launches, kw.warp_fwd_problems,
                kw.warp_bwd_coords_problems)
    imgs = [torch.from_numpy(c[0]).requires_grad_(True) for c in cases]
    xs = [torch.from_numpy(c[1]).requires_grad_(True) for c in cases]
    ys = [torch.from_numpy(c[2]).requires_grad_(True) for c in cases]
    outs = port_warp.sample_many(imgs, xs, ys, padding_mode)
    sum((o * torch.from_numpy(c[3])).sum() for o, c in zip(outs, cases)).backward()
    assert (kw.warp_fwd_launches, kw.warp_bwd_coords_launches, kw.warp_fwd_problems,
            kw.warp_bwd_coords_problems) == counters
    for k, (img, x, y, cot) in enumerate(cases):
        tx, ty = (torch.from_numpy(a).requires_grad_(True) for a in (x, y))
        ref = bilinear_sample(torch.from_numpy(img), tx, ty, padding_mode)
        (ref * torch.from_numpy(cot)).sum().backward()
        assert imgs[k].grad is None
        assert torch.equal(outs[k].detach(), ref.detach()), k
        assert torch.equal(xs[k].grad, tx.grad) and torch.equal(ys[k].grad, ty.grad), k


def _problem_of_block(block_starts, block):
    """``csrc/warp.cu::block_problem``: the last problem of a launch whose
    block_start is at most ``block``."""
    j = 0
    for i in range(1, len(block_starts)):
        j = i if block >= block_starts[i] else j
    return j


@pytest.mark.parametrize("sizes", [
    [4 * (128 >> s) * (416 >> s) for s in range(4) for _ in range(2)],  # selfsup step
    [2 * (32 >> s) * (64 >> s) for s in range(4) for _ in range(2)] + [640, 551 * 3],
    [1, 7, 300, 256, 257, 5, 1000, 3, 3, 12, 900, 2, 511, 512, 40, 9, 4096],  # 17
    [100] * 33,
    [1],
])
def test_plan_groups_covers_every_pixel_once_largest_first(sizes):
    """The host's plan for problems of ``sizes`` output pixels, read with
    the kernels' block scan (``_problem_of_block``): every output pixel of
    every problem falls in exactly one thread of one launch; each launch
    holds at most ``MAX_PROBLEMS`` problems, the largest (in blocks) first;
    a group above ``MAX_PROBLEMS`` splits (17 problems: 2 launches)."""
    blocks = [-(-n // kw.THREADS) for n in sizes]
    plan = kw.plan_groups(blocks)
    assert len(plan) == -(-len(sizes) // kw.MAX_PROBLEMS)
    order = [i for launch in plan for i, _ in launch]
    assert sorted(order) == list(range(len(sizes)))
    assert [blocks[i] for i in order] == sorted(blocks, reverse=True)
    covered = [np.zeros(n, int) for n in sizes]
    for launch in plan:
        assert 1 <= len(launch) <= kw.MAX_PROBLEMS
        starts = [start for _, start in launch]
        for block in range(starts[-1] + blocks[launch[-1][0]]):
            i, start = launch[_problem_of_block(starts, block)]
            first = (block - start) * kw.THREADS
            covered[i][first:first + kw.THREADS] += 1
    assert all((c == 1).all() for c in covered)


@pytest.mark.parametrize("entry", ["warp_forward_many", "warp_backward_coords_many",
                                   "_WarpManyFunction"])
def test_grouped_cuda_wrappers_refuse_cpu_tensors(entry):
    """The grouped entries take CUDA tensors only and never fall back; a
    refused group moves no launch or problem counter."""
    cases = [_case(*GROUP[k], 1.3, seed=k) for k in (0, 8)]
    imgs, xs, ys, gs = ([torch.from_numpy(c[j]) for c in cases] for j in range(4))
    counters = (kw.warp_fwd_launches, kw.warp_bwd_coords_launches, kw.warp_fwd_problems,
                kw.warp_bwd_coords_problems)
    call = {
        "warp_forward_many": lambda: kw.warp_forward_many(imgs, xs, ys),
        "warp_backward_coords_many": lambda: kw.warp_backward_coords_many(imgs, xs, ys, gs),
        "_WarpManyFunction": lambda: kw._WarpManyFunction.apply(
            "zeros", *(t for p in zip(imgs, xs, ys) for t in p)),
    }[entry]
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert (kw.warp_fwd_launches, kw.warp_bwd_coords_launches, kw.warp_fwd_problems,
            kw.warp_bwd_coords_problems) == counters


def test_sample_many_refuses_other_devices_and_an_empty_group():
    meta = torch.empty((1, 4, 5, 3), device="meta")
    xy = torch.empty((1, 4, 5), device="meta")
    with pytest.raises(ValueError, match="device meta"):
        port_warp.sample_many([meta], [xy], [xy])
    with pytest.raises(ValueError, match="no problem"):
        port_warp.sample_many([], [], [])
