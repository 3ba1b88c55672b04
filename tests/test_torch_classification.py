"""The port's depth-as-classification losses against the JAX package's, on
the CPU: ``DepthBins`` (edges, centers and exactly equal labels), the plain
CE against the XLA loss and the interpret-mode Pallas op (value and
logits-gradient), the kernels' split into a forward that keeps each
pixel's logsumexp and a backward from it, the multi-scale CE, the soft
decode, and the layouts and paths the CUDA wrapper hands its kernels.
Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.losses import classification as jax_cls
from supervised_dispnet_tpu.ops.pallas import depth_classification_loss_pallas
from supervised_dispnet_tpu_torch.losses import classification as cls
from supervised_dispnet_tpu_torch.ops.cuda import classification as kc
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

SPACINGS = ["linear", "log", "inverse"]
JAX_CE = {
    "xla": jax_cls.depth_classification_loss,
    "pallas": lambda lg, d, m, b: depth_classification_loss_pallas(lg, d, m, b, interpret=True),
}


def _bins(K, spacing="log"):
    return jax_cls.DepthBins(num_bins=K, spacing=spacing), cls.DepthBins(num_bins=K, spacing=spacing)


def _ce_inputs(shape, K, mask_kind, seed):
    """Unit-normal logits, GT depth over [0.5, 90] m (beyond both ends of
    the bins, so labels 0 and K-1 occur) and a mask: ~30% sparse, empty, or
    float weights in (0, 1]."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((*shape, K)).astype(np.float32)
    gt = rng.uniform(0.5, 90.0, shape).astype(np.float32)
    mask = rng.uniform(size=shape) < 0.3
    if mask_kind == "empty":
        mask = np.zeros(shape, bool)
    elif mask_kind == "float":
        mask = (mask * rng.uniform(0.05, 1.0, shape)).astype(np.float32)
    return logits, gt, mask


@pytest.mark.parametrize("spacing", SPACINGS)
def test_depth_bins_match_jax(spacing):
    """Edges and centers rtol 1e-6 (the JAX package forms them in float32,
    the port in float64 rounded once); labels exactly equal, both ends of
    the range and beyond included."""
    for K in (64, 16, 48):
        jb, tb = _bins(K, spacing)
        np.testing.assert_allclose(tb.edges().numpy(), np.asarray(jb.edges()), rtol=1e-6)
        np.testing.assert_allclose(tb.centers().numpy(), np.asarray(jb.centers()), rtol=1e-6)
        rng = np.random.default_rng(K)
        d = np.concatenate([rng.uniform(0.5, 90.0, 50_000),
                            [0.0, 1.0, 80.0, 100.0, np.asarray(jb.edges())[K // 2]]])
        d = d.astype(np.float32)
        labels = tb.depth_to_index(torch.from_numpy(d))
        assert labels.dtype == torch.int32
        np.testing.assert_array_equal(labels.numpy(), np.asarray(jb.depth_to_index(jnp.asarray(d))))
        assert labels[-5:-3].tolist() == [0, 0] and labels[-3:-1].tolist() == [K - 1, K - 1]


def test_depth_bins_refuse_unknown_spacing():
    with pytest.raises(ValueError, match="spacing"):
        cls.DepthBins(spacing="cubic").edges()
    with pytest.raises(ValueError, match="spacing"):
        cls.DepthBins(spacing="cubic").depth_to_index(torch.ones(3))


@pytest.mark.parametrize("impl", sorted(JAX_CE))
@pytest.mark.parametrize("K", [64, 48, 1])
@pytest.mark.parametrize("mask_kind", ["sparse", "empty", "float"])
def test_ce_plain_matches_jax(impl, K, mask_kind):
    """Value and logits-gradient, rtol 1e-5 / atol 1e-6 of the largest
    gradient entry (the sums run in another order); a CPU tensor takes the
    plain version and never launches the kernels. K=1 and an empty mask:
    loss and gradient 0."""
    shape = (2, 8, 12)
    logits, gt, mask = _ce_inputs(shape, K, mask_kind, seed=K)
    jb, tb = _bins(K)
    ref_loss, ref_grad = jax.value_and_grad(JAX_CE[impl])(
        jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(mask), jb)
    launches = (kc.ce_fwd_launches, kc.ce_bwd_launches)
    lg = torch.from_numpy(logits).requires_grad_(True)
    loss = cls.depth_classification_loss(lg, torch.from_numpy(gt), torch.from_numpy(mask), tb)
    loss.backward()
    assert (kc.ce_fwd_launches, kc.ce_bwd_launches) == launches
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(lg.grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-6 * np.abs(ref_grad).max())
    if K == 1 or mask_kind == "empty":
        assert loss.item() == 0.0 and not lg.grad.any()


@pytest.mark.parametrize("K", [64, 48, 1])
@pytest.mark.parametrize("mask_kind", ["sparse", "empty", "float"])
def test_ce_split_plain_matches_jax(K, mask_kind):
    """``ce_forward_plain`` then ``ce_backward_plain`` from its lse and
    stats, the kernels' split, against the interpret-mode Pallas op: value
    and logits-gradient with the tolerances of ``test_ce_plain_matches_jax``;
    the count is the mask's sum."""
    logits, gt, mask = _ce_inputs((2, 8, 12), K, mask_kind, seed=K + 1)
    jb, tb = _bins(K)
    ref_loss, ref_grad = jax.value_and_grad(JAX_CE["pallas"])(
        jnp.asarray(logits), jnp.asarray(gt), jnp.asarray(mask), jb)
    x, m = torch.from_numpy(logits), torch.from_numpy(mask)
    labels = tb.depth_to_index(torch.from_numpy(gt))
    stats, lse = kc.ce_forward_plain(x, labels, m)
    grad = kc.ce_backward_plain(x, labels, m, lse, stats, torch.tensor(1.0))
    assert lse.shape == (2, 2, 8, 12) and grad.shape == x.shape
    ref_grad = np.asarray(ref_grad)
    np.testing.assert_allclose(stats[0].item(), float(ref_loss), rtol=1e-5, atol=1e-7)
    assert stats[1].item() == pytest.approx(float(mask.sum()), rel=1e-6)
    np.testing.assert_allclose(grad.numpy(), ref_grad, rtol=1e-5,
                               atol=1e-6 * np.abs(ref_grad).max())


@pytest.mark.parametrize("K", [64, 48])
def test_ce_split_lse_matches_jax_logsumexp_with_minus_inf_bins(K):
    """``lse[0]`` against ``jax.nn.logsumexp``, rtol 1e-6, on rows that hold
    -inf: in bin 0 alone, in the 20 leading bins, in every third bin, and a
    row of only -inf (lse -inf on both sides); the gradient stays finite
    wherever a row has a finite entry at its label."""
    logits, gt, mask = _ce_inputs((2, 8, 12), K, "sparse", seed=5)
    rows = logits.reshape(-1, K)
    rows[0::5, 0] = -np.inf
    rows[1::5, :20] = -np.inf
    rows[2::5, ::3] = -np.inf
    rows[3] = -np.inf
    x, m = torch.from_numpy(logits), torch.from_numpy(mask)
    labels = cls.DepthBins(num_bins=K).depth_to_index(torch.from_numpy(gt))
    stats, lse = kc.ce_forward_plain(x, labels, m)
    ref = np.asarray(jax.nn.logsumexp(jnp.asarray(logits), axis=-1))
    assert np.isneginf(ref.reshape(-1)[3]) and np.isfinite(np.delete(ref.reshape(-1), 3)).all()
    np.testing.assert_allclose(lse[0].numpy(), ref, rtol=1e-6)
    grad = kc.ce_backward_plain(x, labels, m, lse, stats, torch.tensor(1.0)).reshape(-1, K)
    at_label = np.take_along_axis(rows, labels.numpy().reshape(-1, 1), 1)[:, 0]
    assert torch.isfinite(grad[torch.from_numpy(np.isfinite(at_label))]).all()


def test_ce_split_backward_keeps_its_precision_at_large_logits():
    """Logits at 3e4 +- a few units, where an ulp of the lse is 2e-3: the
    backward's exp((x - lse[0]) - lse[1]) matches the plain CE's autograd
    gradient (loss rtol 1e-5; gradient rtol 1e-5 / atol 1e-6 of its largest
    entry), and lse[1] holds lse[0]'s rounding error. With lse[0] alone the
    gradient misses that tolerance: the split is what keeps it."""
    rng = np.random.default_rng(9)
    shape, K = (2, 8, 12), 64
    logits = (3e4 + 2.0 * rng.standard_normal((*shape, K))).astype(np.float32)
    labels = torch.from_numpy(rng.integers(0, K, shape).astype(np.int32))
    m = torch.from_numpy(rng.uniform(size=shape) < 0.5)
    x = torch.from_numpy(logits).requires_grad_(True)
    loss = cls.depth_classification_loss_plain(x, None, m, labels=labels)
    (ref,) = torch.autograd.grad(loss, x)
    stats, lse = kc.ce_forward_plain(x.detach(), labels, m)
    g = torch.tensor(1.0)
    grad = kc.ce_backward_plain(x.detach(), labels, m, lse, stats, g)
    tol = {"rtol": 1e-5, "atol": 1e-6 * float(ref.abs().max())}
    np.testing.assert_allclose(stats[0].item(), loss.item(), rtol=1e-5)
    torch.testing.assert_close(grad, ref, **tol)
    exact = torch.logsumexp(torch.from_numpy(logits).double(), -1)
    assert float((lse[0].double() + lse[1].double() - exact).abs().max()) < 1e-5
    assert float((lse[0].double() - exact).abs().max()) > 1e-4
    one_float = torch.stack([lse[0], torch.zeros_like(lse[1])])
    assert not torch.allclose(kc.ce_backward_plain(x.detach(), labels, m, one_float, stats, g),
                              ref, **tol)


def _nchw_view(B, H, W, K, offset=0):
    """The (B, H, W, K) view of an NCHW tensor, ``offset`` floats into its
    storage."""
    storage = torch.randn(B * K * H * W + offset)
    return storage[offset:].view(B, K, H, W).permute(0, 2, 3, 1)


def _shifted(t: torch.Tensor, offset: int) -> torch.Tensor:
    """``t``'s values ``offset`` elements into a larger storage."""
    storage = torch.zeros(t.numel() + offset, dtype=t.dtype)
    storage[offset:] = t.reshape(-1)
    return storage[offset:].view(t.shape)


VECTOR_CASES = {
    # name: (logits, labels offset, mask dtype, mask offset, the vector path)
    "NCHW view, P % 4 == 0": (lambda: _nchw_view(2, 8, 12, 64), 0, torch.bool, 0, True),
    "NCHW view, K=100": (lambda: _nchw_view(2, 8, 12, 100), 0, torch.bool, 0, True),
    "NCHW view, float mask": (lambda: _nchw_view(2, 8, 12, 64), 0, torch.float32, 0, True),
    "contiguous (..., K)": (lambda: torch.randn(2, 8, 12, 64), 0, torch.bool, 0, False),
    "P not a multiple of 4": (lambda: _nchw_view(2, 7, 13, 64), 0, torch.bool, 0, False),
    "logits offset by one float": (lambda: _nchw_view(2, 8, 12, 64, offset=1), 0, torch.bool,
                                   0, False),
    "labels offset by one": (lambda: _nchw_view(2, 8, 12, 64), 1, torch.bool, 0, False),
    "byte mask offset by one byte": (lambda: _nchw_view(2, 8, 12, 64), 0, torch.bool, 1, False),
    "float mask offset by one float": (lambda: _nchw_view(2, 8, 12, 64), 0, torch.float32, 1,
                                       False),
}


@pytest.mark.parametrize("name", sorted(VECTOR_CASES))
def test_ce_vector_path_is_chosen_by_shape_and_alignment(name):
    """4 pixels a thread only for the NCHW view with P a multiple of 4 and
    16-byte-aligned logits and labels (the mask at 4 of its elements); the
    scalar path otherwise. CPU tensors: the choice needs no launch."""
    make, label_offset, mask_dtype, mask_offset, want = VECTOR_CASES[name]
    logits = make()
    shape = logits.shape[:-1]
    labels = _shifted(torch.zeros(shape, dtype=torch.int32), label_offset)
    mask = _shifted(torch.ones(shape, dtype=mask_dtype), mask_offset)
    assert kc.vector_path(logits, labels, mask) is want


def test_ce_plain_reads_an_nchw_view_as_a_contiguous_tensor():
    """The (B, H, W, K) view of an NCHW tensor (the conv head's output)
    gives the same loss and gradient as the same values contiguous, and its
    gradient comes back in the view's layout."""
    logits, gt, mask = _ce_inputs((2, 8, 12), 16, "sparse", seed=1)
    tb = cls.DepthBins(num_bins=16)
    nchw = torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)))
    view = nchw.requires_grad_(True).permute(0, 2, 3, 1)
    assert kc.is_nchw_view(view) and not view.is_contiguous()
    flat = torch.from_numpy(logits).requires_grad_(True)
    a = cls.depth_classification_loss(view, torch.from_numpy(gt), torch.from_numpy(mask), tb)
    b = cls.depth_classification_loss(flat, torch.from_numpy(gt), torch.from_numpy(mask), tb)
    a.backward()
    b.backward()
    assert a.item() == b.item()
    np.testing.assert_array_equal(nchw.grad.permute(0, 2, 3, 1).numpy(), flat.grad.numpy())


def test_ce_plain_takes_labels_instead_of_depth():
    logits, gt, mask = _ce_inputs((2, 8, 12), 16, "sparse", seed=2)
    tb = cls.DepthBins(num_bins=16)
    args = (torch.from_numpy(logits), torch.from_numpy(gt), torch.from_numpy(mask))
    by_depth = cls.depth_classification_loss_plain(*args, tb)
    by_labels = cls.depth_classification_loss_plain(
        args[0], None, args[2], labels=tb.depth_to_index(args[1]))
    assert by_depth.item() == by_labels.item()
    with pytest.raises(ValueError, match="labels"):
        cls.depth_classification_loss_plain(args[0], args[1], args[2])


def test_multiscale_classification_loss_matches_jax():
    """Four scales (1, 1/2, 1/4, 1/8), each upsampled to GT size, weights
    (1, .5, .25, .125): value rtol 1e-5, every scale's gradient rtol 1e-4 /
    atol 1e-6 of its largest entry (the upsample's backward sums in another
    order)."""
    B, H, W, K = 2, 32, 48, 16
    rng = np.random.default_rng(11)
    gt = rng.uniform(0.5, 90.0, (B, H, W)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W)) < 0.3
    logits = [rng.standard_normal((B, H >> s, W >> s, K)).astype(np.float32) for s in range(4)]
    jb, tb = _bins(K)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda ls: jax_cls.multiscale_classification_loss(
            ls, jnp.asarray(gt), jnp.asarray(mask), jb))([jnp.asarray(x) for x in logits])
    ls = [torch.from_numpy(x).requires_grad_(True) for x in logits]
    loss = cls.multiscale_classification_loss(ls, torch.from_numpy(gt), torch.from_numpy(mask), tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for x, g in zip(ls, ref_grads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=1e-4, atol=1e-6 * np.abs(g).max())


@pytest.mark.parametrize("spacing", SPACINGS)
def test_logits_to_depth_matches_jax(spacing):
    """Soft decode, rtol 1e-5; logits spread over +-8 so some pixels are
    near one-hot."""
    logits = (8.0 * np.random.default_rng(3).standard_normal((2, 8, 12, 16))).astype(np.float32)
    jb, tb = _bins(16, spacing)
    ref = np.asarray(jax_cls.logits_to_depth(jnp.asarray(logits), jb))
    got = cls.logits_to_depth(torch.from_numpy(logits), tb)
    assert got.shape == (2, 8, 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)


def test_ce_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the wrapper raises before any launch and leaves its
    counters as they were."""
    logits, gt, mask = _ce_inputs((1, 4, 5), 8, "sparse", seed=0)
    lg, m = torch.from_numpy(logits), torch.from_numpy(mask)
    labels = cls.DepthBins(num_bins=8).depth_to_index(torch.from_numpy(gt))
    launches = (kc.ce_fwd_launches, kc.ce_bwd_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.cross_entropy_cuda(lg, labels, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.ce_forward(lg, labels, m)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kc.ce_backward(lg, labels, m, torch.zeros(2, 1, 4, 5), torch.zeros(2), torch.ones(()))
    assert (kc.ce_fwd_launches, kc.ce_bwd_launches) == launches


def test_kernel_layout_reads_both_dense_layouts_in_place():
    """(B, P, K, batch, pixel, bin strides): the NCHW view and contiguous
    logits pass as they are; another layout is copied to contiguous."""
    B, H, W, K = 2, 3, 5, 7
    nchw = torch.randn(B, K, H, W)
    view = nchw.permute(0, 2, 3, 1)
    got, shape = kc.kernel_layout(view)
    assert got.data_ptr() == nchw.data_ptr()
    assert shape == (B, H * W, K, K * H * W, 1, H * W)
    flat = torch.randn(B, H, W, K)
    got, shape = kc.kernel_layout(flat)
    assert got.data_ptr() == flat.data_ptr() and shape == (B, H * W, K, H * W * K, K, 1)
    odd = torch.randn(B, W, H, K).transpose(1, 2)  # neither layout
    got, shape = kc.kernel_layout(odd)
    assert got.is_contiguous() and torch.equal(got, odd) and shape[3:] == (H * W * K, K, 1)
    got, shape = kc.kernel_layout(torch.randn(6, K))
    assert shape == (6, 1, K, K, K, 1)
