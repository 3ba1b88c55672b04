"""The trainer's options in the port against the JAX package's, on the CPU:
the bf16 trunk, EMA and gradient accumulation, ImageNet normalisation, hue
jitter, the ImageNet encoder conversion, and remat.

- **bf16 forwards** (DispNetS, DispResNet-18, VGG-BN, PoseExpNet at 32x64,
  B=2, train mode, biases and BN parameters away from their init) against
  the JAX model ``clone(dtype=bfloat16)``, as the JAX trainer builds it,
  compiled without XLA's excess precision (by default a fusion may keep a
  conv's bf16 output in float32 on its way into a BN): then both sides
  round where flax's casts say, and agree on each op but for a rounding
  near a tie. The first stage is held to mean relative error <= 2e-4
  (measured <= 6.4e-5) and must be 10x nearer JAX's than the port's fp32
  stage is (>= 3.1e-3). Through a network's depth the one-ulp flips spread
  as bf16 noise does, until the outputs are about as far from JAX's bf16
  ones as an fp32 forward is: they are held to <= 2e-2 (measured <=
  1.3e-2, VGG-BN's coarsest scale). Parameters, the heads and the
  disparities stay float32.
- **bf16 BerHu step** (DispResNet-18, ImageNet normalisation) against the
  JAX bf16 clone's loss and gradients (compiled as above): loss rtol 1e-2
  (measured 2.0e-6); the gradients by relative L2 over all parameters
  <= 0.1 (measured 0.074: the backward's bf16 roundings spread too) and
  <= 0.75x the port's fp32 step's distance (measured 0.62x). ImageNet
  normalisation itself is exact (``test_torch_augment.py``); a step
  normalising with 0.5 / 0.5 instead would miss the loss by far more.
- **EMA and accumulation**: ``ApplyGradients`` against the JAX
  ``TrainState.apply_gradients`` with the JAX trainer's optimizer
  (``optax.MultiSteps`` of Adam for k > 1), fed the same gradients:
  parameters and shadow within 1e-6 / 1e-5 (one float32 computation
  reordered).
- **Hue**: the port's ``augment_batch`` with JAX's draws, hue angle
  included, atol 1e-6 (the YIQ inverse is float32 on both sides).
- **Encoder conversion**: exact against JAX's ``convert_resnet_encoder``.
- **Remat** "full" and "conv": the same loss, gradients (rtol 1e-5) and BN
  running statistics as without, for every network and the
  self-supervised photometric terms; "conv" recomputes no convolution.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.losses.supervised import berhu_loss as jax_berhu
from supervised_dispnet_tpu.losses.supervised import multiscale_supervised_loss as jax_msl
from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.models import DispVggBN as JaxDispVggBN
from supervised_dispnet_tpu.models import FCRN as JaxFCRN
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.training.train_step import TrainState
from supervised_dispnet_tpu.training.trainer import TrainerConfig as JaxTrainerConfig
from supervised_dispnet_tpu.training.trainer import build_optimizer as jax_build_optimizer
from supervised_dispnet_tpu.utils.checkpoint import convert_resnet_encoder as jax_convert
from supervised_dispnet_tpu_torch.data.augment import (
    IMAGENET_MEAN, IMAGENET_STD, AugmentConfig, augment_batch, draw_augment)
from supervised_dispnet_tpu_torch.losses.selfsup import photometric_reconstruction_loss
from supervised_dispnet_tpu_torch.models import (
    DispNetS, DispResNet, DispVggBN, PoseExpNet, get_disp_net)
from supervised_dispnet_tpu_torch.models.common import set_compute_dtype, set_remat
from supervised_dispnet_tpu_torch.models.resnet import ResNetEncoder
from supervised_dispnet_tpu_torch.training.train_step import (
    ApplyGradients, make_supervised_train_step)
from supervised_dispnet_tpu_torch.training.trainer import (
    TrainerConfig, aug_config, build_optimizer)
from supervised_dispnet_tpu_torch.utils.convert import (
    _put_resnet, convert_resnet_encoder, disp_vgg_bn_from_jax, dispnet_from_jax,
    dispresnet_from_jax, posexpnet_from_jax)
from tests.test_torch_augment import _inputs as aug_inputs
from tests.test_torch_augment import jax_draws

B, H, W = 2, 32, 64
BF16 = torch.bfloat16


def _variables(model, *args, seed: int = 0) -> dict:
    """The model's variables, drawn with numpy on the shapes of its init
    (no compile): He-normal kernels, and biases, BN scales, biases and
    running statistics away from their init."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)

    def leaf(path, x):
        name = str(path[-1])
        if "kernel" in name:
            return (rng.standard_normal(x.shape) * np.sqrt(2.0 / np.prod(x.shape[:-1])))\
                .astype(np.float32)
        if "var" in name or "scale" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, jax.tree.map(lambda x: x, shapes))


def _mrel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / np.abs(b).mean())


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, (B, H, W, 3)).astype(np.float32) for _ in range(n)]


# network -> (JAX model, port model, converter, its first stage: (flax
# intermediates path, port module path))
BF16_NETS = {
    "dispnet": (JaxDispNetS, DispNetS, lambda v: dispnet_from_jax(v["params"]),
                (("conv1",), "conv1")),
    "disp_res_18": (lambda: JaxDispResNet(encoder_depth=18), lambda: DispResNet(18),
                    lambda v: dispresnet_from_jax(v["params"], v["batch_stats"], 18),
                    (("encoder", "bn1"), "encoder.bn1")),
    "disp_vgg_bn": (JaxDispVggBN, DispVggBN,
                    lambda v: disp_vgg_bn_from_jax(v["params"], v["batch_stats"]),
                    (("stage0",), "encoder.features.5")),
    "posexpnet": (lambda: JaxPoseExpNet(nb_ref_imgs=2), lambda: PoseExpNet(nb_ref_imgs=2),
                  lambda v: posexpnet_from_jax(v["params"]), (("conv1",), "conv1")),
}


@pytest.mark.parametrize("net", list(BF16_NETS))
def test_bf16_forward_matches_jax_bf16(net):
    jax_cls, port_cls, convert, (jax_path, port_path) = BF16_NETS[net]
    inputs = _images(3 if net == "posexpnet" else 1, seed=1)
    jargs = (jnp.asarray(inputs[0]), [jnp.asarray(r) for r in inputs[1:]])[
        :2 if net == "posexpnet" else 1]
    jmodel = jax_cls()
    v = _variables(jmodel, *jargs, seed=2)
    bn = "batch_stats" in v

    def forward(v, *args):
        kw = {"train": True, "mutable": ["batch_stats", "intermediates"]} if bn else {
            "mutable": ["intermediates"]}
        out, state = jmodel.clone(dtype=jnp.bfloat16).apply(
            v, *args, capture_intermediates=True, **kw)
        inter = state["intermediates"]
        for k in jax_path:
            inter = inter[k]
        return out, inter["__call__"][0]

    # XLA's default lets a fusion keep a bf16 value in float32 (a conv's
    # output going into a BN); without that, flax's casts are what run
    forward = jax.jit(forward).lower(v, *jargs).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref, ref_stage = forward(v, *jargs)
    stages = {}
    ports = {}
    for dtype in (None, BF16):
        port = port_cls()
        port.load_state_dict(convert(v), strict=True)
        assert set_compute_dtype(port, dtype)
        port.get_submodule(port_path).register_forward_hook(
            lambda m, i, o, d=dtype: stages.__setitem__(d, o))
        targs = [torch.from_numpy(x) for x in inputs]
        with torch.no_grad():
            ports[dtype] = port.train()(targs[0], targs[1:]) if net == "posexpnet" \
                else port.train()(targs[0])
        assert all(p.dtype == torch.float32 for p in port.parameters())
    assert stages[BF16].dtype == BF16 and stages[None].dtype == torch.float32
    ref_stage = np.asarray(ref_stage, np.float32)
    near = _mrel(stages[BF16].permute(0, 2, 3, 1).float(), ref_stage)
    far = _mrel(stages[None].permute(0, 2, 3, 1), ref_stage)
    assert near <= 2e-4 and near * 10 <= far, (near, far)
    got = ports[BF16]
    if net == "posexpnet":  # (masks, pose)
        got, ref = [*got[0], got[1]], [*ref[0], ref[1]]
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32
        assert _mrel(g, r) <= 2e-2


@pytest.fixture(scope="module")
def fcrn():
    """One FCRN for the tests here (a ResNet-50's init takes seconds)."""
    return get_disp_net("fcrn", seed=11, device="cpu")


def test_fcrn_stays_fp32_under_bf16(fcrn):
    """The JAX trainer casts only models with a ``dtype`` field; FCRN has
    none, so ``--bf16`` leaves it in float32 on both sides."""
    assert not hasattr(JaxFCRN(), "dtype") and hasattr(JaxDispResNet(), "dtype")
    model = copy.deepcopy(fcrn)
    assert not set_compute_dtype(model, BF16)  # what get_disp_net(bf16=True) calls
    seen = set()
    for m in model.modules():
        m.register_forward_hook(lambda m, i, o: seen.add(o.dtype))
    with torch.no_grad():
        out = model(torch.rand(1, H, W, 3))
    assert seen == {torch.float32} and out.dtype == torch.float32


def _depth_batch(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 60.0, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.3)
    return {"tgt": rng.integers(0, 256, (B, H, W, 3), dtype=np.uint8),
            "intrinsics": np.tile(K, (B, 1, 1)), "depth": depth.astype(np.float16)}


def test_bf16_imagenet_berhu_step_matches_jax_bf16():
    """One BerHu step of DispResNet-18 with a bf16 trunk on ImageNet-
    normalised inputs against JAX's (its augmentation off, ImageNet mean and
    std, the bf16 clone, compiled without excess precision)."""
    model = JaxDispResNet(encoder_depth=18)
    v = _variables(model, jnp.zeros((B, H, W, 3)), seed=4)
    batch = _depth_batch(5)
    jb = {k: jnp.asarray(val) for k, val in batch.items()}
    jaug = JaxAugmentConfig(flip=False, scale_crop=False, color_jitter=False,
                            mean=IMAGENET_MEAN, std=IMAGENET_STD)
    bf = model.clone(dtype=jnp.bfloat16)

    def loss_fn(params):
        imgs, _, depth = jax_augment_batch(
            jax.random.PRNGKey(0), jb["tgt"].astype(jnp.float32)[:, None] / 255.0,
            jb["intrinsics"], jb["depth"].astype(jnp.float32), config=jaug)
        mask = (depth > 0) & (depth < 80.0)
        disps, _ = bf.apply({"params": params, "batch_stats": v["batch_stats"]},
                            imgs[:, 0], train=True, mutable=["batch_stats"])
        return jax_msl([1.0 / d[..., 0] for d in disps], depth, mask, jax_berhu)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn)).lower(v["params"]).compile(
        compiler_options={"xla_allow_excess_precision": False})
    ref_loss, ref_grads = grad_fn(v["params"])
    ref = dispresnet_from_jax(jax.device_get(ref_grads), v["batch_stats"], 18)
    cfg = TrainerConfig(imagenet_normalization=True)
    aug = dataclasses.replace(aug_config(cfg), flip=False, scale_crop=False,
                              color_jitter=False)
    out = {}
    for bf16 in (False, True):
        port = get_disp_net("disp_res_18", bf16=bf16, device="cpu")
        port.load_state_dict(dispresnet_from_jax(v["params"], v["batch_stats"], 18),
                             strict=True)
        step = make_supervised_train_step(port, build_optimizer(cfg, port.parameters()),
                                          "berhu", aug=aug)
        loss = float(step({k: torch.from_numpy(val) for k, val in batch.items()})["loss"])
        assert all(p.grad.dtype == torch.float32 for p in port.parameters())
        names = [n for n, _ in port.named_parameters()]
        got = torch.cat([p.grad.flatten() for p in port.parameters()])
        want = torch.cat([ref[n].flatten() for n in names])
        out[bf16] = (abs(loss / float(ref_loss) - 1), float((got - want).norm() / want.norm()))
    assert out[True][0] <= 1e-2 and out[True][1] <= 0.1, out
    assert out[True][1] <= 0.75 * out[False][1], out


@pytest.mark.parametrize("ema_decay,accum_steps,steps", [(0.9, 1, 3), (0.9, 2, 6), (0.0, 3, 7)])
def test_ema_and_accumulation_match_jax_apply_gradients(ema_decay, accum_steps, steps):
    """``ApplyGradients`` against the JAX ``TrainState.apply_gradients``
    with the JAX trainer's optimizer (``optax.MultiSteps`` of Adam for k > 1),
    fed the same gradients: the shadow ticks once an update, a partial
    accumulation (7 micro-steps of k = 3) is held, not applied."""
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,)}
    params0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(steps)]
    tx = jax_build_optimizer(JaxTrainerConfig(lr=1e-2, accum_steps=accum_steps))
    p = jax.tree.map(jnp.asarray, params0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=p, batch_stats={},
                       opt_state=tx.init(p), rng=jax.random.PRNGKey(0), tx=tx,
                       ema_params=jax.tree.map(jnp.copy, p) if ema_decay else None)
    port = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    opt = build_optimizer(TrainerConfig(lr=1e-2), port.values())
    update = ApplyGradients(port.items(), opt, ema_decay, accum_steps)
    for g in grads:
        state = state.apply_gradients(jax.tree.map(jnp.asarray, g), {}, state.rng,
                                      ema_decay=ema_decay, accum_steps=accum_steps)
        opt.zero_grad(set_to_none=True)
        for k, t in port.items():
            t.grad = torch.from_numpy(g[k].copy())
        update(torch.zeros(()))
    assert update.micro_step == steps and update.updates == steps // accum_steps
    for i, k in enumerate(shapes):
        np.testing.assert_allclose(port[k].detach().numpy(), np.asarray(state.params[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
        if ema_decay:
            np.testing.assert_allclose(update.ema[i].numpy(), np.asarray(state.ema_params[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
    if steps % accum_steps:
        acc = np.asarray(state.opt_state.acc_grads[list(shapes)[0]])
        np.testing.assert_allclose(update.state_dict()["acc"]["a"].numpy(), acc, atol=1e-6)


def test_hue_matches_jax_and_leaves_the_other_draws():
    imgs, K, depth = aug_inputs(3)
    jcfg = JaxAugmentConfig(hue=0.1)
    key = jax.random.PRNGKey(7)
    ref_imgs, ref_K, ref_d = jax_augment_batch(key, jnp.asarray(imgs), jnp.asarray(K),
                                               jnp.asarray(depth), config=jcfg)
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(key, jcfg).items()}
    nb = imgs.shape[0]
    theta = jax.random.uniform(jax.random.fold_in(key, 99), (nb, 1, 1, 1), jnp.float32,
                               -0.1 * 2 * jnp.pi, 0.1 * 2 * jnp.pi)
    draws["hue"] = torch.from_numpy(np.array(theta).reshape(nb))
    got = augment_batch(torch.from_numpy(imgs), torch.from_numpy(K), torch.from_numpy(depth),
                        config=AugmentConfig(hue=0.1), draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref_imgs), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref_K), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref_d))
    a = draw_augment(4, H, W, AugmentConfig(), torch.Generator().manual_seed(8))
    b = draw_augment(4, H, W, AugmentConfig(hue=0.1), torch.Generator().manual_seed(8))
    assert set(b) == set(a) | {"hue"} and all(torch.equal(a[k], b[k]) for k in a)
    assert (b["hue"].abs() <= 0.1 * 2 * np.pi).all()


@pytest.mark.parametrize("depth", [18, 50])
def test_encoder_conversion_matches_jax(depth):
    rng = np.random.default_rng(depth)
    sd = {k: (torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
              if v.is_floating_point() else v)
          for k, v in ResNetEncoder(depth).state_dict().items()}
    sd["fc.weight"], sd["fc.bias"] = torch.zeros(10, 512 * (4 if depth == 50 else 1)), \
        torch.zeros(10)
    params, stats = jax_convert(sd, depth=depth)
    ref: dict = {}
    _put_resnet(ref, "", params, stats, depth)
    got = convert_resnet_encoder(sd, depth)
    assert "fc.weight" not in got
    assert {k for k in got if not k.endswith("num_batches_tracked")} == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    DispResNet(depth).encoder.load_state_dict(got, strict=True)


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _remat_step(base, remat, x):
    model = copy.deepcopy(base).train()
    set_remat(model, remat)
    out = model(x)
    loss = sum(o.mean() for o in (out if isinstance(out, list) else [out]))
    with _CountConvs() as recomputed:
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    stats = {k: v for k, v in model.state_dict().items() if "running_" in k}
    return float(loss.detach()), grads, stats, recomputed.n


@pytest.mark.parametrize("net", ["dispnet", "disp_res_18", "disp_res_50", "disp_vgg_bn",
                                 "fcrn"])
def test_remat_gives_the_same_step(net, request):
    x = torch.from_numpy(_images(1, seed=12)[0][:, :, :32].copy())  # 32x32 keeps it quick
    base = (request.getfixturevalue("fcrn") if net == "fcrn"
            else get_disp_net(net, seed=11, device="cpu"))
    loss, grads, stats, n0 = _remat_step(base, False, x)
    assert n0 == 0
    for remat in ("full", "conv"):
        r_loss, r_grads, r_stats, n = _remat_step(base, remat, x)
        assert r_loss == loss
        for k, g in grads.items():
            np.testing.assert_allclose(r_grads[k].numpy(), g.numpy(), rtol=1e-5,
                                       atol=1e-7 * float(g.abs().max()), err_msg=k)
        for k, s in stats.items():  # updated once, not again in the recompute
            assert torch.equal(r_stats[k], s), k
        assert (n > 0) == (remat == "full")


def test_remat_photometric_terms_give_the_same_loss_and_gradients():
    rng = np.random.default_rng(13)
    tgt, r1, r2 = (torch.from_numpy(x) for x in _images(3, seed=14))
    K = torch.tensor([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]]).expand(B, 3, 3)
    depths0 = [torch.from_numpy(rng.uniform(1, 10, (B, H >> s, W >> s)).astype(np.float32))
               for s in range(4)]
    pose0 = torch.from_numpy(0.02 * rng.standard_normal((B, 2, 6)).astype(np.float32))
    out = []
    for remat in (False, True):
        depths = [d.clone().requires_grad_() for d in depths0]
        pose = pose0.clone().requires_grad_()
        loss, warped = photometric_reconstruction_loss(tgt, [r1, r2], K, depths, None, pose,
                                                       remat=remat)
        loss.backward()
        out.append((float(loss), [d.grad for d in depths] + [pose.grad], len(warped)))
    assert out[0][0] == out[1][0] and out[0][2] == 2 and out[1][2] == 0
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5, atol=1e-9)


def test_fused_decoder_in_bf16_survives_a_first_call_under_inference_mode():
    """The fused decoder's taps are cached a device and dtype
    (``ops/fused_upconv.py::_tent``): the bf16 ones made under
    ``torch.inference_mode()`` (as an eval CLI makes them) serve a later
    train step, and the fused bf16 forward stays within bf16 noise of the
    unfused one (mean relative error <= 2e-2, measured <= 3.7e-3; the composed
    kernel rounds at other points than upsample-then-conv)."""
    x = torch.from_numpy(_images(1, seed=15)[0])
    fused = get_disp_net("disp_res_18", fused_upsample=True, bf16=True, device="cpu")
    unfused = get_disp_net("disp_res_18", bf16=True, device="cpu").eval()
    with torch.inference_mode():
        got, want = fused.eval()(x), unfused(x)
    for f, u in zip(got, want):
        assert _mrel(f, u) <= 2e-2, _mrel(f, u)
    out = fused.train()(x)
    sum(o.mean() for o in out).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in fused.parameters())
