"""The port as a package: it stands apart from JAX and the JAX package, its
entry points run on the card unless the caller asks for the CPU, and short
training runs through the CLI on the CPU (supervised, and self-supervised
on a split without GT) write their logs and checkpoints."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import supervised_dispnet_tpu_torch
from supervised_dispnet_tpu_torch.cli import run_inference as run_inference_cli
from supervised_dispnet_tpu_torch.cli import serve as serve_cli
from supervised_dispnet_tpu_torch.cli import test_disp as test_disp_cli
from supervised_dispnet_tpu_torch.cli import test_pose as test_pose_cli
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.data.packed import write_split
from supervised_dispnet_tpu_torch.models import DispNetS, DispResNet, PoseExpNet, get_disp_net
from supervised_dispnet_tpu_torch.ops.cuda import losses as kl
from supervised_dispnet_tpu_torch.ops.cuda import warp as kw
from supervised_dispnet_tpu_torch.serving import DepthService
from supervised_dispnet_tpu_torch.training.trainer import (
    BEST_NAME, CHECKPOINT_NAME, POSE_BEST_NAME, POSE_CHECKPOINT_NAME, Trainer,
    TrainerConfig)
from supervised_dispnet_tpu_torch.utils.device import set_fp32_math
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

REPO = Path(__file__).resolve().parents[1]
PKG = Path(supervised_dispnet_tpu_torch.__file__).parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "supervised_dispnet_tpu")
# image libraries the JAX package reads, resizes and draws with; the port
# has its own PNG codec and resizes, and matplotlib stays an optional import
# inside ``utils/viz.py::tensor2array``
IMAGE_LIBS = ("cv2", "imageio", "PIL", "matplotlib")


def _port_modules() -> list[str]:
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PKG.rglob("*.py"))


def _forbidden(name: str, forbidden: tuple[str, ...] = FORBIDDEN) -> bool:
    return any(name == f or name.startswith(f + ".") for f in forbidden)


@pytest.fixture(scope="module")
def fresh_import() -> list[str]:
    """``sys.modules`` after every module of the port, and ``chip_smoke``,
    is imported in a fresh interpreter."""
    mods = _port_modules() + ["chip_smoke"]
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=300).stdout
    loaded = json.loads(out.splitlines()[-1])
    for mod in ("training.trainer", "cli.test_disp", "cli.test_pose", "cli.serve", "serving"):
        assert f"supervised_dispnet_tpu_torch.{mod}" in loaded
    return loaded


def test_importing_the_port_leaves_jax_and_the_jax_package_out(fresh_import):
    """Neither ``jax`` nor ``supervised_dispnet_tpu`` (by exact name or with
    a dot after it) appears in ``sys.modules``."""
    assert [m for m in fresh_import if _forbidden(m)] == []


def _module_level_imports(tree: ast.AST):
    """Import statements that run when the module is imported: everywhere
    but inside function bodies."""
    for node in ast.iter_child_nodes(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            yield node
        yield from _module_level_imports(node)


def test_no_port_module_imports_image_libraries_at_module_level(fresh_import):
    """Neither the fresh interpreter's ``sys.modules`` nor any module-level
    import of a port source, of ``chip_smoke.py`` or of a port script, names ``cv2``,
    ``imageio``, ``PIL`` or ``matplotlib``."""
    assert [m for m in fresh_import if _forbidden(m, IMAGE_LIBS)] == []
    bad = []
    for f in (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "scripts").glob("torch_*.py"))):
        for node in _module_level_imports(ast.parse(f.read_text(), str(f))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""])
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if _forbidden(n, IMAGE_LIBS)]
    assert bad == []


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    """Also the imports inside functions, which an import does not run; and
    the port's scripts (``scripts/torch_*.py``)."""
    files = (sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    assert REPO / "scripts" / "torch_convergence_check.py" in files
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_entry_points_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_disp_net("disp_res_18")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainerConfig(), DispResNet(18))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main([str(tmp_path), "--network", "disp_res_18"])
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_disp_cli.main(["--pretrained-dispnet", str(tmp_path / "x.pth.tar"),
                            "--dataset-dir", str(tmp_path),
                            "--dataset-list", str(tmp_path / "list.txt")])
    with pytest.raises(RuntimeError, match="--device cpu"):
        run_inference_cli.main(["--pretrained", str(tmp_path / "x.pth.tar"),
                                "--dataset-dir", str(tmp_path), "--output-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        test_pose_cli.main(["--pretrained-posenet", str(tmp_path / "x.pth.tar"),
                            "--dataset-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve_cli.main(["--pretrained", str(tmp_path / "x.pth.tar")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DepthService(DispNetS())
    assert get_disp_net("disp_res_18", device="cpu").encoder.conv1.weight.device.type == "cpu"


@pytest.fixture
def tf32_flags():
    """The two process-wide TF32 flags, read as a pair; restored after the
    test, so that no other test sees them changed."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_card_math_is_full_fp32_unless_tf32_is_asked_for(tf32_flags):
    """``set_fp32_math`` turns TF32 off for cuDNN convolutions and matrix
    products by default and on when asked; a ``Trainer`` built on the CPU
    leaves both off, whatever they were before."""
    set_fp32_math(tf32=True)
    assert tf32_flags() == (True, True)
    set_fp32_math()
    assert tf32_flags() == (False, False)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    Trainer(TrainerConfig(), torch.nn.Conv2d(3, 1, 1), device="cpu")
    assert tf32_flags() == (False, False)


# Cases whose flags a slice has ported point at a feature still unported,
# beside the ported flag where one fits, under the ids they had.
@pytest.mark.parametrize("cli,argv,err", [
    ("train", ["--spatial-shards", "2"], "--spatial-shards"), ("train", ["--qat"], "--qat"),
    pytest.param("train", ["--loss", "selfsup", "--stochastic-photo", "2", "--loader", "grain"],
                 "--loader grain", id="train-argv2---stochastic-photo"),
    pytest.param("train", ["--loss", "selfsup", "--half-res-photo", "--qat"], "--qat",
                 id="train-argv3---half-res-photo"),
    ("test_disp", ["--int8"], "--int8"),
    pytest.param("test_disp", ["--calib-batches", "4"], "--calib-batches",
                 id="train-argv5---loader"),
    pytest.param("train", ["--loader", "device", "--steps-per-dispatch", "2",
                           "--spatial-shards", "2"], "--spatial-shards",
                 id="train-argv6---steps-per-dispatch"),
    pytest.param("train", ["--training-output-freq", "5", "--qat"], "--qat",
                 id="train-argv7---training-output-freq"),
    pytest.param("test_disp", ["--percentile", "99.9"], "--percentile", id="train-argv8--j"),
])
def test_unported_cli_choices_raise(tmp_path, cli, argv, err):
    if cli == "train":
        main = train_cli.main
        argv = [str(tmp_path), "--network", "disp_res_18", *argv]
    else:
        main = test_disp_cli.main
        argv = ["--pretrained-dispnet", str(tmp_path / "x.pth.tar"), "--dataset-dir",
                str(tmp_path), "--dataset-list", str(tmp_path / "list.txt"), *argv]
    with pytest.raises(NotImplementedError, match=err):
        main([*argv, "--device", "cpu"])


def test_pretrained_encoder_refuses_a_network_without_a_resnet_encoder(tmp_path):
    """``--pretrained-encoder`` is for disp_res*: on VGG-BN it raises
    ``ValueError``, as the JAX CLI does, before any file is read."""
    with pytest.raises(ValueError, match="disp_res"):
        train_cli.main([str(tmp_path), "--network", "disp_vgg_bn", "--pretrained-encoder",
                        str(tmp_path / "enc.pth"), "--device", "cpu"])


def _packed_split(root: Path, H: int, W: int, n_train: int = 6, n_val: int = 4,
                  with_depth: bool = True):
    rng = np.random.default_rng(0)
    K = np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1]], np.float32)
    for split, n in (("train", n_train), ("val", n_val)):
        images = rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)
        depth = rng.uniform(1, 80, (n, H, W)) * (rng.uniform(size=(n, H, W)) < 0.2)
        write_split(root / split, images, np.stack([K, K]), [(0, n // 2), (n // 2, n)],
                    depth.astype(np.float32) if with_depth else None)


def test_cli_trains_two_steps_on_the_cpu_and_writes_logs_and_checkpoint(tmp_path, capsys):
    H, W = 64, 96
    _packed_split(tmp_path / "data", H, W)
    launches = (kl.berhu_fwd_launches, kl.berhu_bwd_launches)
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", "disp_res_18", "--loss", "berhu", "-b", "2",
        "--epoch-size", "2", "--epochs", "1", "--with-gt", "--use-pallas-losses",
        "--device", "cpu", "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2
    assert (kl.berhu_fwd_launches, kl.berhu_bwd_launches) == launches
    printed = capsys.readouterr().out
    assert "abs_rel=" in printed and "rmse=" in printed

    run = Path(trainer.cfg.save_path)
    for name in ("progress_log_summary.csv", "progress_log_full.csv", "metrics.jsonl",
                 "trainer_meta.json", CHECKPOINT_NAME, BEST_NAME):
        assert (run / name).is_file(), name
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    iters = [e for e in events if e["event"] == "train_iter"]
    assert [e["step"] for e in iters] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in iters)
    epoch = [e for e in events if e["event"] == "epoch"][0]
    assert np.isfinite(epoch["abs_rel"]) and np.isfinite(epoch["rmse"])

    ckpt = torch.load(run / CHECKPOINT_NAME, weights_only=False)
    assert ckpt["step"] == 2
    fresh = DispResNet(18)
    fresh.load_state_dict(ckpt["state_dict"], strict=True)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    shutil.rmtree(tmp_path / "ck")  # checked: the disk is shared by the whole suite

    disp = trainer.predict(np.random.default_rng(1).uniform(size=(2, H, W, 3)))
    assert disp.shape == (2, H, W)
    assert ((disp >= 0.01) & (disp <= 10.01)).all()


def test_cli_trains_the_fused_decoder_two_steps_on_the_cpu(tmp_path):
    """``--fused-upsample`` on ``disp_res_18`` at 64x96: two steps with finite
    losses, and a checkpoint that the unfused model loads ``strict=True``
    and that predicts what the fused one does."""
    H, W = 64, 96
    _packed_split(tmp_path / "data", H, W)
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", "disp_res_18", "--loss", "berhu", "-b", "2",
        "--epoch-size", "2", "--epochs", "1", "--fused-upsample", "--device", "cpu",
        "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2 and trainer.model.fused_upsample
    run = Path(trainer.cfg.save_path)
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [e["loss"] for e in events if e["event"] == "train_iter"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    unfused = DispResNet(18)
    unfused.load_state_dict(torch.load(run / CHECKPOINT_NAME, weights_only=True)["state_dict"],
                            strict=True)
    shutil.rmtree(tmp_path / "ck")
    x = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (1, H, W, 3)), dtype=torch.float32)
    with torch.no_grad():
        np.testing.assert_allclose(unfused.eval()(x)[0].numpy(),
                                   trainer.model.eval()(x)[0].numpy(), rtol=1e-5, atol=1e-6)


def test_cli_trains_selfsup_two_steps_on_the_cpu_without_gt(tmp_path, capsys):
    """``--loss selfsup --network dispnet`` on a split with no GT depth:
    two steps, validation with the self-supervised losses, both nets'
    checkpoints, which reload ``strict=True``."""
    H, W = 32, 64
    _packed_split(tmp_path / "data", H, W, n_train=8, n_val=6, with_depth=False)
    launches = (kw.warp_fwd_launches, kw.warp_bwd_launches, kw.warp_bwd_coords_launches)
    trainer = train_cli.main([
        str(tmp_path / "data"), "--network", "dispnet", "--loss", "selfsup",
        "--sequence-length", "3", "-p", "1.0", "-m", "0.2", "-s", "0.1", "-b", "2",
        "--epoch-size", "2", "--epochs", "1", "--use-pallas-warp", "--device", "cpu",
        "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t"])
    assert trainer.step == 2 and not trainer.val_with_gt
    assert (kw.warp_fwd_launches, kw.warp_bwd_launches,
            kw.warp_bwd_coords_launches) == launches
    printed = capsys.readouterr().out
    assert "photo_loss=" in printed and "best val photo_loss" in printed

    run = Path(trainer.cfg.save_path)
    events = [json.loads(x) for x in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(e["loss"]) for e in events if e["event"] == "train_iter")
    epoch = [e for e in events if e["event"] == "epoch"][0]
    assert all(np.isfinite(epoch[k]) for k in ("photo_loss", "exp_loss", "smooth_loss"))
    for name, fresh, model in ((CHECKPOINT_NAME, DispNetS(), trainer.model),
                               (POSE_CHECKPOINT_NAME, PoseExpNet(), trainer.pose_model)):
        assert (run / name).is_file()
        fresh.load_state_dict(torch.load(run / name, weights_only=False)["state_dict"],
                              strict=True)
        for k, v in model.state_dict().items():
            assert torch.equal(fresh.state_dict()[k], v), k
    assert (run / BEST_NAME).is_file() and (run / POSE_BEST_NAME).is_file()
    shutil.rmtree(tmp_path / "ck")


def test_supervised_training_still_needs_gt_for_validation(tmp_path):
    _packed_split(tmp_path / "data", 32, 64, with_depth=False)
    cfg = TrainerConfig(data=str(tmp_path / "data"), batch_size=2)
    with pytest.raises(RuntimeError, match="GT depth"):
        Trainer(cfg, DispResNet(18), device="cpu").make_loaders()
