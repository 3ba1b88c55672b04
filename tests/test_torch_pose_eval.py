"""The port's odometry pose evaluation (``kitti_eval/pose_evaluation_utils.py``,
``cli/test_pose.py``) and the train CLI's ``--pretrained-exppose`` /
``--pretrained-disp``, against the JAX package's, on the CPU.

The numpy utilities on seeded snippets: rtol 1e-6 (the same float64 numpy
on both sides). ``pose_vec_to_snippet`` in both rotation modes: rtol 1e-5
/ atol 1e-6 (float32 rotation matrices from two frameworks). The CLI
against JAX's on one ``write_kitti_odometry`` tree of 75x250 frames, read
at 32x104, with one PoseExpNet ``.pth.tar`` that the port writes and JAX
reads through ``convert_pose_exp_net``: the pose vectors and ATE rtol 1e-4,
the eval CLIs' limit (the same float32 network; the area resize matches
cv2's uint8 output exactly at this ratio), RE within 1e-4 rad (see the
test)."""

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.cli import test_pose as jax_test_pose
from supervised_dispnet_tpu.kitti_eval import pose_evaluation_utils as jpe
from supervised_dispnet_tpu.models import PoseExpNet as JaxPoseExpNet
from supervised_dispnet_tpu.utils.checkpoint import convert_pose_exp_net
from supervised_dispnet_tpu_torch.cli import test_pose
from supervised_dispnet_tpu_torch.cli import train as train_cli
from supervised_dispnet_tpu_torch.kitti_eval import pose_evaluation_utils as pe
from supervised_dispnet_tpu_torch.kitti_eval.synthetic import _euler_mat, write_kitti_odometry
from supervised_dispnet_tpu_torch.models import DispNetS, PoseExpNet
from tests.test_torch_port import _packed_split

SIZE = ["--img-height", "32", "--img-width", "104"]


def _snippets(seed: int, n: int = 6, length: int = 5):
    """Seeded GT and predicted snippets: random-walk poses and noisy copies."""
    rng = np.random.default_rng(seed)
    poses = np.zeros((n + length, 3, 4))
    R, t = np.eye(3), np.zeros(3)
    for i in range(len(poses)):
        poses[i] = np.hstack([R, t[:, None]])
        a = rng.uniform(-0.05, 0.05, 3)
        R = R @ _euler_mat(a)
        t = t + R @ np.array([0.1, 0.0, 1.0])
    gts = [pe.snippet_from_poses(poses, np.arange(i, i + length)) for i in range(n)]
    preds = [g + rng.normal(0, 0.02, g.shape) for g in gts]
    return poses, gts, preds


def test_pose_evaluation_utils_match_jax(tmp_path):
    poses, gts, preds = _snippets(0)
    np.savetxt(tmp_path / "09.txt", poses.reshape(len(poses), 12))
    np.testing.assert_array_equal(pe.read_odometry_poses(tmp_path / "09.txt"),
                                  jpe.read_odometry_poses(tmp_path / "09.txt"))
    for rel in ("first", "mid"):
        np.testing.assert_allclose(pe.snippet_from_poses(poses, np.arange(2, 7), rel),
                                   jpe.snippet_from_poses(poses, np.arange(2, 7), rel),
                                   rtol=1e-6)
    for g, p in zip(gts, preds):
        assert pe.compute_ate(g, p) == pytest.approx(jpe.compute_ate(g, p), rel=1e-6)
        assert pe.compute_re(g, p) == pytest.approx(jpe.compute_re(g, p), rel=1e-6)
    got, want = pe.evaluate_pose_snippets(gts, preds), jpe.evaluate_pose_snippets(gts, preds)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_pose_vec_to_snippet_matches_jax(mode):
    vec = np.random.default_rng(1).normal(0, 0.1, (4, 6)).astype(np.float32)
    np.testing.assert_allclose(test_pose.pose_vec_to_snippet(vec, mode),
                               jax_test_pose.pose_vec_to_snippet(vec, mode),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def odometry(tmp_path_factory):
    """One synthetic sequence of 12 frames and an exp_pose checkpoint of a
    seeded port PoseExpNet with its mask decoder, as the trainer saves it."""
    root = tmp_path_factory.mktemp("odometry")
    write_kitti_odometry(root / "odo", seed=3, frames=12, height=75, width=250)
    model = PoseExpNet(nb_ref_imgs=2, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():  # flax inits biases at 0: make them count
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(len(name)))
    ckpt = root / "exp_pose_checkpoint.pth.tar"
    torch.save({"epoch": 1, "state_dict": model.state_dict()}, ckpt)
    return root, ckpt


@pytest.mark.parametrize("mode", ["euler", "quat"])
def test_pose_cli_matches_jax(odometry, mode, tmp_path):
    """10 snippets in batches of 4 (the last one short, where JAX pads).
    The network's pose vectors rtol 1e-4; ATE and its std rtol 1e-4; RE and
    its std within 1e-4 rad: RE is the arccos of a rotation's trace, which
    near 0 rad turns the two frameworks' float32 rotation matrices (equal to
    ~1e-6) into ~2e-5 rad of a ~0.02 rad error (``test_pose_vec_to_snippet_
    matches_jax`` holds the matrices)."""
    root, ckpt = odometry
    argv = ["--pretrained-posenet", str(ckpt), "--dataset-dir", str(root / "odo"),
            "--sequences", "09", "--rotation-mode", mode, "--batch-size", "4", *SIZE]
    captured, vectors = {}, []
    evaluate, to_snippet = jpe.evaluate_pose_snippets, jax_test_pose.pose_vec_to_snippet

    def capture(gts, preds):
        captured.update(evaluate(gts, preds))
        return evaluate(gts, preds)

    def record(vec, rotation_mode):
        vectors.append(np.asarray(vec))
        return to_snippet(vec, rotation_mode)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpe, "evaluate_pose_snippets", capture)
        mp.setattr(jax_test_pose, "pose_vec_to_snippet", record)
        jax_test_pose.main(argv)
    got = test_pose.main([*argv, "--device", "cpu", "--output-dir", str(tmp_path)])
    assert got["n_snippets"] == captured["n_snippets"] == 10
    np.testing.assert_allclose(np.load(tmp_path / "pose_vectors.npy"), np.stack(vectors),
                               rtol=1e-4, atol=1e-8)
    for k in ("ate_mean", "ate_std"):
        assert got[k] == pytest.approx(captured[k], rel=1e-4), k
    for k in ("re_mean", "re_std"):
        assert got[k] == pytest.approx(captured[k], abs=1e-4), k
    assert np.load(tmp_path / "predictions.npy").shape == (10, 3, 3, 4)


def test_pose_cli_prints_and_refuses_an_orbax_directory(odometry, capsys, tmp_path):
    root, ckpt = odometry
    test_pose.main(["--pretrained-posenet", str(ckpt), "--dataset-dir", str(root / "odo"),
                    *SIZE, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ATE " in out and "RE " in out and "n    10" in out
    with pytest.raises(ValueError, match="orbax"):
        test_pose.main(["--pretrained-posenet", str(tmp_path), "--dataset-dir",
                        str(root / "odo"), "--device", "cpu"])


def _selfsup_argv(tmp_path, *extra):
    _packed_split(tmp_path / "data", 32, 64, n_train=8, n_val=6, with_depth=False)
    return [str(tmp_path / "data"), "--network", "dispnet", "--loss", "selfsup",
            "--sequence-length", "3", "-b", "2", "--epochs", "0", "--device", "cpu",
            "--checkpoints-dir", str(tmp_path / "ck"), "--name", "t", *extra]


def test_train_cli_loads_pretrained_disp_and_exppose(odometry, tmp_path):
    """``--pretrained-disp`` and ``--pretrained-exppose`` (a checkpoint
    with the mask decoder, ``-m 0.2``) set both nets' weights, as the JAX
    CLI's ``convert_network`` / ``convert_pose_exp_net`` do."""
    _, ckpt = odometry
    disp = DispNetS(generator=torch.Generator().manual_seed(9))
    torch.save({"state_dict": disp.state_dict()}, tmp_path / "disp.pth.tar")
    trainer = train_cli.main(_selfsup_argv(tmp_path, "--pretrained-disp",
                                           str(tmp_path / "disp.pth.tar"),
                                           "--pretrained-exppose", str(ckpt)))
    want = torch.load(ckpt, weights_only=True)["state_dict"]
    for k, v in trainer.pose_model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, disp.state_dict()[k]), k


def test_pose_checkpoint_without_masks_loads_only_without_the_mask_decoder(odometry,
                                                                           tmp_path):
    """A pose checkpoint without the explainability decoder: JAX's converter
    leaves the decoder out of the tree (its first ``-m > 0`` step then finds
    no mask weights); the port refuses it at load with ``-m > 0`` and loads
    it with ``-m 0``."""
    _, ckpt = odometry
    sd = {k: v for k, v in torch.load(ckpt, weights_only=True)["state_dict"].items()
          if not k.startswith(("upconv", "predict_mask"))}
    tree = convert_pose_exp_net({k: v.numpy() for k, v in sd.items()}, output_exp=True)
    assert not any(k.startswith(("upconv", "predict_mask")) for k in tree)
    with pytest.raises(Exception, match="upconv|predict_mask"):
        JaxPoseExpNet(nb_ref_imgs=2, output_exp=True).apply(
            {"params": tree}, np.zeros((1, 32, 64, 3), np.float32),
            [np.zeros((1, 32, 64, 3), np.float32)] * 2)
    torch.save({"state_dict": sd}, tmp_path / "pose.pth.tar")
    with pytest.raises(ValueError, match="-m 0"):
        train_cli.main(_selfsup_argv(tmp_path, "--pretrained-exppose",
                                     str(tmp_path / "pose.pth.tar")))
    trainer = train_cli.main(_selfsup_argv(tmp_path, "-m", "0", "--pretrained-exppose",
                                           str(tmp_path / "pose.pth.tar")))
    for k, v in trainer.pose_model.state_dict().items():
        assert torch.equal(v, sd[k]), k
