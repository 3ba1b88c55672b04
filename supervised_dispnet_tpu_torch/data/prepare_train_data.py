"""Offline ETL CLI, raw KITTI / KITTI odometry / Cityscapes -> dumped
training folders: the port's copy of
``supervised_dispnet_tpu/data/prepare_train_data.py`` (reference CLI:
``data/prepare_train_data.py``), with the same flags:

    python -m supervised_dispnet_tpu_torch.data.prepare_train_data <raw_kitti> \\
        --dataset-format kitti --dump-root <out> --with-depth --with-pose \\
        --static-frames static_frames.txt --height 128 --width 416

Dumps per-scene folders of resized frames (baseline JPEGs written by the
port's codec, ``utils/image_io.py::write_jpeg``, as ``cv2.imwrite`` writes
them) + ``cam.txt`` intrinsics, optional per-frame sparse depth ``.npy`` and
``poses.txt``, then writes train.txt / val.txt scene splits, drawn from the
sorted scene names so that the split does not depend on which scene
finished first. Scenes are dumped on ``--num-threads`` threads: decoding,
encoding and the resizes' matrix products run without the interpreter lock.
The tree is what ``cli/train.py`` reads, or what ``data/packed.py`` packs.
"""

from __future__ import annotations

import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from supervised_dispnet_tpu_torch.utils.image_io import write_jpeg


def dump_scene(loader, scene: dict, dump_root: Path) -> str | None:
    """Write one scene's frames, depth, ``cam.txt`` and poses; returns its
    name, or None when it had no frame."""
    out_dir = dump_root / scene["name"]
    out_dir.mkdir(parents=True, exist_ok=True)
    K = None
    for i in range(len(scene["frames"])):
        img, K, _ = loader.load_image(scene, i)
        name = scene["frames"][i].stem
        write_jpeg(out_dir / f"{name}.jpg", img)
        if loader.get_depth:
            np.save(out_dir / f"{name}.npy", loader.get_depth_map(scene, i))
    if K is None:
        return None
    np.savetxt(out_dir / "cam.txt", K, fmt="%.8f")
    if loader.get_pose and "poses" in scene:
        np.savetxt(out_dir / "poses.txt", scene["poses"].reshape(-1, 12), fmt="%.8e")
    return scene["name"]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Resize + dump KITTI raw for training (reference CLI parity)")
    parser.add_argument("dataset_dir", type=Path)
    parser.add_argument("--dataset-format", default="kitti",
                        choices=["kitti", "odometry", "cityscapes"])
    parser.add_argument("--dump-root", type=Path, required=True)
    parser.add_argument("--height", type=int, default=128)
    parser.add_argument("--width", type=int, default=416)
    parser.add_argument("--static-frames", type=Path, default=None)
    parser.add_argument("--test-scenes", type=Path, default=None,
                        help="file of Eigen test drive names to exclude")
    parser.add_argument("--with-depth", action="store_true")
    parser.add_argument("--with-pose", action="store_true")
    parser.add_argument("--num-threads", type=int, default=4)
    parser.add_argument("--val-frac", type=float, default=0.1)
    return parser


def make_loader(args: argparse.Namespace):
    """The crawler of ``--dataset-format`` and its scenes."""
    if args.dataset_format == "kitti":
        from supervised_dispnet_tpu_torch.data.kitti_raw_loader import KittiRawLoader

        loader = KittiRawLoader(
            args.dataset_dir, static_frames_file=args.static_frames,
            img_height=args.height, img_width=args.width, get_depth=args.with_depth,
            get_pose=args.with_pose, test_scene_file=args.test_scenes)
        return loader, [s for drive in loader.scenes for s in loader.collect_scene_data(drive)]
    if args.dataset_format == "odometry":
        from supervised_dispnet_tpu_torch.data.kitti_odometry_loader import (
            KittiOdometryLoader)

        loader = KittiOdometryLoader(
            args.dataset_dir, img_height=args.height, img_width=args.width,
            get_depth=args.with_depth, get_pose=args.with_pose)
        return loader, [s for seq in loader.scenes for s in loader.collect_scene_data(seq)]
    from supervised_dispnet_tpu_torch.data.cityscapes_loader import CityscapesLoader

    loader = CityscapesLoader(args.dataset_dir, img_height=args.height, img_width=args.width)
    return loader, list(loader.collect_scene_data())


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)

    # fail fast on malformed canonical lists
    from supervised_dispnet_tpu_torch.data.filelist_validation import require_valid

    if args.static_frames:
        require_valid("static_frames", args.static_frames)
    if args.test_scenes:
        require_valid("test_scenes", args.test_scenes)

    loader, scenes = make_loader(args)
    args.dump_root.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(max(1, args.num_threads)) as pool:
        results = list(pool.map(lambda s: dump_scene(loader, s, args.dump_root), scenes))
    names: list[str] = [r for r in results if r]

    rng = np.random.default_rng(8964)
    names = sorted(names)
    rng.shuffle(names)
    n_val = max(1, int(len(names) * args.val_frac)) if names else 0
    with open(args.dump_root / "val.txt", "w") as f:
        f.writelines(n + "\n" for n in names[:n_val])
    with open(args.dump_root / "train.txt", "w") as f:
        f.writelines(n + "\n" for n in names[n_val:])
    print(f"dumped {len(names)} scenes -> {args.dump_root}")


if __name__ == "__main__":
    main()
