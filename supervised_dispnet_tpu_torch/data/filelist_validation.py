"""Format validators for the canonical KITTI data-file lists. The port's
copy of ``supervised_dispnet_tpu/data/filelist_validation.py``.

The reference gates its ETL and evaluation on three published artifacts
(reference: ``data/static_frames.txt``, ``kitti_eval/test_files_eigen.txt``,
and the Eigen test-scene list). This environment has no network, so the
canonical contents cannot be vendored verbatim (see
``data/filelists/README.md``); these validators guarantee that whatever
copy the user supplies is structurally sound BEFORE an ETL or eval run
consumes it, instead of failing hundreds of scenes in.

Usage (CLI):  python -m supervised_dispnet_tpu_torch.data.filelist_validation \
                  --static-frames static_frames.txt \
                  --eigen-list test_files_eigen.txt \
                  --test-scenes eigen_test_scenes.txt
"""

from __future__ import annotations

import re
from pathlib import Path

# 2011_09_26 / 2011_09_26_drive_0001_sync / 0000000001 style tokens
_DATE_RE = re.compile(r"^\d{4}_\d{2}_\d{2}$")
_DRIVE_RE = re.compile(r"^\d{4}_\d{2}_\d{2}_drive_\d{4}_sync$")
_FRAME_RE = re.compile(r"^\d+$")
# date/drive/image_0N/data/frame.png
_EIGEN_RE = re.compile(
    r"^\d{4}_\d{2}_\d{2}/\d{4}_\d{2}_\d{2}_drive_\d{4}_sync/"
    r"image_0[0-3]/data/\d+\.(png|jpg)$"
)

EIGEN_TEST_COUNT = 697  # canonical Eigen split size


def _read_lines(path: str | Path) -> list[str]:
    return [l.strip() for l in Path(path).read_text().splitlines() if l.strip()]


def validate_static_frames(path: str | Path) -> list[str]:
    """Errors for a ``static_frames.txt`` (``<date> <drive> <frame_id>``
    per line); empty list = valid."""
    errors = []
    lines = _read_lines(path)
    if not lines:
        errors.append("file is empty")
    for n, line in enumerate(lines, 1):
        parts = line.split()
        if len(parts) != 3:
            errors.append(f"line {n}: expected 3 fields, got {len(parts)}: {line!r}")
            continue
        date, drive, frame = parts
        if not _DATE_RE.match(date):
            errors.append(f"line {n}: bad date {date!r}")
        if not _DRIVE_RE.match(drive):
            errors.append(f"line {n}: bad drive {drive!r}")
        if not _FRAME_RE.match(frame):
            errors.append(f"line {n}: bad frame id {frame!r}")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors


def validate_eigen_list(path: str | Path, expect_count: bool = True) -> list[str]:
    """Errors for a ``test_files_eigen.txt`` (one relative image path per
    line); empty list = valid. ``expect_count`` also checks the canonical
    697-entry size."""
    errors = []
    lines = _read_lines(path)
    if expect_count and len(lines) != EIGEN_TEST_COUNT:
        errors.append(
            f"expected the canonical {EIGEN_TEST_COUNT} Eigen test files, "
            f"got {len(lines)} (pass expect_count=False for custom lists)"
        )
    for n, line in enumerate(lines, 1):
        if not _EIGEN_RE.match(line):
            errors.append(f"line {n}: not a KITTI raw image path: {line!r}")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors


def validate_test_scenes(path: str | Path) -> list[str]:
    """Errors for an Eigen test-scene list (one drive name per line)."""
    errors = []
    lines = _read_lines(path)
    if not lines:
        errors.append("file is empty")
    for n, line in enumerate(lines, 1):
        if not _DRIVE_RE.match(line):
            errors.append(f"line {n}: bad drive name {line!r}")
        if len(errors) > 20:
            errors.append("... (truncated)")
            break
    return errors


def require_valid(kind: str, path: str | Path) -> None:
    """Raise ValueError with the error list if the file is malformed.
    kind: 'static_frames' | 'eigen_list' | 'test_scenes'."""
    fn = {
        "static_frames": validate_static_frames,
        "eigen_list": lambda p: validate_eigen_list(p, expect_count=False),
        "test_scenes": validate_test_scenes,
    }[kind]
    errors = fn(path)
    if errors:
        raise ValueError(
            f"{kind} file {path} is malformed:\n  " + "\n  ".join(errors[:10])
        )


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Validate KITTI file lists")
    ap.add_argument("--static-frames", type=Path)
    ap.add_argument("--eigen-list", type=Path)
    ap.add_argument("--test-scenes", type=Path)
    ap.add_argument("--no-count-check", action="store_true")
    args = ap.parse_args(argv)

    status = 0
    for kind, path in (("static_frames", args.static_frames),
                       ("eigen_list", args.eigen_list),
                       ("test_scenes", args.test_scenes)):
        if path is None:
            continue
        if kind == "eigen_list":
            errors = validate_eigen_list(path, expect_count=not args.no_count_check)
        else:
            errors = {"static_frames": validate_static_frames,
                      "test_scenes": validate_test_scenes}[kind](path)
        if errors:
            status = 1
            print(f"INVALID {kind} {path}:")
            for e in errors[:20]:
                print(f"  {e}")
        else:
            print(f"ok {kind} {path}")
    return status


if __name__ == "__main__":
    raise SystemExit(main())
