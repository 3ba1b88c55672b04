"""Reading and writing checkpoints: the port of
``supervised_dispnet_tpu/utils/checkpoint.py::load_torch_state_dict``, and
the trainer's writer (``save_linked``), which on a data-parallel run rank 0
alone calls (``training/trainer.py::Trainer.save_checkpoint``).

A ``.pth.tar`` written by the port's ``Trainer`` or by the reference holds
the model's state dict under the reference's names, so it loads into the
port's model as it is. Orbax directories are the JAX package's format and
are not read here.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict of a ``.pth.tar``, on the CPU: the ``{'state_dict'}``
    wrapper (``epoch``, ``step``, ``optimizer`` beside it) and DataParallel's
    ``module.`` prefixes are taken off. A directory raises ``ValueError``."""
    p = Path(path)
    if p.is_dir():
        raise ValueError(
            f"{p} is a directory: orbax checkpoints are the JAX package's "
            "format; the port reads .pth.tar files (a state_dict under the "
            "reference's names)")
    blob = torch.load(p, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k.removeprefix("module."): v for k, v in sd.items()}


def save_linked(blob: dict, path: Path, best: Path | None) -> None:
    """``torch.save`` ``blob`` to ``path`` through a temporary name, so each
    save is a new file, and, when ``best`` is given, hard-link ``best`` to
    it: one copy of the bytes on disk, and a later save of ``path`` leaves
    ``best`` as it was."""
    tmp = path.with_name(path.name + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, path)
    if best is not None:
        best.unlink(missing_ok=True)
        os.link(path, best)
