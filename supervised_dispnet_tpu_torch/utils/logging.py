"""Console, CSV/JSONL and tensorboard logging, the port's copy of
``supervised_dispnet_tpu/utils/logging.py``. The log file names match the
reference: ``progress_log_summary.csv``, ``progress_log_full.csv``,
``metrics.jsonl``. Each logger takes ``enabled``: on a data-parallel run
every rank but rank 0 makes its loggers with ``enabled=False``, and they
write and print nothing."""

from __future__ import annotations

import csv
import json
import time
from pathlib import Path


class AverageMeter:
    """Tracks value/avg of one or more series."""

    def __init__(self, i: int = 1, precision: int = 4):
        self.meters = i
        self.precision = precision
        self.reset()

    def reset(self):
        self.val = [0.0] * self.meters
        self.avg = [0.0] * self.meters
        self.sum = [0.0] * self.meters
        self.count = 0

    def update(self, val, n: int = 1):
        if not isinstance(val, (list, tuple)):
            val = [val]
        if len(val) != self.meters:
            raise ValueError(f"expected {self.meters} values, got {len(val)}")
        self.count += n
        for i, v in enumerate(val):
            self.val[i] = float(v)
            self.sum[i] += float(v) * n
            self.avg[i] = self.sum[i] / self.count

    def __repr__(self):
        val = " ".join(f"{v:.{self.precision}f}" for v in self.val)
        avg = " ".join(f"{a:.{self.precision}f}" for a in self.avg)
        return f"{val} ({avg})"


class TermLogger:
    """Minimal terminal progress logger (epoch / train / valid lines)."""

    def __init__(self, n_epochs: int, train_size: int, valid_size: int,
                 enabled: bool = True):
        self.enabled = enabled
        self.n_epochs = n_epochs
        self.train_size = train_size
        self.valid_size = valid_size
        self._t0 = time.time()

    def epoch_start(self, epoch: int):
        if self.enabled:
            print(f"=> epoch {epoch + 1}/{self.n_epochs}", flush=True)

    def train_update(self, i: int, msg: str):
        if self.enabled and (i % 50 == 0 or i == self.train_size - 1):
            dt = time.time() - self._t0
            print(f"  train {i + 1}/{self.train_size} [{dt:7.1f}s] {msg}", flush=True)

    def valid_update(self, i: int, msg: str = ""):
        if self.enabled and (i % 100 == 0 or i == self.valid_size - 1):
            print(f"  valid {i + 1}/{self.valid_size} {msg}", flush=True)

    def print_result(self, msg: str):
        if self.enabled:
            print(f"  {msg}", flush=True)


class CsvLogger:
    """Per-epoch summary + per-iteration full CSV logs."""

    def __init__(self, save_path: str | Path, append: bool = False, enabled: bool = True):
        self.enabled = enabled
        self.save_path = Path(save_path)
        if enabled:
            self.save_path.mkdir(parents=True, exist_ok=True)
        self.summary = self.save_path / "progress_log_summary.csv"
        self.full = self.save_path / "progress_log_full.csv"
        if not enabled or (append and self.summary.exists()):
            return  # resuming: keep the previous run's rows
        with open(self.summary, "w", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(["train_loss", "validation_loss"])
        with open(self.full, "w", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(["train_loss"])

    def write_summary(self, row):
        if not self.enabled:
            return
        with open(self.summary, "a", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)

    def write_iter(self, row):
        if not self.enabled:
            return
        with open(self.full, "a", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)


class JsonlLogger:
    """Structured metrics stream (one JSON object per event)."""

    def __init__(self, path: str | Path, enabled: bool = True):
        self.path = Path(path)
        self._f = None
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a")

    def log(self, **kv):
        if self._f is None:
            return
        kv.setdefault("t", time.time())
        self._f.write(json.dumps(kv) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


class NoopWriter:
    """The writer where tensorboardX does not import: every call does
    nothing."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_image(self, *args, **kwargs):
        pass

    def close(self):
        pass


def make_tensorboard_writer(save_path: str | Path):
    """tensorboardX's ``SummaryWriter`` on ``save_path`` where it imports,
    else a ``NoopWriter``."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        return NoopWriter()
    return SummaryWriter(str(save_path))
