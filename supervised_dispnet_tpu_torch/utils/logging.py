"""Console + CSV/JSONL logging, the port's copy of
``supervised_dispnet_tpu/utils/logging.py`` (without tensorboard). The log
file names match the reference: ``progress_log_summary.csv``,
``progress_log_full.csv``, ``metrics.jsonl``."""

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

    def __init__(self, n_epochs: int, train_size: int, valid_size: int):
        self.n_epochs = n_epochs
        self.train_size = train_size
        self.valid_size = valid_size
        self._t0 = time.time()

    def epoch_start(self, epoch: int):
        print(f"=> epoch {epoch + 1}/{self.n_epochs}", flush=True)

    def train_update(self, i: int, msg: str):
        if i % 50 == 0 or i == self.train_size - 1:
            dt = time.time() - self._t0
            print(f"  train {i + 1}/{self.train_size} [{dt:7.1f}s] {msg}", flush=True)

    def valid_update(self, i: int, msg: str = ""):
        if i % 100 == 0 or i == self.valid_size - 1:
            print(f"  valid {i + 1}/{self.valid_size} {msg}", flush=True)

    def print_result(self, msg: str):
        print(f"  {msg}", flush=True)


class CsvLogger:
    """Per-epoch summary + per-iteration full CSV logs."""

    def __init__(self, save_path: str | Path, append: bool = False):
        self.save_path = Path(save_path)
        self.save_path.mkdir(parents=True, exist_ok=True)
        self.summary = self.save_path / "progress_log_summary.csv"
        self.full = self.save_path / "progress_log_full.csv"
        if append and self.summary.exists():
            return  # resuming: keep the previous run's rows
        with open(self.summary, "w", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(["train_loss", "validation_loss"])
        with open(self.full, "w", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(["train_loss"])

    def write_summary(self, row):
        with open(self.summary, "a", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)

    def write_iter(self, row):
        with open(self.full, "a", newline="") as f:
            csv.writer(f, delimiter="\t").writerow(row)


class JsonlLogger:
    """Structured metrics stream (one JSON object per event)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a")

    def log(self, **kv):
        kv.setdefault("t", time.time())
        self._f.write(json.dumps(kv) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
