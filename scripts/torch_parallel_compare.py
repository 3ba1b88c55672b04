#!/usr/bin/env python3
"""Trees of the port on the same card, the data-parallel step in turns:
``scripts/torch_parallel_run.py`` of each tree under
``torch.distributed.run`` on ``--ranks`` ranks (gloo where they share the
card), in the order A B .. B A (``--rounds`` times), each run timing
``--steps`` steps of each of ``--kinds`` after its first. Prints one JSON
line: for each tree, each kind, the median step ms and all-reduce ms of
rank 0 over its runs, and every run's medians.

    python3 scripts/torch_parallel_compare.py build/parent . --kinds berhu

Each tree builds its kernels first (``ops/cuda/_build.py``, one ``nvcc``
per source). A tree is a checkout of the repo (``git archive`` of an
earlier commit unpacked under ``build/``). Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import socket
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def build(tree: Path) -> None:
    subprocess.run([sys.executable, "-c", "from supervised_dispnet_tpu_torch.ops.cuda import "
                    "_build; _build.build()"], cwd=tree, check=True)


def run(tree: Path, ranks: int, kinds: str, steps: int, out: Path) -> dict:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc-per-node",
           str(ranks), "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           "scripts/torch_parallel_run.py", str(out), "--kinds", kinds, "--steps", str(steps)]
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stdout[-3000:]}"
                         f"{proc.stderr[-3000:]}")
    rec = json.loads((out / "rank0.json").read_text())
    return {kind: {"step_ms": statistics.median(s["step_ms"]),
                   "collective_ms": statistics.median(s["collective_ms"])}
            for kind, s in rec["steps"].items()}


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("trees", type=Path, nargs="+")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--kinds", default="berhu")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--rounds", type=int, default=1)
    args = p.parse_args()
    trees = {chr(ord("a") + i): t.resolve() for i, t in enumerate(args.trees)}
    for tree in trees.values():
        build(tree)
    runs: dict[str, list] = {tag: [] for tag in trees}
    order = [*trees, *reversed(trees)] * args.rounds
    with tempfile.TemporaryDirectory() as tmp:
        for i, tag in enumerate(order):
            res = run(trees[tag], args.ranks, args.kinds, args.steps, Path(tmp) / f"{i}{tag}")
            print(f"{tag} ({trees[tag]}): {res}", flush=True)
            runs[tag].append(res)
    summary = {tag: {"tree": str(trees[tag]), "runs": rs,
                     **{kind: {k: statistics.median(r[kind][k] for r in rs)
                               for k in ("step_ms", "collective_ms")} for kind in rs[0]}}
               for tag, rs in runs.items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
