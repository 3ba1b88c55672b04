"""The CPU threads of the port's tests.

The suite runs in several pytest-xdist workers at once (six in the tier-1
command), and PyTorch gives each process one intra-op thread a core: the
workers' threads then outnumber the cores several times over, and each
torch op waits on threads the others hold. The port's tier took 806 s in
six workers so, and 140 s with two threads a worker (an 8-core host). Each
port test module calls ``cap_torch_threads`` when it is imported; a
process that imports none keeps PyTorch's default.
"""

import torch

TORCH_THREADS = 2


def cap_torch_threads() -> None:
    """At most ``TORCH_THREADS`` intra-op threads in this process."""
    torch.set_num_threads(min(TORCH_THREADS, torch.get_num_threads()))
