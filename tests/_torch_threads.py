"""One share of the machine's cores for PyTorch's CPU ops in this process.

Every ``tests/test_torch_*.py`` imports this first.  Under pytest-xdist each
worker then runs its ops on ``cpu_count // workers`` threads, so the workers
together use the cores once instead of each taking all of them: with one
thread a core a worker, small ops wait at a barrier for threads that are
not scheduled.  A serial run (no ``PYTEST_XDIST_WORKER_COUNT``) keeps every
core.  Rank subprocesses take one thread each on their own
(``_torch_ranks.init_gloo``).
"""

import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // WORKERS))
