"""Each pytest-xdist worker's share of the cores for torch's intra-op
threads.

torch sizes its thread pool to every core of the machine, and under
``-n N`` each of the N workers does so: their threads, waiting for one
another at each op's barrier, starve one another, and the port's tests
ran up to ~50x slower under ``-n 6`` than alone (a 3 s test took 113-235
s).  Importing this module gives each worker ``max(1, cores // N)``
threads; outside xdist it changes nothing.  The port's test files import
it, and every worker imports every test file it collects.
"""

import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))


share_cores()
