"""One torch intra-op thread in the test process that imports this module,
and in the ranks that process spawns (they inherit ``OMP_NUM_THREADS``).

The port's CPU tests run in several worker processes at once on the
machine's cores; torch's CPU kernels on oversubscribed cores run many times
slower than on one thread each.  Every ``test_torch_*`` module but the GPU
one imports this module, so the pin is in place once the worker has
collected its tests, whichever of them it runs."""

import os

import torch

os.environ["OMP_NUM_THREADS"] = "1"
torch.set_num_threads(1)
