"""SegmentationModel — the solver's fixed-network contract around a torch
module (port of advchain_tpu/models/wrapper.py).

``train()`` mode (the default) normalises by batch statistics without
writing them back, the reference's train-mode solver semantics;
``eval()`` uses the running statistics.  ``apply_fixed(x, train=...)``
forces a mode for one call; the solver uses it to force batch statistics
in the final consistency pass.  ``apply_train(x)`` is a training step's
supervised forward: batch statistics, written back into the running ones.

Dropout stays fixed for an episode: every :class:`EpisodeDropout` of the
module replays one mask until :meth:`begin_episode` redraws it, which the
solver calls once per ``adversarial_training``.  Episode seeds come from an
explicit ``torch.Generator`` seeded at construction.
"""

from __future__ import annotations

import torch
from torch import nn

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch.models.unet import EpisodeDropout, _FrozenStats


class SegmentationModel:
    """Callable ``model(x) -> logits`` for the compose solver."""

    def __init__(self, module: nn.Module,
                 use_batch_stats_in_solver: bool = True, seed: int = 0):
        self.module = module
        self.training = bool(use_batch_stats_in_solver)
        self._episodes = torch.Generator().manual_seed(int(seed))
        self.begin_episode()

    @classmethod
    def create(cls, module: nn.Module, seed: int = 0, device=None):
        """Random weights from ``seed`` (the JAX package's init scheme for
        the module, its ``init_weights_``) on ``device``; None means the
        GPU, and no GPU raises."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        module.init_weights_(gen)
        return cls(module.to(dev), seed=seed)

    @property
    def device(self):
        return next(self.module.parameters()).device

    def begin_episode(self, seed=None):
        """Redraw the fixed dropout masks for a new adversarial episode:
        from ``seed``, or from the wrapper's own generator."""
        if seed is None:
            seed = int(torch.randint(2 ** 62, (1,),
                                     generator=self._episodes))
        for i, m in enumerate(self.module.modules()):
            if isinstance(m, EpisodeDropout):
                m.redraw(int(seed) + i)

    def train(self, mode: bool = True):
        """Solver forwards use batch statistics."""
        self.training = bool(mode)
        return self

    def eval(self):
        """Solver forwards use the running statistics."""
        self.training = False
        return self

    def apply_fixed(self, x, train=None):
        """Fixed-network forward; ``train`` forces the BN mode (and
        dropout), None follows the wrapper's mode."""
        self.module.train(self.training if train is None else bool(train))
        return self.module(x)

    def __call__(self, x):
        return self.apply_fixed(x)

    def apply_train(self, x):
        """One training-mode forward that also updates every BatchNorm's
        running statistics (JAX ``apply_train`` with a mutable
        ``batch_stats``); returns the logits, differentiable with respect
        to the weights."""
        self.module.train(True)
        norms = [m for m in self.module.modules()
                 if isinstance(m, _FrozenStats)]
        for m in norms:
            m.write_back = True
        try:
            return self.module(x)
        finally:
            for m in norms:
                m.write_back = False
