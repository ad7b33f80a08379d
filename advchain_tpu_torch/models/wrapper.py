"""SegmentationModel — the solver's fixed-network contract around a torch
module, and the reference model's training utilities (port of
advchain_tpu/models/wrapper.py).

``train()`` mode (the default) normalises by batch statistics without
writing them back, the reference's train-mode solver semantics;
``eval()`` uses the running statistics.  ``apply_fixed(x, train=...)``
forces a mode for one call; the solver uses it to force batch statistics
in the final consistency pass.  ``apply_train(x)`` is a training step's
supervised forward: batch statistics, written back into the running ones
(and spectral norm's ``u`` and ``sigma``).

``compute_dtype`` (e.g. ``torch.bfloat16``) is the JAX package's opt-in
speed mode: every f32 parameter and buffer (BatchNorm's running statistics
and spectral ``u`` / ``sigma`` included) and the input are cast to it for
the network's forward and backward, through ``torch.func.functional_call``
so that gradients reach the f32 master parameters through the casts, and
the logits come back as f32.  Every layer runs in that dtype, BatchNorm and
upsampling included (``torch.autocast`` would keep those in f32, which the
JAX package does not).  Statistics written back in that mode are the
low-precision update copied into the f32 buffers.

Dropout stays fixed for an episode: every :class:`EpisodeDropout` of the
module replays one mask until :meth:`begin_episode` redraws it, which the
solver calls once per ``adversarial_training``.  Episode seeds come from an
explicit ``torch.Generator`` seeded at construction.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch.models.unet import (EpisodeDropout, _FrozenStats,
                                            _StatsWriter)


class SegmentationModel:
    """Callable ``model(x) -> logits`` for the compose solver, plus the
    training and inference entry points of user loops."""

    def __init__(self, module: nn.Module,
                 use_batch_stats_in_solver: bool = True, seed: int = 0,
                 compute_dtype=None):
        self.module = module
        self.training = bool(use_batch_stats_in_solver)
        self.compute_dtype = compute_dtype
        self._adaptive_bn = False
        self._episodes = torch.Generator().manual_seed(int(seed))
        self.begin_episode()

    @classmethod
    def create(cls, module: nn.Module, seed: int = 0, device=None,
               compute_dtype=None):
        """Random weights from ``seed`` (the JAX package's init scheme for
        the module, its ``init_weights_``) on ``device``; None means the
        GPU, and no GPU raises."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        module.init_weights_(gen)
        return cls(module.to(dev), seed=seed, compute_dtype=compute_dtype)

    @property
    def device(self):
        return next(self.module.parameters()).device

    @property
    def use_batch_stats_in_solver(self):
        """An alias of ``training``."""
        return self.training

    @use_batch_stats_in_solver.setter
    def use_batch_stats_in_solver(self, value):
        self.training = bool(value)

    def begin_episode(self, seed=None):
        """Redraw the fixed dropout masks for a new adversarial episode:
        from ``seed``, or from the wrapper's own generator."""
        if seed is None:
            seed = int(torch.randint(2 ** 62, (1,),
                                     generator=self._episodes))
        self.episode_seed = int(seed)
        for i, m in enumerate(self.module.modules()):
            if isinstance(m, EpisodeDropout):
                m.redraw(self.episode_seed + i)

    def train(self, mode: bool = True):
        """Solver forwards use batch statistics."""
        self.training = bool(mode)
        return self

    def eval(self):
        """Solver forwards use the running statistics."""
        self.training = False
        return self

    # ---------------------------------------------------------- forwards
    def _forward(self, x, train: bool, write: bool = False,
                 cast: bool = True):
        """One forward in BN / dropout mode ``train``; ``write``: write the
        statistics back; ``cast``: honour ``compute_dtype``."""
        self.module.train(train)
        writers = [m for m in self.module.modules()
                   if isinstance(m, _StatsWriter)] if write else []
        for m in writers:
            m.write_back = True
        try:
            if self.compute_dtype is None or not cast:
                return self.module(x)
            return self._cast_forward(x, write)
        finally:
            for m in writers:
                m.write_back = False

    def _cast_forward(self, x, write: bool):
        dt = self.compute_dtype
        buffers = dict(self.module.named_buffers())
        low = {k: t.to(dt) for k, t in
               [*self.module.named_parameters(), *buffers.items()]
               if t.dtype == torch.float32}
        if x.dtype == torch.float32:
            x = x.to(dt)
        y = torch.func.functional_call(self.module, low, (x,))
        if write:
            with torch.no_grad():
                for k, buf in buffers.items():
                    if k in low:
                        buf.copy_(low[k])
        return y.float()

    def apply_fixed(self, x, train=None):
        """Fixed-network forward; ``train`` forces the BN mode (and
        dropout), None follows the wrapper's mode."""
        return self._forward(x, self.training if train is None
                             else bool(train))

    def __call__(self, x):
        """The solver's forward; with :meth:`adaptive_bn` enabled, a
        batch-statistics forward that also writes them back (in f32,
        whatever ``compute_dtype``, as the JAX package's)."""
        if self._adaptive_bn:
            return self._forward(x, True, write=True, cast=False)
        return self.apply_fixed(x)

    def apply_train(self, x):
        """One training-mode forward that also updates every BatchNorm's
        running statistics and every spectral norm's ``u`` and ``sigma``
        (JAX ``apply_train`` with a mutable ``batch_stats``); returns the
        logits, differentiable with respect to the weights.  In
        ``compute_dtype`` the buffers stay f32."""
        return self._forward(x, True, write=True)

    def predict(self, x):
        """Inference: running-average BN, no dropout, honouring
        ``compute_dtype`` (the JAX package's jitted ``predict``)."""
        return self._forward(x, False)

    # ------------------------------------------- reference model utilities
    def adaptive_bn(self, if_enable: bool = False):
        """Reference UNet.adaptive_bn: when enabled, ``__call__`` writes
        the incoming batch's statistics into the running ones (and spectral
        norm's ``u`` / ``sigma``) while returning batch-statistics outputs,
        the BN-recalibration recipe.  Other forwards are unchanged."""
        self._adaptive_bn = bool(if_enable)

    def init_bn(self):
        """Reset every BatchNorm's running statistics to (0, 1)."""
        for m in self.module.modules():
            if isinstance(m, _FrozenStats):
                m.reset_running_stats()

    def fix_conv_params_mask(self):
        """``{parameter name: trainable}`` freezing every convolution's
        weight and bias and training the rest (BN affines, the attention's
        ``gamma``): reference UNet.fix_conv_params."""
        conv = {f"{name}.{p}" if name else p
                for name, m in self.module.named_modules()
                if isinstance(m, nn.modules.conv._ConvNd)
                for p, _ in m.named_parameters(recurse=False)}
        return {n: n not in conv for n, _ in self.module.named_parameters()}

    def activate_conv_params_mask(self):
        """All-trainable mask (reference activate_conv_params)."""
        return {n: True for n, _ in self.module.named_parameters()}

    def fix_params_mask(self, trainable_substrings=("outc",)):
        """``{parameter name: trainable}``: trainable where the name holds
        one of ``trainable_substrings`` (reference fix_params)."""
        return {n: any(s in n for s in trainable_substrings)
                for n, _ in self.module.named_parameters()}

    def lr_group_masks(self, head_keys=("outc",)):
        """(body, head) masks of the reference's learning-rate groups: a
        parameter is the head's when its top-level module's name is, or
        starts with, one of ``head_keys``."""
        head = {n: any(n.split(".")[0].startswith(k) for k in head_keys)
                for n, _ in self.module.named_parameters()}
        return {n: not h for n, h in head.items()}, head

    def optim_parameters(self, learning_rate: float,
                         optimizer_factory=torch.optim.SGD,
                         head_keys=("outc",)):
        """Reference UNet.optim_parameters: one optimiser with two
        parameter groups, the body at ``learning_rate`` and the head at 10
        times it."""
        body, head = self.lr_group_masks(head_keys)
        params = dict(self.module.named_parameters())
        groups = [{"params": [params[n] for n, keep in mask.items() if keep],
                   "lr": lr}
                  for mask, lr in ((body, learning_rate),
                                   (head, 10.0 * learning_rate))]
        return optimizer_factory([g for g in groups if g["params"]],
                                 lr=learning_rate)

    def replace(self, state_dict=None):
        """A new wrapper on a copy of the module (with ``state_dict``
        loaded, when given) that keeps the episode seed and the seed
        stream.  As the JAX package's ``replace``, it starts in training
        mode with no ``compute_dtype``."""
        module = copy.deepcopy(self.module)
        if state_dict is not None:
            module.load_state_dict(state_dict)
        m = SegmentationModel(module)
        m._episodes.set_state(self._episodes.get_state())
        m.begin_episode(self.episode_seed)
        return m
