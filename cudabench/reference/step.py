"""The plain reference of one configuration's training steps: upstream
advchain's adversarial step (the clean prediction, the chain's PGD episode,
the supervised pass, the final consistency pass, Adam) and the plain
supervised step, on the parameters, inputs and seeds the benchmark made.

It imports nothing of the measured program.  The model comes from
``model_<name>.py`` beside this file, found by the configuration's model
name; the chain from ``chain.py``.  The reference keeps no BatchNorm
running statistics: every pass of the step normalises by the batch's.

The two seeds the program derives state from are worked out again here:
the chain's initial draws come from a generator seeded as the benchmark
seeded the program's, and a model with dropout draws each step's mask as
the program's wrapper does (one 62-bit episode seed a step from a CPU
generator, the first drawn when the wrapper is built; each dropout's mask
``rand(shape) >= p`` from a generator on the device seeded with the
episode seed plus the dropout's index among the module's submodules)."""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

from . import chain as chain_mod
from .losses import cross_entropy

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
BN_EPS = 1e-5


def model_module(name):
    return importlib.import_module(f"{__package__}.model_{name}")


def batch_norm(x, w, b):
    return F.batch_norm(x, None, None, w, b, training=True, eps=BN_EPS)


class ReferenceTrainer:
    """Runs a configuration's steps from parameters ``weights`` (name ->
    tensor, copied).  ``chain_seed`` seeds the generator of the chain's
    draws on ``device``; ``wrapper_seed`` the dropout's episode seeds.
    ``rows``: use only the first ``rows`` rows of every batch (and of the
    chain's draws), the half-batch fault.  ``dtype``: the precision of
    every computation (the draws are made in float32, then cast)."""

    def __init__(self, config, step, batch, weights, chain_seed,
                 wrapper_seed, device, rows=None, dtype=torch.float32):
        m = config["model"]
        self.model = model_module(m["name"])
        self.args = m["args"]
        self.step_kind = step
        self.rows = rows
        self.dtype = dtype
        self.p = {k: v.detach().to(device, dtype).clone().requires_grad_(True)
                  for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.t = 0
        tr = config["train"]
        self.lr, self.cw = float(tr["lr"]), float(tr["consistency_weight"])
        s = config["solver"]
        self.types, self.weights = s["divergence_types"], s[
            "divergence_weights"]
        self.n_iter = int(s["n_iter"])
        size = [batch, config["image"]["channels"], *config["image"]["shape"]]
        self.chain = chain_mod.build_chain(config["chain"], size,
                                           s["power_iteration"])
        self.gen = torch.Generator(device=device).manual_seed(chain_seed)
        self.episodes = torch.Generator().manual_seed(wrapper_seed)
        self._episode_seed()  # the wrapper draws one when it is built
        self.device = device
        self.episodes_done = []  # each step's chain parameters after PGD

    def _episode_seed(self):
        return int(torch.randint(2 ** 62, (1,), generator=self.episodes))

    def _masks(self, x):
        """This step's dropout masks: one per dropout of the model, drawn
        at the shape of its activation."""
        seed = self._episode_seed()
        drops = getattr(self.model, "dropout_modules", lambda a: [])(
            self.args)
        if not drops:
            return None
        masks = []
        for p, index, channels in drops:
            shape = (x.shape[0], channels) + tuple(x.shape[2:])
            g = torch.Generator(device=x.device).manual_seed(seed + index)
            masks.append(torch.rand(shape, generator=g, device=x.device) >= p)
        return masks

    def _net(self, masks):
        def net(x):
            m = masks
            if m is not None and x.shape[0] != m[0].shape[0]:
                m = [k[:x.shape[0]] for k in m]
            return self.model.forward(self.p, x, self.args, batch_norm, m)
        return net

    def _adam(self, grads):
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(b1).add_((1 - b1) * g)
                self.v[k].mul_(b2).add_((1 - b2) * g * g)
                denom = self.v[k].sqrt() / c2 ** 0.5 + ADAM_EPS
                self.p[k].sub_(self.lr / c1 * self.m[k] / denom)

    def step(self, image, label):
        """One step; returns ({'supervised_loss', 'consistency_loss'} as
        floats, the gradient of each parameter)."""
        masks = self._masks(image)
        image = image.to(self.dtype)
        if self.step_kind == "adversarial":
            draws = [t.draw(self.gen).to(self.dtype) for t in self.chain]
        if self.rows is not None:
            image, label = image[:self.rows], label[:self.rows]
            if masks is not None:
                masks = [m[:self.rows] for m in masks]
        net = self._net(masks)
        losses = {}
        if self.step_kind == "adversarial":
            if self.rows is not None:
                draws = [d[:self.rows] for d in draws]
            with torch.no_grad():
                init_out = net(image)
            params = chain_mod.episode(self.chain, draws, image, init_out,
                                       net, self.n_iter, self.types,
                                       self.weights)
            self.episodes_done.append(params)
            sup = cross_entropy(net(image), label)
            cons, _ = chain_mod.warped_dist(
                self.chain, params, image, init_out, False, net, True,
                self.types, self.weights)
            total = sup + self.cw * cons
            losses["consistency_loss"] = float(cons.detach())
        else:
            sup = cross_entropy(net(image), label)
            total = sup
        losses["supervised_loss"] = float(sup.detach())
        names = list(self.p)
        grads = dict(zip(names, torch.autograd.grad(
            total, [self.p[k] for k in names])))
        self._adam(grads)
        return losses, grads

    def params(self):
        return {k: v.detach() for k, v in self.p.items()}
