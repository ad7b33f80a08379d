"""ComposeAdversarialTransformSolver — chain transforms, optimise them
adversarially (PGD / power iteration), return the consistency loss (port of
advchain_tpu/augmentor/compose.py, the episode without an anatomy mask).

One ``adversarial_training`` call runs eagerly on the data's device: the
reference prediction, the parameter init (or the caller's parameters with
``lazy_load``), ``n_iter`` PGD steps, the projection, and the final
consistency pass.  Each PGD step differentiates the divergence with respect
to the flagged transforms' parameters only; a non-finite divergence leaves
the parameters unchanged (on the device, no host sync).

Model contract: ``model(x) -> logits`` behaves as a fixed network for the
episode.  A model with ``begin_episode()`` (the port's SegmentationModel)
has it called once per episode, which redraws its fixed dropout masks; one
with ``apply_fixed(x, train=...)`` gets batch statistics forced for the
final pass, as the reference forces ``model.train()`` there.

Documented divergence kept from the JAX package: per-transform
``step_sizes`` are honoured (the reference uses ``step_sizes[0]`` for all).
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence

import torch

from advchain_tpu_torch.losses import calc_segmentation_consistency
from advchain_tpu_torch.ops.grid_sample import clip

_episode_seeds = itertools.count(1)


def _binarize_nonzero(mask):
    """mask[mask != 0] = 1."""
    return torch.where(mask != 0, torch.ones_like(mask), mask)


class ComposeAdversarialTransformSolver:
    """Apply and adversarially optimise a chain of transforms."""

    def __init__(self, chain_of_transforms=None,
                 divergence_types: Sequence[str] = ("mse", "contour"),
                 divergence_weights: Sequence[float] = (1.0, 0.5),
                 use_gpu: bool = True, debug: bool = False,
                 if_norm_image: bool = False,
                 min_intensity: Optional[float] = None,
                 max_intensity: Optional[float] = None,
                 is_gt: bool = False):
        del use_gpu  # reference API; the solver runs on the data's device
        self.chain_of_transforms = list(chain_of_transforms or [])
        self.debug = debug
        self.divergence_weights = list(divergence_weights)
        self.divergence_types = list(divergence_types)
        self.if_norm_image = if_norm_image
        self.min_intensity = min_intensity
        self.max_intensity = max_intensity
        self.is_gt = is_gt
        self.class_weights = None

    # ------------------------------------------------------------ main API
    def adversarial_training(self, data, model, optimize_flags=None,
                             init_output=None, lazy_load: bool = False,
                             power_iteration=False, n_iter: int = 1,
                             step_sizes=None, anatomy_mask_images=None,
                             anatomy_reg_weight: float = 50,
                             volume_preserve_tolerance: float = 5e-4):
        """Optimise the chain to maximise prediction inconsistency, then
        return the adversarial consistency loss."""
        if anatomy_mask_images is not None:
            raise NotImplementedError(
                "the anatomy-constrained episode is not ported yet")
        flags = tuple(bool(f) for f in self._normalize_flags(optimize_flags,
                                                             n_iter))
        self._apply_power_iteration_setting(power_iteration)
        steps = tuple(self._normalize_step_sizes(step_sizes))
        transforms = tuple(self.chain_of_transforms)
        data = data.detach()
        device = data.device
        if hasattr(model, "begin_episode"):
            model.begin_episode()
        if init_output is None:
            with torch.no_grad():
                init_output = self._model_call(model, data)
        init_output = init_output.detach()

        gen = torch.Generator(device=device).manual_seed(next(_episode_seeds))
        params = tuple(
            t.param.to(device) if (lazy_load and t.param is not None)
            else t.init_params(gen, device) for t in transforms)
        params = tuple(t.prepare_train(p) if f else p
                       for t, p, f in zip(transforms, params, flags))
        dists = []
        if n_iter > 0:
            for _ in range(n_iter):
                params, d = self.pgd_step(model, params, data, init_output,
                                          flags, steps)
                dists.append(d)
            params = tuple(t.project(p) if f else p
                           for t, p, f in zip(transforms, params, flags))
        params = tuple(p.detach() for p in params)
        with torch.no_grad():
            dist, adv_data, adv_output, warped = self._final_loss(
                model, params, data, init_output)
        for t, p in zip(transforms, params):
            t.param = p
        if self.debug:
            for i, d in enumerate(dists):
                print(f"[inner loop], step {i + 1}: dist {float(d)}")
            print("[outer loop] loss", float(dist))
        self.init_output = init_output
        self.warped_back_adv_output = warped
        self.origin_data = data
        self.adv_data = adv_data
        self.adv_predict = adv_output
        return dist

    # ----------------------------------------------------- chain functions
    def _precompute_chain(self, params, train_flags):
        return tuple(t.precompute(p, training=tf) for t, p, tf in
                     zip(self.chain_of_transforms, params, train_flags))

    def _chain_apply(self, params, data, train_flags, auxs):
        x = data
        for t, p, tf, aux in zip(self.chain_of_transforms, params,
                                 train_flags, auxs):
            x = t.apply_precomputed(aux, p, x, training=tf)
        if self.if_norm_image:
            lo = (torch.amin(data) if self.min_intensity is None
                  else self.min_intensity)
            hi = (torch.amax(data) if self.max_intensity is None
                  else self.max_intensity)
            x = clip(x, lo, hi)
        return x

    def _predict_forward(self, params, data, train_flags, auxs):
        for t, p, tf, aux in zip(self.chain_of_transforms, params,
                                 train_flags, auxs):
            if t.is_geometric():
                data = t.apply_precomputed(aux, p, data, training=tf)
        return data

    def _predict_backward(self, params, data, train_flags, auxs):
        for t, p, tf, aux in reversed(list(zip(
                self.chain_of_transforms, params, train_flags, auxs))):
            if t.is_geometric():
                data = t.inverse_precomputed(aux, p, data, training=tf)
        return data

    def _warped_dist(self, params, data, init_output, train_flags,
                     model_fn, detach_input: bool = False):
        """Chain apply -> net -> warp back with the validity mask -> the
        divergence.  The one-channel mask rides the prediction's backward
        chain: one warp instead of two.  ``detach_input`` stops the
        gradient at the adversarial image (the final pass)."""
        auxs = self._precompute_chain(params, train_flags)
        adv_data = self._chain_apply(params, data, train_flags, auxs)
        adv_output = model_fn(adv_data.detach() if detach_input
                              else adv_data)
        if not self.if_contains_geo_transform():
            return (self.loss_fn(pred=adv_output, reference=init_output),
                    adv_data, adv_output, adv_output)
        ones = torch.ones(init_output.shape[:1] + (1,)
                          + init_output.shape[2:], dtype=init_output.dtype,
                          device=init_output.device)
        fwd = self._predict_forward(params, ones, train_flags, auxs)
        c = adv_output.shape[1]
        both = self._predict_backward(
            params, torch.cat([adv_output, fwd], dim=1), train_flags, auxs)
        warped = both[:, :c]
        fb_mask = _binarize_nonzero(both[:, c:c + 1])
        dist = self.loss_fn(pred=warped, reference=init_output, mask=fb_mask)
        return dist, adv_data, adv_output, warped

    def pgd_step(self, model, params, data, init_output, flags, steps):
        """One PGD iteration (the JAX package's ``build_pgd_step_fn``,
        compose.py:454-534): the divergence's gradient with respect to the
        flagged transforms' parameters, then each flagged transform's update
        rule.  ``model`` is any callable ``model(x) -> logits`` (a train
        step passes its frozen network); no gradient reaches its weights.
        Returns (new params, divergence)."""
        opt = [p.detach().requires_grad_(True)
               for p, f in zip(params, flags) if f]
        it = iter(opt)
        full = tuple(next(it) if f else p for p, f in zip(params, flags))
        dist = self._warped_dist(full, data, init_output, flags,
                                 lambda x: self._model_call(model, x))[0]
        grads = iter(torch.autograd.grad(dist, opt))
        dist = dist.detach()
        ok = torch.isfinite(dist)
        new_params = []
        for t, p, f, s in zip(self.chain_of_transforms, params, flags,
                              steps):
            if f:
                new_params.append(torch.where(
                    ok, t.update(p, next(grads), s), p))
            else:
                new_params.append(p)
        return tuple(new_params), dist

    def _final_loss(self, model, params, data, init_output):
        """The final consistency pass (``_final_loss_math``,
        compose.py:651-688): eval-mode chain, batch statistics in the
        network.  Differentiable with respect to the network's weights,
        with the adversarial image and ``init_output`` detached as in JAX;
        ``adversarial_training`` runs it under ``no_grad``, a train step
        does not."""
        eval_flags = (False,) * len(self.chain_of_transforms)
        return self._warped_dist(
            params, data, init_output.detach(), eval_flags,
            lambda x: self._model_call(model, x, train=True),
            detach_input=True)

    # -------------------------------------------------------------- model
    def get_net_output(self, model, data):
        return model(data)

    def _model_call(self, model, x, train=None):
        """A forward of the fixed network; ``train=True`` forces batch
        statistics where the model supports it and the user has not
        replaced ``get_net_output``."""
        overridden = ("get_net_output" in self.__dict__
                      or type(self).get_net_output is not
                      ComposeAdversarialTransformSolver.get_net_output)
        if train is not None and hasattr(model, "apply_fixed") \
                and not overridden:
            return model.apply_fixed(x, train=train)
        return self.get_net_output(model, x)

    def loss_fn(self, pred, reference, mask=None):
        return calc_segmentation_consistency(
            output=pred, reference=reference,
            divergence_types=self.divergence_types,
            divergence_weights=self.divergence_weights, scales=[0],
            mask=mask, class_weights=self.class_weights, is_gt=self.is_gt)

    # ----------------------------------------------------------- utilities
    def if_contains_geo_transform(self, chain_of_transforms=None):
        chain = (self.chain_of_transforms if chain_of_transforms is None
                 else chain_of_transforms)
        return sum(t.is_geometric() for t in chain) > 0

    def set_transformation(self, parameter_list):
        for t, param in zip(self.chain_of_transforms, parameter_list):
            t.set_parameters(param)

    def get_transformation_parameters(self):
        return [t.get_parameters() for t in self.chain_of_transforms]

    def _normalize_flags(self, optimize_flags, n_iter):
        if optimize_flags is not None:
            if len(optimize_flags) != len(self.chain_of_transforms):
                raise ValueError(
                    f"must specify each transform is learnable or not, "
                    f"expect {len(self.chain_of_transforms)} flags, but got "
                    f"{optimize_flags}")
            return list(optimize_flags)
        if n_iter < 0:
            raise ValueError("n_iter must be >= 0")
        return [n_iter > 0] * len(self.chain_of_transforms)

    def _apply_power_iteration_setting(self, power_iteration):
        if isinstance(power_iteration, bool):
            powers = [power_iteration] * len(self.chain_of_transforms)
        elif isinstance(power_iteration, list):
            if len(power_iteration) != len(self.chain_of_transforms):
                raise ValueError("must specify each transform optimization "
                                 "mode")
            powers = power_iteration
        elif power_iteration == "smart":
            powers = [t.get_name() == "noise"
                      for t in self.chain_of_transforms]
        else:
            raise ValueError(f"power_iteration must be bool/list/'smart', "
                             f"got {power_iteration!r}")
        for t, p in zip(self.chain_of_transforms, powers):
            t.power_iteration = p

    def _normalize_step_sizes(self, step_sizes):
        if step_sizes is None:
            return [1.0] * len(self.chain_of_transforms)
        if isinstance(step_sizes, (int, float)):
            return [float(step_sizes)] * len(self.chain_of_transforms)
        if isinstance(step_sizes, list):
            if len(step_sizes) != len(self.chain_of_transforms):
                raise ValueError("specify step size for each transformation")
            return [float(s) for s in step_sizes]
        raise ValueError(f"step_sizes must be a number or a list, got "
                         f"{step_sizes!r}")
