"""ComposeAdversarialTransformSolver — chain transforms, optimise them
adversarially (PGD / power iteration), return the consistency loss (port
of advchain_tpu/augmentor/compose.py).

One ``adversarial_training`` call runs eagerly on the data's device: the
reference prediction, the parameter init (or the caller's parameters with
``lazy_load``), ``n_iter`` PGD steps, the projection, and the final
consistency pass.  Each PGD step differentiates the divergence with respect
to the flagged transforms' parameters only; a non-finite divergence leaves
the parameters unchanged (on the device, no host sync).

With an anatomy mask the episode keeps the volume of the anatomy: the
geometric transforms' initial parameters are rejection-sampled until the
mask's forward-backward roundtrip loses at most
``volume_preserve_tolerance``, each PGD step adds
``anatomy_reg_weight * mean((binarise(roundtrip) - mask)^2)`` to the
divergence (a penalty with zero gradient: it changes the returned
divergence, not the step), and a failed volume check after ``n_iter``
steps enters the graduated retry ladder of :meth:`optimizing_transform`.
Each rejection try and each ladder decision reads one scalar to the host.

While a torch profiler records, each PGD step is an
``advchain.solver.pgd_step`` span holding ``advchain.solver.grad`` and
``advchain.solver.update``, and each pass through the chain and the network
records ``advchain.chain.precompute``, ``advchain.chain.apply``,
``advchain.chain.warp_back`` and ``advchain.loss.divergence``
(``advchain_tpu_torch._trace``).

The stateful API (``forward`` / ``backward`` / ``predict_*``,
``init_random_transformation``, ``compute_transform_grads``,
``get_adv_data``, ...) drives the transforms' own state, as the
reference's manual loop does.

Model contract: ``model(x) -> logits`` behaves as a fixed network for the
episode.  A model with ``begin_episode()`` (the port's SegmentationModel)
has it called once per episode, which redraws its fixed dropout masks; one
with ``apply_fixed(x, train=...)`` gets batch statistics forced for the
final pass, as the reference forces ``model.train()`` there.

Documented divergences kept from the JAX package: per-transform
``step_sizes`` are honoured (the reference uses ``step_sizes[0]`` for
all); with ``lazy_load=False`` the anatomy-constrained init draws every
transform first and then redraws each geometric one against the fully
fresh chain (the reference redraws transform i while later transforms
still hold the previous episode's parameters; ``lazy_load=True`` keeps
that order).
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch._trace import trace
from advchain_tpu_torch.losses import calc_segmentation_consistency
from advchain_tpu_torch.ops import collectives, norms
from advchain_tpu_torch.ops.grid_sample import clip

logger = logging.getLogger(__name__)

# the JAX package's warnings, word for word
_WARN_INIT = ("random initialization: fail to find a good initialized geo "
              "transformation in the given range; reduce the search space "
              "or increase the tolerance factor")
_WARN_FALLBACK = ("optimization time is 3X longer than expected, use random "
                  "initialized one instead; consider narrowing the affine "
                  "search space or a smaller step size")
_WARN_REINIT = "volume not preserved; continuing search with a new " \
    "initialization"
_WARN_ONE_MORE = "volume not preserved; continuing search with one more step"
# redraws of one geometric transform before the init gives up
_MAX_INIT_TRIES = 10


def np_asarray_list(x):
    """``x`` as a list of Python floats (the JAX package's helper for
    logging per-step distances)."""
    return [float(v) for v in np.asarray(x)]


def _binarize_nonzero(mask):
    """mask[mask != 0] = 1."""
    return torch.where(mask != 0, torch.ones_like(mask), mask)


def _binarize_half(x):
    """1 where x >= 0.5, else 0 (no gradient)."""
    return (x >= 0.5).to(x.dtype)


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
        self.diffs = []
        # this solver's episode seeds, 1, 2, ... (JAX's _next_episode_seed,
        # compose.py:125-127): one solver's draws do not depend on how many
        # episodes other solvers ran before it
        self._episode_seed = 0

    # ------------------------------------------------------------ main API
    def adversarial_training(self, data, model, optimize_flags=None,
                             init_output=None, lazy_load: bool = False,
                             power_iteration=False, n_iter: int = 1,
                             step_sizes=None, anatomy_mask_images=None,
                             anatomy_reg_weight: float = 50,
                             volume_preserve_tolerance: float = 5e-4):
        """Optimise the chain to maximise prediction inconsistency, then
        return the adversarial consistency loss."""
        flags = tuple(bool(f) for f in self._normalize_flags(optimize_flags,
                                                             n_iter))
        self._apply_power_iteration_setting(power_iteration)
        steps = tuple(self._normalize_step_sizes(step_sizes))
        data = data.detach()
        if anatomy_mask_images is None:
            _, dist, adv_data, adv_output, warped, init_output = \
                self._episode(data, model, flags, steps, n_iter, lazy_load,
                              init_output)
        else:
            dist, adv_data, adv_output, warped, init_output = \
                self._anatomy_episode(
                    data, model, flags, steps, n_iter, lazy_load,
                    init_output, anatomy_mask_images, anatomy_reg_weight,
                    volume_preserve_tolerance)
        self.init_output = init_output
        self.warped_back_adv_output = warped
        self.origin_data = data
        self.adv_data = adv_data
        self.adv_predict = adv_output
        if self.debug:
            print("[outer loop] loss", float(dist))
        return dist

    def _generator(self, device):
        """A generator seeded with this solver's next episode seed."""
        self._episode_seed += 1
        return torch.Generator(device=device).manual_seed(self._episode_seed)

    def _episode(self, data, model, flags, steps, n_iter, lazy_load,
                 init_output):
        """The episode without an anatomy mask: fresh (or, with
        ``lazy_load``, only missing) parameters, PGD, projection, final
        pass.  Writes the parameters back; returns (params, dist, adv_data,
        adv_output, warped, init_output)."""
        transforms = tuple(self.chain_of_transforms)
        device = data.device
        if hasattr(model, "begin_episode"):
            model.begin_episode()
        if init_output is None:
            init_output = self.get_init_output(model, data)
        init_output = init_output.detach()
        gen = self._generator(device)
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
            params = self._project(params, flags)
        params = tuple(p.detach() for p in params)
        with torch.no_grad():
            dist, adv_data, adv_output, warped = self._final_loss(
                model, params, data, init_output)
        for t, p in zip(transforms, params):
            t.param = p
            t.is_training = False
        if self.debug:
            for i, d in enumerate(dists):
                print(f"[inner loop], step {i + 1}: dist {float(d)}")
        return params, dist, adv_data, adv_output, warped, init_output

    def _anatomy_episode(self, data, model, flags, steps, n_iter, lazy_load,
                         init_output, anatomy, anatomy_reg_weight, tol):
        """The anatomy-constrained episode: a rejection-sampled init (JAX's
        fused order without ``lazy_load``, the reference's stateful order
        with it), then :meth:`optimizing_transform`'s penalised PGD, volume
        check and retry ladder, then the final pass.  Returns (dist,
        adv_data, adv_output, warped, init_output)."""
        transforms = tuple(self.chain_of_transforms)
        if hasattr(model, "begin_episode"):
            model.begin_episode()
        if init_output is None:
            init_output = self.get_init_output(model, data)
        init_output = init_output.detach()
        if not lazy_load:
            params, _, max_tries = self._anatomy_init(
                self._generator(data.device), data.device, anatomy, tol)
            for t, p, f in zip(transforms, params, flags):
                # with no step to take, JAX's fused order still prepares
                # the flagged parameters (optimizing_transform does it
                # otherwise)
                t.param = t.prepare_train(p) if f and n_iter < 1 else p
            if max_tries > _MAX_INIT_TRIES:
                logger.warning(_WARN_INIT)
        else:
            for t in transforms:  # the caller's parameters follow the data
                if t.param is not None:
                    t.param = t.param.to(data.device)
            self.init_random_transformation(
                lazy_load, anatomy_mask_images=anatomy,
                volume_preserve_tolerance=tol)
        if n_iter >= 1:
            self.optimizing_transform(
                data=data, model=model, init_output=init_output,
                n_iter=n_iter, optimize_flags=list(flags),
                step_sizes=list(steps), anatomy_mask_images=anatomy,
                anatomy_reg_weight=anatomy_reg_weight,
                volume_preserve_tolerance=tol)
        for t in transforms:
            t.eval()
        params = tuple(t.param for t in transforms)
        with torch.no_grad():
            dist, adv_data, adv_output, warped = self._final_loss(
                model, params, data, init_output)
        return dist, adv_data, adv_output, warped, init_output

    # ----------------------------------------------------- chain functions
    def _precompute_chain(self, params, train_flags):
        return tuple(t.precompute(p, training=tf) for t, p, tf in
                     zip(self.chain_of_transforms, params, train_flags))

    def _norm_image(self, x, data):
        if not self.if_norm_image:
            return x
        dg = collectives.current_data_group()
        lo, hi = self.min_intensity, self.max_intensity
        if lo is None:  # over the whole batch, the data group's too
            lo = torch.amin(data) if dg is None else \
                collectives.all_reduce(torch.amin(data), "min", dg.group)
        if hi is None:
            hi = torch.amax(data) if dg is None else \
                collectives.all_reduce(torch.amax(data), "max", dg.group)
        return clip(x, lo, hi)

    def _chain_apply(self, params, data, train_flags, auxs):
        x = data
        for t, p, tf, aux in zip(self.chain_of_transforms, params,
                                 train_flags, auxs):
            x = t.apply_precomputed(aux, p, x, training=tf)
        return self._norm_image(x, data)

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
                     model_fn, detach_input: bool = False, anatomy=None,
                     anatomy_reg_weight: float = 50.0):
        """Chain apply -> net -> warp back with the validity mask -> the
        divergence.  The one-channel mask (and the anatomy mask, when
        given) rides the prediction's backward chain: one warp instead of
        several, and with "lowest" padding the pad value is the minimum
        over every channel of that one call, as in JAX.  ``anatomy`` adds
        the volume penalty, ``anatomy_reg_weight * mean((binarise(rec) -
        anatomy)^2)``, whose gradient is zero.  ``detach_input`` stops the
        gradient at the adversarial image (the final pass)."""
        with trace("advchain.chain.precompute"):
            auxs = self._precompute_chain(params, train_flags)
        with trace("advchain.chain.apply"):
            adv_data = self._chain_apply(params, data, train_flags, auxs)
        adv_output = model_fn(adv_data.detach() if detach_input
                              else adv_data)
        if not self.if_contains_geo_transform():
            with trace("advchain.loss.divergence"):
                dist = self.loss_fn(pred=adv_output, reference=init_output)
            return dist, adv_data, adv_output, adv_output
        with trace("advchain.chain.warp_back"):
            ones = torch.ones(init_output.shape[:1] + (1,)
                              + init_output.shape[2:],
                              dtype=init_output.dtype,
                              device=init_output.device)
            fwd_in = ones if anatomy is None else torch.cat([ones, anatomy],
                                                            1)
            fwd = self._predict_forward(params, fwd_in, train_flags, auxs)
            c = adv_output.shape[1]
            both = self._predict_backward(
                params, torch.cat([adv_output, fwd], dim=1), train_flags,
                auxs)
            warped = both[:, :c]
            fb_mask = _binarize_nonzero(both[:, c:c + 1])
        with trace("advchain.loss.divergence"):
            dist = self.loss_fn(pred=warped, reference=init_output,
                                mask=fb_mask)
            if anatomy is not None:
                rec = _binarize_half(both[:, c + 1:])
                dist = dist + anatomy_reg_weight * torch.mean(
                    (rec - anatomy) ** 2)
        return dist, adv_data, adv_output, warped

    def pgd_step(self, model, params, data, init_output, flags, steps,
                 anatomy=None, anatomy_reg_weight: float = 50.0):
        """One PGD iteration (the JAX package's ``build_pgd_step_fn``,
        compose.py:454-534): the divergence's gradient with respect to the
        flagged transforms' parameters, then each flagged transform's update
        rule.  ``model`` is any callable ``model(x) -> logits`` (a train
        step passes its frozen network); no gradient reaches its weights.
        ``anatomy`` (N, 1, *spatial) adds the volume penalty.  Returns (new
        params, divergence).

        Inside a data group each rank differentiates its share of the
        global divergence (its rows, and slab, over the global batch's);
        the collectives' backwards make each parameter's gradient that of
        the global divergence on the ranks holding it, but a parameter
        replicated over a space group (the bias control points, the affine
        latent, the morph velocity) gets one part from each slab, summed
        here over the group.  A sharded one (the noise) is this rank's
        slab's own."""
        with trace("advchain.solver.pgd_step"):
            return self._pgd_step(model, params, data, init_output, flags,
                                  steps, anatomy, anatomy_reg_weight)

    def _pgd_step(self, model, params, data, init_output, flags, steps,
                  anatomy, anatomy_reg_weight):
        opt = [p.detach().requires_grad_(True)
               for p, f in zip(params, flags) if f]
        it = iter(opt)
        full = tuple(next(it) if f else p for p, f in zip(params, flags))
        dist = self._warped_dist(full, data, init_output, flags,
                                 lambda x: self._model_call(model, x),
                                 anatomy=anatomy,
                                 anatomy_reg_weight=anatomy_reg_weight)[0]
        dg = collectives.current_data_group()
        if dg is not None:  # this rank's share of the global divergence
            dist = dist * dg.share
        with trace("advchain.solver.grad"):
            grads = torch.autograd.grad(dist, opt)
            if dg is not None and dg.space is not None:
                grads = self._sum_replicated_grads(grads, flags, dg.space)
        grads = iter(grads)
        dist = dist.detach()
        if dg is not None:  # the shares summed: the global batch's
            dist = collectives.all_reduce(dist, group=dg.group)
        with trace("advchain.solver.update"):
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

    def _sum_replicated_grads(self, grads, flags, space):
        """The flagged gradients with each replicated parameter's summed
        over the space group, in one all-reduce."""
        flagged = [t for t, f in zip(self.chain_of_transforms, flags) if f]
        rep = [i for i, t in enumerate(flagged) if not t.sharded_params]
        if not rep:
            return grads
        flat = collectives.all_reduce(
            torch.cat([grads[i].reshape(-1) for i in rep]), group=space.group)
        grads = list(grads)
        for i, v in zip(rep, flat.split([grads[i].numel() for i in rep])):
            grads[i] = v.view_as(grads[i])
        return tuple(grads)

    def _project(self, params, flags):
        return tuple(t.project(p) if f else p for t, p, f in
                     zip(self.chain_of_transforms, params, flags))

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

    # ----------------------------------------------- the anatomy constraint
    def _misoverlap(self, params, mask):
        """The eval-mode roundtrip of ``mask`` through the geometric
        transforms, binarised at 0.5, against ``mask``: the MSE.  Only the
        geometric transforms are precomputed: the others leave a
        prediction as it is."""
        eval_flags = (False,) * len(self.chain_of_transforms)
        with torch.no_grad():
            auxs = tuple(t.precompute(p) if t.is_geometric() else None
                         for t, p in zip(self.chain_of_transforms, params))
            fwd = self._predict_forward(params, mask, eval_flags, auxs)
            rec = self._predict_backward(params, fwd, eval_flags, auxs)
            return torch.mean((_binarize_half(rec) - mask) ** 2)

    def _anatomy_init(self, generator, device, mask, tol):
        """Every transform draws, then each geometric one is redrawn
        against the fully fresh chain while the misoverlap exceeds ``tol``
        (at most ``_MAX_INIT_TRIES + 1`` redraws each).  Returns (params,
        misoverlap, the most redraws of one transform)."""
        params = [t.init_params(generator, device)
                  for t in self.chain_of_transforms]
        mis = None
        max_tries = 0
        for i, t in enumerate(self.chain_of_transforms):
            if not t.is_geometric():
                continue
            tries = 0
            if mis is None:
                mis = float(self._misoverlap(params, mask))
            while mis > tol and tries <= _MAX_INIT_TRIES:
                params[i] = t.init_params(generator, device)
                mis = float(self._misoverlap(params, mask))
                tries += 1
            max_tries = max(max_tries, tries)
        if mis is None:
            mis = float(self._misoverlap(params, mask))
        return tuple(params), mis, max_tries

    def compute_anatomy_misoverlapping_loss(self, anatomy_mask_images):
        """Volume-preservation score: the MSE between the binarised
        roundtrip of the anatomy mask and the mask.  With a transform not
        yet initialised, the stateful roundtrip draws it."""
        params = tuple(t.param for t in self.chain_of_transforms)
        if any(p is None for p in params):
            with torch.no_grad():
                recovered = self.predict_backward(
                    self.predict_forward(anatomy_mask_images))
                score = torch.mean((_binarize_half(recovered)
                                    - anatomy_mask_images) ** 2)
        else:
            score = self._misoverlap(params, anatomy_mask_images)
        if self.debug:
            print("anatomy preserving error:", float(score))
        return score

    def optimizing_transform(self, model, data, init_output, optimize_flags,
                             n_iter: int = 1, step_sizes=None,
                             anatomy_mask_images=None,
                             anatomy_reg_weight: float = 50,
                             volume_preserve_tolerance: float = 5e-4):
        """The inner PGD loop from the transforms' current parameters,
        with the volume-preserving graduated retry ladder: after
        ``n_iter`` steps a failed volume check adds one step; at
        2 x ``n_iter`` it draws a fresh rejection-sampled init and adds
        ``n_iter`` steps; at 3 x ``n_iter`` it keeps a random init."""
        transforms = self.chain_of_transforms
        if step_sizes is None:
            step_sizes = [1.0] * len(transforms)
        flags = tuple(bool(f) for f in optimize_flags)
        steps = tuple(float(s) for s in step_sizes)
        data = data.detach()
        use_anatomy = anatomy_mask_images is not None and \
            abs(anatomy_reg_weight) > 1e-32
        anatomy = anatomy_mask_images if use_anatomy else None
        check_volume = use_anatomy and self.if_contains_geo_transform()
        tol = volume_preserve_tolerance

        self.make_learnable_transformation(optimize_flags)
        params = tuple(t.param for t in transforms)
        one_time_iter = n_iter
        i_iter = 0
        stop = n_iter <= 0
        while not stop:
            for j in range(n_iter - i_iter):
                params, d = self.pgd_step(model, params, data, init_output,
                                          flags, steps, anatomy,
                                          anatomy_reg_weight)
                if self.debug:
                    print(f"[inner loop], step {i_iter + j + 1}: dist "
                          f"{float(d)}")
            i_iter = n_iter
            # decision point: project, write back, freeze, volume check
            params = tuple(p.detach() for p in self._project(params, flags))
            for flag, t, p in zip(flags, transforms, params):
                t.param = p
                if flag:
                    t.eval()
            if not check_volume:
                break
            mis = float(self.compute_anatomy_misoverlapping_loss(
                anatomy_mask_images))
            if abs(mis) <= tol:
                stop = True
            elif i_iter >= 3 * one_time_iter:
                stop = True
                logger.warning(_WARN_FALLBACK)
                self.init_random_transformation(
                    anatomy_mask_images=anatomy_mask_images,
                    volume_preserve_tolerance=tol)
                # keep the fallback's random parameters
                params = tuple(t.param for t in transforms)
            else:
                if i_iter == 2 * one_time_iter:
                    self.init_random_transformation(
                        anatomy_mask_images=anatomy_mask_images,
                        volume_preserve_tolerance=tol)
                    n_iter += one_time_iter
                    logger.warning(_WARN_REINIT)
                else:
                    n_iter += 1
                    logger.warning(_WARN_ONE_MORE)
                self.make_learnable_transformation(optimize_flags)
                params = tuple(t.param for t in transforms)
        for t, p in zip(transforms, params):
            t.param = p.detach()
        return transforms

    # ----------------------------------------------------- stateful chain
    def forward(self, data, chain_of_transforms=None, interp=None,
                padding_mode=None):
        """Apply the chain with the transforms' current parameters,
        recording each transform's ``diff`` in ``self.diffs``."""
        data = data.detach()
        t_data = data
        self.diffs = []
        for transform in self._chain(chain_of_transforms):
            t_data = transform.forward(t_data, interp=interp,
                                       padding_mode=padding_mode)
            self.diffs.append(transform.diff)
        return self._norm_image(t_data, data)

    def predict_forward(self, data, chain_of_transforms=None, interp=None,
                        padding_mode=None):
        self.diffs = []
        for transform in self._chain(chain_of_transforms):
            data = transform.predict_forward(data, interp=interp,
                                             padding_mode=padding_mode)
            self.diffs.append(transform.diff)
        return data

    def backward(self, data, chain_of_transforms=None, interp=None,
                 padding_mode=None):
        for transform in reversed(self._chain(chain_of_transforms)):
            data = transform.backward(data, interp=interp,
                                      padding_mode=padding_mode)
        return data

    def predict_backward(self, data, chain_of_transforms=None, interp=None,
                         padding_mode=None):
        for transform in reversed(self._chain(chain_of_transforms)):
            data = transform.predict_backward(data, interp=interp,
                                              padding_mode=padding_mode)
        return data

    def calc_adv_consistency_loss(self, data, model, init_output,
                                  chain_of_transforms=None):
        """The consistency loss of the frozen chain through the stateful
        API, batch statistics forced in the network.  Returns (dist,
        adv_data, adv_output, warped_back_adv_output)."""
        chain = self._chain(chain_of_transforms)
        for tr in chain:
            tr.eval()
        adv_data = self.forward(data, chain)
        adv_output = self._model_call(model, adv_data.detach(), train=True)
        if self.if_contains_geo_transform(chain):
            masks = torch.ones_like(init_output)
            fb_mask = self.predict_backward(
                self.predict_forward(masks, chain), chain)
            warped = self.predict_backward(adv_output, chain)
            dist = self.loss_fn(pred=warped, reference=init_output.detach(),
                                mask=_binarize_nonzero(fb_mask))
        else:
            warped = adv_output
            dist = self.loss_fn(pred=adv_output,
                                reference=init_output.detach())
        return dist, adv_data, adv_output, warped

    def compute_transform_grads(self, data, model, init_output=None,
                                optimize_flags=None):
        """The reference manual loop's ``dist.backward()``: the consistency
        loss and its gradient with respect to every flagged transform's
        current parameters (flagged transforms enter training mode first),
        each stashed as ``transform.grad`` so that
        ``transform.optimize_parameters()`` works with no argument.
        Returns (dist, grads aligned with the chain, None where
        unflagged)."""
        transforms = self.chain_of_transforms
        if optimize_flags is None:
            optimize_flags = [True] * len(transforms)
        flags = tuple(bool(f) for f in optimize_flags)
        for t, f in zip(transforms, flags):
            if f:
                t.train()
        if init_output is None:
            init_output = self.get_init_output(model=model, data=data)
        opt = [t.param.detach().requires_grad_(True)
               for t, f in zip(transforms, flags) if f]
        it = iter(opt)
        full = tuple(next(it) if f else t.param
                     for t, f in zip(transforms, flags))
        dist = self._warped_dist(full, data.detach(), init_output.detach(),
                                 flags, lambda x: self._model_call(model, x))[0]
        grads = iter(torch.autograd.grad(dist, opt) if opt else ())
        out = []
        for t, f in zip(transforms, flags):
            t.grad = next(grads) if f else None
            out.append(t.grad)
        return dist.detach(), tuple(out)

    def get_adv_data(self, data, model, init_output=None, n_iter: int = 0,
                     optimize_flags=None, step_sizes=None,
                     anatomy_mask_images=None, anatomy_reg_weight: float = 50,
                     volume_preserve_tolerance: float = 5e-4):
        """(augmented data, augmented label): a fresh chain, optimised for
        ``n_iter`` steps, applied to ``data``, and the reference prediction
        pushed through its geometric transforms as the pseudo label."""
        if optimize_flags is None:
            optimize_flags = [True] * len(self.chain_of_transforms)
        if step_sizes is None:
            step_sizes = [1.0] * len(self.chain_of_transforms)
        data = data.detach()
        if anatomy_mask_images is None:
            flags = tuple(bool(f) for f in self._normalize_flags(
                optimize_flags, max(n_iter, 0)))
            steps = tuple(self._normalize_step_sizes(step_sizes))
            params, _, adv_data, _, _, init_output = self._episode(
                data, model, flags, steps, n_iter, False, init_output)
            eval_flags = (False,) * len(params)
            with torch.no_grad():
                pseudo_label = self._predict_forward(
                    params, init_output, eval_flags,
                    self._precompute_chain(params, eval_flags))
            return adv_data, pseudo_label
        if hasattr(model, "begin_episode"):
            model.begin_episode()
        if init_output is None:
            init_output = self.get_init_output(model, data)
        self.init_random_transformation(
            lazy_load=False, anatomy_mask_images=anatomy_mask_images,
            volume_preserve_tolerance=volume_preserve_tolerance)
        if n_iter > 0:
            self.optimizing_transform(
                data=data, model=model, init_output=init_output,
                n_iter=n_iter, optimize_flags=optimize_flags,
                step_sizes=step_sizes,
                anatomy_mask_images=anatomy_mask_images,
                anatomy_reg_weight=anatomy_reg_weight,
                volume_preserve_tolerance=volume_preserve_tolerance)
        with torch.no_grad():
            return self.forward(data), self.predict_forward(init_output)

    def init_random_transformation(self, lazy_load: bool = False,
                                   anatomy_mask_images=None,
                                   volume_preserve_tolerance: float = 5e-4):
        """Random parameters for the chain (with ``lazy_load``, only for
        transforms that have none).  Without a mask: one device generator
        seeded from the first transform's stream, on that transform's
        device.  With a mask, on the mask's device, the geometric
        transforms are rejection-sampled: in the fused order without
        ``lazy_load``, in the reference's stateful order with it."""
        chain = self.chain_of_transforms
        if not chain:
            return
        tol = volume_preserve_tolerance
        if anatomy_mask_images is None:
            missing = [t for t in chain if t.param is None or not lazy_load]
            if not missing:
                return
            device = resolve_device(chain[0].device)
            seed = int(torch.randint(2 ** 62, (1,),
                                     generator=chain[0]._generator))
            gen = torch.Generator(device=device).manual_seed(seed)
            for t in missing:
                t.param = t.init_params(gen, device)
            return
        device = anatomy_mask_images.device
        if not lazy_load:
            seed = int(torch.randint(2 ** 62, (1,),
                                     generator=chain[0]._generator))
            gen = torch.Generator(device=device).manual_seed(seed)
            params, mis, max_tries = self._anatomy_init(
                gen, device, anatomy_mask_images, tol)
            for t, p in zip(chain, params):
                t.param = p
            if mis > tol and max_tries > _MAX_INIT_TRIES:
                logger.warning(_WARN_INIT)
            return
        for transform in chain:
            if transform.param is None:
                transform.init_parameters(device)
            if transform.is_geometric():
                tries = 0
                while float(self.compute_anatomy_misoverlapping_loss(
                        anatomy_mask_images)) > tol:
                    transform.init_parameters(device)
                    tries += 1
                    if tries > _MAX_INIT_TRIES:
                        logger.warning(_WARN_INIT)
                        break

    def reset_transformation(self, anatomy_mask_images=None,
                             volume_preserve_tolerance: float = 5e-4):
        self.init_random_transformation(
            lazy_load=False, anatomy_mask_images=anatomy_mask_images,
            volume_preserve_tolerance=volume_preserve_tolerance)

    def train(self):
        for transform in self.chain_of_transforms:
            transform.train()

    def eval(self):
        for transform in self.chain_of_transforms:
            transform.eval()

    def make_learnable_transformation(self, optimize_flags,
                                      chain_of_transforms=None):
        for flag, transform in zip(optimize_flags,
                                   self._chain(chain_of_transforms)):
            if flag:
                transform.train()

    # -------------------------------------------------------------- model
    def get_net_output(self, model, data):
        return model(data)

    def get_init_output(self, model, data):
        with torch.no_grad():
            return self.get_net_output(model, data).detach()

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
    def rescale_intensity(self, data, new_min=0, new_max=1, eps=1e-20):
        """Per-sample min-max rescale."""
        return norms.rescale_intensity(data, new_min, new_max, eps,
                                       per_channel=False)

    def _chain(self, chain_of_transforms=None):
        return (self.chain_of_transforms if chain_of_transforms is None
                else list(chain_of_transforms))

    def if_contains_geo_transform(self, chain_of_transforms=None):
        return sum(t.is_geometric()
                   for t in self._chain(chain_of_transforms)) > 0

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
