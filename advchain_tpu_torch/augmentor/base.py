"""Transform contract: a functional core over explicit parameter tensors
(what the solver's PGD step differentiates) plus the reference's stateful
object API (port of advchain_tpu/augmentor/base.py).

Functional core:
    init_params(generator, device)   -> params     (random draw)
    precompute(params, training)     -> aux        (shared per evaluation)
    apply / apply_precomputed        -> x'         (image forward)
    inverse / inverse_precomputed    -> x          (image backward)
    predict_forward_fn / _backward_fn              (prediction warps)
    update(params, grad, step_size)  -> params'    (PGD / power iteration)
    project(params)                  -> params'    (epsilon ball)
    prepare_train(params)            -> params'    (pre-loop renorm)

Stateful API (the reference's names): init_parameters / set_parameters /
get_parameters / train / eval / forward / backward / predict_forward /
predict_backward / optimize_parameters / rescale_parameters /
set_step_size / get_step_size.  ``forward`` and ``predict_forward`` draw
missing parameters on the data's device.

In a parallel train step each rank draws the global batch's parameters
and keeps its part (:meth:`AdvTransformBase.local_params`): its rows, and
for a transform whose parameter is an image-sized field
(``sharded_params``, the noise) its slab of a spatially partitioned
step's leading spatial axis.  The other parameters are replicated over
the space group.

Debug stashes (``diff``, ``bias_field``, ``affine_matrix``,
``displacement``) hold detached tensors.  They are recorded by the
stateful ``forward`` / ``predict_forward`` (always, with ``debug``), never
for a value that carries a gradient: the solver's episodes and PGD steps
record none, as the JAX package's jitted paths record none.
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Optional

import torch

from advchain_tpu_torch import resolve_device
from advchain_tpu_torch.ops import norms

_seed_counter = itertools.count(0)


class AdvTransformBase:
    """Base adversarial transform.  ``device`` is where
    :meth:`init_parameters` places the parameters (None = the GPU); inside
    the solver, parameters follow the data's device."""

    # whether the parameter is an image-sized field, sharded like the image
    # in a spatially partitioned step (else it is replicated over 'space')
    sharded_params = False

    def __init__(self, spatial_dims: int = 2,
                 config_dict: Optional[dict] = None,
                 power_iteration: bool = False, ignore_values=None,
                 debug: bool = False, seed: Optional[int] = None,
                 use_gpu: bool = True, device=None):
        del use_gpu  # reference API; the device argument decides
        if spatial_dims not in (2, 3):
            raise ValueError(f"only 2D/3D are supported, got "
                             f"spatial_dims={spatial_dims}")
        self.spatial_dims = spatial_dims
        self.config_dict = dict(config_dict or {})
        data_dim = len(self.config_dict["data_size"])
        if data_dim != spatial_dims + 2:
            raise ValueError(
                f"check data size in the config file, should be "
                f"{spatial_dims + 2}D, but got {data_dim}D")
        self.power_iteration = power_iteration
        self.ignore_values = ignore_values
        self.debug = debug
        self.device = device
        self.param = None
        self.diff = None
        self.grad = None
        self.is_training = False
        self.step_size = 1.0
        self._recording = False
        self._generator = torch.Generator().manual_seed(
            next(_seed_counter) if seed is None else int(seed))
        self.init_config(self.config_dict)

    # ------------------------------------------------------ functional core
    def init_params(self, generator: torch.Generator, device=None):
        raise NotImplementedError

    def precompute(self, params, training: bool = False):
        """Per-evaluation state (fields, matrices) computed once and shared
        by the data, prediction and mask applications of one loss."""
        return None

    def apply_precomputed(self, aux, params, data, training: bool = False,
                          interp=None, padding_mode=None):
        return self.apply(params, data, training=training, interp=interp,
                          padding_mode=padding_mode)

    def inverse_precomputed(self, aux, params, data, training: bool = False,
                            interp=None, padding_mode=None):
        return self.inverse(params, data, training=training, interp=interp,
                            padding_mode=padding_mode)

    def apply(self, params, data, training: bool = False, interp=None,
              padding_mode=None):
        raise NotImplementedError

    def inverse(self, params, data, training: bool = False, interp=None,
                padding_mode=None):
        """Warp back to the original coordinates (identity unless
        geometric)."""
        return data

    def predict_forward_fn(self, params, pred, training: bool = False,
                           interp=None, padding_mode=None):
        """Transform a prediction (identity unless geometric)."""
        return pred

    def predict_backward_fn(self, params, pred, training: bool = False,
                            interp=None, padding_mode=None):
        return pred

    def update(self, params, grad, step_size):
        raise NotImplementedError

    def project(self, params):
        """Default: l2 renorm of each batch row into the epsilon ball."""
        return norms.renorm_l2(params, self.epsilon)

    def prepare_train(self, params):
        return params

    def local_params(self, params, dg):
        """This rank's part of the global batch's parameters inside a data
        group ``dg`` (``ops.collectives.DataGroup``): its rows, and its
        slab when the parameter is sharded like the image."""
        params = dg.rows(params)
        if self.sharded_params and dg.space is not None:
            params = dg.space.slab(params)
        return params

    # ------------------------------------------------------- stateful API
    def init_parameters(self, device=None):
        """Draw parameters from the transform's own generator onto
        ``device`` (None: the constructor's ``device``, where None means
        the GPU)."""
        self.param = self.init_params(
            self._generator,
            resolve_device(self.device if device is None else device))
        return self.param

    def set_parameters(self, param):
        self.param = torch.as_tensor(param, dtype=torch.float32).detach()

    def get_parameters(self):
        return self.param

    def set_step_size(self, step_size=1.0):
        self.step_size = step_size

    def get_step_size(self):
        return self.step_size

    def train(self):
        if self.param is None:
            self.init_parameters()
        self.param = self.prepare_train(self.param)
        self.is_training = True

    def eval(self):
        if self.is_training:
            self.param = self.param.detach()
            self.is_training = False

    def forward(self, data, interp=None, padding_mode=None, **kwargs):
        if self.param is None:
            self.init_parameters(data.device)
        with self._stashing():
            out = self.apply(self.param, data, training=self.is_training,
                             interp=interp, padding_mode=padding_mode)
        diff = self._record_diff(data, out)
        self.diff = None if diff is None else diff.detach()
        return out

    def backward(self, data, interp=None, padding_mode=None, **kwargs):
        return self.inverse(self.param, data, training=self.is_training,
                            interp=interp, padding_mode=padding_mode)

    def predict_forward(self, data, interp=None, padding_mode=None,
                        **kwargs):
        if self.param is None:
            self.init_parameters(data.device)
        with self._stashing():
            return self.predict_forward_fn(self.param, data,
                                           training=self.is_training,
                                           interp=interp,
                                           padding_mode=padding_mode)

    def predict_backward(self, data, interp=None, padding_mode=None,
                         **kwargs):
        return self.predict_backward_fn(self.param, data,
                                        training=self.is_training,
                                        interp=interp,
                                        padding_mode=padding_mode)

    def optimize_parameters(self, step_size=None, grad=None):
        """One ascent step with ``grad``, or with the gradient the solver's
        ``compute_transform_grads`` stashed as ``self.grad``."""
        if step_size is None:
            step_size = self.step_size
        if grad is None:
            grad = self.grad
        if grad is None:
            raise ValueError(
                "optimize_parameters needs a gradient: pass grad= or let the "
                "solver stash transform.grad")
        self.param = self.update(self.param, grad, step_size).detach()
        return self.param

    def rescale_parameters(self):
        self.param = self.project(self.param)
        return self.param

    def _record_diff(self, data, out):
        return out - data

    @contextlib.contextmanager
    def _stashing(self):
        """Record the debug stashes inside the block."""
        self._recording = True
        try:
            yield
        finally:
            self._recording = False

    def _stashes(self, value):
        """Whether ``value`` is recorded: inside :meth:`_stashing` or with
        ``debug``, and only when it carries no gradient."""
        return (self._recording or self.debug) and not value.requires_grad

    def _stash(self, name, value):
        """Record a debug artifact, detached (see :meth:`_stashes`)."""
        if self._stashes(value):
            setattr(self, name, value.detach())

    def unit_normalize(self, d, p_type: str = "l2", sharded: bool = False):
        return norms.unit_normalize(d, p_type, sharded)

    def rescale_intensity(self, data, new_min=0.0, new_max=1.0, eps=1e-20):
        return norms.rescale_intensity(data, new_min, new_max, eps)

    def init_config(self, config_dict):
        raise NotImplementedError

    def get_name(self) -> str:
        raise NotImplementedError

    def is_geometric(self) -> int:
        return 0


def _draw(fn, shape, generator: torch.Generator, device):
    """Draw on the generator's device, then move to ``device``."""
    out = fn(shape, generator=generator, device=generator.device)
    return out if device is None else out.to(device)


def uniform(shape, generator, device=None):
    return _draw(torch.rand, shape, generator, device)


def normal(shape, generator, device=None):
    return _draw(torch.randn, shape, generator, device)


def mask_ignore_values(data, transformed, ignore_values):
    """Freeze pixels whose clean value equals ``ignore_values``."""
    mask = torch.abs(data - ignore_values) < 1e-8
    return torch.where(mask, torch.full_like(transformed, ignore_values),
                       transformed)
