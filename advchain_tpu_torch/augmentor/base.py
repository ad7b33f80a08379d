"""Transform contract: a functional core over explicit parameter tensors
(what the solver's PGD step differentiates) plus the reference's stateful
parameter accessors (port of advchain_tpu/augmentor/base.py).

Functional core:
    init_params(generator, device)   -> params     (random draw)
    precompute(params, training)     -> aux        (shared per evaluation)
    apply / apply_precomputed        -> x'         (image forward)
    inverse / inverse_precomputed    -> x          (image backward)
    update(params, grad, step_size)  -> params'    (PGD / power iteration)
    project(params)                  -> params'    (epsilon ball)
    prepare_train(params)            -> params'    (pre-loop renorm)
"""

from __future__ import annotations

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

    def update(self, params, grad, step_size):
        raise NotImplementedError

    def project(self, params):
        raise NotImplementedError

    def prepare_train(self, params):
        return params

    # ------------------------------------------------- stateful accessors
    def init_parameters(self):
        self.param = self.init_params(self._generator,
                                      resolve_device(self.device))
        return self.param

    def set_parameters(self, param):
        self.param = torch.as_tensor(param, dtype=torch.float32).detach()

    def get_parameters(self):
        return self.param

    def unit_normalize(self, d, p_type: str = "l2"):
        return norms.unit_normalize(d, p_type)

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
