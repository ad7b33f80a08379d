"""AdvBias — multiplicative smooth B-spline bias field (port of
advchain_tpu/augmentor/bias.py): control points -> transposed conv by the
B-spline kernel -> crop -> resize -> exp (log space) -> clip to
[1 - eps, 1 + eps] -> multiply onto the image."""

from __future__ import annotations

import math

import torch

from advchain_tpu_torch.augmentor.base import (AdvTransformBase,
                                               mask_ignore_values, normal,
                                               uniform)
from advchain_tpu_torch.ops.bspline import (clip_bias, evaluate_bspline_field,
                                            make_bspline_field_spec)
from advchain_tpu_torch.ops.grid_sample import clip


class AdvBias(AdvTransformBase):
    """config_dict keys: epsilon, control_point_spacing, downscale,
    data_size, interpolation_order, init_mode ('random' | 'gaussian' |
    'identity'), space ('log' | 'linear')."""

    def __init__(self, spatial_dims: int = 2, config_dict=None,
                 power_iteration: bool = False, ignore_values=None,
                 debug: bool = False, seed=None, **kw):
        if config_dict is None:
            config_dict = {
                "epsilon": 0.3, "control_point_spacing": [64, 64],
                "downscale": 2, "data_size": [2, 1, 128, 128],
                "interpolation_order": 3, "init_mode": "random",
                "space": "log",
            }
        super().__init__(spatial_dims=spatial_dims, config_dict=config_dict,
                         power_iteration=power_iteration,
                         ignore_values=ignore_values, debug=debug, seed=seed,
                         **kw)

    def init_config(self, config_dict):
        self.epsilon = config_dict["epsilon"]
        self.magnitude = self.epsilon
        if not 0 <= self.magnitude < 1:
            raise ValueError("please set magnitude within [0,1)")
        self.xi = 1e-6
        self.data_size = tuple(int(s) for s in config_dict["data_size"])
        self.downscale = int(config_dict["downscale"])
        if self.downscale > min(self.data_size[2:]):
            raise ValueError("downscale factor is too large")
        self.interpolation_order = int(config_dict["interpolation_order"])
        self.use_log = config_dict["space"] == "log"
        self.init_mode = config_dict["init_mode"]
        self.spec = make_bspline_field_spec(
            image_size=self.data_size[2:],
            control_point_spacing=config_dict["control_point_spacing"],
            downscale=self.downscale, order=self.interpolation_order)
        self.cp_grid = (self.data_size[0], 1) + self.spec.cp_grid
        # projection bounds are finite only for the 'random' init
        self.low, self.high = -math.inf, math.inf
        if self.init_mode == "random":
            if self.use_log:
                self.low = math.log(1.0 - self.magnitude)
                self.high = math.log(1.0 + self.magnitude)
            else:
                self.low, self.high = -self.magnitude, self.magnitude

    def init_params(self, generator, device=None):
        if self.init_mode == "gaussian":
            return 0.5 * normal(self.cp_grid, generator, device)
        if self.init_mode == "random":
            u = uniform(self.cp_grid, generator, device)
            return u * (self.high - self.low) + self.low
        if self.init_mode == "identity":
            return torch.zeros(self.cp_grid, device=device)
        raise NotImplementedError(f"init_mode {self.init_mode!r}")

    def compute_smoothed_bias(self, cpoint):
        """Control points -> full-resolution bias field (N, 1, *image);
        this rank's slab of it in a spatially partitioned step."""
        return evaluate_bspline_field(cpoint, self.spec,
                                      log_space=self.use_log)

    def precompute(self, params, training: bool = False):
        scale = self.xi if (self.power_iteration and training) else 1.0
        field = clip_bias(self.compute_smoothed_bias(scale * params),
                          self.magnitude)
        self._stash("bias_field", field)
        return field

    def apply_precomputed(self, aux, params, data, training: bool = False,
                          interp=None, padding_mode=None):
        out = aux * data
        if isinstance(self.ignore_values, (int, float)) and \
                not isinstance(self.ignore_values, bool):
            out = mask_ignore_values(data, out, float(self.ignore_values))
        return out

    def apply(self, params, data, training: bool = False, interp=None,
              padding_mode=None):
        return self.apply_precomputed(self.precompute(params, training),
                                      params, data, training)

    def update(self, params, grad, step_size):
        g = self.unit_normalize(grad, "l2")
        if self.power_iteration:
            return g
        return params + step_size * g

    def project(self, params):
        return clip(params, self.low, self.high)

    def prepare_train(self, params):
        if self.power_iteration:
            return self.unit_normalize(params)
        return params

    def _record_diff(self, data, out):
        # the reference records the bias field as the diff
        return getattr(self, "bias_field", None)

    def get_name(self):
        return "bias"
