"""AdvNoise — additive adversarial noise (port of
advchain_tpu/augmentor/noise.py): an l2-unit Gaussian field scaled by
``epsilon`` (``xi`` while power-iterating).  The parameter is an
image-sized field: in a spatially partitioned step each rank holds its
slab, and the updates and projections normalise each sample over the space
group."""

from __future__ import annotations

from advchain_tpu_torch.augmentor.base import (AdvTransformBase,
                                               mask_ignore_values, normal)


class AdvNoise(AdvTransformBase):
    """config_dict keys: epsilon, xi, data_size."""

    sharded_params = True

    def __init__(self, spatial_dims: int = 2, config_dict=None,
                 power_iteration: bool = False, ignore_values=None,
                 debug: bool = False, seed=None, **kw):
        if config_dict is None:
            config_dict = {"epsilon": 0.1, "xi": 1e-6,
                           "data_size": [10, 1, 8, 8]}
        super().__init__(spatial_dims=spatial_dims, config_dict=config_dict,
                         power_iteration=power_iteration,
                         ignore_values=ignore_values, debug=debug, seed=seed,
                         **kw)

    def init_config(self, config_dict):
        self.epsilon = config_dict["epsilon"]
        self.xi = config_dict["xi"]
        self.data_size = tuple(int(s) for s in config_dict["data_size"])

    def init_params(self, generator, device=None):
        return self.unit_normalize(normal(self.data_size, generator, device))

    def apply(self, params, data, training: bool = False, interp=None,
              padding_mode=None):
        scale = self.xi if (self.power_iteration and training) \
            else self.epsilon
        out = data + scale * params
        if self.ignore_values is not None:
            out = mask_ignore_values(data, out, self.ignore_values)
        return out

    def update(self, params, grad, step_size):
        g = self.unit_normalize(grad, sharded=True)
        if self.power_iteration:
            return g
        return params + step_size * g

    def project(self, params):
        return self.unit_normalize(params, "l2", sharded=True)

    def prepare_train(self, params):
        if self.power_iteration:
            return self.unit_normalize(params, sharded=True)
        return params

    def get_name(self):
        return "noise"
