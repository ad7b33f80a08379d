"""AdvMorph — adversarial diffeomorphic deformation, 2D and 3D (port of
advchain_tpu/augmentor/morph.py).

Forward: scale the unit velocity latent by epsilon (xi = 0.5 while
power-iterating), Gaussian-smooth it, upsample to the image
(align_corners=False; bilinear in 2D, trilinear in 3D), exponentiate by 8
scaling-and-squaring steps (in 3D adaptively more, while
``||duv / 2^n||_F > 0.5``), add the base grid, clamp to [-1, 1], smooth the
offsets once more, clamp again, and warp.  The inverse exponentiates the
negated velocity.  Per-call ``padding_mode`` is honoured (unlike
AdvAffine).

The JAX package's ``_remat_demons`` (recompute the squaring chain in the
backward pass) works around the TPU's 16 GiB of HBM and is left out: at
the 3D episode's size (batch 2, 12x192x192) one stored flow is 10.6 MB, so
the 8-16 stored compositions of a differentiated chain stay well under
1 GB of the H100's 80 GB.
"""

from __future__ import annotations

import torch

from advchain_tpu_torch.augmentor.affine import sample_with_padding
from advchain_tpu_torch.augmentor.base import AdvTransformBase, uniform
from advchain_tpu_torch.ops.conv import gaussian_smooth
from advchain_tpu_torch.ops.grid_sample import clip
from advchain_tpu_torch.ops.integrate import base_grid, exponentiate_flow
from advchain_tpu_torch.ops.resize import interpolate


class AdvMorph(AdvTransformBase):
    """config_dict keys: epsilon, data_size, vector_size, forward_interp,
    backward_interp.  ``remat`` (a JAX memory policy) is accepted and
    ignored."""

    def __init__(self, spatial_dims: int = 2, config_dict=None,
                 image_padding_mode="zeros", power_iteration: bool = False,
                 debug: bool = False, seed=None, **kw):
        if config_dict is None:
            config_dict = {
                "epsilon": 1.5, "data_size": [10, 1, 8, 8],
                "vector_size": [4, 4], "forward_interp": "bilinear",
                "backward_interp": "bilinear",
            }
        self.forward_interp = "bilinear"
        self.backward_interp = "bilinear"
        kw.pop("remat", None)
        super().__init__(spatial_dims=spatial_dims, config_dict=config_dict,
                         power_iteration=power_iteration, debug=debug,
                         seed=seed, **kw)
        # fixed hyper-parameters of the reference constructor
        self.sigma = 1
        self.gaussian_ks = 5
        self.smooth_iter = 1
        self.num_steps = 8
        self.image_padding_mode = image_padding_mode

    def init_config(self, config_dict):
        self.epsilon = config_dict["epsilon"]
        self.xi = 0.5
        self.data_size = tuple(int(s) for s in config_dict["data_size"])
        self.vector_size = tuple(int(s) for s in config_dict["vector_size"])
        self.batch_size = self.data_size[0]
        self.image_spatial = self.data_size[2:]
        self.forward_interp = config_dict.get("forward_interp",
                                              self.forward_interp)
        self.backward_interp = config_dict.get("backward_interp",
                                               self.backward_interp)

    def init_params(self, generator, device=None):
        shape = (self.batch_size, self.spatial_dims) + self.vector_size
        return self.unit_normalize(2.0 * uniform(shape, generator, device)
                                   - 1.0)

    def demons_compose(self, duv, smooth: bool = True):
        """Velocity -> full deformation grid (N, d, *spatial) in
        [-1, 1].  In a spatially partitioned step the velocity is
        replicated and smoothed locally; from its resize on, the fields are
        this rank's slab."""
        duv = gaussian_smooth(duv, sigma=self.sigma,
                              kernel_size=self.gaussian_ks,
                              iters=self.smooth_iter)
        duv = interpolate(duv, size=self.image_spatial,
                          mode="bilinear" if self.spatial_dims == 2
                          else "trilinear", align_corners=False)
        grid = base_grid(duv.shape[0], duv.shape[2:], duv.dtype, duv.device)
        offsets = exponentiate_flow(duv, nb_steps=self.num_steps,
                                    adaptive=self.spatial_dims == 3)
        # The reference's last step samples the identity grid at
        # offsets + grid with border padding; bilinear sampling of a linear
        # function returns the position itself, clamped to the border, so
        # the closed form below equals it to the lerp's own rounding.
        composed = clip(offsets + grid, -1.0, 1.0)
        if smooth:
            composed = gaussian_smooth(composed - grid, sigma=self.sigma,
                                       kernel_size=self.gaussian_ks,
                                       iters=1, sharded=True) + grid
        return clip(composed, -1.0, 1.0)

    def _displacement(self, dxy):
        """Deformation grid -> displacement, channel-last."""
        grid = base_grid(dxy.shape[0], dxy.shape[2:], dxy.dtype,
                         dxy.device)
        return torch.movedim(dxy - grid, 1, -1)

    def get_deformation_displacement_field(self, duv):
        """(deformation grid (N, d, *spatial), displacement channel-last)."""
        dxy = self.demons_compose(duv, smooth=True)
        return dxy, self._displacement(dxy)

    def _stash_displacement(self, dxy):
        if self._stashes(dxy):
            self._stash("displacement", self._displacement(dxy))

    def _duv(self, params, training: bool, negate: bool = False):
        scale = self.xi if (self.power_iteration and training) \
            else self.epsilon
        return (-scale if negate else scale) * params

    def transform(self, data, deformation_dxy, interp=None,
                  padding_mode=None):
        grid = torch.movedim(deformation_dxy, 1, -1)
        return sample_with_padding(
            data, grid, interp or self.forward_interp,
            self.image_padding_mode if padding_mode is None
            else padding_mode)

    def precompute(self, params, training: bool = False):
        dxy = self.demons_compose(self._duv(params, training))
        self._stash_displacement(dxy)
        return (dxy, self.demons_compose(self._duv(params, training,
                                                   negate=True)))

    def apply_precomputed(self, aux, params, data, training: bool = False,
                          interp=None, padding_mode=None):
        return self.transform(data, aux[0],
                              interp=interp or self.forward_interp,
                              padding_mode=padding_mode)

    def inverse_precomputed(self, aux, params, data, training: bool = False,
                            interp=None, padding_mode=None):
        return self.transform(data, aux[1],
                              interp=interp or self.backward_interp,
                              padding_mode=padding_mode)

    def apply(self, params, data, training: bool = False, interp=None,
              padding_mode=None):
        dxy = self.demons_compose(self._duv(params, training))
        self._stash_displacement(dxy)
        return self.transform(data, dxy, interp=interp or self.forward_interp,
                              padding_mode=padding_mode)

    def inverse(self, params, data, training: bool = False, interp=None,
                padding_mode=None):
        dxy = self.demons_compose(self._duv(params, training, negate=True))
        return self.transform(data, dxy,
                              interp=interp or self.backward_interp,
                              padding_mode=padding_mode)

    def predict_forward_fn(self, params, pred, training: bool = False,
                           interp=None, padding_mode=None):
        return self.apply(params, pred, training=training, interp=interp,
                          padding_mode=padding_mode)

    def predict_backward_fn(self, params, pred, training: bool = False,
                            interp=None, padding_mode=None):
        return self.inverse(params, pred, training=training, interp=interp,
                            padding_mode=padding_mode)

    def update(self, params, grad, step_size):
        g = self.unit_normalize(grad)
        if self.power_iteration:
            return g
        return params + step_size * g

    def project(self, params):
        return self.unit_normalize(params)

    def prepare_train(self, params):
        if self.power_iteration:
            return self.unit_normalize(params)
        return params

    def get_name(self):
        return "morph"

    def is_geometric(self):
        return 1
