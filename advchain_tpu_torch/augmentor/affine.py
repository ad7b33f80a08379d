"""AdvAffine — batched adversarial 2D and 3D affine warps with exact
inverses (port of advchain_tpu/augmentor/affine.py).

The latent is 5 scalars per sample in 2D (rot, scale_x, scale_y, shift_x,
shift_y) or 9 in 3D (rot_x/y/z, scale_x/y/z, shift_x/y/z), squashed by
Hardtanh and scaled by the config ranges; the 3D matrix is
``T @ (R_zyx @ S)`` (:133-169).  The PGD update uses the sign of the
gradient.  Reference quirk kept: the constructor's ``image_padding_mode``
always wins over a per-call one.
"""

from __future__ import annotations

import math

import torch

from advchain_tpu_torch.augmentor.base import AdvTransformBase, uniform
from advchain_tpu_torch.ops import collectives
from advchain_tpu_torch.ops.affine import affine_grid, invert_affine_matrix
from advchain_tpu_torch.ops.grid_sample import clip, grid_sample


def hardtanh(x):
    """``clip(x, -1, 1)`` with ``jnp.clip``'s half slope at the bounds
    (the JAX package's ``hardtanh``)."""
    return clip(x, -1.0, 1.0)


def sample_with_padding(data, grid, interp: str, padding_mode,
                        tile_order: str = "rows"):
    """grid_sample with the reference's extended padding modes:
    'zeros' | 'border' | 'reflection' | 'lowest' | a float.  'lowest' and a
    float shift the data so the pad value is 0, sample with zeros padding,
    and shift back.  Inside a space group 'lowest' is each sample's minimum
    over every slab."""
    if padding_mode == "lowest":
        n = data.shape[0]
        mins = torch.amin(data.reshape(n, -1), dim=1).detach()
        sg = collectives.current_space()
        if sg is not None:
            mins = collectives.all_reduce(mins, "min", sg.group)
        mins = mins.reshape((n,) + (1,) * (data.dim() - 1))
        out = grid_sample(data - mins, grid, mode=interp,
                          padding_mode="zeros", align_corners=True,
                          tile_order=tile_order)
        return out + mins
    if isinstance(padding_mode, (int, float)) and \
            not isinstance(padding_mode, bool):
        out = grid_sample(data - padding_mode, grid, mode=interp,
                          padding_mode="zeros", align_corners=True,
                          tile_order=tile_order)
        return out + padding_mode
    return grid_sample(data, grid, mode=interp, padding_mode=padding_mode,
                       align_corners=True, tile_order=tile_order)


class AdvAffine(AdvTransformBase):
    """config_dict keys: 2D rot, scale_x, scale_y, shift_x, shift_y;
    3D rot_x/y/z, scale_x/y/z, shift_x/y/z; plus data_size,
    forward_interp, backward_interp."""

    def __init__(self, spatial_dims: int = 2, config_dict=None,
                 image_padding_mode="zeros", power_iteration: bool = False,
                 debug: bool = False, seed=None, **kw):
        if config_dict is None:
            config_dict = {
                "rot": 30.0 / 180.0, "scale_x": 0.2, "scale_y": 0.2,
                "shift_x": 0.1, "shift_y": 0.1, "data_size": [1, 1, 8, 8],
                "forward_interp": "bilinear", "backward_interp": "bilinear",
            }
        self.forward_interp = "bilinear"
        self.backward_interp = "bilinear"
        super().__init__(spatial_dims=spatial_dims, config_dict=config_dict,
                         power_iteration=power_iteration, debug=debug,
                         seed=seed, **kw)
        self.image_padding_mode = image_padding_mode

    def init_config(self, config_dict):
        self.translation_x = config_dict["shift_x"]
        self.translation_y = config_dict["shift_y"]
        self.scale_x = config_dict["scale_x"]
        self.scale_y = config_dict["scale_y"]
        if self.spatial_dims == 2:
            self.rot_ratio = config_dict["rot"]
        else:
            self.rot_x = config_dict["rot_x"]
            self.rot_y = config_dict["rot_y"]
            self.rot_z = config_dict["rot_z"]
            self.scale_z = config_dict["scale_z"]
            self.translation_z = config_dict["shift_z"]
        self.xi = 1e-6
        self.data_size = tuple(int(s) for s in config_dict["data_size"])
        self.batch_size = self.data_size[0]
        self.forward_interp = config_dict.get("forward_interp",
                                              self.forward_interp)
        self.backward_interp = config_dict.get("backward_interp",
                                               self.backward_interp)

    def init_params(self, generator, device=None):
        num_params = 5 if self.spatial_dims == 2 else 9
        return 2.0 * uniform((self.batch_size, num_params), generator,
                             device) - 1.0

    def gen_batch_affine_matrix(self, affine_tensors):
        """Latent (N, 5|9) -> affine matrices (N, d, d+1); in 2D the
        rotation entries are multiplied by the scales."""
        t = hardtanh(affine_tensors)
        if self.spatial_dims == 3:
            return self._matrix_3d(t)
        rot, sx, sy, tx, ty = t.unbind(dim=1)
        ang = rot * self.rot_ratio * math.pi
        cx = 1.0 + sx * self.scale_x
        cy = 1.0 + sy * self.scale_y
        row0 = torch.stack([cx * torch.cos(ang), cy * (-torch.sin(ang)),
                            tx * self.translation_x], dim=-1)
        row1 = torch.stack([cx * torch.sin(ang), cy * torch.cos(ang),
                            ty * self.translation_y], dim=-1)
        return torch.stack([row0, row1], dim=1)

    def _matrix_3d(self, t):
        rx, ry, rz, sx, sy, sz, tx, ty, tz = t.unbind(dim=1)
        o = torch.zeros_like(rx)
        i = torch.ones_like(rx)

        def mat(rows):
            return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=1)

        trans = mat([[i, o, o, tx * self.translation_x],
                     [o, i, o, ty * self.translation_y],
                     [o, o, i, tz * self.translation_z],
                     [o, o, o, i]])
        scale = mat([[1.0 + sx * self.scale_x, o, o, o],
                     [o, 1.0 + sy * self.scale_y, o, o],
                     [o, o, 1.0 + sz * self.scale_z, o],
                     [o, o, o, i]])
        # Euler z-y'-x'' intrinsic rotation
        phi = rx * self.rot_x * math.pi
        theta = ry * self.rot_y * math.pi
        psi = rz * self.rot_z * math.pi
        cphi, sphi = torch.cos(phi), torch.sin(phi)
        cth, sth = torch.cos(theta), torch.sin(theta)
        cpsi, spsi = torch.cos(psi), torch.sin(psi)
        rot = mat([[cth * cpsi, -cphi * spsi + sphi * sth * cpsi,
                    sphi * spsi + cphi * sth * cpsi, o],
                   [cth * spsi, cphi * cpsi + sphi * sth * spsi,
                    -sphi * cpsi + cphi * sth * spsi, o],
                   [-sth, sphi * cth, cphi * cth, o],
                   [o, o, o, i]])
        return torch.bmm(trans, torch.bmm(rot, scale))[:, :3, :4]

    def _matrix(self, params, training: bool):
        if self.power_iteration and training:
            return self.gen_batch_affine_matrix(self.xi * params)
        return self.gen_batch_affine_matrix(params)

    def precompute(self, params, training: bool = False):
        m = self._matrix(params, training)
        return (m, invert_affine_matrix(m))

    def apply_precomputed(self, aux, params, data, training: bool = False,
                          interp=None, padding_mode=None):
        self._stash("affine_matrix", aux[0])
        return self.transform(data, aux[0],
                              interp=interp or self.forward_interp)

    def inverse_precomputed(self, aux, params, data, training: bool = False,
                            interp=None, padding_mode=None):
        return self.transform(data, aux[1],
                              interp=interp or self.backward_interp)

    def transform(self, data, affine_matrix, interp=None):
        grid = affine_grid(affine_matrix, data.shape, align_corners=True)
        return sample_with_padding(data, grid,
                                   interp or self.forward_interp,
                                   self.image_padding_mode,
                                   tile_order="blocks")

    def apply(self, params, data, training: bool = False, interp=None,
              padding_mode=None):
        m = self._matrix(params, training)
        self._stash("affine_matrix", m)
        return self.transform(data, m, interp=interp or self.forward_interp)

    def inverse(self, params, data, training: bool = False, interp=None,
                padding_mode=None):
        inv = invert_affine_matrix(self._matrix(params, training))
        return self.transform(data, inv,
                              interp=interp or self.backward_interp)

    def predict_forward_fn(self, params, pred, training: bool = False,
                           interp=None, padding_mode=None):
        return self.apply(params, pred, training=training, interp=interp,
                          padding_mode=padding_mode)

    def predict_backward_fn(self, params, pred, training: bool = False,
                            interp=None, padding_mode=None):
        return self.inverse(params, pred, training=training, interp=interp,
                            padding_mode=padding_mode)

    def get_inverse_matrix(self, affine_matrix):
        return invert_affine_matrix(affine_matrix)

    def _record_diff(self, data, out):
        # the reference records data - transformed
        return data - out

    def update(self, params, grad, step_size):
        g = torch.sign(grad)
        if self.power_iteration:
            return g
        return params + step_size * g

    def project(self, params):
        # the scales are bounded inside gen_batch_affine_matrix (Hardtanh)
        return params

    def prepare_train(self, params):
        if self.power_iteration:
            return torch.sign(params)
        return params

    def get_name(self):
        return "affine"

    def is_geometric(self):
        return 1
