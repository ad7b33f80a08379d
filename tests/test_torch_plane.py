"""The port's plane sampler (3D trilinear, ``ADVCHAIN_ZBAND=0``) against
the JAX package.

The twins (the CPU path of advchain_tpu_torch.kernels.plane_sample's plane
pair) are held against ``_weighted_plane_sample``, which runs the Pallas
``plane_gather`` / ``plane_scatter`` kernels in interpret mode on the CPU,
VMEM-resident and, under a tiny ``ADVCHAIN_VMEM_IMG_BUDGET``, streamed.
``grid_sample_3d`` on the plane route (the packed formulation for every C)
is held against JAX's 4-base formulation (one channel within the budget)
and its packed one (channels that would need groups), and a small 3D
episode on the route against JAX on the same switch.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu import augmentor as jaug
from advchain_tpu.kernels import gather_matmul as gm

from advchain_tpu_torch import augmentor as taug
from advchain_tpu_torch.kernels.plane_sample import (plane_sample_bwd_plain,
                                                     plane_sample_fwd_plain)

from test_torch_corner import _spy_jax, _t, jax_env  # noqa: F401
from test_torch_episode3d import FULL, MORPH_FREE, _episode, _params, _volume
from test_torch_episode3d import models  # noqa: F401  (carried weights)
import torch_threads  # noqa: F401  (one intra-op thread a process)

jgs = importlib.import_module("advchain_tpu.ops.grid_sample")
tgs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")

D, H, W = 5, 6, 7
HW = H * W


def _plane_inputs(seed, k, n=2, c=3, p=300):
    """Bases over the whole volume, with points on the last column (the +1
    tap wraps to the next row of the same plane), the last row and the
    last pixel of a plane (taps past HW read zero, never the next plane),
    and the last plane."""
    r = np.random.RandomState(seed)
    img = r.randn(n, c, D, HW).astype(np.float32)
    z = r.randint(0, D, size=(n, p)).astype(np.int32)
    yx = r.randint(0, HW, size=(n, p)).astype(np.int32)
    yx[:, :8] = np.arange(8) % H * W + W - 1
    yx[:, 8:16] = (H - 1) * W + np.arange(8) % W
    yx[:, 16:24] = HW - 1
    z[:, 16:20] = np.arange(4) % (D - 1)  # planes with a plane after them
    z[:, 24:32] = D - 1
    wts = r.rand(n, k, p).astype(np.float32)
    g = r.randn(n, c, p).astype(np.float32)
    offsets = (0, 1) if k == 2 else (0, 1, W, W + 1)
    return img, z, yx, wts, g, offsets


@pytest.mark.parametrize("variant", ["resident", "streamed"])
@pytest.mark.parametrize("k", [2, 4])
def test_twin_fwd_matches_pallas_plane_gather(k, variant, jax_env):
    img, z, yx, wts, _, offsets = _plane_inputs(k, k)
    jax_env(**({"ADVCHAIN_VMEM_IMG_BUDGET": "1024"}
               if variant == "streamed" else {}))
    ref = gm._weighted_plane_sample(
        jnp.asarray(img), tuple(jnp.asarray(a) for a in (z, yx, wts)),
        offsets, D, HW)
    out = plane_sample_fwd_plain(*_t(img, z, yx, wts), offsets)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("variant", ["resident", "streamed"])
@pytest.mark.parametrize("k", [2, 4])
def test_twin_bwd_matches_pallas_plane_scatter(k, variant, jax_env):
    img, z, yx, wts, g, offsets = _plane_inputs(10 + k, k)
    # the exact f32 scatter tier; a tiny budget forces the streamed RMW
    env = {"ADVCHAIN_SCATTER_SPLIT": "3"}
    if variant == "streamed":
        env["ADVCHAIN_VMEM_IMG_BUDGET"] = "1024"
    jax_env(**env)

    def f(im, ww):
        return gm._weighted_plane_sample(
            im, (jnp.asarray(z), jnp.asarray(yx), ww), offsets, D, HW)

    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(wts))
    ref_img, ref_w = vjp(jnp.asarray(g))
    d_img, d_w = plane_sample_bwd_plain(*_t(g, img, z, yx, wts), offsets)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img), atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-5)


def test_plane_edge_reads_zero(jax_env):
    """The last pixel of a plane that has a plane after it: its +1, +w and
    +w+1 taps read zero and get no gradient (JAX pads each plane on its
    own), while a last-column point's +1 tap wraps inside its plane."""
    r = np.random.RandomState(5)
    img = (r.rand(1, 2, D, HW) + 0.5).astype(np.float32)
    z = np.array([[0, 1, 2, 1]], np.int32)
    yx = np.array([[HW - 1, HW - 1, HW - 1, W - 1]], np.int32)
    wts = (r.rand(1, 4, 4) + 0.5).astype(np.float32)
    g = (r.rand(1, 2, 4) + 0.5).astype(np.float32)
    offsets = (0, 1, W, W + 1)
    out = plane_sample_fwd_plain(*_t(img, z, yx, wts), offsets)
    d_img, d_w = plane_sample_bwd_plain(*_t(g, img, z, yx, wts), offsets)
    base = img[0][:, z[0, :3], HW - 1]
    np.testing.assert_allclose(out[0, :, :3].numpy(), wts[0, 0, :3] * base,
                               rtol=1e-6)
    assert not d_w[0, 1:, :3].any()
    np.testing.assert_allclose(  # the wrapped tap: plane 1, row 1, column 0
        d_w[0, 1, 3].item(), float((g[0, :, 3] * img[0, :, 1, W]).sum()),
        rtol=1e-6)
    # only the taps of each point's own plane receive gradient
    assert not d_img[0, :, 3:].any() and not d_img[0, :, 0, 0].any()
    jax_env(ADVCHAIN_SCATTER_SPLIT="3")
    _, vjp = jax.vjp(lambda im, ww: gm._weighted_plane_sample(
        im, (jnp.asarray(z), jnp.asarray(yx), ww), offsets, D, HW),
        jnp.asarray(img), jnp.asarray(wts))
    ref_img, ref_w = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-6)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img), atol=1e-6)


def test_planes_outside_the_volume_read_zero():
    img, z, yx, wts, g, offsets = _plane_inputs(6, 4)
    img, z, yx, wts, g = _t(img, z, yx, wts, g)
    z[:, :10] = -1
    z[:, 10:20] = D
    out = plane_sample_fwd_plain(img, z, yx, wts, offsets)
    d_img, d_w = plane_sample_bwd_plain(g, img, z, yx, wts, offsets)
    assert not out[:, :, :20].any() and not d_w[:, :, :20].any()
    _, ref = plane_sample_bwd_plain(g[:, :, 20:], img, z[:, 20:],
                                    yx[:, 20:], wts[:, :, 20:].contiguous(),
                                    offsets)
    torch.testing.assert_close(d_w[:, :, 20:], ref, atol=0, rtol=0)


# ------------------------------------------------------------ the route
def _grid_case(seed, n=2, c=2, do=4, ho=5, wo=6, spread=1.3):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, D, H, W).astype(np.float32)
    grid = ((r.rand(n, do, ho, wo, 3) * 2 - 1) * spread).astype(np.float32)
    cot = r.randn(n, c, do, ho, wo).astype(np.float32)
    return img, grid, cot


def _no_zband(monkeypatch):
    class Refuse:
        @staticmethod
        def apply(*args):
            raise AssertionError("the plane route took the z-band kernels")

    monkeypatch.setattr(tgs, "ZBandGridSample", Refuse)


# JAX's two formulations: one channel whose K=2 stack fits the budget takes
# the 4-base path; two channels under a budget of one channel's K=2 stack
# (2 x D x 512 floats) would need channel groups, so take the packed path
# (whose K=4 stack then streams)
FORMULATIONS = {"4base": (1, {}),
                "packed": (2, {"ADVCHAIN_VMEM_IMG_BUDGET": str(2 * D * 512
                                                               * 4)})}


def _both_routes(img, grid, cot, padding, align, formulation, jax_env,
                 monkeypatch):
    jax_env(ADVCHAIN_ZBAND="0", **FORMULATIONS[formulation][1])
    packed = _spy_jax(monkeypatch, "_grid_sample_3d_pallas_packed")
    planes = _spy_jax(monkeypatch, "plane_gather")

    def f(x, g):
        with jgs.force_impl("pallas"):
            out = jgs.grid_sample(x, g, padding_mode=padding,
                                  align_corners=align)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (rx, rg) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(img), jnp.asarray(grid))
    assert planes and bool(packed) == (formulation == "packed")
    _no_zband(monkeypatch)
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = tgs.grid_sample(x, g, padding_mode=padding, align_corners=align)
    (out * torch.from_numpy(cot)).sum().backward()
    return ((out.detach().numpy(), x.grad.numpy(), g.grad.numpy()),
            (np.asarray(ref), np.asarray(rx), np.asarray(rg)))


@pytest.mark.parametrize("formulation", list(FORMULATIONS))
@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_plane_route_matches_jax(padding, align, formulation, jax_env,
                                 monkeypatch):
    c = FORMULATIONS[formulation][0]
    img, grid, cot = _grid_case(9, c=c)
    ours, ref = _both_routes(img, grid, cot, padding, align, formulation,
                             jax_env, monkeypatch)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_plane_route_clamp_edge_matches_jax(padding, jax_env, monkeypatch):
    """Grid entries exactly on +-1 and past the volume (the packed
    formulation, where the z taps are separate launches)."""
    img, grid, cot = _grid_case(10, c=2, do=4, ho=4, wo=4, spread=1.0)
    grid[:, 0, :, :, 2] = -1.0
    grid[:, -1, :, :, 2] = 1.0
    grid[:, :, 0, :, 1] = -1.0
    grid[:, :, -1, :, 1] = 1.0
    grid[:, :, :, 0, 0] = -1.0
    grid[:, :, :, -1, 0] = 1.0
    grid[:, 1, 1, 1] = (1.0, -1.0, 1.0)
    grid[:, 2, 2, 2] = (1.3, -1.2, 1.1)
    ours, ref = _both_routes(img, grid, cot, padding, True, "packed",
                             jax_env, monkeypatch)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_routes_agree_in_the_port(monkeypatch):
    """The z-band and plane routes compute one function."""
    img, grid, cot = _grid_case(11, c=3)
    res = []
    for switch in ("1", "0"):
        monkeypatch.setenv("ADVCHAIN_ZBAND", switch)
        x = torch.from_numpy(img).requires_grad_(True)
        g = torch.from_numpy(grid).requires_grad_(True)
        out = tgs.grid_sample_3d(x, g, padding_mode="border")
        (out * torch.from_numpy(cot)).sum().backward()
        res.append([t.detach() for t in (out, x.grad, g.grad)])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- episodes
def _legacy_episode(models, names, n_iter, jax_env, monkeypatch):
    # every composition on the sampler in JAX, as in the port's 3D path
    jax_env(ADVCHAIN_GRID_SAMPLE_IMPL="pallas", ADVCHAIN_ZBAND="0",
            ADVCHAIN_STENCIL="0")
    planes = _spy_jax(monkeypatch, "plane_gather")
    jmodel, tmodel = models
    params = _params(names)
    img = _volume()
    ref = _episode(jaug, jmodel, names, n_iter,
                   [jnp.asarray(p) for p in params], jnp.asarray(img))
    assert planes, "the JAX episode did not trace the plane kernels"
    _no_zband(monkeypatch)
    ours = _episode(taug, tmodel, names, n_iter,
                    [torch.from_numpy(p) for p in params],
                    torch.from_numpy(img))
    return ref, ours


def test_legacy_route_morph_free_chain_one_pgd_step_3d(models, jax_env,
                                                       monkeypatch):
    ref, ours = _legacy_episode(models, MORPH_FREE, 1, jax_env, monkeypatch)
    assert abs(ours[0] - ref[0]) / abs(ref[0]) < 1e-3, (ours[0], ref[0])
    for i, (a, b) in enumerate(zip(ours[2], ref[2])):
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
        assert rel < 1e-3, (i, rel)


def test_legacy_route_full_chain_no_pgd_3d(models, jax_env, monkeypatch):
    ref, ours = _legacy_episode(models, FULL, 0, jax_env, monkeypatch)
    assert abs(ours[0] - ref[0]) <= 1e-4 * abs(ref[0]), (ours[0], ref[0])
    d = np.abs(ours[1] - ref[1])
    assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
        (d.mean(), (d > 1e-3).mean())
