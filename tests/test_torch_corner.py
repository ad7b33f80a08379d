"""The port's flat-index corner sampler (2D, ``ADVCHAIN_BAND_KERNEL=0``)
against the JAX package.

The twins (the CPU path of advchain_tpu_torch.kernels.plane_sample's
corner pair) are held against ``_weighted_corner_sample``, which runs the
Pallas ``corner_gather`` / ``corner_scatter`` kernels in interpret mode on
the CPU, in their VMEM-resident variants and, under a tiny
``ADVCHAIN_VMEM_IMG_BUDGET``, their streamed / chunk-major ones.  The
switch is read at trace time in JAX and at call time in the port, so each
JAX setting clears the trace caches.  ``grid_sample_2d`` on the corner
route and a small 2D episode on it are held against JAX on the same
switch.
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
from advchain_tpu_torch.kernels import plane_sample as ps
from advchain_tpu_torch.kernels.plane_sample import (CornerSample,
                                                     corner_sample_bwd,
                                                     corner_sample_bwd_plain,
                                                     corner_sample_fwd,
                                                     corner_sample_fwd_plain)

from test_torch_e2e import FULL, MORPH_FREE, _episode, _image, _params
from test_torch_e2e import models  # noqa: F401  (the carried UNet_16)
import torch_threads  # noqa: F401  (one intra-op thread a process)

# the JAX ops package re-exports a function named grid_sample, which
# shadows the submodule under attribute lookup
jgs = importlib.import_module("advchain_tpu.ops.grid_sample")
tgs = importlib.import_module("advchain_tpu_torch.ops.grid_sample")

H, W = 7, 9
S = H * W


@pytest.fixture
def jax_env(monkeypatch):
    """Set JAX trace-time switches; the trace caches are cleared on entry
    and on exit, so no program outlives its setting."""
    def set_env(**env):
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        jax.clear_caches()

    jax.clear_caches()
    yield set_env
    monkeypatch.undo()
    jax.clear_caches()


def _corner_inputs(seed, k, n=2, c=3, p=300):
    """Base indices over the whole image, with rows ending on the last
    column (their +1 tap wraps to the next row's first pixel) and points
    on the last row and the last pixel (their +w / +1 taps fall past S)."""
    r = np.random.RandomState(seed)
    img = r.randn(n, c, S).astype(np.float32)
    idx = r.randint(0, S, size=(n, p)).astype(np.int32)
    idx[:, :8] = np.arange(8) % H * W + W - 1       # last column
    idx[:, 8:16] = (H - 1) * W + np.arange(8) % W   # last row
    idx[:, 16:20] = S - 1
    wts = r.rand(n, k, p).astype(np.float32)
    g = r.randn(n, c, p).astype(np.float32)
    offsets = (0, 1, W, W + 1)[:k] if k != 2 else (0, W)
    return img, idx, wts, g, offsets


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


VARIANTS = {"resident": {}, "streamed": {"ADVCHAIN_VMEM_IMG_BUDGET": "1024"}}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_twin_fwd_matches_pallas_corner_gather(k, variant, jax_env):
    img, idx, wts, _, offsets = _corner_inputs(k, k)
    jax_env(**VARIANTS[variant])
    ref = gm._weighted_corner_sample(jnp.asarray(img), (jnp.asarray(idx),
                                                         jnp.asarray(wts)),
                                     offsets, S)
    out = corner_sample_fwd_plain(*_t(img, idx, wts), offsets)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("variant", ["resident", "chunk_major"])
@pytest.mark.parametrize("k", [1, 4])
def test_twin_bwd_matches_pallas_corner_scatter(k, variant, jax_env):
    img, idx, wts, g, offsets = _corner_inputs(10 + k, k)
    # the scatter's exact f32 tier (its default 2-term tier rounds ~1e-5 of
    # the accumulated magnitude); a tiny budget forces the chunk-major grid
    env = {"ADVCHAIN_SCATTER_SPLIT": "3"}
    if variant == "chunk_major":
        env["ADVCHAIN_VMEM_IMG_BUDGET"] = "1024"
    jax_env(**env)

    def f(im, ww):
        return gm._weighted_corner_sample(im, (jnp.asarray(idx), ww),
                                          offsets, S)

    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(wts))
    ref_img, ref_w = vjp(jnp.asarray(g))
    d_img, d_w = corner_sample_bwd_plain(*_t(g, img, idx, wts), offsets)
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img), atol=1e-5)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-5)


def _stress_inputs(kind, c=2, seed=20):
    """Corner inputs on the H x W raster that stress a backward which sums
    coincident taps before adding them: every point on one pixel, each
    raster row's bases right to left (the first column's bases on the last
    image column, whose +1 tap wraps), or a random permutation of bases two
    pixels apart (no two points share a tap).  Returns the inputs and the
    raster width."""
    r = np.random.RandomState(seed)
    rows, cols = np.arange(H)[:, None], np.arange(W)[None, :]
    if kind == "one_pixel":
        idx, width = np.full((2, S), (H // 2) * W + W // 2), W
    elif kind == "right_to_left":
        idx, width = np.tile((rows * W + W - 1 - cols).reshape(1, -1),
                             (2, 1)), W
    else:
        evens = (rows[::2] * W + cols[:, ::2]).reshape(-1)
        idx = np.stack([r.permutation(evens) for _ in range(2)])
        width = (W + 1) // 2
    idx = idx.astype(np.int32)
    p = idx.shape[1]
    img = r.randn(2, c, S).astype(np.float32)
    wts = r.rand(2, 4, p).astype(np.float32)
    g = r.randn(2, c, p).astype(np.float32)
    return img, idx, wts, g, (0, 1, W, W + 1), width


STRESS = ["one_pixel", "right_to_left", "permutation"]


@pytest.mark.parametrize("variant", ["resident", "chunk_major"])
@pytest.mark.parametrize("kind", STRESS)
def test_twin_bwd_matches_pallas_corner_scatter_under_stress(kind, variant,
                                                            jax_env):
    """The plain backward against JAX's ``corner_scatter`` and
    ``_wcs_bwd``'s ``d_weights`` on inputs that stress a merging
    backward."""
    img, idx, wts, g, offsets, _ = _stress_inputs(kind)
    env = {"ADVCHAIN_SCATTER_SPLIT": "3"}
    if variant == "chunk_major":
        env["ADVCHAIN_VMEM_IMG_BUDGET"] = "1024"
    jax_env(**env)

    def f(im, ww):
        return gm._weighted_corner_sample(im, (jnp.asarray(idx), ww),
                                          offsets, S)

    _, vjp = jax.vjp(f, jnp.asarray(img), jnp.asarray(wts))
    ref_img, ref_w = vjp(jnp.asarray(g))
    d_img, d_w = corner_sample_bwd_plain(*_t(g, img, idx, wts), offsets)
    scale = float(np.abs(np.asarray(ref_img)).max())
    np.testing.assert_allclose(d_img.numpy(), np.asarray(ref_img),
                               atol=1e-6 * scale)
    np.testing.assert_allclose(d_w.numpy(), np.asarray(ref_w), atol=1e-5)


@pytest.mark.parametrize("kind", STRESS + ["scattered"])
def test_corner_sample_with_and_without_the_raster_width(kind):
    """The raster width only tiles the CUDA backward: on the CPU the
    forward and both gradients are the same with and without it."""
    if kind == "scattered":
        img, idx, wts, g, offsets = _corner_inputs(21, 4)
        width = 30  # P = 300
    else:
        img, idx, wts, g, offsets, width = _stress_inputs(kind)
    idx_t, g_t = _t(idx, g)
    results = []
    for w in (None, width):
        x, ww = (torch.from_numpy(a).requires_grad_(True) for a in (img, wts))
        out = CornerSample.apply(x, idx_t, ww, offsets, w)
        (out * g_t).sum().backward()
        results.append((out.detach(), x.grad, ww.grad))
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("width", [7, 0, -30, 2.5, 600])
def test_wrapper_rejects_a_width_that_does_not_divide_p(width):
    img, idx, wts, g, offsets = _corner_inputs(22, 4)  # P = 300
    img, idx, wts, g = _t(img, idx, wts, g)
    with pytest.raises(ValueError):
        corner_sample_bwd(g, img, idx, wts, offsets, width)
    with pytest.raises(ValueError):
        CornerSample.apply(img, idx, wts, offsets, width)


def test_flat_contract_wraps_the_last_column(jax_env):
    """At x = w-1 the +1 tap is the next row's first pixel: the kernel
    level ``d_w`` of that corner is g times that pixel, as JAX's
    ``_wcs_bwd`` gives, where the band contract would give 0.  Past the
    flat end the tap reads zero."""
    r = np.random.RandomState(3)
    img = (r.rand(1, 2, S) + 0.5).astype(np.float32)
    rows = np.arange(H - 1)
    idx = (rows * W + W - 1).astype(np.int32)[None]
    idx = np.concatenate([idx, [[S - 1]]], axis=1).astype(np.int32)
    p = idx.shape[1]
    wts = r.rand(1, 4, p).astype(np.float32)
    g = (r.rand(1, 2, p) + 0.5).astype(np.float32)
    offsets = (0, 1, W, W + 1)
    _, d_w = corner_sample_bwd_plain(*_t(g, img, idx, wts), offsets)
    wrapped = (g[0, :, :-1] * img[0][:, (rows + 1) * W]).sum(0)
    np.testing.assert_allclose(d_w[0, 1, :-1].numpy(), wrapped, rtol=1e-6)
    assert (d_w[0, 1, :-1] > 0).all()
    assert not d_w[0, 1:, -1].any()  # the last pixel's +1, +w, +w+1 taps
    jax_env()
    _, vjp = jax.vjp(lambda ww: gm._weighted_corner_sample(
        jnp.asarray(img), (jnp.asarray(idx), ww), offsets, S),
        jnp.asarray(wts))
    np.testing.assert_allclose(d_w.numpy(), np.asarray(vjp(jnp.asarray(g))
                                                       [0]), atol=1e-6)
    # the forward reads the image zero-padded past its flat end
    padded = np.pad(img, ((0, 0), (0, 0), (0, W + 1)))
    ref = sum(wts[:, k, None] * padded[:, :, idx[0] + off]
              for k, off in enumerate(offsets))
    out = corner_sample_fwd_plain(*_t(img, idx, wts), offsets)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)


def test_wrappers_take_the_twins_for_cpu_tensors():
    img, idx, wts, g, offsets = _corner_inputs(4, 4)
    img, idx, wts, g = _t(img, idx, wts, g)
    before = {r: dict(c) for r, c in ps.LAUNCHES.items()}
    assert torch.equal(corner_sample_fwd(img, idx, wts, offsets),
                       corner_sample_fwd_plain(img, idx, wts, offsets))
    for a, b in zip(corner_sample_bwd(g, img, idx, wts, offsets),
                    corner_sample_bwd_plain(g, img, idx, wts, offsets)):
        assert torch.equal(a, b)
    assert ps.LAUNCHES == before  # a twin is no launch


def test_wrapper_rejects_bad_calls():
    img, idx, wts, g, offsets = _corner_inputs(5, 4)
    img, idx, wts, g = _t(img, idx, wts, g)
    with pytest.raises(ValueError):
        corner_sample_fwd(img, idx, wts, offsets[:3])  # K != w.shape[1]
    with pytest.raises(ValueError):
        corner_sample_fwd(img, idx, wts, (0, -1, W, W + 1))
    with pytest.raises(ValueError):
        corner_sample_fwd(img, idx, torch.cat([wts, wts], 1),
                          offsets + offsets)  # more than 4 taps
    with pytest.raises(ValueError):
        corner_sample_fwd(img[:, :, None], idx, wts, offsets)
    with pytest.raises(ValueError):
        corner_sample_bwd(g[:, :1], img, idx, wts, offsets)


def test_corner_sample_gradcheck_float64():
    img, idx, wts, _, offsets = _corner_inputs(6, 4, n=1, c=2, p=40)
    img_t = torch.from_numpy(img).double().requires_grad_(True)
    w_t = torch.from_numpy(wts).double().requires_grad_(True)
    (idx_t,) = _t(idx)
    assert torch.autograd.gradcheck(
        lambda a, b: CornerSample.apply(a, idx_t, b, offsets), (img_t, w_t))


# ------------------------------------------------------------ the route
def _grid_case(seed, n=2, c=2, h=H, w=W, ho=5, wo=6, spread=1.3):
    r = np.random.RandomState(seed)
    img = r.randn(n, c, h, w).astype(np.float32)
    grid = ((r.rand(n, ho, wo, 2) * 2 - 1) * spread).astype(np.float32)
    cot = r.randn(n, c, ho, wo).astype(np.float32)
    return img, grid, cot


def _spy_jax(monkeypatch, name):
    """Count the JAX kernel function ``name`` while tracing."""
    calls = []
    real = getattr(gm, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(gm, name, spy)
    return calls


def _no_band(monkeypatch):
    """The port's legacy route must not touch the band kernels (the default
    route's grid-level pair)."""
    class Refuse:
        @staticmethod
        def apply(*args):
            raise AssertionError("the corner route took the band kernels")

    monkeypatch.setattr(tgs, "BandGridSample", Refuse)


def _both_routes(img, grid, cot, padding, align, mode, jax_env, monkeypatch):
    jax_env(ADVCHAIN_BAND_KERNEL="0", ADVCHAIN_SCATTER_SPLIT="3")
    calls = _spy_jax(monkeypatch, "corner_gather")

    def f(x, g):
        with jgs.force_impl("pallas"):
            out = jgs.grid_sample(x, g, mode=mode, padding_mode=padding,
                                  align_corners=align)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (rx, rg) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jnp.asarray(img), jnp.asarray(grid))
    assert calls, "JAX did not trace the corner kernels"
    _no_band(monkeypatch)
    x = torch.from_numpy(img).requires_grad_(True)
    g = torch.from_numpy(grid).requires_grad_(True)
    out = tgs.grid_sample(x, g, mode=mode, padding_mode=padding,
                          align_corners=align)
    (out * torch.from_numpy(cot)).sum().backward()
    gg = g.grad if g.grad is not None else torch.zeros_like(g)
    return ((out.detach().numpy(), x.grad.numpy(), gg.numpy()),
            (np.asarray(ref), np.asarray(rx), np.asarray(rg)))


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_corner_route_matches_jax(padding, align, jax_env, monkeypatch):
    img, grid, cot = _grid_case(7)
    ours, ref = _both_routes(img, grid, cot, padding, align, "bilinear",
                             jax_env, monkeypatch)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-4)
    np.testing.assert_allclose(ours[2], ref[2], atol=1e-4)


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_corner_route_clamp_edge_matches_jax(padding, jax_env, monkeypatch):
    """Grid entries exactly on +-1 (the base grid's corners) and past the
    image: on x = w-1 the +1 tap wraps, with folded weight 0, so the grid
    gradient must still match."""
    img, grid, cot = _grid_case(8, ho=4, wo=4, spread=1.0)
    grid[:, 0, :, 1] = -1.0
    grid[:, -1, :, 1] = 1.0
    grid[:, :, 0, 0] = -1.0
    grid[:, :, -1, 0] = 1.0
    grid[:, 1, 1] = (1.0, -1.0)
    grid[:, 2, 2] = (1.3, -1.2)
    ours, ref = _both_routes(img, grid, cot, padding, True, "bilinear",
                             jax_env, monkeypatch)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("padding", ["zeros", "border"])
def test_corner_route_nearest_matches_jax(padding, jax_env, monkeypatch):
    """Nearest on the corner route: one unit-weight tap, offsets (0,)."""
    img, grid, cot = _grid_case(9, spread=1.2)
    ours, ref = _both_routes(img, grid, cot, padding, True, "nearest",
                             jax_env, monkeypatch)
    np.testing.assert_allclose(ours[0], ref[0], atol=1e-6)
    np.testing.assert_allclose(ours[1], ref[1], atol=1e-5)
    assert not ours[2].any() and not ref[2].any()


def test_routes_agree_in_the_port(monkeypatch):
    """The band and corner routes compute one function."""
    img, grid, cot = _grid_case(10, c=3)
    res = []
    for switch in ("1", "0"):
        monkeypatch.setenv("ADVCHAIN_BAND_KERNEL", switch)
        x = torch.from_numpy(img).requires_grad_(True)
        g = torch.from_numpy(grid).requires_grad_(True)
        out = tgs.grid_sample_2d(x, g, padding_mode="zeros")
        (out * torch.from_numpy(cot)).sum().backward()
        res.append([t.detach() for t in (out, x.grad, g.grad)])
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


# ------------------------------------------------------------- episodes
def _legacy_episode(models, names, n_iter, jax_env, monkeypatch):
    jax_env(ADVCHAIN_GRID_SAMPLE_IMPL="pallas", ADVCHAIN_BAND_KERNEL="0")
    calls = _spy_jax(monkeypatch, "corner_gather")
    jmodel, tmodel = models
    params = _params(names)
    img = _image()
    ref = _episode(jaug, jmodel, names, n_iter,
                   [jnp.asarray(p) for p in params], jnp.asarray(img))
    assert calls, "the JAX episode did not trace the corner kernels"
    _no_band(monkeypatch)
    ours = _episode(taug, tmodel, names, n_iter,
                    [torch.from_numpy(p) for p in params],
                    torch.from_numpy(img))
    return ref, ours


def test_legacy_route_morph_free_chain_one_pgd_step(models, jax_env,
                                                    monkeypatch):
    ref, ours = _legacy_episode(models, MORPH_FREE, 1, jax_env, monkeypatch)
    assert abs(ours[0] - ref[0]) / abs(ref[0]) < 1e-3, (ours[0], ref[0])
    for i, (a, b) in enumerate(zip(ours[2], ref[2])):
        rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
        assert rel < 1e-3, (i, rel)


def test_legacy_route_full_chain_no_pgd(models, jax_env, monkeypatch):
    """tests/test_torch_e2e.py's bounds for the full chain: dist within
    1e-3 and the sparse criterion on adv_data (morph's floor flips; the
    band route's dist is off by 1.4e-4 relative, ROADMAP queue 3)."""
    ref, ours = _legacy_episode(models, FULL, 0, jax_env, monkeypatch)
    assert abs(ours[0] - ref[0]) < 1e-3, (ours[0], ref[0])
    d = np.abs(ours[1] - ref[1])
    assert d.mean() < 1e-4 and (d > 1e-3).mean() < 0.01, \
        (d.mean(), (d > 1e-3).mean())
