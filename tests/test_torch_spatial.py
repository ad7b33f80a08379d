"""The port's spatial sharding (``advchain_tpu_torch.parallel.spatial``) on
2 and 4 spawned CPU ranks over gloo, against the port's dense ops and the
JAX package's sharded ones (``advchain_tpu/parallel/spatial.py``, on the
virtual CPU devices of tests/conftest.py) on the same numpy inputs.

One spawn per world size runs every case (``spatial_rank``) and returns
each rank's local outputs and gradients; the tests assemble the global
tensors.  The rank function imports neither JAX nor the JAX package.

Tolerances, each with its reason:
  * ``halo_exchange``: exact, forward and gradient (data movement; the
    values and cotangents are small integers, so the gradient's sums are
    exact in any order).
  * ``sharded_gaussian_smooth``: 1e-6 against the port's dense op (the
    same taps in the same order: measured 0) and against JAX's sharded op
    (its convolution reassociates the taps).
  * ``sharded_grid_sample``: 1e-5 of the max against the port's dense
    sampler (every case, on 2 and 4 ranks) and JAX's sharded one (on 2
    ranks: each route, padding and mode, forward; a gradient on each
    route), forward and both gradients, on both routes (the halo route
    remaps the sharded coordinate to the slab, an ulp of the slab
    coordinate; gradients reassociate their sums).
    Nearest agrees exactly, at ties too: the halo route rounds the
    sharded coordinate to its plane on the global coordinate before the
    remap (the tie grid's sharded coordinates sit within an ulp of
    half-integers, or on them).  JAX's halo route remaps the unrounded
    coordinate, which moves some of them to the other plane: on the tie
    grid the port is held to JAX's dense sampler, and JAX's own sharded
    result is compared at the points it did not move.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh import run_ranks
import torch_threads  # noqa: F401  (one intra-op thread a process)

HALOS = (1, 2, 3)          # d_loc = 4 planes a shard
MAX_DISP = {2: 0.13, 3: 0.1}
DISP = {2: 0.12, 3: 0.08}
GRID_CASES = [  # (dims, grid, mode, padding, max_disp)
    (dims, grid, mode, pad, md)
    for dims in (2, 3)
    for grid in ("random", "near", "tie")
    for mode in ("bilinear", "nearest")
    for pad in ("zeros", "border")
    for md in ((None,) if grid == "random" else (None, "bound", 1.5))
    if not (grid == "tie" and mode == "bilinear")
]
GRAD_CASES = [(dims, kind, pad, md) for dims in (2, 3)
              for kind in ("near", "clipped", "planes")
              for pad in ("zeros", "border")
              for md in (None, "bound")]


def _rand(shape, seed, lo=0.0, hi=1.0):
    r = np.random.RandomState(seed)
    return (lo + (hi - lo) * r.rand(*shape)).astype(np.float32)


def _halo_input(world):
    r = np.random.RandomState(1)
    return r.randint(-8, 8, (2, 3, 4 * world, 5)).astype(np.float32)


def _gauss_inputs(world):
    return {"g2": _rand((2, 3, 4 * world, 12), 2),
            "g3": _rand((2, 2, 4 * world, 10, 12), 3),
            "grad": _rand((2, 1, 4 * world, 8), 4)}


def _source(dims, world):
    shape = (2, 3, 8 * world, 16) if dims == 2 else (2, 2, 4 * world, 10, 12)
    return _rand(shape, 10 + dims)


def _base(shape_sp):
    axes = [np.linspace(-1.0, 1.0, s) for s in shape_sp]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([mesh[len(shape_sp) - 1 - i]
                     for i in range(len(shape_sp))], axis=-1)


def _grid(dims, kind, world):
    """(N, *S, dims) sampling grids: uniform past the volume; a warp
    within ``DISP`` of the identity, or that warp clipped to [-1, 1]; the
    identity along the sharded axis, each coordinate exactly on its plane
    where an f32 grid value reaches it; or moved by half a plane (on a
    half-integer, or within an ulp of one)."""
    shape_sp = _source(dims, world).shape[2:]
    if kind == "random":
        return _rand((2,) + shape_sp + (dims,), 20 + dims, -1.15, 1.15)
    base = np.broadcast_to(_base(shape_sp), (2,) + shape_sp + (dims,))
    if kind in ("near", "clipped"):
        u = _rand(base.shape, 30 + dims, -1.0, 1.0) * DISP[dims]
        g = (base + u).astype(np.float32)
        # clipped: the morph's grids clamp to [-1, 1], so their samples sit
        # exactly on the volume's end planes
        return np.clip(g, -1.0, 1.0) if kind == "clipped" else g
    g = base.astype(np.float32).copy()
    size0 = shape_sp[0]
    if kind == "planes":  # every sharded coordinate exactly on a plane
        pix = np.arange(size0, dtype=np.float32)
    else:
        pix = (np.arange(size0, dtype=np.float32) + np.float32(0.5))
        pix = np.where(np.arange(size0) % 2 == 0, pix, pix - 1)  # both ways
    gz = (pix * np.float32(2.0) / np.float32(size0 - 1)
          - np.float32(1.0)).astype(np.float32)
    for i in range(size0):  # the f32 value that unnormalises to pix exactly
        for step in (0, 1, -1, 2, -2):
            v = gz[i]
            for _ in range(abs(step)):
                v = np.nextafter(v, np.float32(np.sign(step)))
            if ((v + np.float32(1)) * np.float32(0.5)) \
                    * np.float32(size0 - 1) == pix[i]:
                gz[i] = v
                break
    g[..., dims - 1] = gz.reshape((1, size0) + (1,) * (dims - 1))
    return g


def _ct(shape, seed):
    return _rand(shape, seed, -1.0, 1.0)


def spatial_rank(rank, world, device):
    """Every case on this rank: meshes (1, world) and, on 4 ranks, (2, 2)."""
    from advchain_tpu_torch.parallel import (halo_exchange,
                                             make_spatial_mesh,
                                             shard_volume,
                                             sharded_gaussian_smooth,
                                             sharded_grid_sample)
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import spatial
    mesh = make_spatial_mesh(1, world, device_type=device)
    idx = rank
    out = {"halo": {}, "gauss": {}, "grid": {}, "grad": {}}
    x = shard_volume(_halo_input(world), mesh)
    for h in HALOS:
        xl = x.clone().requires_grad_(True)
        y = halo_exchange(xl, h, 2, mesh)
        ct = torch.as_tensor(np.random.RandomState(100 * h + idx).randint(
            -4, 4, y.shape).astype(np.float32))
        (y * ct).sum().backward()
        out["halo"][h] = (y.detach(), ct, xl.grad)
    for name, xg in _gauss_inputs(world).items():
        xl = shard_volume(xg, mesh)
        if name == "grad":
            xl.requires_grad_(True)
            sharded_gaussian_smooth(xl, mesh, 1.0, 5).square().sum()\
                .backward()
            out["gauss"][name] = xl.grad
            continue
        for iters in (1, 2):
            out["gauss"][name, iters] = sharded_gaussian_smooth(
                xl, mesh, 1.0, 5, iters)
    try:
        tiny = shard_volume(_rand((1, 1, 2 * world, 8, 8), 5), mesh)
        sharded_gaussian_smooth(tiny, mesh, 1.0, 5)
    except AssertionError as e:
        out["tiny"] = str(e)
    for dims, kind, mode, pad, md in GRID_CASES:
        xl = shard_volume(_source(dims, world), mesh)
        gl = spatial._local_block(_grid(dims, kind, world), mesh,
                                  spatial.grid_sharding(mesh))
        collectives.reset_counts()
        y = sharded_grid_sample(xl, gl, mesh, mode=mode, padding_mode=pad,
                                max_disp=MAX_DISP[dims] if md == "bound"
                                else md)
        out["grid"][dims, kind, mode, pad, md] = (y,
                                                  dict(collectives.COUNTS))
    for dims, kind, pad, md in GRAD_CASES:
        xl = shard_volume(_source(dims, world), mesh).requires_grad_(True)
        gl = spatial._local_block(_grid(dims, kind, world), mesh,
                                  spatial.grid_sharding(mesh))
        gl.requires_grad_(True)
        y = sharded_grid_sample(xl, gl, mesh, padding_mode=pad,
                                max_disp=MAX_DISP[dims] if md else None)
        ct = torch.as_tensor(_ct(y.shape, 40 + idx))
        (y * ct).sum().backward()
        out["grad"][dims, kind, pad, md] = (ct, xl.grad, gl.grad)
    if world == 4:  # the data axis too: 2 x 2
        mesh2 = make_spatial_mesh(2, 2, device_type=device)
        xl = shard_volume(_source(2, world), mesh2)
        gl = spatial._local_block(_grid(2, "near", world), mesh2,
                                  spatial.grid_sharding(mesh2))
        out["data2"] = (mesh2.get_coordinate(),
                        sharded_grid_sample(xl, gl, mesh2,
                                            max_disp=MAX_DISP[2]),
                        sharded_grid_sample(xl, gl, mesh2))
    return out


@pytest.fixture(scope="module")
def runs():
    return {world: run_ranks(spatial_rank, world) for world in (2, 4)}


def _cat(parts, dim):
    return torch.cat(list(parts), dim=dim)


def _close(ours, ref, tol=1e-5):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        (np.abs(ours - ref).max(), scale)


def _jax_mesh(cpu_devices, world, n_data=1):
    from advchain_tpu.parallel import make_spatial_mesh
    return make_spatial_mesh(n_data, world // n_data, devices=cpu_devices)


# ---------------------------------------------------------- halo_exchange
@pytest.mark.parametrize("halo", HALOS)
@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_is_slicing_the_padded_tensor(runs, world, halo):
    x = torch.as_tensor(_halo_input(world))
    d_loc = x.shape[2] // world
    xp = torch.nn.functional.pad(x, (0, 0, halo, halo))
    grad = torch.zeros_like(xp)
    for r, out in enumerate(runs[world]):
        y, ct, _ = out["halo"][halo]
        lo = r * d_loc
        assert torch.equal(y, xp[:, :, lo:lo + d_loc + 2 * halo])
        grad[:, :, lo:lo + d_loc + 2 * halo] += ct
    dx = _cat((out["halo"][halo][2] for out in runs[world]), 2)
    assert torch.equal(dx, grad[:, :, halo:halo + x.shape[2]])


# -------------------------------------------------- the sharded Gaussian
@pytest.mark.parametrize("iters", [1, 2])
@pytest.mark.parametrize("name", ["g2", "g3"])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gaussian_smooth_matches_dense_and_jax(runs, cpu_devices,
                                                       world, name, iters):
    import jax.numpy as jnp
    from advchain_tpu.parallel import sharded_gaussian_smooth as jsmooth
    from advchain_tpu_torch.ops.conv import gaussian_smooth
    x = _gauss_inputs(world)[name]
    ours = _cat((out["gauss"][name, iters] for out in runs[world]), 2)
    dense = gaussian_smooth(torch.as_tensor(x), 1.0, 5, iters)
    np.testing.assert_allclose(ours.numpy(), dense.numpy(), rtol=1e-6,
                               atol=1e-6)
    ref = jsmooth(jnp.asarray(x), _jax_mesh(cpu_devices, world), 1.0, 5,
                  iters)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gaussian_smooth_gradient(runs, world):
    from advchain_tpu_torch.ops.conv import gaussian_smooth
    x = torch.as_tensor(_gauss_inputs(world)["grad"]).requires_grad_(True)
    gaussian_smooth(x, 1.0, 5).square().sum().backward()
    ours = _cat((out["gauss"]["grad"] for out in runs[world]), 2)
    np.testing.assert_allclose(ours.numpy(), x.grad.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_gaussian_smooth_rejects_tiny_shards(runs, world):
    for out in runs[world]:
        assert out["tiny"] == "local extent 2 < halo 4: use fewer 'space' " \
            "shards"


# --------------------------------------------------- the sharded sampler
def _dense_sample(x, g, mode, pad):
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    return grid_sample(torch.as_tensor(x), torch.as_tensor(g), mode=mode,
                       padding_mode=pad)


def _expected_route(dims, kind, md, world):
    from advchain_tpu_torch.parallel.spatial import _halo_planes
    if md is None:
        return "gather"
    size0 = _source(dims, world).shape[2]
    bound = MAX_DISP[dims] if md == "bound" else md
    return "halo" if _halo_planes(bound, size0) < size0 // world \
        else "gather"


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=["-".join(map(str, c)) for c in GRID_CASES])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_grid_sample_matches_dense(runs, world, case):
    dims, kind, mode, pad, md = case
    ours = _cat((out["grid"][case][0] for out in runs[world]), 2)
    counts = runs[world][0]["grid"][case][1]
    want = _expected_route(dims, kind, md, world)
    # both routes all-gather the shard extents; the gather route then the
    # source, the halo route exchanges the neighbour bands
    assert counts["all_gather"] == 1 + int(want == "gather")
    assert counts["neighbour_exchange"] == int(want == "halo")
    dense = _dense_sample(_source(dims, world), _grid(dims, kind, world),
                          mode, pad)
    if mode == "nearest":
        assert torch.equal(ours, dense)
    else:
        _close(ours, dense)


@pytest.mark.parametrize("dims", [2, 3])
def test_tie_grid_sits_on_half_integers(dims):
    """The tie grid's sharded coordinates are half-integers to within an
    ulp, where nearest rounds half to even."""
    from advchain_tpu_torch.kernels._coords import prep_coord
    for world in (2, 4):
        g = torch.as_tensor(_grid(dims, "tie", world))
        pix = prep_coord(g[..., dims - 1], g.shape[1], True, "zeros")
        frac = (pix - pix.floor()).double()
        assert float((frac - 0.5).abs().max()) < 1e-6  # an ulp at 7.5
        assert bool((frac == 0.5).any())


# JAX's sharded sampler compiles one program per case on the CPU: it runs
# on 2 shards, on each route, padding, mode and rank, and at the ties
JAX_CASES = [(dims, "near", mode, pad, md) for dims in (2, 3)
             for mode in ("bilinear", "nearest") for pad in ("zeros", "border")
             for md in (None, "bound")] + \
    [(dims, "tie", "nearest", "zeros", "bound") for dims in (2, 3)] + \
    [(dims, "random", "bilinear", "zeros", None) for dims in (2, 3)]
JAX_GRAD_CASES = [(2, "near", "zeros", None), (3, "near", "border", "bound")]


@pytest.mark.parametrize("case", JAX_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_CASES])
def test_sharded_grid_sample_matches_jax(runs, cpu_devices, case):
    import jax.numpy as jnp
    from advchain_tpu.ops.grid_sample import grid_sample as jsample
    from advchain_tpu.parallel import sharded_grid_sample as jsharded
    world = 2
    dims, kind, mode, pad, md = case
    x, g = _source(dims, world), _grid(dims, kind, world)
    ours = _cat((out["grid"][case][0] for out in runs[world]), 2)
    ref = np.asarray(jsharded(
        jnp.asarray(x), jnp.asarray(g), _jax_mesh(cpu_devices, world),
        mode=mode, padding_mode=pad,
        max_disp=MAX_DISP[dims] if md == "bound" else md))
    if mode == "bilinear":
        _close(ours, ref)
    elif kind == "tie":
        dense = np.asarray(jsample(jnp.asarray(x), jnp.asarray(g),
                                   mode=mode, padding_mode=pad))
        np.testing.assert_array_equal(ours.numpy(), dense)
        kept = ref == dense  # JAX's halo route off the ties it moved
        np.testing.assert_array_equal(ours.numpy()[kept], ref[kept])
    else:
        np.testing.assert_array_equal(ours.numpy(), ref)


def _dense_grads(dims, kind, pad, world, cts):
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    x = torch.as_tensor(_source(dims, world)).requires_grad_(True)
    g = torch.as_tensor(_grid(dims, kind, world)).requires_grad_(True)
    y = grid_sample(x, g, padding_mode=pad)
    (y * _cat(cts, 2)).sum().backward()
    return x.grad, g.grad


@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=["-".join(map(str, c)) for c in GRAD_CASES])
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_grid_sample_gradients_match_dense(runs, world, case):
    dims, kind, pad, md = case
    parts = [out["grad"][case] for out in runs[world]]
    dx, dg = _dense_grads(dims, kind, pad, world, [p[0] for p in parts])
    _close(_cat((p[1] for p in parts), 2), dx)
    _close(_cat((p[2] for p in parts), 1), dg)


@pytest.mark.parametrize("case", JAX_GRAD_CASES,
                         ids=["-".join(map(str, c)) for c in JAX_GRAD_CASES])
def test_sharded_grid_sample_gradients_match_jax(runs, cpu_devices, case):
    import jax
    import jax.numpy as jnp
    from advchain_tpu.parallel import sharded_grid_sample as jsharded
    world = 2
    dims, kind, pad, md = case
    mesh = _jax_mesh(cpu_devices, world)
    parts = [out["grad"][case] for out in runs[world]]
    ct = jnp.asarray(_cat((p[0] for p in parts), 2).numpy())
    jdx, jdg = jax.grad(lambda a, g: jnp.sum(jsharded(
        a, g, mesh, padding_mode=pad,
        max_disp=MAX_DISP[dims] if md else None) * ct),
        argnums=(0, 1))(jnp.asarray(_source(dims, world)),
                        jnp.asarray(_grid(dims, kind, world)))
    _close(_cat((p[1] for p in parts), 2), np.asarray(jdx))
    _close(_cat((p[2] for p in parts), 1), np.asarray(jdg))


def test_sharded_grid_sample_on_a_data_by_space_mesh(runs):
    """4 ranks as (data, space) = (2, 2): each rank samples its row's
    half, on both routes."""
    x, g = _source(2, 4), _grid(2, "near", 4)
    dense = _dense_sample(x, g, "bilinear", "zeros")
    h = x.shape[2] // 2
    for out in runs[4]:
        (i, j), halo, gather = out["data2"]
        want = dense[i:i + 1, :, j * h:(j + 1) * h]
        _close(halo, want)
        _close(gather, want)


def test_chain_displacement_bound_matches_jax():
    """tests/test_spatial.py's configurations, and the None cases."""
    from advchain_tpu import augmentor as jaug
    from advchain_tpu.parallel import chain_displacement_bound as jbound
    from advchain_tpu_torch import augmentor as taug
    from advchain_tpu_torch.parallel import chain_displacement_bound

    size = [2, 1, 24, 24]
    size3 = [2, 1, 8, 24, 24]
    cfgs = {
        "morph": {"epsilon": 1.0, "data_size": size, "vector_size": [6, 6]},
        "affine": {"rot": 0.2, "scale_x": 0.15, "scale_y": 0.15,
                   "shift_x": 0.1, "shift_y": 0.1, "data_size": size},
        "noise": {"epsilon": 0.1, "xi": 1e-6, "data_size": size},
        "big": {"rot": 0.2, "scale_x": 1.0, "scale_y": 0.1, "shift_x": 0.1,
                "shift_y": 0.1, "data_size": size},
        "affine3": {"rot_x": 0.1, "rot_y": 0.05, "rot_z": 0.2,
                    "scale_x": 0.1, "scale_y": 0.2, "scale_z": 0.1,
                    "shift_x": 0.1, "shift_y": 0.1, "shift_z": 0.2,
                    "data_size": size3},
        "morph3": {"epsilon": 3.0, "data_size": size3,
                   "vector_size": [4, 6, 6]},
    }
    kinds = {"morph": "AdvMorph", "affine": "AdvAffine", "noise": "AdvNoise",
             "big": "AdvAffine", "affine3": "AdvAffine", "morph3": "AdvMorph"}
    dims = {"affine3": 3, "morph3": 3}

    def chain(pkg, names):
        return [getattr(pkg, kinds[n])(spatial_dims=dims.get(n, 2),
                                       config_dict=cfgs[n]) for n in names]

    class Unknown:
        def is_geometric(self):
            return 1

        def get_name(self):
            return "shear"

    for names in (("morph", "affine"), ("noise",), ("noise", "morph"),
                  ("affine",), ("big",), ("affine", "big"), ("affine3",),
                  ("morph3", "affine3"), ()):
        ours = chain_displacement_bound(chain(taug, names))
        ref = jbound(chain(jaug, names))
        assert (ours is None) == (ref is None), names
        if ref is not None:
            assert ours == pytest.approx(float(ref), rel=1e-12), names
    assert chain_displacement_bound(chain(taug, ("morph",)) + [Unknown()]) \
        is None
    assert jbound(chain(jaug, ("morph",)) + [Unknown()]) is None
