"""The port's CUDA kernels (band and z-band, corner-level and grid-level,
corner and plane samplers, the stencil warp) on the card, against their
plain twins and the CPU path.

Run on a machine with an NVIDIA GPU (sm_90a) and nvcc:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX (the card's machine has none), and each test
decides at run time, not at import, whether CUDA is present.
"""

import sys

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(device, n=4, c=3, h=37, w=45, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn(n, c, h, w, generator=gen, device=device)
    p = 500
    y = torch.randint(-1, h + 1, (n, p), generator=gen, device=device,
                      dtype=torch.int32)
    x = torch.randint(-1, w + 1, (n, p), generator=gen, device=device,
                      dtype=torch.int32)
    wts = torch.rand(n, 4, p, generator=gen, device=device)
    g = torch.randn(n, c, p, generator=gen, device=device)
    return img, y, x, wts, g


def test_fwd_kernel_matches_twin(cuda):
    from advchain_tpu_torch.kernels import band_sample as bs
    img, y, x, wts, _ = _inputs(cuda)
    before = bs.FWD_LAUNCHES
    out = bs.band_sample_fwd(img, y, x, wts)
    torch.cuda.synchronize()
    assert bs.FWD_LAUNCHES == before + 1
    torch.testing.assert_close(out, bs.band_sample_fwd_plain(img, y, x, wts),
                               atol=1e-5, rtol=0)


def test_bwd_kernel_matches_twin(cuda):
    from advchain_tpu_torch.kernels import band_sample as bs
    img, y, x, wts, g = _inputs(cuda, seed=1)
    before = bs.BWD_LAUNCHES
    d_img, d_w = bs.band_sample_bwd(g, img, y, x, wts)
    torch.cuda.synchronize()
    assert bs.BWD_LAUNCHES == before + 1
    r_img, r_w = bs.band_sample_bwd_plain(g, img, y, x, wts)
    torch.testing.assert_close(d_w, r_w, atol=1e-5, rtol=0)
    # atomics sum in no fixed order: f32 reassociation of max|d_img|
    scale = float(r_img.abs().max())
    assert float((d_img - r_img).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_grid_sample_gradients_match_the_cpu(cuda, padding):
    from advchain_tpu_torch.ops.grid_sample import grid_sample_2d
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(2, 3, 20, 24, generator=gen)
    grid = torch.rand(2, 17, 19, 2, generator=gen) * 2.4 - 1.2
    cot = torch.randn(2, 3, 17, 19, generator=gen)
    results = []
    for dev in ("cpu", cuda):
        x = img.to(dev).clone().requires_grad_(True)
        gr = grid.to(dev).clone().requires_grad_(True)
        out = grid_sample_2d(x, gr, padding_mode=padding)
        (out * cot.to(dev)).sum().backward()
        results.append([t.detach().cpu() for t in (out, x.grad, gr.grad)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-5)


def test_cuda_tensor_never_takes_the_twin(cuda):
    from advchain_tpu_torch.kernels import band_sample as bs
    img, y, x, wts, _ = _inputs(cuda, seed=3)
    with pytest.raises(TypeError):
        bs.band_sample_fwd(img.double(), y, x, wts)


def _band_grid_inputs(device, kind, c=3, n=2, shape=(37, 45), seed=0):
    """img, grid (N, P, 2) on the image's own raster and a cotangent.
    ``near_identity``: an identity grid jittered by up to 1.5 px per axis
    (neighbouring points' atomics land on shared corners); ``near_pm1``:
    the same with 5% of its entries on exactly +-1; ``spread``: uniform
    over 1.2 times the image (samples past the border)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn((n, c) + shape, generator=gen, device=device)
    axes = [torch.linspace(-1, 1, s, device=device) for s in shape]
    yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy], -1).reshape(1, -1, 2).expand(n, -1, 2)
    jitter = 2 * torch.rand(ident.shape, generator=gen, device=device) - 1
    if kind == "spread":
        grid = jitter * 1.2
    else:
        px = torch.tensor([1.5 * 2 / (s - 1) for s in reversed(shape)],
                          device=device)
        grid = ident + jitter * px
        if kind == "near_pm1":
            pick = torch.rand(grid.shape, generator=gen, device=device) < 0.05
            sign = torch.where(torch.rand(grid.shape, generator=gen,
                                          device=device) < 0.5, -1.0, 1.0)
            grid = torch.where(pick, sign, grid)
    g = torch.randn(n, c, grid.shape[1], generator=gen, device=device)
    return img, grid.contiguous(), g


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("grid_kind", ["near_identity", "near_pm1",
                                       "spread"])
def test_band_grid_kernels_match_plain(cuda, grid_kind, mode, padding):
    """The grid-level band pair against its plain versions: the forward
    equal bit for bit (it repeats the plain fold's roundings), d_img and
    d_grid within 1e-5 of their largest entries (atomics and the channel
    sum reassociate), nearest's d_grid zero, one launch each way."""
    from advchain_tpu_torch.kernels import band_sample as bs
    img, grid, g = _band_grid_inputs(cuda, grid_kind)
    for align in (True, False):
        args = (padding, align, mode)
        before = (bs.GRID_FWD_LAUNCHES, bs.GRID_BWD_LAUNCHES)
        out = bs.band_grid_sample_fwd(img, grid, *args)
        assert torch.equal(out, bs.band_grid_sample_fwd_plain(img, grid,
                                                              *args))
        r_img, r_grid = bs.band_grid_sample_bwd_plain(g, img, grid, *args)
        d_img, d_grid = bs.band_grid_sample_bwd(g, img, grid, *args)
        for ours, ref in ((d_img, r_img), (d_grid, r_grid)):
            scale = float(ref.abs().max())
            assert float((ours - ref).abs().max()) <= 1e-5 * scale
        if mode == "nearest":
            assert not bool(d_grid.any())
        assert (bs.GRID_FWD_LAUNCHES, bs.GRID_BWD_LAUNCHES) == \
            (before[0] + 1, before[1] + 1)


def test_grid_sample_2d_takes_the_grid_pair(cuda, monkeypatch):
    """grid_sample_2d on CUDA tensors: one grid-level launch each way, none
    of the corner-level or corner-route pairs, and no call of the
    host-side fold or of a plain twin."""
    import chip_smoke
    from advchain_tpu_torch.kernels import band_sample as bs
    from advchain_tpu_torch.kernels import _coords
    from advchain_tpu_torch.ops import grid_sample_2d
    gs = sys.modules["advchain_tpu_torch.ops.grid_sample"]

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route took a host-side fold or twin")

    for module, name in ((gs, "corner_weights"), (gs, "nearest_weights"),
                         (_coords, "corner_weights"),
                         (_coords, "nearest_weights"),
                         (bs, "band_grid_sample_fwd_plain"),
                         (bs, "band_grid_sample_bwd_plain")):
        monkeypatch.setattr(module, name, refuse)
    img, grid, _ = _band_grid_inputs(cuda, "spread", shape=(19, 23))
    for mode in ("bilinear", "nearest"):
        x = img.clone().requires_grad_(True)
        gr = grid.reshape(2, 19, 23, 2).clone().requires_grad_(True)
        chip_smoke.reset_launch_counts()
        grid_sample_2d(x, gr, mode=mode,
                       padding_mode="border").sum().backward()
        counts = chip_smoke.launch_counts()
        assert counts["band_grid"] == {"fwd": 1, "bwd": 1}
        assert counts["band"] == counts["corner"] == {"fwd": 0, "bwd": 0}
        assert counts["corner_tile"] == {"bwd": 0}
        assert gr.grad is not None
        assert bool(gr.grad.abs().sum() > 0) == (mode == "bilinear")


def test_cuda_tensor_never_takes_the_band_grid_twin(cuda, monkeypatch):
    from advchain_tpu_torch.kernels import band_sample as bs
    img, grid, g = _band_grid_inputs(cuda, "spread", shape=(9, 11))
    with pytest.raises(TypeError):
        bs.band_grid_sample_fwd(img, grid.double())
    with pytest.raises(TypeError):
        bs.band_grid_sample_bwd(g, img.double(), grid)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(bs, "band_grid_sample_fwd_plain", refuse)
    monkeypatch.setattr(bs, "band_grid_sample_bwd_plain", refuse)
    bs.band_grid_sample_fwd(img, grid)
    bs.band_grid_sample_bwd(g, img, grid)
    torch.cuda.synchronize()


def _zband_inputs(device, n=2, c=3, d=7, h=13, w=17, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn(n, c, d, h, w, generator=gen, device=device)
    p = 700
    idx = [torch.randint(-1, s + 1, (n, p), generator=gen, device=device,
                         dtype=torch.int32) for s in (d, h, w)]
    wts = torch.rand(n, 8, p, generator=gen, device=device)
    g = torch.randn(n, c, p, generator=gen, device=device)
    return img, idx, wts, g


def test_zband_fwd_kernel_matches_twin(cuda):
    from advchain_tpu_torch.kernels import zband_sample as zs
    img, idx, wts, _ = _zband_inputs(cuda)
    before = zs.FWD_LAUNCHES
    out = zs.zband_sample_fwd(img, *idx, wts)
    torch.cuda.synchronize()
    assert zs.FWD_LAUNCHES == before + 1
    torch.testing.assert_close(out, zs.zband_sample_fwd_plain(img, *idx, wts),
                               atol=1e-5, rtol=0)


def test_zband_bwd_kernel_matches_twin(cuda):
    from advchain_tpu_torch.kernels import zband_sample as zs
    img, idx, wts, g = _zband_inputs(cuda, seed=1)
    before = zs.BWD_LAUNCHES
    d_img, d_w = zs.zband_sample_bwd(g, img, *idx, wts)
    torch.cuda.synchronize()
    assert zs.BWD_LAUNCHES == before + 1
    r_img, r_w = zs.zband_sample_bwd_plain(g, img, *idx, wts)
    torch.testing.assert_close(d_w, r_w, atol=1e-5, rtol=0)
    # atomics sum in no fixed order: f32 reassociation of max|d_img|
    scale = float(r_img.abs().max())
    assert float((d_img - r_img).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
def test_grid_sample_3d_gradients_match_the_cpu(cuda, padding):
    from advchain_tpu_torch.ops.grid_sample import grid_sample_3d
    gen = torch.Generator().manual_seed(2)
    img = torch.randn(2, 3, 6, 11, 13, generator=gen)
    grid = torch.rand(2, 5, 9, 10, 3, generator=gen) * 2.4 - 1.2
    cot = torch.randn(2, 3, 5, 9, 10, generator=gen)
    results = []
    for dev in ("cpu", cuda):
        x = img.to(dev).clone().requires_grad_(True)
        gr = grid.to(dev).clone().requires_grad_(True)
        out = grid_sample_3d(x, gr, padding_mode=padding)
        (out * cot.to(dev)).sum().backward()
        results.append([t.detach().cpu() for t in (out, x.grad, gr.grad)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("dims", [2, 3])
def test_nearest_matches_the_cpu(cuda, dims):
    from advchain_tpu_torch.kernels import band_sample as bs
    from advchain_tpu_torch.kernels import zband_sample as zs
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    gen = torch.Generator().manual_seed(3)
    spatial = (5, 11, 13)[3 - dims:]
    img = torch.randn((2, 2) + spatial, generator=gen)
    grid = torch.rand((2,) + spatial + (dims,), generator=gen) * 2.4 - 1.2
    cot = torch.randn(img.shape, generator=gen)
    # 2D on the band grid pair, 3D on the fused z-band pair
    mod, fwd, bwd = (bs if dims == 2 else zs, "GRID_FWD_LAUNCHES",
                     "GRID_BWD_LAUNCHES")
    results = []
    for dev in ("cpu", cuda):
        before = (getattr(mod, fwd), getattr(mod, bwd))
        x = img.to(dev).clone().requires_grad_(True)
        out = grid_sample(x, grid.to(dev), mode="nearest")
        (out * cot.to(dev)).sum().backward()
        if dev != "cpu":
            assert (getattr(mod, fwd), getattr(mod, bwd)) == \
                (before[0] + 1, before[1] + 1)
        results.append([t.detach().cpu() for t in (out, x.grad)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=0)


def _zband_grid_inputs(device, spread, c=3, n=2, shape=(8, 32, 48), seed=0):
    """img, grid (N, P, 3) on the volume's own raster and a cotangent.
    ``spread`` None: an identity grid jittered by up to one voxel per axis
    (neighbouring points' atomics land on shared corners); a number:
    uniform over ``spread`` times the volume (samples past the volume)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn((n, c) + shape, generator=gen, device=device)
    axes = [torch.linspace(-1, 1, s, device=device) for s in shape]
    zz, yy, xx = torch.meshgrid(*axes, indexing="ij")
    ident = torch.stack([xx, yy, zz], -1).reshape(1, -1, 3).expand(n, -1, 3)
    jitter = 2 * torch.rand(ident.shape, generator=gen, device=device) - 1
    if spread is None:
        voxel = torch.tensor([2 / (s - 1) for s in reversed(shape)],
                             device=device)
        grid = ident + jitter * voxel
    else:
        grid = jitter * spread
    g = torch.randn(n, c, grid.shape[1], generator=gen, device=device)
    return img, grid.contiguous(), g


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("grid_kind", ["near_identity", "spread"])
def test_zband_grid_kernels_match_plain(cuda, grid_kind, mode, padding):
    """The fused pair against its plain versions on a near-identity grid
    and on one that reaches past the volume: forward within 1e-6, d_img
    and d_grid within 1e-5 of their largest entries (atomics and the
    channel sum reassociate), one launch each way."""
    from advchain_tpu_torch.kernels import zband_sample as zs
    img, grid, g = _zband_grid_inputs(
        cuda, *((None, 2) if grid_kind == "near_identity" else (1.2, 3)))
    for align in (True, False):
        args = (padding, align, mode)
        before = (zs.GRID_FWD_LAUNCHES, zs.GRID_BWD_LAUNCHES)
        out = zs.zband_grid_sample_fwd(img, grid, *args)
        torch.testing.assert_close(
            out, zs.zband_grid_sample_fwd_plain(img, grid, *args),
            atol=1e-6, rtol=0)
        r_img, r_grid = zs.zband_grid_sample_bwd_plain(g, img, grid, *args)
        d_img, d_grid = zs.zband_grid_sample_bwd(g, img, grid, *args)
        for ours, ref in ((d_img, r_img), (d_grid, r_grid)):
            scale = float(ref.abs().max())
            assert float((ours - ref).abs().max()) <= 1e-5 * scale
        if mode == "nearest":
            assert not bool(d_grid.any())
        assert (zs.GRID_FWD_LAUNCHES, zs.GRID_BWD_LAUNCHES) == \
            (before[0] + 1, before[1] + 1)


def test_grid_sample_3d_takes_the_fused_pair(cuda, monkeypatch):
    """grid_sample_3d on CUDA tensors: one fused launch each way, none of
    the corner-level pair, and no call of the host-side fold or of a plain
    twin."""
    import chip_smoke
    from advchain_tpu_torch.kernels import zband_sample as zs
    from advchain_tpu_torch.kernels import _coords
    from advchain_tpu_torch.ops import grid_sample_3d
    gs = sys.modules["advchain_tpu_torch.ops.grid_sample"]

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route took a host-side fold or twin")

    for module, name in ((gs, "corner_weights_3d"), (gs, "nearest_weights"),
                         (_coords, "corner_weights_3d"),
                         (_coords, "nearest_weights"),
                         (zs, "zband_grid_sample_fwd_plain"),
                         (zs, "zband_grid_sample_bwd_plain")):
        monkeypatch.setattr(module, name, refuse)
    img, grid, _ = _zband_grid_inputs(cuda, 1.1, shape=(5, 9, 11))
    x = img.clone().requires_grad_(True)
    gr = grid.reshape(2, 5, 9, 11, 3).clone().requires_grad_(True)
    chip_smoke.reset_launch_counts()
    grid_sample_3d(x, gr, padding_mode="border").sum().backward()
    counts = chip_smoke.launch_counts()
    assert counts["zband_grid"] == {"fwd": 1, "bwd": 1}
    assert counts["zband"] == {"fwd": 0, "bwd": 0}
    assert gr.grad is not None and bool(gr.grad.abs().sum() > 0)


def test_cuda_tensor_never_takes_the_zband_twin(cuda):
    from advchain_tpu_torch.kernels import zband_sample as zs
    img, idx, wts, _ = _zband_inputs(cuda, seed=3)
    with pytest.raises(TypeError):
        zs.zband_sample_fwd(img.double(), *idx, wts)
    img, grid, _ = _zband_grid_inputs(cuda, 1.0)
    with pytest.raises(TypeError):
        zs.zband_grid_sample_fwd(img, grid.double())


def _hold_stencil_bwd(g, img, flow, slope):
    """The CUDA backward against its twin: d_img and d_flow within 1e-5 of
    their largest entries (channel sums, and the atomics of taps outside
    the gather's window, reassociate), and its count of those taps equal
    to the plain count."""
    from advchain_tpu_torch.kernels import stencil_warp as sw
    before = sw.BWD_LAUNCHES
    d_img, d_flow = sw.stencil_warp_bwd(g, img, flow, slope)
    torch.cuda.synchronize()
    assert sw.BWD_LAUNCHES == before + 1
    r_img, r_flow = sw.stencil_warp_bwd_plain(g, img, flow, slope)
    for ours, ref in ((d_img, r_img), (d_flow, r_flow)):
        scale = float(ref.abs().max())
        assert float((ours - ref).abs().max()) <= 1e-5 * scale
    assert int(sw.LAST_OUT_OF_WINDOW) == sw.out_of_window_plain(flow)


@pytest.mark.parametrize("c", [1, 2, 5])
def test_stencil_kernels_match_twins(cuda, c):
    """chip_smoke.py phase 10's cases: N=128, 192x192, a near-identity flow
    (also with its border on exactly +-1) and one of up to 20 px past the
    border with entries on exactly +-1; the backward with both dispatch
    slopes."""
    import chip_smoke
    from advchain_tpu_torch.kernels import stencil_warp as sw
    for _, flow in chip_smoke.stencil_flows(128, (192, 192), cuda):
        img, g = chip_smoke.stencil_inputs(128, c, flow)
        before = sw.FWD_LAUNCHES
        out = sw.stencil_warp_fwd(img, flow)
        torch.cuda.synchronize()
        assert sw.FWD_LAUNCHES == before + 1
        torch.testing.assert_close(out, sw.stencil_warp_fwd_plain(img, flow),
                                   atol=1e-5, rtol=0)
        for slope in (1.0, 0.5):
            _hold_stencil_bwd(g, img, flow,
                              torch.tensor([slope], device=cuda))


def test_stencil_bwd_on_the_headline_squarings(cuda):
    """The 8 squaring inputs of a seeded headline morph, each warping
    itself, with both dispatch slopes; the last squarings pass the
    gather's window."""
    import chip_smoke
    flows = chip_smoke.morph_squarings(cuda)
    for k, flow in enumerate(flows):
        g = chip_smoke.stencil_inputs(128, 2, flow, seed=k)[1]
        for slope in (1.0, 0.5):
            _hold_stencil_bwd(g, flow, flow,
                              torch.tensor([slope], device=cuda))


@pytest.mark.parametrize("c", [1, 2, 5])
def test_stencil_bwd_at_an_odd_shape(cuda, c):
    """N=3, 17x23: tiles of 32 x 8 that the image fills unevenly."""
    import chip_smoke
    for _, flow in chip_smoke.stencil_flows(3, (17, 23), cuda):
        img, g = chip_smoke.stencil_inputs(3, c, flow)
        for slope in (1.0, 0.5):
            _hold_stencil_bwd(g, img, flow, torch.tensor([slope], device=cuda))


def test_stencil_bwd_is_deterministic_in_window(cuda):
    """Every tap of the near-identity flow lies within the gather's window,
    so the gather alone writes d_img, and two runs agree bit for bit."""
    import chip_smoke
    from advchain_tpu_torch.kernels import stencil_warp as sw
    _, flow = chip_smoke.stencil_flows(128, (192, 192), cuda)[0]
    img, g = chip_smoke.stencil_inputs(128, 2, flow)
    first = sw.stencil_warp_bwd(g, img, flow)
    assert int(sw.LAST_OUT_OF_WINDOW) == 0
    second = sw.stencil_warp_bwd(g, img, flow)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dims", [2, 3])
def test_dispatch_slope_matches_plain(cuda, dims):
    """The predicate's kernel equals its twin, [slope, dpx], below and past
    the radius (2 px in 2D, 1 voxel in 3D), and with a NaN (the sampler's
    side, as JAX's comparison)."""
    from advchain_tpu_torch.kernels import stencil_warp as sw
    from advchain_tpu_torch.ops.integrate import base_grid
    shape = (9, 13, 11)[3 - dims:]
    radius = {2: 2, 3: 1}[dims]
    gen = torch.Generator(device=cuda).manual_seed(5)
    base = base_grid(3, shape, device=cuda)
    vox = torch.tensor([2.0 / (s - 1) for s in reversed(shape)],
                       device=cuda).reshape((1, dims) + (1,) * dims)
    noise = 2 * torch.rand(base.shape, generator=gen, device=cuda) - 1
    sides = []
    for k in (0.5, 0.99, 1.5, 4.0):
        flow = (base + k * radius * vox * noise).contiguous()
        out = sw.dispatch_slope(flow, radius)
        assert torch.equal(out, sw.dispatch_slope_plain(flow, radius))
        sides.append(float(out[0]))
    assert sides[0] == 1.0 and sides[-1] == 0.5
    flow.view(-1)[7] = float("nan")
    assert float(sw.dispatch_slope(flow, radius)[0]) == 0.5


def test_dispatch_slope_calls_on_two_streams_keep_apart(cuda):
    """Each call reduces into words of its own: predicates queued at once
    on two streams, one below the radius and one past it, each return
    their own flow's ``[slope, dpx]``."""
    from advchain_tpu_torch.kernels import stencil_warp as sw
    from advchain_tpu_torch.ops.integrate import base_grid
    base = base_grid(64, (192, 192), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    noise = 2 * torch.rand(base.shape, generator=gen, device=cuda) - 1
    flows = [(base + k * noise * (2.0 / 191)).contiguous()
             for k in (0.5, 8.0)]
    refs = [sw.dispatch_slope_plain(f, 2) for f in flows]
    streams = [torch.cuda.Stream() for _ in flows]
    torch.cuda.synchronize()
    outs = [[] for _ in flows]
    for _ in range(20):
        for i, (flow, stream) in enumerate(zip(flows, streams)):
            with torch.cuda.stream(stream):
                outs[i].append(sw.dispatch_slope(flow, 2))
    torch.cuda.synchronize()
    for got, ref in zip(outs, refs):
        assert all(torch.equal(o, ref) for o in got)
    assert [float(r[0]) for r in refs] == [1.0, 0.5]


def test_compose_flow_without_a_grid_gradient_skips_the_predicate(cuda):
    """Under ``no_grad`` a composition launches the stencil forward and no
    predicate; with a gradient, one predicate."""
    from advchain_tpu_torch.kernels import stencil_warp as sw
    from advchain_tpu_torch.ops.integrate import base_grid, compose_flow
    flow = base_grid(2, (17, 23), device=cuda) + 0.05 * torch.randn(
        2, 2, 17, 23, device=cuda)
    before = (sw.FWD_LAUNCHES, sw.SLOPE_LAUNCHES)
    with torch.no_grad():
        compose_flow(flow, flow)
    assert (sw.FWD_LAUNCHES, sw.SLOPE_LAUNCHES) == \
        (before[0] + 1, before[1])
    f = flow.clone().requires_grad_(True)
    compose_flow(f, f)
    assert (sw.FWD_LAUNCHES, sw.SLOPE_LAUNCHES) == \
        (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("slope", [1.0, 0.5])
def test_zband_edge_padding_takes_the_runtime_slope(cuda, slope):
    """The z-band grid backward with edge padding reads the slope at an
    exact lower bound from the device, as its plain version."""
    from advchain_tpu_torch.kernels import zband_sample as zs
    img, grid, g = _zband_grid_inputs(cuda, 1.0)
    grid[:, ::7] = -1.0  # whole points on the lower bound
    s = torch.tensor([slope], device=cuda)
    d_img, d_grid = zs.zband_grid_sample_bwd(g, img, grid, "edge", True,
                                             "bilinear", s)
    torch.cuda.synchronize()
    r_img, r_grid = zs.zband_grid_sample_bwd_plain(g, img, grid, "edge",
                                                   True, "bilinear", s)
    for ours, ref in ((d_img, r_img), (d_grid, r_grid)):
        scale = float(ref.abs().max())
        assert float((ours - ref).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("dims", [2, 3])
def test_compose_flow_past_the_radius_matches_the_cpu(cuda, dims):
    """A composition past the stencil radius with 5% of its entries on
    exactly +-1: the card's predicate takes the sampler's half slope, as
    the CPU's; output and both gradients agree."""
    from advchain_tpu_torch.ops.integrate import base_grid, compose_flow
    shape = (5, 17, 23)[3 - dims:]
    gen = torch.Generator().manual_seed(6)
    base = base_grid(2, shape)
    flow = base + 0.3 * torch.randn(base.shape, generator=gen)
    pick = torch.rand(base.shape, generator=gen) < 0.05
    flow = torch.where(pick, torch.where(flow >= 0, 1.0, -1.0), flow)
    cot = torch.randn(base.shape, generator=gen)
    results = []
    for dev in ("cpu", cuda):
        f1 = flow.to(dev).clone().requires_grad_(True)
        f2 = flow.to(dev).clone().requires_grad_(True)
        out = compose_flow(f1, f2)
        (out * cot.to(dev)).sum().backward()
        results.append([t.detach().cpu() for t in (out, f1.grad, f2.grad)])
    for a, b in zip(*results):
        scale = float(a.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(scale, 1.0)


def test_compose_flow_takes_the_stencil_kernels(cuda):
    from advchain_tpu_torch.kernels import stencil_warp as sw
    from advchain_tpu_torch.ops.integrate import base_grid, compose_flow
    gen = torch.Generator().manual_seed(4)
    flow = base_grid(2, (17, 23)) + 0.05 * torch.randn(2, 2, 17, 23,
                                                       generator=gen)
    cot = torch.randn(flow.shape, generator=gen)
    results = []
    for dev in ("cpu", cuda):
        before = (sw.FWD_LAUNCHES, sw.BWD_LAUNCHES, sw.SLOPE_LAUNCHES)
        f = flow.to(dev).clone().requires_grad_(True)
        out = compose_flow(f, f)
        (out * cot.to(dev)).sum().backward()
        if dev != "cpu":
            assert (sw.FWD_LAUNCHES, sw.BWD_LAUNCHES, sw.SLOPE_LAUNCHES) == \
                tuple(b + 1 for b in before)
        results.append([t.detach().cpu() for t in (out, f.grad)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-5)


def test_cuda_tensor_never_takes_the_stencil_twin(cuda):
    from advchain_tpu_torch.kernels import stencil_warp as sw
    img = torch.randn(2, 3, 8, 9, device=cuda)
    flow = torch.zeros(2, 2, 8, 9, device=cuda)
    with pytest.raises(TypeError):
        sw.stencil_warp_fwd(img.double(), flow.double())


def _plane_inputs(device, k, n=3, c=3, d=4, h=13, w=17, seed=0,
                  planes=True):
    """Flat-index inputs with points on the last column (the +1 tap wraps
    to the next row), the last row and the last pixel of a plane (taps past
    HW read zero), and, for the plane pair, planes outside [0, D)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    hw = h * w
    img = torch.randn((n, c, d, hw) if planes else (n, c, hw), generator=gen,
                      device=device)
    p = 600
    yx = torch.randint(0, hw, (n, p), generator=gen, device=device,
                       dtype=torch.int32)
    yx[:, :10] = torch.arange(10, device=device) % h * w + w - 1
    yx[:, 10:20] = (h - 1) * w + torch.arange(10, device=device) % w
    yx[:, 20:30] = hw - 1
    z = torch.randint(-1, d + 1, (n, p), generator=gen, device=device,
                      dtype=torch.int32) if planes else None
    wts = torch.rand(n, k, p, generator=gen, device=device)
    g = torch.randn(n, c, p, generator=gen, device=device)
    offsets = {1: (0,), 2: (0, 1), 4: (0, 1, w, w + 1)}[k]
    return img, z, yx, wts, g, offsets


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("route", ["corner", "plane"])
def test_plane_sample_kernels_match_twins(cuda, route, k):
    from advchain_tpu_torch.kernels import plane_sample as ps
    img, z, yx, wts, g, offsets = _plane_inputs(cuda, k, seed=k,
                                                planes=route == "plane")
    idx = (yx,) if route == "corner" else (z, yx)
    fwd = getattr(ps, f"{route}_sample_fwd")
    bwd = getattr(ps, f"{route}_sample_bwd")
    # the corner backward at the tap square launches the tile kernel
    bwd_fam = ("corner_tile" if route == "corner" and ps.tile_offsets(offsets)
               else route)
    before = {"fwd": ps.LAUNCHES[route]["fwd"],
              "bwd": ps.LAUNCHES[bwd_fam]["bwd"]}
    out = fwd(img, *idx, wts, offsets)
    d_img, d_w = bwd(g, img, *idx, wts, offsets)
    torch.cuda.synchronize()
    assert {"fwd": ps.LAUNCHES[route]["fwd"],
            "bwd": ps.LAUNCHES[bwd_fam]["bwd"]} == {
                "fwd": before["fwd"] + 1, "bwd": before["bwd"] + 1}
    # the forward sums in the twin's order with rounded products: equal
    assert torch.equal(out, getattr(ps, f"{route}_sample_fwd_plain")(
        img, *idx, wts, offsets))
    r_img, r_w = getattr(ps, f"{route}_sample_bwd_plain")(g, img, *idx, wts,
                                                          offsets)
    torch.testing.assert_close(d_w, r_w, atol=1e-5, rtol=0)
    # atomics sum in no fixed order: f32 reassociation of max|d_img|
    scale = float(r_img.abs().max())
    assert float((d_img - r_img).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("padding", ["zeros", "border", "reflection"])
@pytest.mark.parametrize("dims", [2, 3])
def test_legacy_routes_match_the_cpu(cuda, dims, padding, monkeypatch):
    """ADVCHAIN_BAND_KERNEL=0 / ADVCHAIN_ZBAND=0 on the card: the corner or
    plane grid kernels launch (the default route's band or z-band grid
    pair does not, nor the flat plane pair), and the sample and its
    gradients equal the CPU's."""
    import chip_smoke
    from advchain_tpu_torch.ops.grid_sample import grid_sample
    monkeypatch.setenv("ADVCHAIN_BAND_KERNEL", "0")
    monkeypatch.setenv("ADVCHAIN_ZBAND", "0")
    gen = torch.Generator().manual_seed(5)
    spatial = (6, 11, 13)[3 - dims:]
    img = torch.randn((2, 3) + spatial, generator=gen)
    grid = torch.rand((2, 5, 9, 10)[:dims + 1] + (dims,),
                      generator=gen) * 2.4 - 1.2
    cot = torch.randn((2, 3) + tuple(grid.shape[1:-1]), generator=gen)
    route, old = (("corner", "band_grid") if dims == 2
                  else ("plane_grid", "zband_grid"))
    results = []
    for dev in ("cpu", cuda):
        chip_smoke.reset_launch_counts()
        x = img.to(dev).clone().requires_grad_(True)
        gr = grid.to(dev).clone().requires_grad_(True)
        out = grid_sample(x, gr, padding_mode=padding)
        (out * cot.to(dev)).sum().backward()
        counts = chip_smoke.launch_counts()
        if dev != "cpu":
            # one launch each way: the corner pair (its backward on the
            # tile kernel), or the plane grid pair over both z taps (no
            # flat plane launch)
            assert chip_smoke.family_launches(counts, route) == {"fwd": 1,
                                                                 "bwd": 1}
            if dims == 2:
                assert counts["corner_tile"] == {"bwd": 1}
            assert counts[old] == {"fwd": 0, "bwd": 0}
            assert counts["plane"] == {"fwd": 0, "bwd": 0}
        results.append([t.detach().cpu() for t in (out, x.grad, gr.grad)])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape", [(40, 50), (9, 13)])
def test_corner_bwd_kernels_match_plain(cuda, shape):
    """chip_smoke's phase-14 corner backward cases at a small size: the
    tile kernel at the tap square (with and without the raster width, on
    inputs that stress its merge: all points on one pixel, rows right to
    left, bases with no coincident taps, rasters no multiple of its tile,
    of one point and under one block) and the flat kernel at other K and
    offsets, each launched once, d_img and d_w within 1e-5 of their
    largest entries."""
    import chip_smoke
    worst = chip_smoke.check_corner_bwd(3, shape, cuda)
    assert set(worst) == {"corner", "corner_tile"}


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_corner_route_takes_the_tile_kernel(cuda, mode, monkeypatch):
    """ADVCHAIN_BAND_KERNEL=0 on CUDA tensors: a bilinear sample's
    backward launches the corner tile kernel, a nearest one's (one tap) the
    flat kernel, and neither calls the plain backward."""
    import chip_smoke
    from advchain_tpu_torch.kernels import plane_sample as ps
    from advchain_tpu_torch.ops import grid_sample_2d
    monkeypatch.setenv("ADVCHAIN_BAND_KERNEL", "0")

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain backward")

    monkeypatch.setattr(ps, "corner_sample_bwd_plain", refuse)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 3, 33, 47, generator=gen,
                    device=cuda).requires_grad_(True)
    grid = torch.rand(2, 35, 41, 2, generator=gen, device=cuda) * 2.2 - 1.1
    chip_smoke.reset_launch_counts()
    grid_sample_2d(x, grid, mode=mode).sum().backward()
    counts = chip_smoke.launch_counts()
    tile = int(mode == "bilinear")
    assert counts["corner"] == {"fwd": 1, "bwd": 1 - tile}
    assert counts["corner_tile"] == {"bwd": tile}
    assert bool(x.grad.abs().sum() > 0)


def test_cuda_tensor_never_takes_the_plane_twin(cuda):
    from advchain_tpu_torch.kernels import plane_sample as ps
    img, z, yx, wts, _, offsets = _plane_inputs(cuda, 4, seed=9)
    with pytest.raises(TypeError):
        ps.plane_sample_fwd(img.double(), z, yx, wts, offsets)
    with pytest.raises(TypeError):
        ps.corner_sample_fwd(img[:, :, 0].contiguous(), yx.long(), wts,
                             offsets)


def _plane_grid_inputs(device, n=3, c=4, shape=(13, 17, 19), seed=0):
    """img, grid (N, P, 3) and a cotangent at an odd shape: a grid spread
    over 1.2 times the volume with 10% of its entries exactly +-1 (points
    on the volume's edge planes, rows and columns, where taps collapse or
    fall past a plane's flat end)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randn((n, c) + shape, generator=gen, device=device)
    p = 3000
    grid = (2 * torch.rand(n, p, 3, generator=gen, device=device) - 1) * 1.2
    pick = torch.rand(n, p, 3, generator=gen, device=device) < 0.1
    grid = torch.where(pick, torch.where(grid >= 0, 1.0, -1.0), grid)
    g = torch.randn(n, c, p, generator=gen, device=device)
    return img, grid.contiguous(), g


@pytest.mark.parametrize("padding,slope", [("zeros", None), ("border", None),
                                           ("reflection", None),
                                           ("edge", 1.0), ("edge", 0.5)])
def test_plane_grid_kernels_match_plain(cuda, padding, slope):
    """The plane grid pair against its plain versions at an odd shape:
    forward within 1e-6, d_img and d_grid within 1e-5 of their largest
    entries, one launch each way."""
    from advchain_tpu_torch.kernels import plane_sample as ps
    img, grid, g = _plane_grid_inputs(cuda)
    s = None if slope is None else torch.tensor([slope], device=cuda)
    for align in (True, False):
        before = dict(ps.LAUNCHES["plane_grid"])
        out = ps.plane_grid_sample_fwd(img, grid, padding, align)
        torch.testing.assert_close(
            out, ps.plane_grid_sample_fwd_plain(img, grid, padding, align),
            atol=1e-6, rtol=0)
        d_img, d_grid = ps.plane_grid_sample_bwd(g, img, grid, padding,
                                                 align, s)
        r_img, r_grid = ps.plane_grid_sample_bwd_plain(g, img, grid,
                                                       padding, align, s)
        for ours, ref in ((d_img, r_img), (d_grid, r_grid)):
            scale = float(ref.abs().max())
            assert float((ours - ref).abs().max()) <= 1e-5 * scale
        assert ps.LAUNCHES["plane_grid"] == {"fwd": before["fwd"] + 1,
                                             "bwd": before["bwd"] + 1}


def test_grid_sample_3d_takes_the_plane_grid_pair(cuda, monkeypatch):
    """grid_sample_3d with ADVCHAIN_ZBAND=0 on CUDA tensors: one plane grid
    launch each way, no flat plane or z-band launch, and no call of the
    host-side fold or of a plain twin."""
    import chip_smoke
    from advchain_tpu_torch.kernels import plane_sample as ps
    from advchain_tpu_torch.kernels import _coords
    from advchain_tpu_torch.ops import grid_sample_3d
    monkeypatch.setenv("ADVCHAIN_ZBAND", "0")

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA route took a host-side fold or twin")

    for module, name in ((_coords, "plane_weights"),
                         (ps, "plane_grid_sample_fwd_plain"),
                         (ps, "plane_grid_sample_bwd_plain")):
        monkeypatch.setattr(module, name, refuse)
    img, grid, _ = _plane_grid_inputs(cuda, n=2, c=3, shape=(5, 9, 11))
    grid = grid[:, :5 * 9 * 11].reshape(2, 5, 9, 11, 3)
    x = img.clone().requires_grad_(True)
    gr = grid.clone().requires_grad_(True)
    chip_smoke.reset_launch_counts()
    grid_sample_3d(x, gr, padding_mode="border").sum().backward()
    counts = chip_smoke.launch_counts()
    assert counts["plane_grid"] == {"fwd": 1, "bwd": 1}
    assert counts["plane"] == counts["zband_grid"] == {"fwd": 0, "bwd": 0}
    assert gr.grad is not None and bool(gr.grad.abs().sum() > 0)


def test_cuda_tensor_never_takes_the_plane_grid_twin(cuda, monkeypatch):
    from advchain_tpu_torch.kernels import plane_sample as ps

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor took the plain twin")

    monkeypatch.setattr(ps, "plane_grid_sample_fwd_plain", refuse)
    monkeypatch.setattr(ps, "plane_grid_sample_bwd_plain", refuse)
    img, grid, g = _plane_grid_inputs(cuda, seed=4)
    with pytest.raises(TypeError):
        ps.plane_grid_sample_fwd(img.double(), grid.double())
    with pytest.raises(TypeError):
        ps.plane_grid_sample_bwd(g.half(), img, grid)
    with pytest.raises(ValueError):
        ps.plane_grid_sample_fwd(img, grid[:, :, :2].contiguous())


@pytest.mark.parametrize("route", ["grid_sample_2d", "grid_sample_3d",
                                   "stencil_warp_2d"])
def test_kernel_paths_refuse_a_bf16_image(cuda, route):
    """A bf16 network output must be cast back before it is warped: the
    samplers pass a CUDA tensor to the kernel as it is, and the kernel
    wrappers take f32 alone."""
    from advchain_tpu_torch import ops
    dims = 3 if route.endswith("3d") else 2
    spatial = (4, 8, 8)[-dims:]
    img = torch.rand((2, 3) + spatial, device=cuda, dtype=torch.bfloat16)
    grid = torch.rand((2,) + spatial + (dims,), device=cuda) * 2 - 1
    with pytest.raises(TypeError, match="f32"):
        getattr(ops, route)(img, grid)


def test_bf16_model_feeds_the_samplers_f32(cuda):
    """The wrapper's bf16 mode returns f32 logits, so the solver's warps
    of its predictions run on the kernels."""
    from advchain_tpu_torch.models import SegmentationModel, UNet
    from advchain_tpu_torch.ops import grid_sample_2d
    model = SegmentationModel.create(UNet(1, 4, 16), device=cuda,
                                     compute_dtype=torch.bfloat16)
    logits = model(torch.rand(2, 1, 32, 32, device=cuda))
    assert logits.dtype == torch.float32
    grid = torch.rand(2, 32, 32, 2, device=cuda) * 2 - 1
    assert grid_sample_2d(logits, grid).dtype == torch.float32
