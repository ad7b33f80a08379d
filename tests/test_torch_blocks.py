"""The port's block zoo (``advchain_tpu_torch.models.blocks``) against the
JAX package's Flax one (``advchain_tpu/models/blocks.py``), every block
with Flax's random weights carried across by
``models.convert.flax_blocks_to_torch_state``: the spectral variants, the
domain banks, ``ResConvUp``'s transposed convolution (its kernel flipped)
and the functions, ``spatial_pyramid_pool`` after permuting JAX's NHWC
flatten order to the port's NCHW one.

Inputs are numpy draws from a seed, NCHW for the port and NHWC for Flax.
The running statistics start away from (0, 1), so eval mode reads them.
In training mode both sides write the statistics back (JAX's mutable
``batch_stats``, the port's ``write_back``), and where a block has dropout
JAX's masks are read off its ``nn.Dropout`` calls and replayed in the
port's ``EpisodeDropout``.  Outputs and the written statistics within
1e-5 of the largest entry, every parameter's and the inputs' gradients of
``sum(out * ct)`` within 1e-4 relative L2 of ``jax.grad``'s.  The
initializers are held by their statistics (the random streams differ),
``BatchInstanceNorm`` and ``AdaptiveBatchNorm`` inside a 2-rank data group
against one process, and ``models.__all__`` against JAX's.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from advchain_tpu.models import blocks as jb

from advchain_tpu_torch import models as tm
from advchain_tpu_torch.models import blocks as tb
from advchain_tpu_torch.models.unet import EpisodeDropout, _StatsWriter

from test_torch_mesh import run_ranks
import torch_threads  # noqa: F401  (one intra-op thread a process)

N = 2
TOL_OUT = 1e-5
TOL_GRAD = 1e-4


def _draw(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name: (Flax module, port factory, the array inputs' shapes (NCHW; "w4" /
# "b4" an affine weight / bias of 4 channels), the int arguments after
# them, how the mode is passed: "train", "ura" (use_running_average) or
# None)
CASES = {
    "ConvDown": (jb.ConvDown(12), lambda: tb.ConvDown(6, 12),
                 [(N, 6, 16, 16)], (), "train"),
    "ConvDown_spectral_dropout": (
        jb.ConvDown(12, dropout=0.3, spectral=True),
        lambda: tb.ConvDown(6, 12, dropout=0.3, spectral=True),
        [(N, 6, 16, 16)], (), "train"),
    "ResConvDown": (jb.ResConvDown(8), lambda: tb.ResConvDown(5, 8),
                    [(N, 5, 16, 12)], (), "train"),
    "ResConvDown_spectral": (jb.ResConvDown(8, spectral=True),
                             lambda: tb.ResConvDown(5, 8, spectral=True),
                             [(N, 5, 16, 12)], (), "train"),
    "ResConv": (jb.ResConv(7, dropout=0.2), lambda: tb.ResConv(4, 7, 0.2),
                [(N, 4, 10, 12)], (), "train"),
    "ResConv_spectral": (jb.ResConv(7, spectral=True),
                         lambda: tb.ResConv(4, 7, spectral=True),
                         [(N, 4, 10, 12)], (), "train"),
    "ResBilinearUp": (jb.ResBilinearUp(6), lambda: tb.ResBilinearUp(8, 4, 6),
                      [(N, 8, 6, 5), (N, 4, 12, 10)], (), "train"),
    "ResBilinearUp_spectral": (
        jb.ResBilinearUp(6, spectral=True),
        lambda: tb.ResBilinearUp(8, 4, 6, spectral=True),
        [(N, 8, 6, 5), (N, 4, 12, 10)], (), "train"),
    "ResConvUp": (jb.ResConvUp(6), lambda: tb.ResConvUp(8, 4, 6),
                  [(N, 8, 6, 5), (N, 4, 12, 10)], (), "train"),
    "ResConvUp_spectral": (jb.ResConvUp(6, spectral=True),
                           lambda: tb.ResConvUp(8, 4, 6, spectral=True),
                           [(N, 8, 6, 5), (N, 4, 12, 10)], (), "train"),
    "DilationConv": (jb.DilationConv(6, dilation=2, dropout=0.25),
                     lambda: tb.DilationConv(4, 6, dilation=2, dropout=0.25),
                     [(N, 4, 12, 14)], (), "train"),
    "DilationConv_k5": (jb.DilationConv(6, kernel_size=5),
                        lambda: tb.DilationConv(4, 6, kernel_size=5),
                        [(N, 4, 12, 14)], (), "train"),
    "OutConvRelu": (jb.OutConvRelu(3), lambda: tb.OutConvRelu(5, 3),
                    [(N, 5, 8, 8)], (), None),
    "OutConvRelu_linear": (jb.OutConvRelu(3, activation=None),
                           lambda: tb.OutConvRelu(5, 3, activation=None),
                           [(N, 5, 8, 8)], (), None),
    "SELayer": (jb.SELayer(), lambda: tb.SELayer(32), [(N, 32, 6, 5)], (),
                None),
    "CSELayer": (jb.CSELayer(), lambda: tb.CSELayer(6), [(N, 6, 7, 5)], (),
                 None),
    "ChannelSELayer": (jb.ChannelSELayer(), lambda: tb.ChannelSELayer(6),
                       [(N, 6, 7, 5)], (), None),
    "SpatialSELayer": (jb.SpatialSELayer(), lambda: tb.SpatialSELayer(6),
                       [(N, 6, 7, 5)], (), None),
    "ChannelSpatialSELayer": (jb.ChannelSpatialSELayer(),
                              lambda: tb.ChannelSpatialSELayer(6),
                              [(N, 6, 7, 5)], (), None),
    "SqeUp": (jb.SqeUp(6, dropout=0.2), lambda: tb.SqeUp(8, 8, 6, 0.2),
              [(N, 8, 5, 6), (N, 8, 11, 12)], (), "train"),
    "BatchInstanceNorm": (jb.BatchInstanceNorm(),
                          lambda: tb.BatchInstanceNorm(5),
                          [(N + 1, 5, 7, 6)], (), "ura"),
    "BatchInstanceNorm_3d": (jb.BatchInstanceNorm(),
                             lambda: tb.BatchInstanceNorm(3),
                             [(N, 3, 4, 5, 6)], (), "ura"),
    "AdaptiveInstanceNorm": (jb.AdaptiveInstanceNorm(),
                             lambda: tb.AdaptiveInstanceNorm(),
                             [(N, 4, 6, 7), "w4", "b4"], (), None),
    "AdaptiveBatchNorm": (jb.AdaptiveBatchNorm(),
                          lambda: tb.AdaptiveBatchNorm(),
                          [(N, 4, 6, 7), "w4", "b4"], (), None),
    "UnetConv3": (jb.UnetConv3(4), lambda: tb.UnetConv3(2, 4),
                  [(N, 2, 4, 6, 5)], (), "train"),
    "UnetConv3_no_bn": (jb.UnetConv3(4, use_batchnorm=False),
                        lambda: tb.UnetConv3(2, 4, use_batchnorm=False),
                        [(N, 2, 4, 6, 5)], (), "train"),
    "UnetUp3": (jb.UnetUp3(4, z_scale_factor=2),
                lambda: tb.UnetUp3(3, 2, 4, z_scale_factor=2),
                [(N, 2, 6, 8, 10), (N, 3, 3, 4, 5)], (), "train"),
    "UnetUp3_pad": (jb.UnetUp3(4), lambda: tb.UnetUp3(3, 2, 4),
                    [(N, 2, 3, 5, 6), (N, 3, 4, 6, 8)], (), "train"),
    "DomainDoubleConv": (jb.DomainDoubleConv(5, num_domains=3),
                         lambda: tb.DomainDoubleConv(3, 5, 3),
                         [(N, 3, 8, 9)], (1,), "train"),
    "DomainInConv": (jb.DomainInConv(5, num_domains=2, dropout=0.3),
                     lambda: tb.DomainInConv(3, 5, 2, 0.3),
                     [(N, 3, 8, 9)], (0,), "train"),
    "DomainPoolDown": (jb.DomainPoolDown(5, num_domains=3),
                       lambda: tb.DomainPoolDown(3, 5, 3),
                       [(N, 3, 8, 9)], (2,), "train"),
    "DomainUp": (jb.DomainUp(4, num_domains=2, dropout=0.2),
                 lambda: tb.DomainUp(5, 3, 4, 2, 0.2),
                 [(N, 5, 4, 5), (N, 3, 9, 12)], (1,), "train"),
    "UnetConv2": (jb.UnetConv2(5), lambda: tb.UnetConv2(3, 5),
                  [(N, 3, 8, 9)], (), "train"),
    "UnetConv2_n3_stride2": (
        jb.UnetConv2(5, use_batchnorm=False, n=3, stride=2),
        lambda: tb.UnetConv2(3, 5, use_batchnorm=False, n=3, stride=2),
        [(N, 3, 16, 18)], (), "train"),
    "Conv2DBatchNorm": (jb.Conv2DBatchNorm(5, kernel_size=5, padding=2),
                        lambda: tb.Conv2DBatchNorm(3, 5, kernel_size=5,
                                                   padding=2),
                        [(N, 3, 8, 9)], (), "train"),
    "Conv2DBatchNormRelu": (jb.Conv2DBatchNormRelu(5, stride=2),
                            lambda: tb.Conv2DBatchNormRelu(3, 5, stride=2),
                            [(N, 3, 8, 9)], (), "train"),
}


def _nhwc(a):
    return np.moveaxis(a, 1, -1) if a.ndim > 2 else a


def _nchw(a):
    return np.moveaxis(a, -1, 1) if a.ndim > 2 else a


def _inputs(name):
    """The array inputs (NCHW) and the int arguments of a case."""
    arrays = []
    for i, spec in enumerate(CASES[name][2]):
        if isinstance(spec, str):  # an affine vector passed to forward
            v = _draw((int(spec[1:]),), 20 + i)
            arrays.append(1.0 + 0.5 * v if spec[0] == "w" else v)
        else:
            arrays.append(_draw(spec, 10 + i))
    return arrays, list(CASES[name][3])


def _perturb(stats, seed):
    """Running statistics away from (0, 1); spectral ``u`` / ``sigma``
    keep Flax's init."""
    r = np.random.RandomState(seed)

    def move(path, a):
        key = getattr(path[-1], "key", "")
        if key == "mean":
            return jnp.asarray(r.uniform(-0.5, 0.5, a.shape), jnp.float32)
        if key == "var":
            return jnp.asarray(r.uniform(0.5, 1.5, a.shape), jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, stats)


def _tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _mode_kw(mode, train):
    if mode == "train":
        return {"train": train}
    if mode == "ura":
        return {"use_running_average": not train}
    return {}


def _jax_side(name):
    """Flax's variables (statistics perturbed; BatchInstanceNorm's gate
    moved off 1 so both branches count), its eval output, and in training
    mode its output, written statistics, gradients and dropout masks."""
    fmod, _, _, _, mode = CASES[name]
    arrays, ints = _inputs(name)
    jx = [jnp.asarray(_nhwc(x)) for x in arrays]
    variables = fmod.init({"params": jax.random.PRNGKey(0),
                           "dropout": jax.random.PRNGKey(1)}, *jx, *ints,
                          **_mode_kw(mode, False))
    params = variables.get("params", {})
    if "gate" in params:
        params = dict(params, gate=jnp.asarray(
            np.random.RandomState(3).uniform(0.2, 0.8,
                                             params["gate"].shape),
            jnp.float32))
    stats = _perturb(variables.get("batch_stats", {}), 4)
    eval_out = fmod.apply({"params": params, "batch_stats": stats}, *jx,
                          *ints, **_mode_kw(mode, False))
    rngs = {"dropout": jax.random.PRNGKey(5)}
    masks = []

    def record(next_fun, a, kw, context):
        out = next_fun(*a, **kw)
        if isinstance(context.module, fnn.Dropout):
            masks.append(np.moveaxis(np.asarray(out != 0)
                                     | np.asarray(a[0] == 0), -1, 1))
        return out

    def train_apply(p, inputs):
        return fmod.apply({"params": p, "batch_stats": stats}, *inputs,
                          *ints, **_mode_kw(mode, True), rngs=rngs,
                          mutable=["batch_stats"])

    with fnn.intercept_methods(record):
        y, new = train_apply(params, jx)
    ct = jnp.asarray(_draw(y.shape, 30))
    g_params, g_inputs = jax.grad(
        lambda p, inputs: jnp.sum(train_apply(p, inputs)[0] * ct),
        argnums=(0, 1))(params, jx)
    return {"params": _tree(params), "stats": _tree(stats),
            "eval": _nchw(np.asarray(eval_out)),
            "train": _nchw(np.asarray(y)),
            "new_stats": _tree(new.get("batch_stats", {})),
            "g_params": _tree(g_params),
            "g_inputs": [_nchw(np.asarray(g)) for g in g_inputs],
            "ct": _nchw(np.asarray(ct)), "masks": masks}


def _port_side(name, jside):
    """The port's block with JAX's weights: its eval output, then a
    training forward with the statistics written back and JAX's dropout
    masks replayed, and its gradients."""
    arrays, ints = _inputs(name)
    block = CASES[name][1]()
    block.load_state_dict(tm.flax_blocks_to_torch_state(jside["params"],
                                                        jside["stats"]))
    block.eval()
    with torch.no_grad():
        eval_out = block(*[torch.from_numpy(x) for x in arrays], *ints)
    queue = list(jside["masks"])

    def take(m, a):
        m._mask = torch.from_numpy(queue.pop(0))

    hooks = [m.register_forward_pre_hook(take) for m in block.modules()
             if isinstance(m, EpisodeDropout) and m.p > 0]
    block.train()
    for m in block.modules():
        if isinstance(m, _StatsWriter):
            m.write_back = True
    inputs = [torch.from_numpy(x).requires_grad_(True) for x in arrays]
    try:
        y = block(*inputs, *ints)
    finally:
        for h in hooks:
            h.remove()
    assert not queue, "the port ran fewer dropouts than JAX"
    (y * torch.from_numpy(jside["ct"].copy())).sum().backward()
    return block, eval_out, y.detach(), [x.grad for x in inputs]


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jside = _jax_side(request.param)
    return request.param, jside, _port_side(request.param, jside)


def _close(ours, ref, tol):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(ours - ref).max() <= tol * scale, \
        (np.abs(ours - ref).max(), scale)


def _rel_l2(ours, ref):
    ours = np.asarray(ours, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return np.linalg.norm(ours - ref) / max(np.linalg.norm(ref), 1e-30)


def test_block_outputs_match_flax(pair):
    """Eval and training outputs within 1e-5 of the largest entry."""
    name, jside, (block, eval_out, y, _) = pair
    _close(eval_out, jside["eval"], TOL_OUT)
    _close(y, jside["train"], TOL_OUT)


def test_block_written_statistics_match_flax(pair):
    """The running statistics and spectral ``u`` / ``sigma`` after one
    training forward with the write-back, against JAX's mutated
    ``batch_stats``."""
    name, jside, (block, *_) = pair
    want = tm.flax_blocks_to_torch_state(jside["params"],
                                         jside["new_stats"])
    got = {k: v for k, v in block.named_buffers()
           if not k.endswith("num_batches_tracked")}
    for k, v in got.items():
        _close(v, want[k].numpy(), TOL_OUT)


def test_block_gradients_match_jax_grad(pair):
    """The parameters' gradient, all leaves together, and the inputs'
    within 1e-4 relative L2 of ``jax.grad``'s (converted like the weights:
    the converter is linear in them); each leaf within 1e-4 of its own
    norm plus 1e-6 of the whole's (a convolution bias that feeds a
    BatchNorm has an exact gradient of 0 and a computed one of rounding
    size)."""
    name, jside, (block, _, _, g_inputs) = pair
    want = tm.flax_blocks_to_torch_state(jside["g_params"], jside["stats"])
    # an unused bank member has no gradient, JAX's zeros
    params = {k: torch.zeros_like(p) if p.grad is None else p.grad
              for k, p in block.named_parameters()}
    if params:
        ours = np.concatenate([g.numpy().ravel() for g in params.values()])
        ref = np.concatenate([want[k].numpy().ravel() for k in params])
        assert _rel_l2(ours, ref) <= TOL_GRAD
        whole = np.linalg.norm(ref)
        for k, g in params.items():
            gap = np.linalg.norm(g.numpy() - want[k].numpy())
            assert gap <= TOL_GRAD * np.linalg.norm(want[k].numpy()) \
                + 1e-6 * whole, k
    for got, ref in zip(g_inputs, jside["g_inputs"]):
        assert _rel_l2(got, ref) <= TOL_GRAD


def test_state_dict_names_are_complete(pair):
    """The carried state dict holds exactly the block's keys (every bank
    member, every spectral buffer)."""
    name, jside, (block, *_) = pair
    carried = tm.flax_blocks_to_torch_state(jside["params"], jside["stats"])
    assert sorted(carried) == sorted(block.state_dict())


# ------------------------------------------------------------ functions
@pytest.mark.parametrize("out_ch,shape", [(2, (N, 8, 5, 6)),
                                          (3, (N, 6, 7, 7))])
def test_bilinear_additive_upsampling_matches_flax(out_ch, shape):
    x = _draw(shape, 0)
    ref = jb.bilinear_additive_upsampling(jnp.asarray(_nhwc(x)), out_ch)
    ours = tb.bilinear_additive_upsampling(torch.from_numpy(x), out_ch)
    _close(ours, _nchw(np.asarray(ref)), TOL_OUT)


@pytest.mark.parametrize("channels,out_ch", [(4, 4), (6, 4)])
def test_bilinear_additive_upsampling_keeps_jax_assertions(channels,
                                                           out_ch):
    with pytest.raises(AssertionError):
        tb.bilinear_additive_upsampling(torch.zeros(1, channels, 2, 2),
                                        out_ch)


@pytest.mark.parametrize("bins,shape", [((1, 2, 4), (N, 3, 8, 8)),
                                        ((1, 3, 4), (N, 5, 11, 7)),
                                        ((2, 5), (N, 2, 9, 13))])
def test_spatial_pyramid_pool_matches_flax_in_nchw_order(bins, shape):
    """Each level of JAX's (N, b * b * C) flattened in (row, column, c)
    order, permuted to the port's (c, row, column)."""
    x = _draw(shape, 1)
    ref = np.asarray(jb.spatial_pyramid_pool(jnp.asarray(_nhwc(x)), bins))
    n, c = shape[:2]
    parts, start = [], 0
    for b in bins:
        level = ref[:, start:start + b * b * c].reshape(n, b, b, c)
        parts.append(np.moveaxis(level, -1, 1).reshape(n, -1))
        start += b * b * c
    ours = tb.spatial_pyramid_pool(torch.from_numpy(x), bins)
    _close(ours, np.concatenate(parts, axis=1), 0.0)


# --------------------------------------------------------- initializers
INITS = {"normal_init": (tb.normal_init, (64, 32, 7, 7),
                         lambda s: 0.02),
         "xavier_init": (tb.xavier_init, (64, 32, 7, 7),
                         lambda s: np.sqrt(2.0 / ((s[0] + s[1]) * 49))),
         "xavier_dense": (tb.xavier_init, (400, 300),
                          lambda s: np.sqrt(2.0 / (s[0] + s[1]))),
         "kaiming_init": (tb.kaiming_init, (64, 32, 7, 7),
                          lambda s: np.sqrt(2.0 / (32 * 49)))}


@pytest.mark.parametrize("name", sorted(INITS))
def test_initializers_by_their_statistics(name):
    """Zero mean and the std of Flax's initializer within 5% on >= 1e5
    draws, drawn from the generator, and Flax's own std alike."""
    fn, shape, std = INITS[name]
    w = fn(shape, torch.Generator().manual_seed(0))
    assert w.shape == shape and w.numel() >= 1e5
    assert abs(float(w.std()) / std(shape) - 1) < 0.05
    assert abs(float(w.mean())) < 0.05 * std(shape)
    flax_init = getattr(jb, name.replace("_dense", "_init"))
    jw = np.asarray(flax_init(jax.random.PRNGKey(0),
                              shape[2:] + shape[1::-1]))
    assert abs(float(jw.std()) / std(shape) - 1) < 0.05
    same = fn(shape, torch.Generator().manual_seed(0))
    assert torch.equal(w, same)


def test_bn_scale_init_statistics():
    from advchain_tpu_torch.models.unet import bn_scale_init
    w = bn_scale_init((200000,), torch.Generator().manual_seed(1))
    assert abs(float(w.mean()) - 1) < 1e-3
    assert abs(float(w.std()) / 0.02 - 1) < 0.05


# ------------------------------------------------- a 2-rank data group
GROUP_ROWS = 3


def _norm_inputs():
    r = np.random.RandomState(8)
    return {"x": (r.randn(2 * GROUP_ROWS, 4, 5, 6) * 2 + 1).astype(
                np.float32),
            "ct": r.randn(2 * GROUP_ROWS, 4, 5, 6).astype(np.float32),
            "w": (1 + 0.3 * r.randn(4)).astype(np.float32),
            "b": (0.2 * r.randn(4)).astype(np.float32),
            "gate": r.uniform(0.2, 0.8, 4).astype(np.float32)}


def norm_values(rows=slice(None)):
    """BatchInstanceNorm (training, write-back) and AdaptiveBatchNorm on
    ``rows``: outputs, input and parameter gradients, running statistics;
    inside a data group, this rank's part."""
    t = {k: torch.from_numpy(v) for k, v in _norm_inputs().items()}
    out = {}
    bin_ = tb.BatchInstanceNorm(4)
    with torch.no_grad():
        bin_.weight.copy_(t["w"])
        bin_.bias.copy_(t["b"])
        bin_.gate.copy_(t["gate"])
    bin_.train()
    bin_.write_back = True
    x = t["x"][rows].clone().requires_grad_(True)
    y = bin_(x)
    (y * t["ct"][rows]).sum().backward()
    out["bin"] = (y.detach(), x.grad, bin_.weight.grad, bin_.bias.grad,
                  bin_.gate.grad, bin_.running_mean.clone(),
                  bin_.running_var.clone())
    w = t["w"].clone().requires_grad_(True)
    b = t["b"].clone().requires_grad_(True)
    x = t["x"][rows].clone().requires_grad_(True)
    y = tb.AdaptiveBatchNorm()(x, w, b)
    (y * t["ct"][rows]).sum().backward()
    out["adabn"] = (y.detach(), x.grad, w.grad, b.grad)
    return out


def space_block_output(name, sg=None):
    """The port's block of case ``name`` (seeded) in training mode on the
    case's inputs: its output; inside a space group ``sg`` on this rank's
    rows of each feature map (the first rank takes the odd row)."""
    arrays, ints = _inputs(name)
    torch.manual_seed(0)
    block = CASES[name][1]()
    block.train()
    xs = []
    for a in arrays:
        t = torch.from_numpy(a)
        if sg is not None and t.dim() > 1:
            first = (t.shape[2] + 1) // 2
            t = t[:, :, :first] if sg.index == 0 else t[:, :, first:]
        xs.append(t)
    with torch.no_grad():
        return block(*xs, *ints)


def norm_rank(rank, world, device):
    from advchain_tpu_torch.ops import collectives
    from advchain_tpu_torch.parallel import make_mesh, make_spatial_mesh
    from advchain_tpu_torch.parallel.mesh import every_rank_group
    group = make_mesh(device_type=device).get_group("data")
    with collectives.data_group(group, GROUP_ROWS):
        out = norm_values(slice(rank * GROUP_ROWS, (rank + 1) * GROUP_ROWS))
    mesh = make_spatial_mesh(1, world, device_type=device)
    space = collectives.SpaceGroup(mesh.get_group("space"), world,
                                   mesh.get_local_rank("space"), mesh)
    out["space"] = {}
    for name in sorted(CASES):
        with collectives.data_group(mesh.get_group("data"),
                                    CASES[name][2][0][0], space=space,
                                    reduce_group=every_rank_group(mesh)):
            out["space"][name] = space_block_output(
                name, collectives.current_space())
    return out


@pytest.fixture(scope="module")
def norm_runs():
    return run_ranks(norm_rank, 2), norm_values()


@pytest.mark.parametrize("name", ["bin", "adabn"])
def test_norms_over_a_data_group_match_one_process(norm_runs, name):
    """On 2 ranks: each rank's rows of the outputs and input gradients,
    the parameter gradients summed over the ranks, and the running
    statistics (every rank's) against one process on the whole batch."""
    outs, dense = norm_runs
    ref = dense[name]
    got = [o[name] for o in outs]
    for i in (0, 1):  # rows: output, input gradient
        _close(torch.cat([g[i] for g in got]), ref[i], 1e-6)
    n_params = 3 if name == "bin" else 2
    for i in range(2, 2 + n_params):
        _close(sum(g[i] for g in got), ref[i], 1e-5)
    for i in range(2 + n_params, len(ref)):  # running statistics
        for g in got:
            _close(g[i], ref[i], 1e-6)


# ------------------------------------------------------------- the names
def test_models_all_matches_jax():
    """Every name of JAX's ``models.__all__`` but
    ``torch_unet_state_to_flax`` (convert.py says why)."""
    from advchain_tpu import models as jm
    missing = set(jm.__all__) - set(tm.__all__)
    assert missing == {"torch_unet_state_to_flax"}
    assert set(tb.__all__) == set(jb.__all__)
    for name in jm.__all__:
        if name != "torch_unet_state_to_flax":
            assert hasattr(tm, name), name


def test_blocks_refuse_a_space_group(norm_runs):
    """No block refuses a space group any more: on 2 ranks each block of
    ``CASES`` (the port's, seeded) runs inside a (1, 2) space group on its
    rank's rows of the input (split unevenly where the rows are odd), and
    its output rows in rank order (a replicated output: every rank's) are
    the dense block's within 1e-5 of the largest entry
    (tests/test_torch_space_blocks.py holds every block's gradients and
    statistics too)."""
    outs, _ = norm_runs
    for name in sorted(CASES):
        ref = space_block_output(name)
        got = [o["space"][name] for o in outs]
        if ref.dim() == 2:
            for g in got:
                _close(g, ref, 1e-5)
        else:
            _close(torch.cat(got, 2), ref, 1e-5)
