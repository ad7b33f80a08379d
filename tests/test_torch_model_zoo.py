"""The port's model zoo against the JAX package's Flax one: the UNet's
options (encoder / decoder dropout, self-attention, spectral norm, the head
activation), UNetv2, DeeplySupervisedUNet, the wrapper's user-loop methods
and ``get_unet_model``, with the Flax weights (the spectral ``u`` and
``sigma`` included) carried across by the port's convert functions.

Dropout masks cannot match across frameworks, so in training mode JAX's
masks are read off its ``nn.Dropout`` calls (``nn.intercept_methods``) and
replayed in the port's :class:`EpisodeDropout` modules, call for call; the
masks' own properties are tested apart.  Logits are held to 1e-4, updated
statistics to 1e-5."""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from advchain_tpu import models as jm

from advchain_tpu_torch import models as tm
from advchain_tpu_torch.models.unet import EpisodeDropout, FrozenStatsBN
import torch_threads  # noqa: F401  (one intra-op thread a process)

N = 2


def _perturbed_stats(stats, seed):
    """Running statistics away from their (0, 1) init, so eval mode is
    tested; spectral ``u`` / ``sigma`` keep Flax's init."""
    r = np.random.RandomState(seed)

    def move(path, a):
        name = getattr(path[-1], "key", "")
        if name == "mean":
            return jnp.asarray(r.uniform(-0.5, 0.5, a.shape), jnp.float32)
        if name == "var":
            return jnp.asarray(r.uniform(0.5, 1.5, a.shape), jnp.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, stats)


def _flax(module, shape, seed=0):
    """The JAX model with random weights; a self-attention's ``gamma`` set
    to 0.7 so that the block changes the output (Flax inits it at 0)."""
    model = jm.SegmentationModel.create(module, shape,
                                        rng=jax.random.PRNGKey(seed))
    model.batch_stats = _perturbed_stats(model.batch_stats, seed)
    if "self_atn" in model.params:
        params = jax.tree_util.tree_map(lambda a: a, model.params)
        params["self_atn"]["gamma"] = jnp.full((1,), 0.7, jnp.float32)
        model.params = params
    return model


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jmodel, module, compute_dtype=None):
    module.load_state_dict(tm.flax_unet_to_torch_state(
        _np_tree(jmodel.params), _np_tree(jmodel.batch_stats)))
    return tm.SegmentationModel(module, compute_dtype=compute_dtype)


def _image(shape, seed=1):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_forward(jmodel, x, train, rng=None, **kwargs):
    """JAX's fixed-network forward (no write-back) and, in training mode,
    the masks of its dropout calls in call order, NCHW."""
    rng = jax.random.PRNGKey(5) if rng is None else rng
    masks = []

    def record(next_fun, args, kw, context):
        out = next_fun(*args, **kw)
        if isinstance(context.module, fnn.Dropout) and train:
            masks.append(np.moveaxis(np.asarray(out != 0), -1, 1))
        return out

    with fnn.intercept_methods(record):
        y = jmodel.module.apply(jmodel._variables(), jnp.asarray(x),
                                train=train, rngs={"dropout": rng},
                                mutable=False, **kwargs)
    return y, masks


def _replay(module, masks):
    """Hand JAX's masks, in call order, to the port's active dropouts."""
    queue = list(masks)

    def take(m, args):
        m._mask = torch.tensor(queue.pop(0))

    handles = [m.register_forward_pre_hook(take) for m in module.modules()
               if isinstance(m, EpisodeDropout) and m.p > 0 and masks]
    return queue, handles


def _port_forward(tmodel, x, train, masks, **kwargs):
    queue, handles = _replay(tmodel.module, masks if train else [])
    try:
        tmodel.module.train(train)
        with torch.no_grad():
            y = tmodel.module(torch.from_numpy(x), **kwargs)
    finally:
        for h in handles:
            h.remove()
    assert not queue, "the port ran fewer dropouts than JAX"
    return y


def _close(ours, ref, atol=1e-4):
    if isinstance(ref, (tuple, list)):
        assert len(ours) == len(ref)
        for a, b in zip(ours, ref):
            _close(a, b, atol)
        return
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


UNET_OPTIONS = {
    "plain": {},
    "encoder_dropout": {"encoder_dropout": 0.3},
    "decoder_dropout": {"decoder_dropout": 0.3},
    "self_attention": {"self_attention": True},
    "spectral": {"spectral": True},
    "softmax": {"last_layer_act": "softmax"},
    "sigmoid": {"last_layer_act": "sigmoid"},
    "all": {"encoder_dropout": 0.2, "decoder_dropout": 0.2,
            "self_attention": True, "spectral": True,
            "last_layer_act": "softmax"},
}
SHAPE = (N, 1, 32, 32)


def _unet_pair(opts, fs=16, seed=0, classes=3):
    jmodel = _flax(jm.UNet(input_channel=1, num_classes=classes,
                           feature_scale=fs, **opts), SHAPE, seed)
    tmodel = _carry(jmodel, tm.UNet(1, classes, fs, **opts))
    return jmodel, tmodel


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", list(UNET_OPTIONS))
def test_unet_option_logits_match_flax(case, train):
    jmodel, tmodel = _unet_pair(UNET_OPTIONS[case])
    x = _image(SHAPE)
    ref, masks = _jax_forward(jmodel, x, train)
    expected = {"encoder_dropout": 5, "decoder_dropout": 4, "all": 9}.get(
        case, 0)
    assert len(masks) == (expected if train else 0)
    _close(_port_forward(tmodel, x, train, masks), ref)


def test_unet_keeps_its_bottleneck_and_attention_map():
    jmodel, tmodel = _unet_pair({"self_attention": True})
    x = _image(SHAPE)
    _, state = jmodel.module.apply(jmodel._variables(), jnp.asarray(x),
                                   train=False, mutable=["intermediates"])
    sown = state["intermediates"]
    _port_forward(tmodel, x, False, [])
    hidden = np.moveaxis(np.asarray(sown["hidden_feature"][0]), -1, 1)
    _close(tmodel.module.hidden_feature, hidden, 1e-5)
    _close(tmodel.module.attention_map, sown["attention_map"][0], 1e-5)
    assert not tmodel.module.hidden_feature.requires_grad


def test_last_layer_act_rejects_others():
    with pytest.raises(NotImplementedError):
        tm.UNet(1, 4, 16, last_layer_act="tanh")


def _spectral_stats(module):
    return {k: v.clone() for k, v in module.state_dict().items()
            if k.endswith((".u", ".sigma"))}


def test_spectral_statistics_across_one_apply_train():
    """Frozen passes use the carried ``u`` and leave it and ``sigma``
    bit-equal; one ``apply_train`` writes both as Flax does (1e-5), and
    the logits before and after it match JAX's in both BN modes."""
    jmodel, tmodel = _unet_pair({"spectral": True})
    x = _image(SHAPE)
    carried = _spectral_stats(tmodel.module)
    for train in (True, False):
        _close(_port_forward(tmodel, x, train, []),
               _jax_forward(jmodel, x, train)[0])
    with torch.no_grad():
        tmodel(torch.from_numpy(x))
        tmodel.predict(torch.from_numpy(x))
    for k, v in _spectral_stats(tmodel.module).items():
        assert torch.equal(v, carried[k]), k
    ref, new_stats = jmodel.apply_train(jmodel.params, jmodel.batch_stats,
                                        jnp.asarray(x),
                                        jax.random.PRNGKey(5))
    ours = tmodel.apply_train(torch.from_numpy(x))
    _close(ours, ref)
    want = tm.flax_unet_to_torch_state(_np_tree(jmodel.params),
                                       _np_tree(new_stats))
    state = tmodel.module.state_dict()
    moved = 0
    for k, v in want.items():
        if k.endswith((".u", ".sigma", "running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(),
                                       atol=1e-5, rtol=0, err_msg=k)
            moved += k.endswith(".u") and not torch.equal(state[k],
                                                          carried[k])
    assert moved == 18  # every spectral convolution's u moved
    jmodel.batch_stats = new_stats
    for train in (True, False):
        _close(_port_forward(tmodel, x, train, []),
               _jax_forward(jmodel, x, train)[0])


def test_carried_spectral_names():
    jmodel, tmodel = _unet_pair({"spectral": True, "self_attention": True})
    stats = jmodel.batch_stats["down2"]["conv"]["conv1_sn"]
    assert set(stats) == {"conv1/kernel/u", "conv1/kernel/sigma"}
    state = tmodel.module.state_dict()
    assert tuple(state["down2.mpconv.1.conv.0.u"].shape) == (1, 16)
    assert state["down2.mpconv.1.conv.0.sigma"].dim() == 0
    assert "self_atn.gamma" in state and "outc.conv.u" not in state


# ------------------------------------------------------ the other nets
OTHER_NETS = {
    "unetv2": (lambda: jm.UNetv2(1, 3, 16, encoder_dropout=0.2,
                                 decoder_dropout=0.2, self_attention=True),
               lambda: tm.UNetv2(1, 3, 16, encoder_dropout=0.2,
                                 decoder_dropout=0.2, self_attention=True),
               {}, 9),
    "dsv": (lambda: jm.DeeplySupervisedUNet(1, 3, base_n_filters=4,
                                            dropout=0.2),
            lambda: tm.DeeplySupervisedUNet(1, 3, base_n_filters=4,
                                            dropout=0.2), {}, 6),
    "dsv_multi_out": (lambda: jm.DeeplySupervisedUNet(
        1, 3, base_n_filters=4, dropout=0.2),
        lambda: tm.DeeplySupervisedUNet(1, 3, base_n_filters=4,
                                        dropout=0.2),
        {"multi_out": True}, 6),
}


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("net", list(OTHER_NETS))
def test_other_nets_match_flax(net, train):
    make_j, make_t, kwargs, n_masks = OTHER_NETS[net]
    jmodel = _flax(make_j(), SHAPE)
    tmodel = _carry(jmodel, make_t())
    x = _image(SHAPE)
    ref, masks = _jax_forward(jmodel, x, train, **kwargs)
    assert len(masks) == (n_masks if train else 0)
    ours = _port_forward(tmodel, x, train, masks, **kwargs)
    if kwargs:
        assert len(ours) == 3 and all(o.shape == (N, 3, 32, 32)
                                      for o in ours)
    _close(ours, ref)


def test_dsv_dropout_quirk_and_heads():
    """One rate on x3, x4 and x5 (a mask each) and on up1-up3, none on up4;
    the two deep-supervision heads by the reference's names."""
    module = tm.DeeplySupervisedUNet(1, 3, base_n_filters=4, dropout=0.2)
    rates = {n: m.p for n, m in module.named_modules()
             if isinstance(m, EpisodeDropout)}
    assert {n for n, p in rates.items() if p} == {
        "drop3", "drop4", "drop5", "up1.drop", "up2.drop", "up3.drop"}
    assert rates["up4.drop"] == 0.0
    keys = module.state_dict()
    assert "up2_conv1.conv.weight" in keys and "up3_conv1.conv.weight" in keys


# ------------------------------------------------------ dropout masks
def test_episode_dropout_mask_properties():
    drop = EpisodeDropout(0.3).train()
    drop.redraw(11)
    x = torch.rand(4, 8, 64, 64) + 0.5
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert torch.equal(drop(x), y)           # fixed within the episode
    drop.redraw(12)
    assert not torch.equal(drop(x) != 0, kept)  # a new episode redraws
    assert torch.equal(drop.eval()(x), x)


def test_wrapper_episode_masks_fixed_until_begin_episode():
    model = tm.SegmentationModel(tm.UNet(1, 3, 16, encoder_dropout=0.5,
                                         decoder_dropout=0.5))
    x = torch.from_numpy(_image((N, 1, 32, 32)))
    with torch.no_grad():
        first, again = model(x), model(x)
        model.begin_episode()
        other = model(x)
    assert torch.equal(first, again)
    assert not torch.allclose(first, other)


# ------------------------------------------------ wrapper methods vs JAX
def _param_names(jmodel, module):
    """{torch parameter name: Flax path} through the convert function:
    every Flax leaf filled with its own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(jmodel.params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(a), i, np.float32)
                  for i, (_, a) in enumerate(leaves)])
    state = tm.flax_unet_to_torch_state(ids, _np_tree(jmodel.batch_stats))
    paths = ["/".join(getattr(k, "key", str(k)) for k in p)
             for p, _ in leaves]
    return {n: paths[int(state[n].reshape(-1)[0])]
            for n, _ in module.named_parameters()}


def _by_path(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(getattr(k, "key", str(k)) for k in p): v
            for p, v in leaves}


def test_masks_partition_like_jax():
    opts = {"self_attention": True, "spectral": True}
    jmodel, tmodel = _unet_pair(opts)
    names = _param_names(jmodel, tmodel.module)
    assert len(set(names.values())) == len(names) == len(
        jax.tree_util.tree_leaves(jmodel.params))
    pairs = [(tmodel.fix_conv_params_mask(), jmodel.fix_conv_params_mask()),
             (tmodel.activate_conv_params_mask(),
              jmodel.activate_conv_params_mask()),
             (tmodel.fix_params_mask(("outc", "up4")),
              jmodel.fix_params_mask(("outc", "up4"))),
             *zip(tmodel.lr_group_masks(("outc", "self")),
                  jmodel.lr_group_masks(("outc", "self")))]
    for ours, ref in pairs:
        ref = {k: bool(v) for k, v in _by_path(ref).items()}
        assert {names[n]: v for n, v in ours.items()} == ref
    frozen = {n for n, v in tmodel.fix_conv_params_mask().items() if not v}
    assert "self_atn.gamma" not in frozen and "inc.conv.conv.1.weight" \
        not in frozen and "self_atn.query_conv.weight" in frozen


def test_optim_parameters_lr_groups_like_jax():
    """One SGD step on unit gradients: the body moves by lr, the head by
    10 lr, in both packages."""
    jmodel, tmodel = _unet_pair({})
    names = _param_names(jmodel, tmodel.module)
    lr = 0.01
    tx = jmodel.optim_parameters(lr)
    ones = jax.tree_util.tree_map(jnp.ones_like, jmodel.params)
    updates, _ = tx.update(ones, tx.init(jmodel.params), jmodel.params)
    ref = _by_path(jax.tree_util.tree_map(
        lambda u: float(np.asarray(u).reshape(-1)[0]), updates))
    opt = tmodel.optim_parameters(lr)
    assert isinstance(opt, torch.optim.SGD)
    assert [g["lr"] for g in opt.param_groups] == [lr, 10 * lr]
    before = {n: p.detach().clone()
              for n, p in tmodel.module.named_parameters()}
    for p in tmodel.module.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for n, p in tmodel.module.named_parameters():
        delta = (p.detach() - before[n]).reshape(-1)
        assert torch.allclose(delta, torch.full_like(delta, ref[names[n]]),
                              atol=1e-7), n
    adam = tmodel.optim_parameters(lr, torch.optim.Adam, ("outc", "up4"))
    assert isinstance(adam, torch.optim.Adam)
    assert len(adam.param_groups[1]["params"]) == 10


def test_predict_adaptive_bn_and_init_bn_like_jax():
    """``predict``: running statistics, no dropout.  ``adaptive_bn``: the
    solver's forward writes the batch statistics (and spectral ``u`` /
    ``sigma``) back, as JAX's eager call does.  ``init_bn``: (0, 1)."""
    opts = {"spectral": True, "encoder_dropout": 0.2}
    jmodel, tmodel = _unet_pair(opts)
    x = _image(SHAPE)
    _close(tmodel.predict(torch.from_numpy(x)),
           jmodel.predict(jnp.asarray(x)))
    jmodel.adaptive_bn(True)
    tmodel.adaptive_bn(True)
    rng = jax.random.PRNGKey(5)
    jmodel.begin_episode(rng)
    _, masks = _jax_forward(jmodel, x, True, rng)
    ref = jmodel(jnp.asarray(x))
    queue, handles = _replay(tmodel.module, masks)
    with torch.no_grad():
        ours = tmodel(torch.from_numpy(x))
    for h in handles:
        h.remove()
    assert not queue
    _close(ours, ref)
    want = tm.flax_unet_to_torch_state(_np_tree(jmodel.params),
                                       _np_tree(jmodel.batch_stats))
    state = tmodel.module.state_dict()
    for k in want:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(),
                                   atol=1e-5, rtol=0, err_msg=k)
    jmodel.adaptive_bn(False)
    tmodel.adaptive_bn(False)
    before = {k: v.clone() for k, v in tmodel.module.state_dict().items()}
    with torch.no_grad():
        tmodel(torch.from_numpy(x))
    assert all(torch.equal(v, before[k])
               for k, v in tmodel.module.state_dict().items())
    jmodel.init_bn()
    tmodel.init_bn()
    want = tm.flax_unet_to_torch_state(_np_tree(jmodel.params),
                                       _np_tree(jmodel.batch_stats))
    for k, v in tmodel.module.state_dict().items():
        exact = "running" in k or "num_batches" in k
        torch.testing.assert_close(v, want[k], atol=0 if exact else 1e-5,
                                   rtol=0, msg=k)


def test_replace_like_jax():
    jmodel, tmodel = _unet_pair({"decoder_dropout": 0.2})
    jnew = _flax(jm.UNet(1, 3, 16, decoder_dropout=0.2), SHAPE, seed=3)
    tmodel.eval()
    tmodel.compute_dtype = torch.bfloat16
    seed = tmodel.episode_seed
    new = tmodel.replace(tm.flax_unet_to_torch_state(
        _np_tree(jnew.params), _np_tree(jnew.batch_stats)))
    jrep = jmodel.replace(jnew.params, jnew.batch_stats)
    assert new.module is not tmodel.module and new.training \
        and jrep.training and new.compute_dtype is None
    assert new.episode_seed == seed
    x = _image(SHAPE)
    _close(new.predict(torch.from_numpy(x)), jrep.predict(jnp.asarray(x)))
    # the old wrapper keeps its weights; both draw the same next seeds
    assert not torch.equal(new.module.outc.conv.weight,
                           tmodel.module.outc.conv.weight)
    tmodel.begin_episode()
    new.begin_episode()
    assert new.episode_seed == tmodel.episode_seed != seed
    new.use_batch_stats_in_solver = False
    assert not new.training and not new.use_batch_stats_in_solver


# --------------------------------------------------------- get_unet_model
@pytest.mark.parametrize("arch,fs", [("UNet_16", 4), ("UNet_64", 1)])
def test_get_unet_model_like_jax(tmp_path, arch, fs):
    module = tm.UNet(1, 4, fs)
    module.init_weights_(torch.Generator().manual_seed(2))
    r = np.random.RandomState(2)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, FrozenStatsBN):
                m.running_mean.copy_(torch.from_numpy(
                    r.uniform(-0.5, 0.5, m.num_features).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    r.uniform(0.5, 1.5, m.num_features).astype(np.float32)))
    path = tmp_path / f"{arch}.pth"
    torch.save(module.state_dict(), path)
    ref = jm.get_unet_model(str(path), num_classes=4, model_arch=arch)
    ours = tm.get_unet_model(str(path), num_classes=4, device="cpu",
                             model_arch=arch)
    assert ours.device.type == "cpu" and ours.compute_dtype is None
    x = _image((N, 1, 32, 32))
    _close(ours.predict(torch.from_numpy(x)), ref.predict(jnp.asarray(x)))
    with torch.no_grad():
        _close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)))
    bf16 = tm.get_unet_model(str(path), num_classes=4, device="cpu",
                             model_arch=arch, compute_dtype=torch.bfloat16)
    assert bf16.compute_dtype is torch.bfloat16


def test_get_unet_model_refuses(tmp_path):
    path = tmp_path / "m.pth"
    torch.save(tm.UNet(1, 2, 4).state_dict(), path)
    with pytest.raises(NotImplementedError):
        tm.get_unet_model(str(path), device="cpu", model_arch="UNet_32")
    with pytest.raises(FileNotFoundError):
        tm.get_unet_model(str(tmp_path / "absent.pth"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.get_unet_model(str(path))


def test_aliases():
    assert tm.TorchBatchNorm is FrozenStatsBN
    conv = tm.ZDecomposedConv3d(2, 5)
    assert isinstance(conv, torch.nn.Conv3d)
    assert conv.kernel_size == (3, 3, 3) and conv.padding == (1, 1, 1)
    assert tm.flax_unetv2_to_torch_state is tm.flax_unet_to_torch_state
