"""The port's utilities (advchain_tpu_torch.utils) against the JAX package's
on identical numpy inputs: the readers and ``load_image_label`` on files
the tests write, ``random_chain``, every RandAugment op and
``MyRandAugment``'s draws, checkpoints and the transform state, ``checked``,
the timers and trace, and the warped-grid plot.

Nearest sampling rounds half to even, so a geometric op in nearest mode is
held equal everywhere but at the pixels whose float64 source coordinate lies
within 1e-4 px of a half-integer (``nearest_tie_mask``), and the count of
those pixels is asserted small."""

import gzip
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import advchain_tpu.utils as jutils
from advchain_tpu.utils import vis as jvis

import advchain_tpu_torch.utils as tutils
from advchain_tpu_torch.utils import vis as tvis
from advchain_tpu_torch.utils.rand_augment import GEOMETRIC_OPS

from chip_smoke import (build_solver, cardiac_chain, make_image, make_labels,
                        nearest_tie_mask, recipe_volume, tensors_of,
                        train_parts, write_nifti, write_nrrd)
import torch_threads  # noqa: F401  (one intra-op thread a process)

TIE_TOL = 1e-4
TOL = 1e-6
# a sequence's ops on JAX's intermediates: Contrast's mean over the image
# reassociates (XLA's CPU reduction against PyTorch's), up to ~1e-6 at 32^2
TOL_SEQUENCE = 4e-6
# the 15 cases of tests/test_utils.py::test_apply_op_valid_output
OP_CASES = [
    ("Identity", 0.0), ("ShearX", 0.2), ("ShearY", -0.2),
    ("TranslateX", 10.0), ("TranslateY", -10.0), ("Rotate", 20.0),
    ("Brightness", 0.5), ("Color", 0.5), ("Contrast", -0.5),
    ("Sharpness", 0.9), ("Posterize", 4.0), ("Solarize", 128.0),
    ("AutoContrast", 0.0), ("Equalize", 0.0), ("Invert", 0.0)]


def test_utils_all_matches_jax():
    assert tutils.__all__ == jutils.__all__
    for name in tutils.__all__:
        assert hasattr(tutils, name)


# ----------------------------------------------------------------- readers
@pytest.mark.parametrize("dtype,encoding", [(np.int16, "gzip"),
                                            (np.float32, "raw"),
                                            (np.uint8, "gzip")])
def test_read_nrrd_like_jax(tmp_path, dtype, encoding):
    data = (np.random.RandomState(0).rand(3, 5, 4) * 100).astype(dtype)
    types = {np.int16: "short", np.float32: "float", np.uint8: "uchar"}
    header = (f"NRRD0004\ntype: {types[dtype]}\ndimension: 3\n"
              f"sizes: 4 5 3\nendian: little\nencoding: {encoding}\n\n")
    raw = data.tobytes()
    p = tmp_path / "t.nrrd"
    p.write_bytes(header.encode() + (gzip.compress(raw)
                                     if encoding == "gzip" else raw))
    ours, ref = tutils.read_nrrd(p), jutils.read_nrrd(p)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, data)


@pytest.mark.parametrize("name,dtype", [("t.nii", np.float32),
                                        ("t.nii.gz", np.int16)])
def test_read_nifti_like_jax(tmp_path, name, dtype):
    vol = (np.random.RandomState(1).rand(5, 6, 7) * 50).astype(dtype)
    p = tmp_path / name
    write_nifti(p, vol)
    ours, ref = tutils.read_nifti(p), jutils.read_nifti(p)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, vol)
    np.testing.assert_array_equal(tutils.read_medical_image(p),
                                  jutils.read_medical_image(p))


@pytest.mark.parametrize("fmt", ["nrrd", "nifti"])
@pytest.mark.parametrize("slice_id", [3, -1])
@pytest.mark.parametrize("with_label", [False, True])
def test_load_image_label_like_jax(tmp_path, fmt, slice_id, with_label):
    vol, label = recipe_volume((6, 40, 36), seed=2)
    write = write_nrrd if fmt == "nrrd" else write_nifti
    ext = ".nrrd" if fmt == "nrrd" else ".nii.gz"
    img_path, lbl_path = tmp_path / f"img{ext}", tmp_path / f"seg{ext}"
    write(img_path, vol)
    write(lbl_path, label)
    kw = dict(slice_id=slice_id, crop_size=(24, 20))
    args = (img_path, lbl_path) if with_label else (img_path,)
    ours, ref = tutils.load_image_label(*args, **kw), \
        jutils.load_image_label(*args, **kw)
    if not with_label:
        ours, ref = (ours,), (ref,)
    for a, b in zip(ours, ref):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert ours[0].shape == ((24, 20) if slice_id >= 0 else (6, 24, 20))


def test_check_dir_and_rescale_intensity(tmp_path):
    d = tmp_path / "made"
    assert tutils.check_dir(d) == jutils.check_dir(d) == -1
    assert tutils.check_dir(d, create=True) == -1 and d.exists()
    assert tutils.check_dir(d) == jutils.check_dir(d) == 1
    x = (np.random.RandomState(0).rand(2, 3, 8, 8) * 10 - 5).astype(
        np.float32)
    np.testing.assert_allclose(
        tutils.rescale_intensity(torch.from_numpy(x)).numpy(),
        np.asarray(jutils.rescale_intensity(jnp.asarray(x))), atol=TOL,
        rtol=0)


@pytest.mark.parametrize("with_sizes", [False, True])
def test_random_chain_draws_like_jax(with_sizes):
    items = ["noise", "bias", "morph", "affine"]
    sizes = [1, 2, 3, 4] if with_sizes else None
    for seed in range(20):
        kw = dict(max_length=3 if seed % 2 else None, size_list=sizes)
        ours = tutils.random_chain(items, rng=np.random.RandomState(seed),
                                   **kw)
        ref = jutils.random_chain(items, rng=np.random.RandomState(seed),
                                  **kw)
        assert ours == ref


# ------------------------------------------------------------ rand augment
def _hold(ours, ref, op, mag, interp, h, w, tol=TOL):
    """Equal to JAX's where nearest sampling has no tie, else within
    ``tol``; returns the count of differing pixels and of tie pixels."""
    ours = ours.numpy() if torch.is_tensor(ours) else ours
    ref = np.asarray(ref)
    diff = np.abs(ours - ref)
    if op in GEOMETRIC_OPS and interp == "nearest":
        ties = nearest_tie_mask(op, mag, h, w, TIE_TOL)
        wrong = diff > 0
        assert not (wrong & ~ties).any(), f"{op} {mag} differs off the ties"
        return int(wrong.sum()), int(ties.sum())
    assert diff.max() <= tol, f"{op} {mag} {interp}: {diff.max()}"
    return 0, 0


@pytest.mark.parametrize("fill", [None, 0.4, [0.25, 0.75]])
@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
@pytest.mark.parametrize("op,mag", OP_CASES)
def test_apply_op_like_jax(op, mag, interp, fill):
    r = np.random.RandomState(2)
    c = 2 if isinstance(fill, list) else 1
    x = r.rand(2, c, 16, 16).astype(np.float32)
    ours = tutils.apply_op(torch.from_numpy(x), op, mag, interp=interp,
                           fill=fill)
    ref = jutils.apply_op(jnp.asarray(x), op, mag, interp=interp, fill=fill)
    assert ours.shape == x.shape and ours.dtype == torch.float32
    _hold(ours, ref, op, mag, interp, 16, 16)


@pytest.mark.parametrize("op,mag", [("ShearX", 0.09), ("ShearY", -0.09),
                                    ("Rotate", 9.0), ("Rotate", -9.0),
                                    ("ShearX", -0.3)])
def test_apply_op_nearest_ties_at_192(op, mag):
    """At 192^2 and bin 9 the shears put rows y = 50, 150 on half-integers
    (bin 30, a shear of 0.3: every tenth row from y = 5) and the rotation a
    few pixels: equal off those ties; the ties are those rows, or under 1%
    of the image."""
    x = np.random.RandomState(3).rand(1, 1, 192, 192).astype(np.float32)
    ours = tutils.apply_op(torch.from_numpy(x), op, mag)
    ref = jutils.apply_op(jnp.asarray(x), op, mag)
    n_wrong, n_ties = _hold(ours, ref, op, mag, "nearest", 192, 192)
    rows = {0.09: 2, 0.3: 19}
    if op.startswith("Shear"):
        assert n_ties == rows[abs(mag)] * 192
    else:
        assert 0 < n_ties <= 0.01 * 192 * 192
    assert n_wrong <= n_ties


def test_apply_op_three_channels_like_jax():
    x = np.random.RandomState(4).rand(2, 3, 12, 12).astype(np.float32)
    for op, mag in (("Color", 0.81), ("Color", -0.81), ("Contrast", 0.81),
                    ("Contrast", -0.81), ("Equalize", 0.0),
                    ("Sharpness", -0.81)):
        _hold(tutils.apply_op(torch.from_numpy(x), op, mag),
              jutils.apply_op(jnp.asarray(x), op, mag), op, mag,
              "nearest", 12, 12)


def test_translate_leaves_exact_zero_columns():
    x = torch.linspace(0, 1, 256).reshape(1, 1, 16, 16)
    t = tutils.apply_op(x, "TranslateX", 3.0)
    assert torch.equal(t[..., 3:], x[..., :-3])
    assert torch.equal(t[..., :3], torch.zeros_like(t[..., :3]))
    t = tutils.apply_op(x, "TranslateY", -3.0, fill=0.5)
    assert torch.equal(t[..., :-3, :], x[..., 3:, :])
    assert bool((t[..., -3:, :] == 0.5).all())


def test_unknown_op_and_bad_fill_raise():
    with pytest.raises(ValueError):
        tutils.apply_op(torch.zeros(1, 1, 8, 8), "Sparkle", 1.0)
    with pytest.raises(ValueError):
        tutils.apply_op(torch.zeros(1, 2, 8, 8), "ShearX", 0.1,
                        fill=[0.1, 0.2, 0.3])


@pytest.mark.parametrize("interp", ["nearest", "bilinear"])
def test_my_rand_augment_like_jax(interp):
    """For 10 seeds: JAX's op sequence and magnitudes, each op of it equal
    to JAX's on JAX's input to that op (under the tie rule), the whole
    output equal where no op met a tie, and replay bit-equal."""
    x = np.random.RandomState(5).rand(2, 1, 32, 32).astype(np.float32)
    for seed in range(10):
        fill = 0.5 if seed % 3 == 0 else None
        ours = tutils.MyRandAugment(num_ops=2, magnitude=9, seed=seed,
                                    interpolation=interp, fill=fill)
        ref = jutils.MyRandAugment(num_ops=2, magnitude=9, seed=seed,
                                   interpolation=interp, fill=fill)
        y = ours(torch.from_numpy(x))
        y_ref = np.asarray(ref(jnp.asarray(x)))
        assert ours.op_sequence == ref.op_sequence
        assert (ours.op_name, ours.magnitude_state) == \
            (ref.op_name, ref.magnitude_state)
        step_in, n_wrong = jnp.asarray(x), 0
        for op, mag in ref.op_sequence:
            step_out = jutils.apply_op(step_in, op, mag, interp=interp,
                                       fill=fill)
            n_wrong += _hold(tutils.apply_op(
                torch.from_numpy(np.array(step_in)), op, mag,
                interp=interp, fill=fill), step_out, op, mag, interp,
                32, 32, TOL_SEQUENCE)[0]
            step_in = step_out
        if n_wrong == 0:
            np.testing.assert_allclose(y.numpy(), y_ref, atol=TOL_SEQUENCE,
                                       rtol=0)
        assert torch.equal(ours(torch.from_numpy(x), reuse_param=True), y)
        # a second draw advances both streams alike
        ours(torch.from_numpy(x))
        ref(jnp.asarray(x))
        assert ours.op_sequence == ref.op_sequence


# -------------------------------------------------------------- checkpoint
def _batch(n=2, shape=(32, 32)):
    return {"image": torch.as_tensor(make_image(n, shape)),
            "label": torch.as_tensor(make_labels(n, shape))}


def test_train_state_checkpoint_roundtrip_and_resume(tmp_path):
    """A TrainState after one adversarial step and its generator's state,
    saved and restored into fresh objects bit for bit (loadable with
    ``weights_only=True``); the next steps from both are identical on the
    CPU."""
    data = _batch()
    step, _, state = train_parts("cpu", 2, (32, 32), 0)
    gen = torch.Generator().manual_seed(1)
    state, _ = step(state, data, gen)
    path = tmp_path / "ckpt" / "state.pt"
    tutils.save_checkpoint(str(path), {"state": state,
                                       "generator": gen.get_state()})
    raw = torch.load(path, weights_only=True)
    assert raw["state"]["step"] == 1 and "module" in raw["state"]["model"]
    assert tutils.restore_checkpoint(str(path))["state"]["step"] == 1
    step2, _, state2 = train_parts("cpu", 2, (32, 32), 5)
    gen2 = torch.Generator().manual_seed(7)
    tree = tutils.restore_checkpoint(
        str(path), target={"state": state2, "generator": gen2.get_state()})
    assert tree["state"] is state2 and state2.step == 1
    gen2.set_state(tree["generator"])
    ours = tensors_of({"m": state.model.module.state_dict(),
                       "o": state.optimizer.state_dict(),
                       "g": gen.get_state(),
                       "e": state.model._episodes.get_state()})
    back = tensors_of({"m": state2.model.module.state_dict(),
                       "o": state2.optimizer.state_dict(),
                       "g": gen2.get_state(),
                       "e": state2.model._episodes.get_state()})
    assert ours.keys() == back.keys()
    for k in ours:
        assert torch.equal(ours[k], back[k]), k
    assert state2.model.episode_seed == state.model.episode_seed
    _, m1 = step(state, data, gen)
    _, m2 = step2(state2, data, gen2)
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k


def test_model_options_roundtrip(tmp_path):
    """Spectral ``u`` / ``sigma``, running statistics and the wrapper's
    flags and ``compute_dtype`` come back."""
    from advchain_tpu_torch.models import SegmentationModel, UNet
    a = SegmentationModel.create(UNet(1, 2, 16, spectral=True),
                                 seed=0, device="cpu",
                                 compute_dtype=torch.bfloat16)
    a.apply_train(torch.rand(2, 1, 16, 16))
    a.eval()
    a.adaptive_bn(True)
    b = SegmentationModel.create(UNet(1, 2, 16, spectral=True),
                                 seed=3, device="cpu")
    path = tutils.save_checkpoint(str(tmp_path / "m.pt"), a)
    tutils.restore_checkpoint(path, target=b)
    for k, v in a.module.state_dict().items():
        assert torch.equal(v, b.module.state_dict()[k]), k
    assert b.compute_dtype == torch.bfloat16 and not b.training \
        and b._adaptive_bn and b.episode_seed == a.episode_seed


def test_transform_state_checkpoint_roundtrip(tmp_path):
    solver = build_solver(2, (16, 16))
    for t in solver.chain_of_transforms:
        t.device = "cpu"
    solver.init_random_transformation()
    before = [p.clone() for p in solver.get_transformation_parameters()]
    path = tutils.save_transform_state(str(tmp_path / "tr.pt"), solver)
    assert set(torch.load(path, weights_only=True)) == {
        "0_noise", "1_bias", "2_affine", "3_morph"}
    solver.init_random_transformation()  # scramble
    assert not torch.equal(solver.chain_of_transforms[0].param, before[0])
    restored = build_solver(2, (16, 16))
    for t in restored.chain_of_transforms:
        t.device = "cpu"
    for s in (solver, restored):
        tutils.restore_transform_state(path, s)
        for p, q in zip(s.get_transformation_parameters(), before):
            assert torch.equal(p, q)
    # a transform saved without parameters is skipped on restore
    fresh = build_solver(2, (16, 16))
    empty = tutils.save_transform_state(str(tmp_path / "e.pt"), fresh)
    tutils.restore_transform_state(empty, solver)
    assert torch.equal(solver.chain_of_transforms[0].param, before[0])


# --------------------------------------------------------------- profiling
def test_checked_raises_on_nan_and_inf():
    safe = tutils.checked(torch.log)
    assert torch.isfinite(safe(torch.ones(3))).all()
    with pytest.raises(FloatingPointError):
        safe(torch.full((3,), -1.0))
    with pytest.raises(FloatingPointError):
        safe(torch.zeros(3))
    # the wrapper takes the JAX package's jit argument
    assert torch.equal(tutils.checked(torch.exp, jit=False)(torch.zeros(2)),
                       torch.ones(2))


def test_checked_passes_a_clean_episode():
    from advchain_tpu_torch.models import SegmentationModel, UNet
    solver = build_solver(2, (32, 32))
    model = SegmentationModel.create(UNet(1, 4, 4), seed=0, device="cpu")
    data = torch.as_tensor(make_image(2, (32, 32)))
    loss = tutils.checked(lambda x: solver.adversarial_training(
        x, model, n_iter=1, power_iteration="smart", step_sizes=1.0))(data)
    assert np.isfinite(float(loss))


def test_timer_benchmark_and_trace(tmp_path):
    f = torch.nn.functional.relu
    x = torch.randn(64, 64)
    with tutils.Timer() as t:
        t.sync(f(x), {"a": [x]})
    assert t.ms is not None and t.ms >= 0
    stats = tutils.benchmark(f, x, reps=3)
    assert stats["min_ms"] <= stats["mean_ms"] + 1e-9 and stats["reps"] == 3
    tutils.start_trace(str(tmp_path))
    with pytest.raises(RuntimeError):
        tutils.start_trace(str(tmp_path))
    with tutils.trace("my_region"):
        f(x)
    path = tutils.stop_trace()
    assert "my_region" in open(path).read()
    json.loads(open(path).read())
    with pytest.raises(RuntimeError):
        tutils.stop_trace()


# --------------------------------------------------------------------- vis
def test_plot_warped_grid_lines_like_jax():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    dvf = np.random.RandomState(6).uniform(-0.1, 0.1, (2, 20, 24)).astype(
        np.float32)
    bg = np.random.RandomState(7).rand(20, 24)
    fig, (a, b) = plt.subplots(1, 2)
    tvis.plot_warped_grid(torch.from_numpy(dvf), a, bg_img=bg, interval=4)
    jvis.plot_warped_grid(jnp.asarray(dvf), b, bg_img=bg, interval=4)
    assert len(a.lines) == len(b.lines) == 5 + 6
    for la, lb in zip(a.lines, b.lines):
        np.testing.assert_array_equal(la.get_xdata(), lb.get_xdata())
        np.testing.assert_array_equal(la.get_ydata(), lb.get_ydata())
    plt.close(fig)


def test_plots_take_tensors_and_draw(tmp_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    img = torch.rand(16, 16)
    fig, ax = plt.subplots(1, 4)
    tvis.plot_image(img, ax[0])
    tvis.plot_general(img > 0.5, ax[1], title="mask")
    tvis.plot_noise(img - 0.5, ax[2])
    tvis.plot_bias_field(img, ax[3])
    for a in ax:
        assert len(a.images) == 1
    np.testing.assert_array_equal(np.asarray(ax[0].images[0].get_array()),
                                  img.numpy())
    fig.savefig(tmp_path / "f.png")
    plt.close(fig)
    plt.figure()
    tvis.plot_image(img)  # the current pyplot axes
    plt.close("all")


def test_recipe_chain_order():
    """The cardiac-2D recipe's chain, in the example's order."""
    chain = cardiac_chain(2, (32, 32), device="cpu")
    assert [t.get_name() for t in chain] == ["noise", "bias", "morph",
                                             "affine"]
