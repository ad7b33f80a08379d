"""The port's UNet against the JAX package's Flax UNet_16, with the Flax
weights carried across by flax_unet_to_torch_state."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from advchain_tpu.models import SegmentationModel as JaxModel
from advchain_tpu.models import UNet as FlaxUNet

from advchain_tpu_torch.models import (SegmentationModel, UNet,
                                       flax_unet_to_torch_state)
import torch_threads  # noqa: F401  (one intra-op thread a process)


def _flax_model(seed=0, shape=(2, 1, 64, 64)):
    model = JaxModel.create(FlaxUNet(input_channel=1, num_classes=4,
                                     feature_scale=4), shape,
                            rng=jax.random.PRNGKey(seed))
    # running statistics away from their (0, 1) init so eval mode is tested
    r = np.random.RandomState(seed)
    model.batch_stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)
                              if a.ndim else a), model.batch_stats)
    return model


def carried_model(jmodel, device="cpu"):
    """The port's UNet_16 with the JAX model's weights."""
    state = flax_unet_to_torch_state(
        jax.tree_util.tree_map(np.asarray, jmodel.params),
        jax.tree_util.tree_map(np.asarray, jmodel.batch_stats))
    module = UNet(input_channel=1, num_classes=4, feature_scale=4)
    module.load_state_dict(state)
    return SegmentationModel(module.to(device))


@pytest.mark.parametrize("train", [True, False])
def test_unet16_logits_match_flax(train):
    jmodel = _flax_model()
    tmodel = carried_model(jmodel)
    x = np.random.RandomState(1).rand(2, 1, 64, 64).astype(np.float32)
    ref = jmodel.apply_fixed(jnp.asarray(x), jmodel._episode_rng,
                             train=train)
    with torch.no_grad():
        ours = tmodel.apply_fixed(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def test_train_mode_leaves_running_stats_untouched():
    tmodel = carried_model(_flax_model(2))
    before = {k: v.clone() for k, v in tmodel.module.state_dict().items()}
    tmodel.train()
    tmodel(torch.rand(2, 1, 32, 32))
    for k, v in tmodel.module.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_state_dict_keys_follow_the_reference_names():
    keys = set(UNet(1, 4, 4).state_dict())
    for k in ("inc.conv.conv.0.weight", "inc.conv.conv.1.running_mean",
              "down1.mpconv.1.conv.3.weight", "up4.conv.conv.4.bias",
              "outc.conv.weight"):
        assert k in keys


def test_create_defaults_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentationModel.create(UNet(1, 4, 4))
    model = SegmentationModel.create(UNet(1, 4, 4), seed=3, device="cpu")
    assert model.device.type == "cpu" and model.training
