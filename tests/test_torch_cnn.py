"""The ImageNet towers against the JAX package (``care_tpu/models/cnn.py``):
ResNet-18 and ResNet-50 at 64 x 64 and InceptionResNetV2 at 96 x 96, as
``tests/test_cnn.py`` runs ``care_tpu``'s, each converted from the
torchvision / pretrainedmodels-named mirrors of
``tests/torch_cnn_mirror.py`` with randomized BatchNorm statistics.

Held: features and logits within ``care_tpu``'s own bounds against its
mirrors (2e-4 absolute and 1e-3 relative; InceptionResNetV2 5e-4
absolute); the port's converter equal, leaf for leaf, to ``params_from_jax``
/ ``variables_from_jax`` of ``care_tpu``'s conversion; the frozen
BatchNorm unmoved by ``train()``; the preprocessing equal.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.models import cnn as jax_cnn
from care_tpu_torch.models import cnn
from care_tpu_torch.models.weights import variables_from_jax

from test_cnn import _randomize_bn_stats
from test_torch_backbone_card import two_threads  # noqa: F401 (a fixture)
from torch_cnn_mirror import TorchInceptionResNetV2, TorchResNet

pytestmark = pytest.mark.usefixtures("two_threads")

CASES = [("resnet18", 64, False, 2e-4), ("resnet50", 64, True, 2e-4),
         ("inceptionresnetv2", 96, True, 5e-4)]


def _mirror(name, seed):
    torch.manual_seed(seed)
    tm = (TorchResNet(depth=int(name[6:])) if name.startswith("resnet")
          else TorchInceptionResNetV2())
    return {k: v.numpy() for k, v in _randomize_bn_stats(
        tm.eval(), seed=seed).state_dict().items()}


@pytest.mark.parametrize("name,side,logits,atol", CASES)
def test_tower_matches_jax(name, side, logits, atol):
    sd = _mirror(name, seed=1)
    jvars = jax_cnn.convert_cnn_state_dict(sd, name)
    x = np.random.RandomState(2).randn(2, side, side, 3).astype(np.float32)
    jmodel = jax_cnn.create_cnn(name)

    # the converter: the port's state dict is care_tpu's conversion carried
    # by variables_from_jax, exactly
    state = cnn.convert_cnn_state_dict(sd, name)
    model = cnn.create_cnn(name, torch.Generator().manual_seed(1),
                           with_logits=True)
    variables_from_jax(model, jvars)
    want_state = model.state_dict()
    assert sorted(state) == sorted(want_state)
    for k, v in state.items():
        assert torch.equal(v, want_state[k]), k
    # load_converted leaves the classifier out of a tower without one
    trunk = cnn.load_converted(
        cnn.create_cnn(name, torch.Generator().manual_seed(2)), state) \
        if name == "resnet18" else copy.deepcopy(model)
    head = "fc" if name.startswith("resnet") else "last_linear"
    setattr(trunk, head, None)

    # care_tpu's features; its logits are its Dense on them
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    dense = jvars["params"][head]
    heads = {False: (trunk, want),
             True: (model, want.astype(np.float64) @ dense["kernel"]
                    + dense["bias"])}
    for with_logits in {False, logits}:
        tower, expected = heads[with_logits]
        got = cnn.encode_images(tower.eval(), x, batch_size=1)
        assert got.shape == expected.shape
        np.testing.assert_allclose(got, expected, rtol=1e-3, atol=atol)
        # frozen BatchNorm: training mode normalises the same way and the
        # running statistics stay where they were
        before = {k: v.clone() for k, v in tower.state_dict().items()}
        with torch.no_grad():
            trained = tower.train()(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(trained, cnn.encode_images(
            tower.eval(), x, batch_size=2))
        for k, v in tower.state_dict().items():
            assert torch.equal(v, before[k]), k


def test_preprocess_matches_jax():
    imgs = (np.random.RandomState(3).rand(3, 100, 80, 3) * 255).astype(
        np.uint8)
    for name in ("resnet18", "inceptionresnetv2"):
        got = cnn.preprocess_cnn_images(imgs, name)
        side = cnn.CNN_SPECS[name][1]
        assert got.shape == (3, side, side, 3)
        np.testing.assert_array_equal(
            got, jax_cnn.preprocess_cnn_images(imgs, name))


def test_specs_match_jax():
    assert sorted(cnn.CNN_SPECS) == sorted(jax_cnn.CNN_SPECS)
    for name, spec in cnn.CNN_SPECS.items():
        assert spec[1:] == jax_cnn.CNN_SPECS[name][1:], name
    with pytest.raises(AssertionError, match="unknown CNN"):
        cnn.create_cnn("vgg19", torch.Generator())
