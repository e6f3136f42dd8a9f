"""ImageNet CNN towers: torchvision-style ResNets and InceptionResNetV2.

Port of ``care_tpu/models/cnn.py`` (reference
``pretreatment/extract_image_feats_from_frames.py`` and
``models/Backbone.py:27-33``): per-frame image features, optionally the
classifier's logits, and the in-model backbones of ``with_backbones``.

The towers take NHWC normalized images, as ``care_tpu``'s do, and compute
in NCHW on ``F.conv2d``. Submodules carry the flax tree's names (``stem``,
``layer1_0.conv1.conv``, ``mixed_5b.branch1_0``, ``repeat_1_3.conv2d``,
...). Every BatchNorm is frozen (``FlaxBatchNorm(frozen=True)``: the
running statistics whatever ``train()`` says, as ``care_tpu``'s
``use_running_average=True``). Padding is explicit and symmetric, as
``care_tpu``'s ``ConvBN`` and pools give it; max pooling pads with -inf and
the InceptionResNetV2 branch pool divides by the count of valid elements.
Weights come from local torch state dicts (torchvision / pretrainedmodels
naming) through ``convert_cnn_state_dict``; nothing is downloaded.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch.models.common import (Dense, FlaxBatchNorm,
                                          encode_in_chunks, flax_init_)


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _conv(cin: int, cout: int, kernel, stride, padding, bias: bool,
          generator: torch.Generator) -> nn.Conv2d:
    return flax_init_(nn.Conv2d(cin, cout, _pair(kernel), _pair(stride),
                                _pair(padding), bias=bias), generator)


class ConvBN(nn.Module):
    """Bias-free conv + frozen BatchNorm + optional ReLU (torchvision's
    conv/bn pairs, pretrainedmodels' ``BasicConv2d``)."""

    def __init__(self, cin: int, features: int, kernel, stride=1, padding=0,
                 eps: float = 1e-5, act: bool = True,
                 generator: torch.Generator = None):
        super().__init__()
        self.conv = _conv(cin, features, kernel, stride, padding, False,
                          generator)
        self.bn = FlaxBatchNorm(features, eps=eps, frozen=True)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return torch.relu(x) if self.act else x


def _max_pool(x, k=3, s=2, p=0):
    return F.max_pool2d(x, k, s, p)


def _avg_pool_excl_pad(x, k=3, s=1, p=1):
    """AvgPool2d(count_include_pad=False): window sum / valid count."""
    return F.avg_pool2d(x, k, s, p, count_include_pad=False)


# ---------------------------------------------------------------------------
# ResNet (torchvision semantics: the stride on Bottleneck's 3x3 conv)
# ---------------------------------------------------------------------------

class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, stride, downsample, generator):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 3, stride, 1, generator=generator)
        self.conv2 = ConvBN(planes, planes, 3, 1, 1, act=False,
                            generator=generator)
        self.downsample = (ConvBN(cin, planes, 1, stride, 0, act=False,
                                  generator=generator)
                           if downsample else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv2(self.conv1(x)) + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, stride, downsample, generator):
        super().__init__()
        self.conv1 = ConvBN(cin, planes, 1, 1, 0, generator=generator)
        self.conv2 = ConvBN(planes, planes, 3, stride, 1, generator=generator)
        self.conv3 = ConvBN(planes, planes * 4, 1, 1, 0, act=False,
                            generator=generator)
        self.downsample = (ConvBN(cin, planes * 4, 1, stride, 0, act=False,
                                  generator=generator)
                           if downsample else None)

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        return torch.relu(self.conv3(self.conv2(self.conv1(x))) + idt)


RESNET_CFGS = {
    18: (BasicBlock, [2, 2, 2, 2]),
    34: (BasicBlock, [3, 4, 6, 3]),
    50: (Bottleneck, [3, 4, 6, 3]),
    101: (Bottleneck, [3, 4, 23, 3]),
    152: (Bottleneck, [3, 8, 36, 3]),
}


class ResNet(nn.Module):
    """images [B, H, W, 3] (normalized) -> pooled features [B, 512 *
    expansion], or with ``with_logits`` the ImageNet logits (the ``fc``
    head exists only then, as flax creates it only when it runs)."""

    def __init__(self, depth: int = 101, num_classes: int = 1000,
                 with_logits: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        if generator is None:
            raise ValueError("ResNet needs a torch.Generator")
        block, layers = RESNET_CFGS[depth]
        self.stem = ConvBN(3, 64, 7, 2, 3, generator=generator)
        self.block_names = []
        planes, inplanes = 64, 64
        for li, n_blocks in enumerate(layers):
            stride = 1 if li == 0 else 2
            for b in range(n_blocks):
                ds = b == 0 and (stride != 1
                                 or inplanes != planes * block.expansion)
                name = f"layer{li + 1}_{b}"
                self.add_module(name, block(inplanes, planes,
                                            stride if b == 0 else 1, ds,
                                            generator))
                self.block_names.append(name)
                inplanes = planes * block.expansion
            planes *= 2
        self.fc = (flax_init_(Dense(inplanes, num_classes), generator)
                   if with_logits else None)

    def forward(self, images):
        x = _max_pool(self.stem(images.permute(0, 3, 1, 2)), 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        feats = x.mean(dim=(2, 3))
        return feats if self.fc is None else self.fc(feats)


# ---------------------------------------------------------------------------
# InceptionResNetV2 (pretrainedmodels semantics; BN eps 1e-3)
# ---------------------------------------------------------------------------

def _bc(cin, features, kernel, stride=1, padding=0, generator=None):
    return ConvBN(cin, features, kernel, stride, padding, eps=1e-3,
                  generator=generator)


class _Branches(nn.Module):
    """Named chains of ``_bc`` convs, each ``name: [(cin, cout, kernel,
    stride, padding), ...]`` registered as ``name_0``, ``name_1``, ...
    (or ``name`` for a chain of one)."""

    def __init__(self, chains: dict, generator):
        super().__init__()
        self.chains = {}
        for name, convs in chains.items():
            names = ([name] if len(convs) == 1 else
                     [f"{name}_{j}" for j in range(len(convs))])
            for n, spec in zip(names, convs):
                self.add_module(n, _bc(*spec, generator=generator))
            self.chains[name] = names

    def branch(self, name, x):
        for n in self.chains[name]:
            x = getattr(self, n)(x)
        return x


class Mixed5b(_Branches):
    def __init__(self, generator):
        super().__init__({
            "branch0": [(192, 96, 1)],
            "branch1": [(192, 48, 1), (48, 64, 5, 1, 2)],
            "branch2": [(192, 64, 1), (64, 96, 3, 1, 1), (96, 96, 3, 1, 1)],
        }, generator)
        self.branch3_1 = _bc(192, 64, 1, generator=generator)

    def forward(self, x):
        return torch.cat([self.branch("branch0", x), self.branch("branch1", x),
                          self.branch("branch2", x),
                          self.branch3_1(_avg_pool_excl_pad(x))], dim=1)


class _Residual(_Branches):
    """A residual Inception block: branches concatenated, a biased 1x1
    ``conv2d`` back to ``width``, ``x + scale * y``, then ReLU unless
    ``no_relu``."""

    def __init__(self, chains, width, scale, no_relu, generator):
        super().__init__(chains, generator)
        cat = sum(convs[-1][1] for convs in chains.values())
        self.conv2d = _conv(cat, width, 1, 1, 0, True, generator)
        self.scale, self.no_relu = scale, no_relu

    def forward(self, x):
        y = torch.cat([self.branch(n, x) for n in self.chains], dim=1)
        y = x + self.scale * self.conv2d(y)
        return y if self.no_relu else torch.relu(y)


def Block35(generator, scale=0.17):
    return _Residual({
        "branch0": [(320, 32, 1)],
        "branch1": [(320, 32, 1), (32, 32, 3, 1, 1)],
        "branch2": [(320, 32, 1), (32, 48, 3, 1, 1), (48, 64, 3, 1, 1)],
    }, 320, scale, False, generator)


def Block17(generator, scale=0.10):
    return _Residual({
        "branch0": [(1088, 192, 1)],
        "branch1": [(1088, 128, 1), (128, 160, (1, 7), 1, (0, 3)),
                    (160, 192, (7, 1), 1, (3, 0))],
    }, 1088, scale, False, generator)


def Block8(generator, scale=0.20, no_relu=False):
    return _Residual({
        "branch0": [(2080, 192, 1)],
        "branch1": [(2080, 192, 1), (192, 224, (1, 3), 1, (0, 1)),
                    (224, 256, (3, 1), 1, (1, 0))],
    }, 2080, scale, no_relu, generator)


class Mixed6a(_Branches):
    def __init__(self, generator):
        super().__init__({
            "branch0": [(320, 384, 3, 2)],
            "branch1": [(320, 256, 1), (256, 256, 3, 1, 1),
                        (256, 384, 3, 2)],
        }, generator)

    def forward(self, x):
        return torch.cat([self.branch("branch0", x), self.branch("branch1", x),
                          _max_pool(x, 3, 2, 0)], dim=1)


class Mixed7a(_Branches):
    def __init__(self, generator):
        super().__init__({
            "branch0": [(1088, 256, 1), (256, 384, 3, 2)],
            "branch1": [(1088, 256, 1), (256, 288, 3, 2)],
            "branch2": [(1088, 256, 1), (256, 288, 3, 1, 1),
                        (288, 320, 3, 2)],
        }, generator)

    def forward(self, x):
        return torch.cat([self.branch(n, x) for n in self.chains]
                         + [_max_pool(x, 3, 2, 0)], dim=1)


class InceptionResNetV2(nn.Module):
    """images [B, H, W, 3] -> pooled features [B, 1536], or with
    ``with_logits`` the 1001-way (ImageNet + background) logits of
    ``last_linear``."""

    def __init__(self, num_classes: int = 1001, with_logits: bool = False,
                 generator: torch.Generator = None):
        super().__init__()
        if generator is None:
            raise ValueError("InceptionResNetV2 needs a torch.Generator")
        g = generator
        self.conv2d_1a = _bc(3, 32, 3, 2, generator=g)
        self.conv2d_2a = _bc(32, 32, 3, generator=g)
        self.conv2d_2b = _bc(32, 64, 3, padding=1, generator=g)
        self.conv2d_3b = _bc(64, 80, 1, generator=g)
        self.conv2d_4a = _bc(80, 192, 3, generator=g)
        self.mixed_5b = Mixed5b(g)
        self.blocks = ([f"repeat_{i}" for i in range(10)] + ["mixed_6a"]
                       + [f"repeat_1_{i}" for i in range(20)] + ["mixed_7a"]
                       + [f"repeat_2_{i}" for i in range(9)] + ["block8"])
        for name in self.blocks:
            if name == "mixed_6a":
                block = Mixed6a(g)
            elif name == "mixed_7a":
                block = Mixed7a(g)
            elif name == "block8":
                block = Block8(g, scale=1.0, no_relu=True)
            elif name.startswith("repeat_1_"):
                block = Block17(g)
            elif name.startswith("repeat_2_"):
                block = Block8(g)
            else:
                block = Block35(g)
            self.add_module(name, block)
        self.conv2d_7b = _bc(2080, 1536, 1, generator=g)
        self.last_linear = (flax_init_(Dense(1536, num_classes), g)
                            if with_logits else None)

    def forward(self, images):
        x = images.permute(0, 3, 1, 2)
        x = self.conv2d_2b(self.conv2d_2a(self.conv2d_1a(x)))
        x = self.conv2d_4a(self.conv2d_3b(_max_pool(x, 3, 2, 0)))
        x = self.mixed_5b(_max_pool(x, 3, 2, 0))
        for name in self.blocks:
            x = getattr(self, name)(x)
        feats = self.conv2d_7b(x).mean(dim=(2, 3))  # avgpool_1a at 299
        return (feats if self.last_linear is None
                else self.last_linear(feats))


# ---------------------------------------------------------------------------
# torch state-dict conversion (torchvision / pretrainedmodels naming)
# ---------------------------------------------------------------------------

class _StateBuilder:
    """The port's state dict from a torch one: conv weights keep torch's
    layout, BatchNorm ``weight`` / ``bias`` / ``running_*`` become the
    frozen BN's ``scale`` / ``bias`` / ``mean`` / ``var``."""

    def __init__(self, sd):
        self.sd = {k: np.asarray(v, dtype=np.float32) for k, v in sd.items()
                   if np.asarray(v).dtype.kind == "f"}
        self.out = {}

    def convbn(self, port, conv_key, bn_key=None):
        bn_key = bn_key or conv_key
        self.out[port + ".conv.weight"] = self.sd[conv_key + ".weight"]
        for leaf, key in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            self.out[f"{port}.bn.{leaf}"] = self.sd[f"{bn_key}.{key}"]

    def layer(self, port, key):
        """A biased conv or a Linear: weight and bias as they are."""
        self.out[port + ".weight"] = self.sd[key + ".weight"]
        self.out[port + ".bias"] = self.sd[key + ".bias"]

    def state(self) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.out.items()}


def convert_torch_resnet_state_dict(sd: Dict[str, Any],
                                    depth: int) -> Dict[str, torch.Tensor]:
    """torchvision / pretrainedmodels ResNet state dict -> the port's
    ``ResNet`` state dict (``fc`` when the state dict has a classifier)."""
    tb = _StateBuilder(sd)
    tb.convbn("stem", "conv1", "bn1")
    block, layers = RESNET_CFGS[depth]
    n_convs = 2 if block is BasicBlock else 3
    for li, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            pre, port = f"layer{li + 1}.{b}", f"layer{li + 1}_{b}"
            for c in range(1, n_convs + 1):
                tb.convbn(f"{port}.conv{c}", f"{pre}.conv{c}", f"{pre}.bn{c}")
            if f"{pre}.downsample.0.weight" in tb.sd:
                tb.convbn(f"{port}.downsample", f"{pre}.downsample.0",
                          f"{pre}.downsample.1")
    fc = "fc" if "fc.weight" in tb.sd else "last_linear"
    if fc + ".weight" in tb.sd:
        tb.layer("fc", fc)
    return tb.state()


def convert_torch_inceptionresnetv2_state_dict(
        sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """pretrainedmodels InceptionResNetV2 state dict -> the port's
    ``InceptionResNetV2`` state dict."""
    tb = _StateBuilder(sd)

    def bc(port, key):
        tb.convbn(port, key + ".conv", key + ".bn")

    def chains(port_block, torch_block, sizes):
        for b, n in sizes:
            if n == 0:
                bc(f"{port_block}.{b}", f"{torch_block}.{b}")
            for j in range(n):
                bc(f"{port_block}.{b}_{j}", f"{torch_block}.{b}.{j}")

    for name in ("conv2d_1a", "conv2d_2a", "conv2d_2b", "conv2d_3b",
                 "conv2d_4a", "conv2d_7b"):
        bc(name, name)
    # mixed_5b's branch3 holds (AvgPool, BasicConv2d): torch key branch3.1
    chains("mixed_5b", "mixed_5b", [("branch0", 0), ("branch1", 2),
                                    ("branch2", 3)])
    bc("mixed_5b.branch3_1", "mixed_5b.branch3.1")
    for i in range(10):
        chains(f"repeat_{i}", f"repeat.{i}",
               [("branch0", 0), ("branch1", 2), ("branch2", 3)])
        tb.layer(f"repeat_{i}.conv2d", f"repeat.{i}.conv2d")
    chains("mixed_6a", "mixed_6a", [("branch0", 0), ("branch1", 3)])
    for i in range(20):
        chains(f"repeat_1_{i}", f"repeat_1.{i}",
               [("branch0", 0), ("branch1", 3)])
        tb.layer(f"repeat_1_{i}.conv2d", f"repeat_1.{i}.conv2d")
    chains("mixed_7a", "mixed_7a", [("branch0", 2), ("branch1", 2),
                                    ("branch2", 3)])
    for i in range(9):
        chains(f"repeat_2_{i}", f"repeat_2.{i}",
               [("branch0", 0), ("branch1", 3)])
        tb.layer(f"repeat_2_{i}.conv2d", f"repeat_2.{i}.conv2d")
    chains("block8", "block8", [("branch0", 0), ("branch1", 3)])
    tb.layer("block8.conv2d", "block8.conv2d")
    if "last_linear.weight" in tb.sd:
        tb.layer("last_linear", "last_linear")
    return tb.state()


# ---------------------------------------------------------------------------
# factory, preprocessing, batched extraction
# ---------------------------------------------------------------------------

def _resnet(depth: int):
    return lambda g, logits: ResNet(depth=depth, with_logits=logits,
                                    generator=g)


_IMAGENET = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))
CNN_SPECS = {
    # name -> (constructor(generator, with_logits), input size, mean, std,
    # feature dim)
    **{f"resnet{d}": (_resnet(d), 224, *_IMAGENET, 512 if d < 50 else 2048)
       for d in (18, 34, 50, 101, 152)},
    "inceptionresnetv2": (
        lambda g, logits: InceptionResNetV2(with_logits=logits, generator=g),
        299, (0.5, 0.5, 0.5), (0.5, 0.5, 0.5), 1536),
}


def create_cnn(name: str, generator: torch.Generator,
               with_logits: bool = False) -> nn.Module:
    assert name in CNN_SPECS, \
        f"unknown CNN `{name}` (have {sorted(CNN_SPECS)})"
    return CNN_SPECS[name][0](generator, with_logits)


def convert_cnn_state_dict(sd: Dict[str, Any],
                           name: str) -> Dict[str, torch.Tensor]:
    if name.startswith("resnet"):
        return convert_torch_resnet_state_dict(sd, int(name[6:]))
    return convert_torch_inceptionresnetv2_state_dict(sd)


def load_converted(model: nn.Module, state: Dict[str, torch.Tensor]):
    """Load a converted state dict into ``model`` strictly, leaving out
    the classifier when the model has none (``care_tpu``'s flax model
    ignores the converted head then)."""
    own = model.state_dict()
    state = {k: v for k, v in state.items() if k in own
             or not k.startswith(("fc.", "last_linear."))}
    model.load_state_dict(state, strict=True)
    return model


def preprocess_cnn_images(images: np.ndarray, name: str) -> np.ndarray:
    """uint8 [N, H, W, 3] (any size) -> normalized float32 at the model's
    input size, as pretrainedmodels' ``TransformImage`` does: the shorter
    side resized to size / 0.875, a center crop, [0, 1], normalized."""
    from PIL import Image
    _, size, mean, std, _ = CNN_SPECS[name]
    resize = int(size / 0.875)
    out = np.empty((len(images), size, size, 3), np.float32)
    for i, img in enumerate(images):
        pil = Image.fromarray(np.asarray(img, np.uint8))
        w, h = pil.size
        if w < h:
            nw, nh = resize, int(round(h * resize / w))
        else:
            nw, nh = int(round(w * resize / h)), resize
        pil = pil.resize((nw, nh), Image.BILINEAR)
        left, top = (nw - size) // 2, (nh - size) // 2
        out[i] = np.asarray(
            pil.crop((left, top, left + size, top + size)), np.float32) / 255.0
    return (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def encode_images(model: nn.Module, images: np.ndarray,
                  batch_size: int = 64) -> np.ndarray:
    """[N, H, W, 3] normalized images -> features (or logits) [N, D] f32,
    in chunks of ``batch_size`` on the model's device."""
    return encode_in_chunks(model, images, batch_size, torch.float32)
