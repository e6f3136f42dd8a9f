"""In-model visual backbones for end-to-end training and serving.

Port of ``care_tpu/models/backbone.py`` (reference ``models/Backbone.py``):
an optional backbone for the image stream that encodes raw frames
``[B, n_frames, H, W, 3]`` into features inside the captioner. Only the
``i`` stream takes one. Registry:

* ``clip~ViT-B/32`` (and ``ViT-B-32``, ``ViT-B/16``, ``ViT-B-16``): the
  CLIP visual tower of ``pretreatment/clip.py``;
* the ImageNet CNNs of ``models/cnn.py`` (``resnet18/34/50/101/152``,
  ``inceptionresnetv2``).

The frames of a batch run through the tower as one ``[B * n_frames, H, W,
3]`` batch and come back as ``[B, n_frames, D]``. Pretrained weights load
from local torch state dicts (``opt['backbone_weights']``, one path per
modality, '' to keep the init) through ``maybe_load_backbone_weights``.
"""

from typing import List, Optional

import torch
from torch import nn

from care_tpu_torch.models.cnn import (CNN_SPECS, convert_cnn_state_dict,
                                       create_cnn, load_converted)
from care_tpu_torch.pretreatment.clip import (CLIPVisionTransformer,
                                              convert_openai_clip_state_dict)

_VIT_B = dict(width=768, layers=12, heads=12, output_dim=512)
_CLIP_VIT_CONFIGS = {
    "ViT-B/32": dict(patch_size=32, **_VIT_B),
    "ViT-B-32": dict(patch_size=32, **_VIT_B),
    "ViT-B/16": dict(patch_size=16, **_VIT_B),
    "ViT-B-16": dict(patch_size=16, **_VIT_B),
}


def _backbone_names(opt: dict) -> List[str]:
    names = [n.strip() for n in opt.get("with_backbones", [])]
    assert len(names) == len(opt["modality"]), \
        (len(names), len(opt["modality"]))
    return names


class BackboneManager(nn.Module):
    """Applies ``Backbone_I`` to the ``i`` stream, passes others through."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.keys: List[Optional[str]] = []
        for name, char in zip(_backbone_names(opt), opt["modality"]):
            if char != "i" or not name:
                assert not name or char == "i", \
                    "only the image backbone is supported"
                self.keys.append(None)
                continue
            key = f"Backbone_{char.upper()}"
            if "clip" in name:
                arch = name.split("~")[1]
                cfg = _CLIP_VIT_CONFIGS.get(arch)
                assert cfg is not None, f"unsupported CLIP arch `{arch}`"
                tower = CLIPVisionTransformer(**cfg, generator=generator)
            else:
                assert name in CNN_SPECS, \
                    f"unsupported backbone `{name}` " \
                    f"(use clip~<arch> or one of {sorted(CNN_SPECS)})"
                tower = create_cnn(name, generator)
            self.add_module(key, tower)
            self.keys.append(key)

    def forward(self, feats: List[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for key, f in zip(self.keys, feats):
            if key is None:
                outputs.append(f)
                continue
            bsz, n_frames = f.shape[:2]
            out = getattr(self, key)(f.reshape((bsz * n_frames,)
                                               + f.shape[2:]))
            outputs.append(out.reshape(bsz, n_frames, -1))
        return outputs


def get_backbone(opt: dict,
                 generator: torch.Generator) -> Optional[BackboneManager]:
    if not opt.get("with_backbones", []):
        return None
    return BackboneManager(opt, generator)


def maybe_load_backbone_weights(model: nn.Module, opt: dict) -> nn.Module:
    """Overwrite the backbones of the Captioner ``model`` in place with
    converted local torch weights (``opt['backbone_weights']``: one state
    dict path per modality, '' to keep the init; the reference downloads
    them, ``models/Backbone.py:22-33``). Returns ``model``."""
    paths = opt.get("backbone_weights", [])
    names = [n.strip() for n in opt.get("with_backbones", [])]
    if not paths or not names:
        return model
    assert len(paths) == len(names), (len(paths), len(names))
    for path, name, char in zip(paths, names, opt["modality"]):
        if not path or not name:
            continue
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = {k: v.float().numpy() for k, v in sd.items()
              if hasattr(v, "numpy")}
        key = f"Backbone_{char.upper()}"
        assert model.backbone is not None and hasattr(model.backbone, key), \
            f"backbone scope `{key}` not found in the model"
        tower = getattr(model.backbone, key)
        if "clip" in name:
            tower.load_state_dict(convert_openai_clip_state_dict(sd)[0],
                                  strict=True)
        else:
            load_converted(tower, convert_cnn_state_dict(sd, name))
    return model
