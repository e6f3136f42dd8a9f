"""The visual front on the card (``-m gpu``): the CLIP, ResNet and
InceptionResNetV2 towers and the backbone captioner on the card against
the CPU port, and a training run with a backbone that repeats bit for bit.
This file imports neither JAX nor ``care_tpu`` (the card's machine has no
flax), so the ``gpu`` run can collect it; ``tests/test_torch_clip.py``,
``tests/test_torch_cnn.py`` and ``tests/test_torch_backbone.py`` hold the
port to ``care_tpu`` on the CPU. It also keeps the fixtures those files
share (``backbone_opt``, ``frame_batch``).
"""

import numpy as np
import pytest
import torch

from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.cnn import create_cnn, encode_images
from care_tpu_torch.models.weights import params_to_jax
from care_tpu_torch.pretreatment.clip import CLIPVisionTransformer
from care_tpu_torch.training import Trainer

FLAGSHIP = {"dataset": "MSRVTT", "method": "Transformer", "task": "CARE",
            "feats": "ViT", "decoder_modality_flags": "VA",
            "predictor_modality_flags": "VAT", "vocab_size": 40}
# the side of the frames a tower takes in these tests: CLIP's positional
# table fixes 224; the CNNs take any size
FRAME_SIDE = {"clip~ViT-B/32": 224, "resnet18": 32}


def backbone_opt(backbone: str, n_frames: int = 4, dropout: float = 0.0):
    """The CARE flagship at test size (the paper grid's ``tiny_opt``
    widths) with ``backbone`` on its image stream: the backbone's
    512-wide features feed ``Encoder_I``."""
    opt = get_opt(FLAGSHIP, read_vocab=False, resolve_paths=False)
    dim = 4 * opt["num_attention_heads"]
    opt.update(dim_hidden=dim, intermediate_size=2 * dim, n_frames=n_frames,
               max_len=8, attribute_prediction_k=16, use_attr_topk=4,
               retrieval_topk=4, hidden_dropout_prob=dropout,
               encoder_dropout_prob=dropout,
               attention_probs_dropout_prob=dropout)
    for char in "amr":
        opt[f"dim_{char}"] = max(4, opt[f"dim_{char}"] // 64)
    opt["dim_i"] = 512
    opt["with_backbones"] = ["" if c != "i" else backbone
                             for c in opt["modality"]]
    return opt


def frame_batch(opt: dict, batch_size: int, seed: int) -> dict:
    """A training batch as numpy arrays whose image stream is raw frames
    [B, n_frames, side, side, 3] of normalized values."""
    rs = np.random.RandomState(seed)
    side = FRAME_SIDE[next(n for n in opt["with_backbones"] if n)]
    feats = []
    for c in opt["modality"]:
        shape = ((batch_size, opt["n_frames"], side, side, 3) if c == "i"
                 else (batch_size, opt["retrieval_topk"] if c == "r"
                       else opt["n_frames"], opt[f"dim_{c}"]))
        feats.append(rs.randn(*shape).astype(np.float32))
    shape = (batch_size, opt["max_len"] - 1)
    return {"feats": feats,
            "input_ids": rs.randint(6, opt["vocab_size"], shape).astype(
                np.int32),
            "labels": rs.randint(6, opt["vocab_size"], shape).astype(
                np.int32),
            "labels_attr": rs.randint(
                0, 2, (batch_size, opt["attribute_prediction_k"])).astype(
                    np.float32)}


@pytest.fixture(scope="module")
def two_threads():
    """Two intra-op threads for torch while a module of tower tests runs:
    the suite runs several workers on one host, where more threads for
    the towers' convolutions and large products only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,side", [("clip", 224), ("resnet50", 224),
                                       ("inceptionresnetv2", 299)])
def test_towers_on_the_card_equal_the_cpu(cuda_device, name, side):
    """Each tower at its published size on 4 frames, the same weights on
    the card (TF32 off) and on the CPU: features within 2e-4 absolute and
    1e-3 relative (the CNN suite's bounds; 5e-4 absolute for
    InceptionResNetV2)."""
    g = torch.Generator().manual_seed(3)
    model = (CLIPVisionTransformer(generator=g) if name == "clip"
             else create_cnn(name, g)).eval()
    frames = np.random.RandomState(4).randn(4, side, side, 3).astype(
        np.float32)
    want = encode_images(model, frames)
    got = encode_images(model.to(cuda_device), frames)
    atol = 5e-4 if name == "inceptionresnetv2" else 2e-4
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("backbone", ["resnet18", "clip~ViT-B/32"])
def test_backbone_translate_on_the_card_equals_the_cpu(cuda_device,
                                                       backbone):
    """Beam search (beam 5) with the backbone on raw frames, on the card and
    on the CPU: identical tokens, scores within 1e-4."""
    opt = backbone_opt(backbone, n_frames=2)
    feats = frame_batch(opt, 2, seed=7)["feats"]
    out = []
    for device in ("cpu", cuda_device):
        model = build_captioner(opt, device=device, seed=6)
        out.append(get_translator(opt, device=device).translate_batch(
            model, {"feats": feats}))
    (want_h, want_s), (got_h, got_s) = out
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_backbone_training_repeats_bit_for_bit(cuda_device, tmp_path):
    """Two runs of 2 steps from one seed with the CLIP backbone and dropout
    on (cuDNN deterministic): equal losses and a parameter gap of 0.0."""
    opt = dict(backbone_opt("clip~ViT-B/32", n_frames=2, dropout=0.1),
               epochs=1, checkpoint_path=str(tmp_path / "exps"))
    batches = [frame_batch(opt, 2, seed=20 + i) for i in range(2)]
    runs = []
    for _ in range(2):
        tr = Trainer(opt, ListLoader(batches), device=cuda_device)
        tr.fit()
        runs.append(([l for h in tr.history for l in h["step_losses"]],
                     params_to_jax(tr.model)))
    (loss_a, params_a), (loss_b, params_b) = runs
    assert loss_a == loss_b

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + "/")
            else:
                yield prefix + k, v
    b = dict(leaves(params_b))
    assert max(float(np.abs(v - b[k]).max())
               for k, v in leaves(params_a)) == 0.0
