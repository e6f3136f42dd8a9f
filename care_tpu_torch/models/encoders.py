"""Multi-stream feature encoders.

Port of ``care_tpu/models/encoders.py:MultipleStreams`` (reference
``models/Encoder.py``): one ``Encoder_<C>`` stream per dense modality
character, of the kind the ``encoder`` option names (``Embedder``: Linear +
LN + Dropout; ``ReLUEmbedder``: Linear + ReLU + Dropout; ``Identity``;
``EncoderWithHighWayBN``, ARB's encoder: Linear + HighWay + BatchNorm +
Dropout; ``MultiTransformerEncoder``: Linear + a Transformer encoder per
stream; ``TransformerEncoder``: Linear per stream, then one Transformer
encoder over all of them), the fusion of the streams (``temporal_concat``,
``addition``, ``channel_concat`` or ``none``) and the per-component modality
views (the decoder and the concept predictor may each see a subset of the
streams). The retrieved-text stream ``t`` is embedded by the framework.

The BatchNorm is ``torch.nn.BatchNorm1d``'s: in training it normalises with
the biased batch variance and moves the running mean and the unbiased
running variance by momentum 0.1, which the JAX package's
``_TorchBatchNorm`` was written to reproduce; in evaluation it uses the
running statistics.

``VOE`` (reference ``Encoder.py:379-412``) chains one flax-layout GRU per
dense modality over time, each after the first starting from the carry of
the one before and reading the dropped-out outputs of the one before beside
its own features, and closes with the BatchNorm.

The patch encoders (``CNN1`` / ``CNN2`` / ``CNN3``: ``CNNPatchEncoder``;
``SingleStreamEmbedder``; the ``LightCNN`` and ``POSLayer`` blocks) use
flax's ``nn.BatchNorm`` semantics instead (``FlaxBatchNorm``): the biased
batch variance moves the running one, by momentum 0.9 in
``CNNPatchEncoder``.
"""

from typing import Any, Dict, List

import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch.models.common import (Dense, Dropout, FlaxBatchNorm,
                                          LayerNorm, dense, flax_init_)
from care_tpu_torch.models.embeddings import PositionalEmbedding
from care_tpu_torch.models.layers import EncoderLayer


class HighWay(nn.Module):
    """Gated highway block (reference ``Encoder.py:210-226``):
    ``g * x + (1 - g) * tanh(w1 x)``, g = sigmoid(w2 x)."""

    def __init__(self, hidden_size: int, generator: torch.Generator):
        super().__init__()
        self.w1 = dense(hidden_size, hidden_size, generator)
        self.w2 = dense(hidden_size, hidden_size, generator)

    def forward(self, x):
        y = torch.tanh(self.w1(x))
        gate = torch.sigmoid(self.w2(x))
        return gate * x + (1 - gate) * y


class BN1d(nn.Module):
    """BatchNorm over the channel axis with statistics across batch x time
    (reference ``Encoder.py:229-241``): ``bn`` is a ``BatchNorm1d``
    (momentum 0.1, eps 1e-5). Evaluation normalises with the running
    statistics as the JAX package writes it, in the promoted dtype of the
    input and the module's tensors."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.bn = nn.BatchNorm1d(hidden_size, eps=1e-5, momentum=0.1)

    def forward(self, x):
        flat = x.reshape(-1, self.hidden_size)
        bn = self.bn
        if self.training:
            out = F.batch_norm(flat, bn.running_mean, bn.running_var,
                               bn.weight, bn.bias, training=True,
                               momentum=bn.momentum, eps=bn.eps)
        else:
            inv = torch.rsqrt(bn.running_var + bn.eps)
            out = (flat - bn.running_mean) * inv * bn.weight + bn.bias
        return out.reshape(x.shape)


class TransformerEncoderBase(nn.Module):
    """Position embedding + LN + dropout + ``num_hidden_layers_encoder``
    self-attention encoder layers over the concatenated streams (reference
    ``Encoder.py:244-298``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.position_embeddings = PositionalEmbedding(
            opt["n_frames"], opt["dim_hidden"],
            opt.get("trainable_pe", False), generator)
        self.LayerNorm = LayerNorm(opt["dim_hidden"],
                                   eps=opt["layer_norm_eps"])
        self.dropout = Dropout(opt["hidden_dropout_prob"])
        self.num_layers = opt["num_hidden_layers_encoder"]
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", EncoderLayer(opt, generator))

    def forward(self, input_feats, only_return_encoder_hidden_states=True):
        if not isinstance(input_feats, (list, tuple)):
            input_feats = [input_feats]
        n_frames = input_feats[0].shape[1]
        pos = self.position_embeddings(
            torch.arange(n_frames, device=input_feats[0].device)[None, :])
        hidden_states = torch.cat([f + pos for f in input_feats], dim=1)
        hidden_states = self.dropout(self.LayerNorm(hidden_states))
        all_states, all_attn = [hidden_states], ()
        for i in range(self.num_layers):
            hidden_states, probs, _ = getattr(self, f"layer_{i}")(
                all_states[-1])
            all_states.append(hidden_states)
            all_attn += (probs,)
        if only_return_encoder_hidden_states:
            return all_states[-1]
        return {"encoder_hidden_states": all_states[-1],
                "all_encoder_hidden_states": all_states,
                "all_encoder_intra_attentions": all_attn}


class LinearLNDrop(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dropout: float, eps: float,
                 generator: torch.Generator):
        super().__init__()
        self.linear = dense(dim_in, dim_out, generator)
        self.ln = LayerNorm(dim_out, eps=eps)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ln(self.linear(x)))


class LinearReLUDrop(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dropout: float,
                 generator: torch.Generator):
        super().__init__()
        self.linear = dense(dim_in, dim_out, generator)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(torch.relu(self.linear(x)))


class IdentityStream(nn.Module):
    def forward(self, x):
        return x


class HighWayBNStream(nn.Module):
    """ARB's stream: Linear -> HighWay -> BN1d -> Dropout."""

    def __init__(self, dim_in: int, dim_out: int, dropout: float,
                 generator: torch.Generator):
        super().__init__()
        self.linear = dense(dim_in, dim_out, generator)
        self.highway = HighWay(dim_out, generator)
        self.bn = BN1d(dim_out)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.bn(self.highway(self.linear(x))))


class LinearStream(nn.Module):
    """Linear, optionally followed by a Transformer encoder of its own
    (``backbone``)."""

    def __init__(self, dim_in: int, dim_out: int, generator: torch.Generator,
                 backbone_opt: dict = None):
        super().__init__()
        self.linear = dense(dim_in, dim_out, generator)
        self.backbone = (None if backbone_opt is None else
                         TransformerEncoderBase(backbone_opt, generator))

    def forward(self, x):
        x = self.linear(x)
        return x if self.backbone is None else self.backbone(x)


STREAM_KINDS = {
    "Embedder": "embedder",
    "ReLUEmbedder": "relu",
    "Identity": "identity",
    "EncoderWithHighWayBN": "highwaybn",
    "MultiTransformerEncoder": "multitransformer",
    "TransformerEncoder": "transformer",
}
FUSIONS = ("temporal_concat", "addition", "channel_concat", "none")


def fuse(encoder_hidden_states, fusion_type: str):
    """Fuse the per-modality states (reference ``Encoder.py:140-153``);
    ``none`` keeps the list."""
    if fusion_type == "none":
        return encoder_hidden_states
    if not isinstance(encoder_hidden_states, (list, tuple)):
        encoder_hidden_states = [encoder_hidden_states]
    if fusion_type == "addition":
        return torch.stack(list(encoder_hidden_states), dim=0).mean(dim=0)
    if fusion_type == "temporal_concat":
        return torch.cat(list(encoder_hidden_states), dim=1)
    if fusion_type == "channel_concat":
        return torch.cat(list(encoder_hidden_states), dim=2)
    raise ValueError(f"unsupported fusion `{fusion_type}`")


class MultipleStreams(nn.Module):
    """One ``Encoder_<C>`` stream per dense modality character + fusion +
    component views."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt["encoder"] not in STREAM_KINDS:
            raise ValueError(f"unknown encoder `{opt['encoder']}`")
        self.kind = STREAM_KINDS[opt["encoder"]]
        self.fusion_type = opt.get("fusion", "temporal_concat")
        if self.fusion_type not in FUSIONS:
            raise ValueError(f"unsupported fusion `{self.fusion_type}`")
        self.opt = opt
        self.dense_modality = "".join(c for c in opt["modality"].lower()
                                      if c != "t")
        dim_out = opt.get("dim_hidden", 512)
        dropout = opt.get("encoder_dropout_prob", 0.5)
        self.stream_names = []
        for char in self.dense_modality:
            dim_in = opt["dim_" + char]
            if self.kind == "embedder":
                stream = LinearLNDrop(dim_in, dim_out, dropout,
                                      opt["layer_norm_eps"], generator)
            elif self.kind == "relu":
                stream = LinearReLUDrop(dim_in, dim_out, dropout, generator)
            elif self.kind == "identity":
                stream = IdentityStream()
            elif self.kind == "highwaybn":
                stream = HighWayBNStream(dim_in, dim_out, dropout, generator)
            else:
                stream = LinearStream(
                    dim_in, dim_out, generator,
                    opt if self.kind == "multitransformer" else None)
            name = f"Encoder_{char.upper()}"
            self.add_module(name, stream)
            self.stream_names.append(name)
        self.backbone = (TransformerEncoderBase(opt, generator)
                         if self.kind == "transformer" else None)

    def post_processing(self, encoder_hidden_states) -> Dict[str, Any]:
        if self.backbone is not None:
            return self.backbone(encoder_hidden_states,
                                 only_return_encoder_hidden_states=False)
        return {"encoder_hidden_states": fuse(encoder_hidden_states,
                                              self.fusion_type)}

    def _component_view(self, per_modality: Dict[str, list],
                        component_modality: str) -> Dict[str, Any]:
        keep = [i for i, c in enumerate(self.dense_modality)
                if c in component_modality]
        view = {k: [v[i] for i in keep] for k, v in per_modality.items()}
        view.update(self.post_processing(view["encoder_hidden_states"]))
        return view

    def forward(self, input_feats: List[torch.Tensor]) -> Dict[str, Any]:
        if len(input_feats) != len(self.stream_names):
            raise ValueError(f"{len(input_feats)} feature streams for "
                             f"modality `{self.dense_modality}`")
        states = [getattr(self, name)(f)
                  for name, f in zip(self.stream_names, input_feats)]
        per_modality = {"encoder_hidden_states": states,
                        "mean_encoder_hidden_states":
                            [s.mean(dim=1) for s in states]}
        data: Dict[str, Any] = {k: list(v) for k, v in per_modality.items()}
        for key_name, comp_mod in [
                ("inputs_for_predictor", self.opt.get("modality_for_predictor")),
                ("inputs_for_decoder", self.opt.get("modality_for_decoder"))]:
            comp_mod = (comp_mod or "").replace("t", "")
            if comp_mod and comp_mod != self.dense_modality:
                data[key_name] = self._component_view(per_modality, comp_mod)
        data.update(self.post_processing(states))
        return data


class GRUCellFlax(nn.Module):
    """flax's ``nn.GRUCell``, which is not ``torch.nn.GRUCell``: ``ir``,
    ``iz`` and ``in`` map the input with a bias, ``hr`` and ``hz`` the
    state without one and ``hn`` with one; r = sigmoid(ir(x) + hr(h)),
    z = sigmoid(iz(x) + hz(h)), n = tanh(in(x) + r * hn(h)),
    h' = (1 - z) * n + z * h. Init as flax's: lecun-normal input kernels,
    orthogonal state kernels, zero biases."""

    def __init__(self, dim_in: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, flax_init_(Dense(dim_in, features),
                                             generator))
        for name, bias in (("hr", False), ("hz", False), ("hn", True)):
            layer = Dense(features, features, bias=bias)
            with torch.no_grad():
                nn.init.orthogonal_(layer.weight, generator=generator)
                if bias:
                    layer.bias.zero_()
            self.add_module(name, layer)

    def scan(self, inputs, carry):
        """The cell over time: inputs [B, T, dim_in], carry [B, H]; returns
        (the last carry, the outputs [B, T, H]). The input maps of every
        step are taken at once."""
        xr, xz, xn = (getattr(self, n)(inputs) for n in ("ir", "iz", "in"))
        outputs = []
        for t in range(inputs.shape[1]):
            r = torch.sigmoid(xr[:, t] + self.hr(carry))
            z = torch.sigmoid(xz[:, t] + self.hz(carry))
            n = torch.tanh(xn[:, t] + r * self.hn(carry))
            carry = (1.0 - z) * n + z * carry
            outputs.append(carry)
        return carry, torch.stack(outputs, dim=1)


class VOE(nn.Module):
    """Chained per-modality GRUs (reference ``Encoder.py:379-412``): the
    first ``RNN_<c>`` starts from zeros over its features; each later one
    starts from the last carry of the one before, over the dropout of its
    outputs concatenated with its own features; then ``bn`` (``BN1d``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.modality = [c for c in opt["modality"] if c != "t"]
        H = opt["dim_hidden"]
        for i, char in enumerate(self.modality):
            dim_in = opt["dim_" + char] + (H if i else 0)
            self.add_module(f"RNN_{char}", GRUCellFlax(dim_in, H, generator))
        self.dropout = Dropout(opt.get("encoder_dropout_prob", 0.5))
        self.bn = BN1d(H)
        self.dim_hidden = H

    def forward(self, input_feats: List[torch.Tensor]) -> Dict[str, Any]:
        if len(input_feats) != len(self.modality):
            raise ValueError(f"{len(input_feats)} feature streams for "
                             f"modality `{''.join(self.modality)}`")
        outputs = carry = None
        for i, char in enumerate(self.modality):
            x = input_feats[i]
            if i:
                x = torch.cat([self.dropout(outputs), x], dim=2)
            else:
                carry = x.new_zeros((x.shape[0], self.dim_hidden))
            carry, outputs = getattr(self, f"RNN_{char}").scan(x, carry)
        outputs = self.bn(outputs)
        return {"encoder_hidden_states": outputs,
                "mean_encoder_hidden_states": [outputs.mean(dim=1)]}


class LightCNN(nn.Module):
    """Small conv stack over per-frame patch grids (dense-patch
    experiments, reference ``Encoder.py:301-323``): [B, n_frames,
    ch * res * res] -> [B, n_frames, chs[-1] * res'^2], ``conv<i>`` (3x3,
    no padding) + ``bn<i>`` (flax's BatchNorm, momentum 0.99) + ReLU; the
    output flattened in flax's NHWC order."""

    def __init__(self, chs=(12, 32, 128, 512), resolution: int = 7,
                 dropout_rate: float = 0.0,
                 generator: torch.Generator = None):
        super().__init__()
        self.chs, self.resolution = tuple(chs), resolution
        for i, (cin, cout) in enumerate(zip(self.chs, self.chs[1:])):
            self.add_module(f"conv{i + 1}", flax_init_(
                nn.Conv2d(cin, cout, 3), generator))
            self.add_module(f"bn{i + 1}", FlaxBatchNorm(cout))
        self.dropout = Dropout(dropout_rate)

    def forward(self, x):
        bsz, n_frames, _ = x.shape
        r = self.resolution
        h = x.reshape(bsz * n_frames, self.chs[0], r, r)
        for i in range(1, len(self.chs)):
            h = torch.relu(getattr(self, f"bn{i}")(
                getattr(self, f"conv{i}")(h)))
        return self.dropout(h.permute(0, 2, 3, 1).reshape(bsz, n_frames, -1))


class POSLayer(nn.Module):
    """Learned positional bias over per-frame patch positions (reference
    ``Encoder.py:326-338``): ``pos_bias`` [res^2] added to every channel's
    patch grid."""

    def __init__(self, resolution: int = 7):
        super().__init__()
        self.pos_bias = nn.Parameter(torch.zeros(resolution ** 2))

    def forward(self, x):
        bsz, n_frames, _ = x.shape
        h = x.reshape(bsz * n_frames, -1, self.pos_bias.numel())
        return (h + self.pos_bias).reshape(bsz, n_frames, -1)


class SingleStreamEmbedder(nn.Module):
    """All dense modalities concatenated along channels, then one Linear +
    LN + Dropout ``encoder`` (reference ``SingleStream`` /
    ``SingleStreamEmbedder``, ``Encoder.py:29-48,159-162``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        dim_in = sum(opt["dim_" + c] for c in opt["modality"].lower()
                     if c != "t")
        self.encoder = LinearLNDrop(
            dim_in, opt.get("dim_hidden", 512),
            opt.get("encoder_dropout_prob", 0.5), opt["layer_norm_eps"],
            generator)

    def forward(self, input_feats: List[torch.Tensor]) -> Dict[str, Any]:
        x = self.encoder(torch.cat(list(input_feats), dim=-1))
        return {"encoder_hidden_states": x,
                "mean_encoder_hidden_states": [x.mean(dim=1)]}


class CNNPatchEncoder(nn.Module):
    """Dense-patch 3D-conv encoder (reference ``models/Att_Encoder.py:6-99``,
    ``CNN1`` / ``CNN2`` / ``CNN3``): the first stream [B, n_frames,
    n_layers, n_patches] (n_patches a square, the stream's width
    ``dim_<c>``) is mean-pooled over layers into a [B, 1, F, ws, ws] volume,
    then ``Conv_0`` / ``BatchNorm_0`` (2 channels), a frame-pair average,
    ``Conv_1`` / ``BatchNorm_1`` (4), a frame-pair average, and ``Conv_2`` /
    ``BatchNorm_2`` (8) whose kernel depth F // 4 collapses the frames,
    each conv followed by flax's BatchNorm (momentum 0.9) and ReLU; the
    [B, 8, 1, ws, ws] volume is flattened channel-major into one token,
    then ``net`` (Dense) and ``LN``. The frame-pair average is a reshape
    and mean, the VALID (2, 1, 1) pool, with a deterministic backward."""

    def __init__(self, opt: dict, kernel_size=(3, 3, 3), padding=(1, 1, 1),
                 generator: torch.Generator = None):
        super().__init__()
        char = next(c for c in opt["modality"].lower() if c != "t")
        n_patches, self.n_frames = opt["dim_" + char], opt["n_frames"]
        self.ws = int(n_patches ** 0.5)
        if self.ws * self.ws != n_patches:
            raise ValueError(f"{n_patches} patches (dim_{char}) is not a "
                             f"square grid")
        k, p = tuple(kernel_size), tuple(padding)
        for i, (cin, cout, kernel, pad) in enumerate((
                (1, 2, k, p), (2, 4, k, p),
                (4, 8, (self.n_frames // 4,) + k[1:], (0,) + p[1:]))):
            self.add_module(f"Conv_{i}", flax_init_(
                nn.Conv3d(cin, cout, kernel, padding=pad), generator))
            self.add_module(f"BatchNorm_{i}", FlaxBatchNorm(cout,
                                                            momentum=0.9))
        self.net = dense(8 * n_patches, opt.get("dim_hidden", 512),
                         generator)
        self.LN = LayerNorm(opt.get("dim_hidden", 512),
                            eps=opt["layer_norm_eps"])

    def _block(self, i: int, x):
        return torch.relu(getattr(self, f"BatchNorm_{i}")(
            getattr(self, f"Conv_{i}")(x)))

    @staticmethod
    def _frame_pairs(x):
        b, c, f, h, w = x.shape
        return x[:, :, :f - f % 2].reshape(b, c, f // 2, 2, h, w).mean(dim=3)

    def forward(self, input_feats) -> Dict[str, Any]:
        x = (input_feats[0] if isinstance(input_feats, (list, tuple))
             else input_feats)
        bsz, n_frames, _, n_patches = x.shape
        if n_frames != self.n_frames or n_patches != self.ws ** 2:
            raise ValueError(f"patch features {tuple(x.shape)} for "
                             f"n_frames {self.n_frames} and "
                             f"{self.ws ** 2} patches")
        x = x.mean(dim=2).reshape(bsz, 1, n_frames, self.ws, self.ws)
        x = self._frame_pairs(self._block(0, x))
        x = self._frame_pairs(self._block(1, x))
        x = self._block(2, x).reshape(bsz, 1, -1)     # channel-major
        x = self.LN(self.net(x))
        return {"encoder_hidden_states": x,
                "mean_encoder_hidden_states": [x.mean(dim=1)]}


CNN_VARIANTS = {
    "CNN1": ((3, 3, 3), (1, 1, 1)),
    "CNN2": ((7, 3, 3), (3, 1, 1)),
    "CNN3": ((7, 5, 5), (3, 2, 2)),
}


def get_encoder(opt: dict, generator: torch.Generator) -> nn.Module:
    name = opt["encoder"]
    if name == "VOE":
        return VOE(opt, generator)
    if name == "SingleStreamEmbedder":
        return SingleStreamEmbedder(opt, generator)
    if name in CNN_VARIANTS:
        k, p = CNN_VARIANTS[name]
        return CNNPatchEncoder(opt, k, p, generator)
    return MultipleStreams(opt, generator)
