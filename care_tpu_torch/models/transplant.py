"""Reference-checkpoint weight transplantation: a torch state_dict of the
reference -> the flax-named variables tree of the port.

Port of ``care_tpu/models/transplant.py``. A user of the PyTorch reference
carries a trained checkpoint over: ``tools/convert_reference_ckpt.py``
loads a reference Lightning checkpoint (``{'state_dict',
'hyper_parameters': {'opt'}}``, the format ``models/__init__.py:115`` /
``Wrapper.load_from_checkpoint`` consumes), maps every parameter into the
``Captioner``'s variables tree by structure (torch ``(out, in)`` linears ->
flax ``(in, out)`` kernels, BatchNorm running statistics ->
``batch_stats``, the gates of the recurrent cells split and their biases
folded, ...) and saves it in the port's checkpoint format, which
``translate -cp`` serves.

The port's parameters carry flax's names and layouts, so the template is
``models/weights.py:variables_to_jax(model)`` as numpy, the mapping is the
JAX package's numpy arithmetic (transposes, slices, sums) term by term,
so both packages give bit-equal trees, and ``variables_from_jax`` loads
the result into the model.

Covered: every CLI-reachable encoder family (Embedder, ReLUEmbedder,
Identity, SingleStreamEmbedder, EncoderWithHighWayBN,
MultiTransformerEncoder, TransformerEncoder, VOE, CNN1/2/3, the
retrieved-caption Text_Embedder), all five decoder families (Transformer,
TwoStage/NACF, SALSTM, TopDown, VOE), the CARE concept stack (MIL
predictor + SemanticContainer), PointerGen and the NACF length predictor.
Consumption of the torch state_dict is tracked, so that unmapped
*parameters* are reported instead of silently dropped.
"""

import re
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "transplant_transformer_weights", "transplant_salstm_weights",
    "transplant_topdown_weights", "transplant_voe_weights",
    "transplant_pointer_weights", "transplant_length_predictor",
    "transplant_highwaybn_encoder", "transplant_stream_encoder",
    "transplant_cnn_patch_encoder", "transplant_reference_state_dict",
    "strip_wrapper_prefix",
]

# torch buffers that have no flax-parameter counterpart (deterministic or
# bookkeeping-only); never reported as unmapped.
_BUFFER_PATTERNS = (
    r"\.num_batches_tracked$",
    r"\.position_ids$",
    r"\.pe$",                      # sinusoidal position-encoding buffer
    r"(^|\.)mask($|\.)",           # cached attention masks
)


def _to_np(v):
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


class _NPView:
    """Mapping view over a torch state_dict: converts tensors to numpy on
    access and records which keys a transplant consumed."""

    def __init__(self, sd):
        self._sd = sd
        self.consumed = set()

    def __getitem__(self, k):
        v = _to_np(self._sd[k])
        self.consumed.add(k)
        return v

    def __contains__(self, k):
        return k in self._sd

    def keys(self):
        return self._sd.keys()


def _view(state_dict) -> _NPView:
    return state_dict if isinstance(state_dict, _NPView) \
        else _NPView(state_dict)


def _set(tree, path, value):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[k]
    assert keys[-1] in node, (path, sorted(node.keys()))
    assert tuple(node[keys[-1]].shape) == tuple(value.shape), \
        (path, node[keys[-1]].shape, value.shape)
    node[keys[-1]] = value


def _transplant_text_embedder(sd, p, opt):
    """Reference ``Text_Embedder`` (``Encoder.py:341-376``, the 't' retrieved-
    caption stream) -> our ``framework.py:TextEmbedder``.  Param-less when
    both retrieval flags are off (it borrows the decoder's embeddings)."""
    base_t = "encoder.Encoder_T"
    base_o = "text_embedder"
    if f"{base_t}.embs.word_embeddings.weight" in sd:
        _set(p, f"{base_o}/embs/word_embeddings",
             sd[f"{base_t}.embs.word_embeddings.weight"])
        _set(p, f"{base_o}/embs/position_embeddings",
             sd[f"{base_t}.embs.position_embeddings.weight"])
        _set(p, f"{base_o}/embs/LayerNorm/scale",
             sd[f"{base_t}.embs.LayerNorm.weight"])
        _set(p, f"{base_o}/embs/LayerNorm/bias",
             sd[f"{base_t}.embs.LayerNorm.bias"])
    if f"{base_t}.rnn.weight_ih_l0" in sd:
        # torch bidirectional nn.LSTM (gate order i,f,g,o; separate ih/hh
        # biases) -> flax OptimizedLSTMCell (per-gate denses; input side
        # bias-less, so bias_ih is folded into the hidden-side bias)
        h = opt["dim_hidden"]
        for cell, suf in [("rnn_fwd", ""), ("rnn_bwd", "_reverse")]:
            w_ih = sd[f"{base_t}.rnn.weight_ih_l0{suf}"]
            w_hh = sd[f"{base_t}.rnn.weight_hh_l0{suf}"]
            b = (sd[f"{base_t}.rnn.bias_ih_l0{suf}"]
                 + sd[f"{base_t}.rnn.bias_hh_l0{suf}"])
            for j, gate in enumerate("ifgo"):
                sl = slice(j * h, (j + 1) * h)
                _set(p, f"{base_o}/{cell}/cell/i{gate}/kernel", w_ih[sl].T)
                _set(p, f"{base_o}/{cell}/cell/h{gate}/kernel", w_hh[sl].T)
                _set(p, f"{base_o}/{cell}/cell/h{gate}/bias", b[sl])
        _set(p, f"{base_o}/LayerNorm/scale", sd[f"{base_t}.LayerNorm.weight"])
        _set(p, f"{base_o}/LayerNorm/bias", sd[f"{base_t}.LayerNorm.bias"])


def _transplant_encoder_streams(sd, p, opt):
    """Per-modality dense streams: encoder.Encoder_M.0.{weight,bias}
    (Linear), .1 LayerNorm; the 't' stream routes to the Text_Embedder."""
    for char in opt["modality"]:
        if char == "t":
            _transplant_text_embedder(sd, p, opt)
            continue
        C = char.upper()
        _set(p, f"encoder/Encoder_{C}/linear/kernel",
             sd[f"encoder.Encoder_{C}.0.weight"].T)
        _set(p, f"encoder/Encoder_{C}/linear/bias",
             sd[f"encoder.Encoder_{C}.0.bias"])
        _set(p, f"encoder/Encoder_{C}/ln/scale",
             sd[f"encoder.Encoder_{C}.1.weight"])
        _set(p, f"encoder/Encoder_{C}/ln/bias",
             sd[f"encoder.Encoder_{C}.1.bias"])


def _transplant_mha(sd, p, theirs: str, base: str):
    """One MHA sublayer (reference ``Layers.py`` attention: SDPA q/k/v +
    output dense + LayerNorm, optional learned hybrid bias)."""
    for proj in ["query", "key", "value"]:
        _set(p, f"{base}/{proj}/kernel", sd[f"{theirs}.SDPA.{proj}.weight"].T)
        _set(p, f"{base}/{proj}/bias", sd[f"{theirs}.SDPA.{proj}.bias"])
    _set(p, f"{base}/dense/kernel", sd[f"{theirs}.dense.weight"].T)
    _set(p, f"{base}/dense/bias", sd[f"{theirs}.dense.bias"])
    _set(p, f"{base}/LayerNorm/scale", sd[f"{theirs}.LayerNorm.weight"])
    _set(p, f"{base}/LayerNorm/bias", sd[f"{theirs}.LayerNorm.bias"])
    if f"{theirs}.SDPA.hybrid_bias" in sd:
        _set(p, f"{base}/hybrid_bias", sd[f"{theirs}.SDPA.hybrid_bias"])


def _transplant_ffn(sd, p, ffn_t: str, ffn_o: str):
    _set(p, f"{ffn_o}/dense1/kernel", sd[f"{ffn_t}.dense1.weight"].T)
    _set(p, f"{ffn_o}/dense1/bias", sd[f"{ffn_t}.dense1.bias"])
    _set(p, f"{ffn_o}/dense2/kernel", sd[f"{ffn_t}.dense2.weight"].T)
    _set(p, f"{ffn_o}/dense2/bias", sd[f"{ffn_t}.dense2.bias"])
    _set(p, f"{ffn_o}/LayerNorm/scale", sd[f"{ffn_t}.LayerNorm.weight"])
    _set(p, f"{ffn_o}/LayerNorm/bias", sd[f"{ffn_t}.LayerNorm.bias"])


def _transplant_transformer_encoder_base(sd, p, torch_base: str,
                                         flax_base: str, opt):
    """Reference ``TransformerEncoderBase`` (``Encoder.py:244-298``: PE +
    LN + N self-attention EncoderLayers) -> our ``encoders.py`` backbone.
    The sinusoidal PE is a buffer (no params); only the trainable variant
    maps a table."""
    if f"{torch_base}.position_embeddings.weight" in sd:
        _set(p, f"{flax_base}/position_embeddings/embedding",
             sd[f"{torch_base}.position_embeddings.weight"])
    _set(p, f"{flax_base}/LayerNorm/scale",
         sd[f"{torch_base}.LayerNorm.weight"])
    _set(p, f"{flax_base}/LayerNorm/bias",
         sd[f"{torch_base}.LayerNorm.bias"])
    for i in range(opt["num_hidden_layers_encoder"]):
        _transplant_mha(sd, p, f"{torch_base}.layers.{i}.intra_attention",
                        f"{flax_base}/layer_{i}/intra_attention")
        _transplant_ffn(sd, p, f"{torch_base}.layers.{i}.ffn",
                        f"{flax_base}/layer_{i}/ffn")


def transplant_cnn_patch_encoder(state_dict, flax_variables,
                                 torch_base: str = "encoder",
                                 flax_base: str = "encoder"):
    """Reference ``Att_Encoder.py:6-99`` (CNN1/2/3 dense-patch 3D-conv
    encoders) -> our ``CNNPatchEncoder`` params + batch_stats.  torch
    Conv3d kernels are (out, in, kd, kh, kw); flax NDHWC wants
    (kd, kh, kw, in, out)."""
    sd = _view(state_dict)
    p = flax_variables["params"]
    bs = flax_variables["batch_stats"]
    pre_t = f"{torch_base}." if torch_base else ""
    pre_o = f"{flax_base}/" if flax_base else ""
    for i in range(3):
        w = sd[f"{pre_t}block{i + 1}.0.weight"]
        _set(p, f"{pre_o}Conv_{i}/kernel", np.transpose(w, (2, 3, 4, 1, 0)))
        _set(p, f"{pre_o}Conv_{i}/bias", sd[f"{pre_t}block{i + 1}.0.bias"])
        _set(p, f"{pre_o}BatchNorm_{i}/scale", sd[f"{pre_t}block{i + 1}.1.weight"])
        _set(p, f"{pre_o}BatchNorm_{i}/bias", sd[f"{pre_t}block{i + 1}.1.bias"])
        _set(bs, f"{pre_o}BatchNorm_{i}/mean",
             sd[f"{pre_t}block{i + 1}.1.running_mean"])
        _set(bs, f"{pre_o}BatchNorm_{i}/var",
             sd[f"{pre_t}block{i + 1}.1.running_var"])
    _set(p, f"{pre_o}net/kernel", sd[f"{pre_t}net.weight"].T)
    _set(p, f"{pre_o}net/bias", sd[f"{pre_t}net.bias"])
    _set(p, f"{pre_o}LN/scale", sd[f"{pre_t}LN.weight"])
    _set(p, f"{pre_o}LN/bias", sd[f"{pre_t}LN.bias"])
    return flax_variables


def transplant_stream_encoder(state_dict, flax_variables, opt):
    """Map the remaining CLI-reachable encoder families
    (``Encoder.py:159-207`` + ``Att_Encoder.py``) that are not handled by
    the per-method mappers: ReLUEmbedder, Identity, SingleStreamEmbedder,
    MultiTransformerEncoder, TransformerEncoder, CNN1/2/3."""
    sd = _view(state_dict)
    p = flax_variables["params"]
    enc = opt["encoder"]
    if enc in ("CNN1", "CNN2", "CNN3"):
        return transplant_cnn_patch_encoder(sd, flax_variables)
    if enc == "SingleStreamEmbedder":
        # SingleStream names its module `encoder` (-> encoder.encoder.*)
        _set(p, "encoder/encoder/linear/kernel",
             sd["encoder.encoder.0.weight"].T)
        _set(p, "encoder/encoder/linear/bias", sd["encoder.encoder.0.bias"])
        _set(p, "encoder/encoder/ln/scale", sd["encoder.encoder.1.weight"])
        _set(p, "encoder/encoder/ln/bias", sd["encoder.encoder.1.bias"])
        return flax_variables
    for char in opt["modality"]:
        if char == "t":
            _transplant_text_embedder(sd, p, opt)
            continue
        C = char.upper()
        base_t, base_o = f"encoder.Encoder_{C}", f"encoder/Encoder_{C}"
        if enc == "Identity":
            continue                       # nn.Identity: no params
        if enc == "ReLUEmbedder":          # Sequential(Linear, ReLU, Drop)
            _set(p, f"{base_o}/linear/kernel", sd[f"{base_t}.0.weight"].T)
            _set(p, f"{base_o}/linear/bias", sd[f"{base_t}.0.bias"])
        elif enc == "MultiTransformerEncoder":
            # Sequential(Linear, TransformerEncoderBase) per stream
            _set(p, f"{base_o}/linear/kernel", sd[f"{base_t}.0.weight"].T)
            _set(p, f"{base_o}/linear/bias", sd[f"{base_t}.0.bias"])
            _transplant_transformer_encoder_base(
                sd, p, f"{base_t}.1", f"{base_o}/backbone", opt)
        elif enc == "TransformerEncoder":  # bare Linear per stream
            _set(p, f"{base_o}/linear/kernel", sd[f"{base_t}.weight"].T)
            _set(p, f"{base_o}/linear/bias", sd[f"{base_t}.bias"])
        else:
            raise NotImplementedError(enc)
    if enc == "TransformerEncoder":        # shared post-fusion backbone
        _transplant_transformer_encoder_base(
            sd, p, "encoder.backbone", "encoder/backbone", opt)
    return flax_variables


def transplant_transformer_weights(state_dict, flax_params, opt):
    """Map the reference TransformerSeq2Seq weights into our Captioner
    params (Transformer/TwoStage methods; Embedder encoder; NaiveHead)."""
    sd = _view(state_dict)
    p = flax_params

    _transplant_encoder_streams(sd, p, opt)

    # decoder embeddings
    _set(p, "decoder/embedding/word_embeddings",
         sd["decoder.embedding.word_embeddings.weight"])
    if opt.get("trainable_pe"):
        _set(p, "decoder/embedding/position_embeddings/embedding",
             sd["decoder.embedding.position_embeddings.weight"])
    _set(p, "decoder/embedding/LayerNorm/scale",
         sd["decoder.embedding.LayerNorm.weight"])
    _set(p, "decoder/embedding/LayerNorm/bias",
         sd["decoder.embedding.LayerNorm.bias"])

    # decoder layers
    for i in range(opt["num_hidden_layers_decoder"]):
        for ours, theirs in [
                ("intra_attention", f"decoder.layers.{i}.intra_attention"),
                ("inter_attention", f"decoder.layers.{i}.inter_attention")]:
            _transplant_mha(sd, p, theirs, f"decoder/layer_{i}/{ours}")
        _transplant_ffn(sd, p, f"decoder.layers.{i}.ffn",
                        f"decoder/layer_{i}/ffn")

    # head
    _set(p, "cls_head/tgt_word_prj/kernel",
         sd["cls_head.tgt_word_prj.weight"].T)

    return _transplant_concept_stack(sd, p, opt)


def transplant_salstm_weights(state_dict, flax_params, opt):
    """Map the reference RNNSeq2Seq (SALSTM) weights into our Captioner."""
    sd = _view(state_dict)
    p = flax_params

    _transplant_encoder_streams(sd, p, opt)

    d = "decoder"
    _set(p, f"{d}/word_embeddings", sd["decoder.embedding.weight"])
    _set(p, f"{d}/LayerNorm/scale", sd["decoder.LayerNorm.weight"])
    _set(p, f"{d}/LayerNorm/bias", sd["decoder.LayerNorm.bias"])
    # LSTM cell: torch weight_ih (4h, in) -> kernel (in, 4h)
    _set(p, f"{d}/rnn/ih/kernel", sd["decoder.rnn.weight_ih"].T)
    _set(p, f"{d}/rnn/ih/bias", sd["decoder.rnn.bias_ih"])
    _set(p, f"{d}/rnn/hh/kernel", sd["decoder.rnn.weight_hh"].T)
    _set(p, f"{d}/rnn/hh/bias", sd["decoder.rnn.bias_hh"])
    if not opt.get("_no_v2h_v2c"):      # VOE decoder: no v2h/v2c init
        _set(p, f"{d}/v2h/kernel", sd["decoder.v2h.weight"].T)
        _set(p, f"{d}/v2h/bias", sd["decoder.v2h.bias"])
        _set(p, f"{d}/v2c/kernel", sd["decoder.v2c.weight"].T)
        _set(p, f"{d}/v2c/bias", sd["decoder.v2c.bias"])
    _transplant_rnn_attention(sd, p, "decoder.att", f"{d}/att")
    _set(p, "cls_head/tgt_word_prj/kernel",
         sd["cls_head.tgt_word_prj.weight"].T)
    return p


def _transplant_lstm_cell(sd, p, torch_base: str, flax_base: str):
    """torch nn.LSTMCell (weight_ih (4h,in), gate order i,f,g,o) -> our
    LSTMCellTorch ih/hh denses (the reference's +1 forget-bias offset is
    already baked into the saved biases)."""
    _set(p, f"{flax_base}/ih/kernel", sd[f"{torch_base}.weight_ih"].T)
    _set(p, f"{flax_base}/ih/bias", sd[f"{torch_base}.bias_ih"])
    _set(p, f"{flax_base}/hh/kernel", sd[f"{torch_base}.weight_hh"].T)
    _set(p, f"{flax_base}/hh/bias", sd[f"{torch_base}.bias_hh"])


def _transplant_additive_attention(sd, p, torch_base: str, flax_base: str):
    """Reference ``AdditiveAttention`` (``components/Attention.py:134-206``)
    -> our params; one ``linear1_f`` per (unshared) feats stream."""
    _set(p, f"{flax_base}/linear1_h/kernel", sd[f"{torch_base}.linear1_h.weight"].T)
    _set(p, f"{flax_base}/linear1_h/bias", sd[f"{torch_base}.linear1_h.bias"])
    i = 0
    while f"{torch_base}.linear1_f.{i}.weight" in sd:
        _set(p, f"{flax_base}/linear1_f_{i}/kernel",
             sd[f"{torch_base}.linear1_f.{i}.weight"].T)
        _set(p, f"{flax_base}/linear1_f_{i}/bias",
             sd[f"{torch_base}.linear1_f.{i}.bias"])
        i += 1
    assert i > 0, f"no {torch_base}.linear1_f.* in the checkpoint"
    _set(p, f"{flax_base}/linear2/kernel", sd[f"{torch_base}.linear2.weight"].T)
    if f"{torch_base}.hybrid_bias" in sd:
        _set(p, f"{flax_base}/hybrid_bias", sd[f"{torch_base}.hybrid_bias"])


def _transplant_rnn_attention(sd, p, torch_base: str, flax_base: str):
    """The RNN decoders' visual-attention module is one of three classes
    picked by opt (``RNN_single_layer.py:255-270``): MultiHeadAttention
    (``rnn_use_mha``), MultiLevelAttention (``with_multileval_attention``,
    two nested additives), or plain AdditiveAttention — dispatch on the
    checkpoint keys."""
    if f"{torch_base}.SDPA.query.weight" in sd:
        _transplant_mha(sd, p, torch_base, flax_base)
    elif f"{torch_base}.temporal_aware_attention.linear1_h.weight" in sd:
        for sub in ["temporal_aware_attention", "modality_aware_attention"]:
            _transplant_additive_attention(sd, p, f"{torch_base}.{sub}",
                                           f"{flax_base}/{sub}")
    else:
        _transplant_additive_attention(sd, p, torch_base, flax_base)


def transplant_topdown_weights(state_dict, flax_params, opt):
    """Map the reference ``TopDownAttentionRNNDecoder``
    (``RNN_multi_layers.py:60-125``: two LSTM cells, Sequential v2h/v2c,
    additive attention) into our ``models/decoders.py`` params."""
    sd = _view(state_dict)
    p = flax_params

    _transplant_encoder_streams(sd, p, opt)

    d = "decoder"
    _set(p, f"{d}/word_embeddings", sd["decoder.embedding.weight"])
    _set(p, f"{d}/LayerNorm/scale", sd["decoder.LayerNorm.weight"])
    _set(p, f"{d}/LayerNorm/bias", sd["decoder.LayerNorm.bias"])
    _transplant_lstm_cell(sd, p, "decoder.bottom_rnn", f"{d}/bottom_rnn")
    _transplant_lstm_cell(sd, p, "decoder.top_rnn", f"{d}/top_rnn")
    # v2h/v2c are Sequential(Linear, Tanh) in the reference
    for lin in ["v2h", "v2c"]:
        _set(p, f"{d}/{lin}/kernel", sd[f"decoder.{lin}.0.weight"].T)
        _set(p, f"{d}/{lin}/bias", sd[f"decoder.{lin}.0.bias"])
    _transplant_rnn_attention(sd, p, "decoder.att", f"{d}/att")
    if "decoder.semantic_att.linear1_h.weight" in sd:
        _transplant_additive_attention(sd, p, "decoder.semantic_att",
                                       f"{d}/semantic_att")
    _set(p, "cls_head/tgt_word_prj/kernel",
         sd["cls_head.tgt_word_prj.weight"].T)
    return p


def transplant_voe_weights(state_dict, flax_variables, opt):
    """Map the reference VOE stack (``Encoder.py:379-412``: chained
    per-modality ``nn.GRU`` + BN1d; ``RNN_single_layer.py:354``: SALSTM
    decoder without v2h/v2c) into our params + batch_stats.

    torch GRU gate order is r,z,n with separate ih/hh biases; flax's
    ``nn.GRUCell`` keeps only the input-side r/z biases, so the torch
    hidden-side r/z biases are folded in (the n-gate hidden bias stays
    separate because it sits inside the reset multiplication)."""
    sd = _view(state_dict)
    p = flax_variables["params"]
    bs = flax_variables["batch_stats"]
    h = opt["dim_hidden"]
    for char in opt["modality"]:
        if char == "t":
            continue
        tb, fb = f"encoder.RNN_{char}", f"encoder/RNN_{char}"
        w_ih = sd[f"{tb}.weight_ih_l0"]          # (3h, in) — r|z|n
        w_hh = sd[f"{tb}.weight_hh_l0"]          # (3h, h)
        b_ih = sd[f"{tb}.bias_ih_l0"]
        b_hh = sd[f"{tb}.bias_hh_l0"]
        for j, gate in enumerate(["r", "z", "n"]):
            sl = slice(j * h, (j + 1) * h)
            _set(p, f"{fb}/i{gate}/kernel", w_ih[sl].T)
            _set(p, f"{fb}/h{gate}/kernel", w_hh[sl].T)
            if gate == "n":
                _set(p, f"{fb}/in/bias", b_ih[sl])
                _set(p, f"{fb}/hn/bias", b_hh[sl])
            else:
                _set(p, f"{fb}/i{gate}/bias", b_ih[sl] + b_hh[sl])
    _set(p, "encoder/bn/bn/scale", sd["encoder.bn.bn.weight"])
    _set(p, "encoder/bn/bn/bias", sd["encoder.bn.bn.bias"])
    _set(bs, "encoder/bn/bn/mean", sd["encoder.bn.bn.running_mean"])
    _set(bs, "encoder/bn/bn/var", sd["encoder.bn.bn.running_var"])

    p = transplant_salstm_weights(sd, p, {**opt, "modality": "",
                                          "_no_v2h_v2c": True})
    return {"params": p, "batch_stats": bs}


def transplant_pointer_weights(state_dict, flax_params):
    """Map the reference Pointer (``models/Pointer.py:18-31``: bare SDPA
    q/k/v + Wq/Wc gate linears) into our ``models/pointer.py`` params."""
    sd = _view(state_dict)
    p = flax_params
    for proj in ["query", "key", "value"]:
        _set(p, f"pointer/attention/{proj}/kernel",
             sd[f"pointer.attention.{proj}.weight"].T)
        _set(p, f"pointer/attention/{proj}/bias",
             sd[f"pointer.attention.{proj}.bias"])
    for lin in ["Wq", "Wc"]:
        _set(p, f"pointer/{lin}/kernel", sd[f"pointer.{lin}.weight"].T)
        _set(p, f"pointer/{lin}/bias", sd[f"pointer.{lin}.bias"])
    return p


def transplant_length_predictor(state_dict, flax_params, net_index=0):
    """Map the reference ``Predictor_length`` MLP
    (``pred_length.py:8-13``: Linear-ReLU-Dropout-Linear at
    ``predictor.nets.<i>.net``) into our ``PredictorLength`` params."""
    sd = _view(state_dict)
    p = flax_params
    base = f"predictor.nets.{net_index}.net"
    _set(p, "predictor/Predictor_length/net1/kernel", sd[f"{base}.0.weight"].T)
    _set(p, "predictor/Predictor_length/net1/bias", sd[f"{base}.0.bias"])
    _set(p, "predictor/Predictor_length/net2/kernel", sd[f"{base}.3.weight"].T)
    _set(p, "predictor/Predictor_length/net2/bias", sd[f"{base}.3.bias"])
    return p


def transplant_highwaybn_encoder(state_dict, flax_variables, opt):
    """Map the ARB/NAB EncoderWithHighWayBN streams (Linear + HighWay +
    BatchNorm1d + Dropout) into params + batch_stats."""
    sd = _view(state_dict)
    p = flax_variables["params"]
    bs = flax_variables["batch_stats"]
    for char in opt["modality"]:
        C = char.upper()
        base_t = f"encoder.Encoder_{C}"
        base_o = f"encoder/Encoder_{C}"
        _set(p, f"{base_o}/linear/kernel", sd[f"{base_t}.0.weight"].T)
        _set(p, f"{base_o}/linear/bias", sd[f"{base_t}.0.bias"])
        _set(p, f"{base_o}/highway/w1/kernel", sd[f"{base_t}.1.w1.weight"].T)
        _set(p, f"{base_o}/highway/w1/bias", sd[f"{base_t}.1.w1.bias"])
        _set(p, f"{base_o}/highway/w2/kernel", sd[f"{base_t}.1.w2.weight"].T)
        _set(p, f"{base_o}/highway/w2/bias", sd[f"{base_t}.1.w2.bias"])
        _set(p, f"{base_o}/bn/bn/scale", sd[f"{base_t}.2.bn.weight"])
        _set(p, f"{base_o}/bn/bn/bias", sd[f"{base_t}.2.bn.bias"])
        _set(bs, f"{base_o}/bn/bn/mean", sd[f"{base_t}.2.bn.running_mean"])
        _set(bs, f"{base_o}/bn/bn/var", sd[f"{base_t}.2.bn.running_var"])
    return {"params": p, "batch_stats": bs}


def _transplant_concept_stack(sd, p, opt):
    # optional concept stack (CARE)
    if opt.get("attribute_prediction"):
        # Predictor_attribute prj (single 'V' flag -> one Linear)
        _set(p, "predictor/Predictor_attribute/attribute_heads/prj/kernel",
             sd["predictor.nets.0.prj.weight"].T)
        _set(p, "predictor/Predictor_attribute/attribute_heads/prj/bias",
             sd["predictor.nets.0.prj.bias"])
    if opt.get("use_attr"):
        base_t = "predictor.nets.1.attr_embs"
        base_o = "predictor/SemanticContainer/attr_embs"
        if f"{base_t}.word_embeddings.weight" in sd:
            _set(p, f"{base_o}/word_embeddings",
                 sd[f"{base_t}.word_embeddings.weight"])
            _set(p, f"{base_o}/position_embeddings",
                 sd[f"{base_t}.position_embeddings.weight"])
            _set(p, f"{base_o}/LayerNorm/scale",
                 sd[f"{base_t}.LayerNorm.weight"])
            _set(p, f"{base_o}/LayerNorm/bias",
                 sd[f"{base_t}.LayerNorm.bias"])
        if "predictor.nets.1.semantic2hidden.weight" in sd:
            _set(p, "predictor/SemanticContainer/semantic2hidden/kernel",
                 sd["predictor.nets.1.semantic2hidden.weight"].T)
            if "predictor.nets.1.semantic2hidden.bias" in sd:
                _set(p, "predictor/SemanticContainer/semantic2hidden/bias",
                     sd["predictor.nets.1.semantic2hidden.bias"])
    return p


# ---------------------------------------------------------------------------
# whole-checkpoint dispatch
# ---------------------------------------------------------------------------

def strip_wrapper_prefix(state_dict, source: str = "captioner"
                         ) -> Tuple[Dict, Dict]:
    """Split a Lightning-checkpoint state_dict into the captioner's own
    keys and any mean-teacher copy (``Wrapper.py``: ``self.captioner`` /
    ``self.teacher_captioner``). Accepts bare captioner state_dicts too.

    Returns (selected, other): ``selected`` is the ``source`` module's
    state_dict with the prefix stripped."""
    out = {"captioner": {}, "teacher_captioner": {}}
    bare = {}
    for k, v in state_dict.items():
        for prefix in out:
            if k.startswith(prefix + "."):
                out[prefix][k[len(prefix) + 1:]] = v
                break
        else:
            bare[k] = v
    if not out["captioner"] and not out["teacher_captioner"]:
        # already a bare captioner state_dict
        return bare, {}
    assert source in out, source
    other = out["teacher_captioner" if source == "captioner"
                else "captioner"]
    return out[source], other


def _is_buffer(key: str) -> bool:
    return any(re.search(pat, key) for pat in _BUFFER_PATTERNS)


def transplant_reference_state_dict(state_dict, variables, opt,
                                    verbose: bool = True):
    """Transplant a full reference captioner state_dict into ``variables``
    (our init template), dispatching on the opt's encoder/decoder the same
    way ``models/Framework.py:get_framework`` assembles the torch model.

    Returns (variables, report) where report lists the torch keys that were
    consumed, skipped as buffers, and left unmapped (unmapped parameters
    indicate an unsupported sub-module and should be treated as an error
    by strict callers)."""
    sd, other = strip_wrapper_prefix(state_dict)
    if other and verbose:
        print(f"- dropping {len(other)} teacher_captioner keys "
              "(use --from-teacher to convert the teacher copy)")
    view = _NPView(sd)

    enc = opt.get("encoder", "Embedder")
    dec = opt["decoder"]
    t_opt = dict(opt)

    if dec == "VOERNNDecoder":
        assert enc == "VOE", (enc, dec)
        variables = transplant_voe_weights(view, variables, opt)
        params = variables["params"]
    else:
        if enc == "EncoderWithHighWayBN":
            variables = transplant_highwaybn_encoder(view, variables, opt)
            t_opt["modality"] = ""          # encoder handled above
        elif enc in ("ReLUEmbedder", "Identity", "SingleStreamEmbedder",
                     "MultiTransformerEncoder", "TransformerEncoder",
                     "CNN1", "CNN2", "CNN3"):
            variables = transplant_stream_encoder(view, variables, opt)
            t_opt["modality"] = ""          # encoder handled above
        elif enc != "Embedder":
            raise NotImplementedError(
                f"checkpoint conversion does not support encoder `{enc}` "
                "yet (supported: Embedder, EncoderWithHighWayBN, VOE, "
                "ReLUEmbedder, Identity, SingleStreamEmbedder, "
                "MultiTransformerEncoder, TransformerEncoder, CNN1/2/3)")

        params = variables["params"]
        if dec in ("TransformerDecoder", "TwoStageTransformerDecoder"):
            params = transplant_transformer_weights(view, params, t_opt)
        elif dec == "SingleLayerRNNDecoder":
            params = transplant_salstm_weights(view, params, t_opt)
        elif dec == "TopDownAttentionRNNDecoder":
            params = transplant_topdown_weights(view, params, t_opt)
        else:
            raise NotImplementedError(
                f"checkpoint conversion does not support decoder `{dec}` "
                "yet (supported: TransformerDecoder, "
                "TwoStageTransformerDecoder, SingleLayerRNNDecoder, "
                "TopDownAttentionRNNDecoder, VOERNNDecoder)")

    if any(k.startswith("pointer.") for k in sd):
        params = transplant_pointer_weights(view, params)

    # NACF length predictor: locate its net index in predictor.nets
    if "Predictor_length" in params.get("predictor", {}):
        idxs = sorted({int(m.group(1)) for k in sd
                       if (m := re.match(
                           r"predictor\.nets\.(\d+)\.net\.0\.weight$", k))})
        assert len(idxs) == 1, \
            f"expected exactly one Predictor_length in the checkpoint, " \
            f"found nets {idxs}"
        params = transplant_length_predictor(view, params,
                                             net_index=idxs[0])

    variables = dict(variables)
    variables["params"] = params

    unmapped = [k for k in sd
                if k not in view.consumed and not _is_buffer(k)]
    report = {
        "consumed": sorted(view.consumed),
        "buffers_skipped": sorted(k for k in sd
                                  if k not in view.consumed
                                  and _is_buffer(k)),
        "unmapped": sorted(unmapped),
    }
    if verbose and unmapped:
        print(f"- WARNING: {len(unmapped)} torch keys were not mapped: "
              f"{report['unmapped'][:10]}"
              f"{'…' if len(unmapped) > 10 else ''}")
    return variables, report
