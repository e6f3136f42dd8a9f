"""Random state dicts in the reference's key names and torch layouts.

``reference_state_dict(opt, variables, seed)`` writes, for the captioner
that ``opt`` builds, every tensor that ``care_tpu/models/transplant.py``
reads from a reference (PyTorch) checkpoint: torch ``(out, in)`` linears,
``nn.LSTM`` / ``nn.LSTMCell`` / ``nn.GRU`` weights with their gates stacked
and both biases, ``Conv3d`` kernels ``(out, in, kd, kh, kw)``, BatchNorm
running statistics and step counters. The shapes come from ``variables``,
the model's flax-named tree (``models/weights.py:variables_to_jax`` of a
port model, or a ``care_tpu`` model's init). The values are seeded noise:
linears and tables 0.1 x N(0, 1), LayerNorm and BatchNorm scales near 1,
running variances in [0.7, 1.4].

``lightning_checkpoint(path, opt, state_dict, teacher=None)`` saves them as
the reference's Lightning checkpoint (``captioner.*`` keys, and
``teacher_captioner.*`` for a mean-teacher run).

Imports torch and numpy only, so that ``chip_smoke.py`` may use it, as
it uses the card's operand makers of ``tests/torch_card_cases.py``.
"""

import numpy as np
import torch


class _Writer:
    def __init__(self, variables, seed):
        self.p = variables["params"]
        self.bs = variables.get("batch_stats", {})
        self.rs = np.random.RandomState(seed)
        self.sd = {}

    @staticmethod
    def _node(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    def has(self, path, tree=None):
        try:
            self._node(self.p if tree is None else tree, path)
            return True
        except (KeyError, TypeError):
            return False

    def shape(self, path, tree=None):
        return tuple(np.shape(self._node(self.p if tree is None else tree,
                                         path)))

    def put(self, key, shape, kind="normal"):
        if kind == "scale":
            a = 1.0 + 0.1 * self.rs.randn(*shape)
        elif kind == "var":
            a = self.rs.uniform(0.7, 1.4, shape)
        elif kind == "mean":
            a = self.rs.uniform(-0.3, 0.3, shape)
        else:
            a = 0.1 * self.rs.randn(*shape)
        self.sd[key] = torch.from_numpy(np.asarray(a, np.float32))

    def same(self, key, path):
        self.put(key, self.shape(path))

    def linear(self, key, path, bias=True):
        self.put(f"{key}.weight", self.shape(f"{path}/kernel")[::-1])
        if bias:
            self.same(f"{key}.bias", f"{path}/bias")

    def ln(self, key, path):
        self.put(f"{key}.weight", self.shape(f"{path}/scale"), "scale")
        self.same(f"{key}.bias", f"{path}/bias")

    def bn(self, key, path):
        self.ln(key, path)
        self.put(f"{key}.running_mean", self.shape(f"{path}/mean", self.bs),
                 "mean")
        self.put(f"{key}.running_var", self.shape(f"{path}/var", self.bs),
                 "var")
        self.sd[f"{key}.num_batches_tracked"] = torch.tensor(7)


def _text_embedder(w, opt):
    base_t, base_o = "encoder.Encoder_T", "text_embedder"
    if w.has(f"{base_o}/embs/word_embeddings"):
        w.same(f"{base_t}.embs.word_embeddings.weight",
               f"{base_o}/embs/word_embeddings")
        w.same(f"{base_t}.embs.position_embeddings.weight",
               f"{base_o}/embs/position_embeddings")
        w.ln(f"{base_t}.embs.LayerNorm", f"{base_o}/embs/LayerNorm")
    if w.has(f"{base_o}/rnn_fwd"):
        # a bidirectional nn.LSTM: gates i, f, g, o stacked
        for cell, suf in (("rnn_fwd", ""), ("rnn_bwd", "_reverse")):
            c = f"{base_o}/{cell}/cell"
            n_in, h = w.shape(f"{c}/ii/kernel")
            w.put(f"{base_t}.rnn.weight_ih_l0{suf}", (4 * h, n_in))
            w.put(f"{base_t}.rnn.weight_hh_l0{suf}", (4 * h, h))
            w.put(f"{base_t}.rnn.bias_ih_l0{suf}", (4 * h,))
            w.put(f"{base_t}.rnn.bias_hh_l0{suf}", (4 * h,))
        w.ln(f"{base_t}.LayerNorm", f"{base_o}/LayerNorm")


def _encoder_streams(w, opt):
    for char in opt["modality"]:
        if char == "t":
            _text_embedder(w, opt)
            continue
        C = char.upper()
        w.linear(f"encoder.Encoder_{C}.0", f"encoder/Encoder_{C}/linear")
        w.ln(f"encoder.Encoder_{C}.1", f"encoder/Encoder_{C}/ln")


def _mha(w, theirs, base):
    for proj in ("query", "key", "value"):
        w.linear(f"{theirs}.SDPA.{proj}", f"{base}/{proj}")
    w.linear(f"{theirs}.dense", f"{base}/dense")
    w.ln(f"{theirs}.LayerNorm", f"{base}/LayerNorm")
    if w.has(f"{base}/hybrid_bias"):
        w.same(f"{theirs}.SDPA.hybrid_bias", f"{base}/hybrid_bias")


def _ffn(w, theirs, base):
    w.linear(f"{theirs}.dense1", f"{base}/dense1")
    w.linear(f"{theirs}.dense2", f"{base}/dense2")
    w.ln(f"{theirs}.LayerNorm", f"{base}/LayerNorm")


def _transformer_encoder_base(w, tb, fb, opt):
    if w.has(f"{fb}/position_embeddings/embedding"):
        w.same(f"{tb}.position_embeddings.weight",
               f"{fb}/position_embeddings/embedding")
    w.ln(f"{tb}.LayerNorm", f"{fb}/LayerNorm")
    for i in range(opt["num_hidden_layers_encoder"]):
        _mha(w, f"{tb}.layers.{i}.intra_attention",
             f"{fb}/layer_{i}/intra_attention")
        _ffn(w, f"{tb}.layers.{i}.ffn", f"{fb}/layer_{i}/ffn")


def _cnn_patch_encoder(w, tb="encoder", fb="encoder"):
    for i in range(3):
        kd, kh, kw, n_in, n_out = w.shape(f"{fb}/Conv_{i}/kernel")
        w.put(f"{tb}.block{i + 1}.0.weight", (n_out, n_in, kd, kh, kw))
        w.same(f"{tb}.block{i + 1}.0.bias", f"{fb}/Conv_{i}/bias")
        w.bn(f"{tb}.block{i + 1}.1", f"{fb}/BatchNorm_{i}")
    w.linear(f"{tb}.net", f"{fb}/net")
    w.ln(f"{tb}.LN", f"{fb}/LN")


def _stream_encoder(w, opt):
    enc = opt["encoder"]
    if enc in ("CNN1", "CNN2", "CNN3"):
        _cnn_patch_encoder(w)
        return
    if enc == "SingleStreamEmbedder":
        w.linear("encoder.encoder.0", "encoder/encoder/linear")
        w.ln("encoder.encoder.1", "encoder/encoder/ln")
        return
    for char in opt["modality"]:
        if char == "t":
            _text_embedder(w, opt)
            continue
        C = char.upper()
        base_t, base_o = f"encoder.Encoder_{C}", f"encoder/Encoder_{C}"
        if enc == "Identity":
            continue
        if enc in ("ReLUEmbedder", "MultiTransformerEncoder"):
            w.linear(f"{base_t}.0", f"{base_o}/linear")
            if enc == "MultiTransformerEncoder":
                _transformer_encoder_base(w, f"{base_t}.1",
                                          f"{base_o}/backbone", opt)
        elif enc == "TransformerEncoder":
            w.linear(base_t, f"{base_o}/linear")
    if enc == "TransformerEncoder":
        _transformer_encoder_base(w, "encoder.backbone", "encoder/backbone",
                                  opt)


def _head(w):
    w.linear("cls_head.tgt_word_prj", "cls_head/tgt_word_prj", bias=False)


def _concept_stack(w, opt):
    if opt.get("attribute_prediction"):
        w.linear("predictor.nets.0.prj",
                 "predictor/Predictor_attribute/attribute_heads/prj")
    if opt.get("use_attr"):
        base_t = "predictor.nets.1.attr_embs"
        base_o = "predictor/SemanticContainer/attr_embs"
        if w.has(f"{base_o}/word_embeddings"):
            w.same(f"{base_t}.word_embeddings.weight",
                   f"{base_o}/word_embeddings")
            w.same(f"{base_t}.position_embeddings.weight",
                   f"{base_o}/position_embeddings")
            w.ln(f"{base_t}.LayerNorm", f"{base_o}/LayerNorm")
        s2h = "predictor/SemanticContainer/semantic2hidden"
        if w.has(f"{s2h}/kernel"):
            w.linear("predictor.nets.1.semantic2hidden", s2h,
                     bias=w.has(f"{s2h}/bias"))


def _transformer(w, opt):
    _encoder_streams(w, opt)
    w.same("decoder.embedding.word_embeddings.weight",
           "decoder/embedding/word_embeddings")
    if opt.get("trainable_pe"):
        w.same("decoder.embedding.position_embeddings.weight",
               "decoder/embedding/position_embeddings/embedding")
    w.ln("decoder.embedding.LayerNorm", "decoder/embedding/LayerNorm")
    for i in range(opt["num_hidden_layers_decoder"]):
        for sub in ("intra_attention", "inter_attention"):
            _mha(w, f"decoder.layers.{i}.{sub}", f"decoder/layer_{i}/{sub}")
        _ffn(w, f"decoder.layers.{i}.ffn", f"decoder/layer_{i}/ffn")
    _head(w)
    _concept_stack(w, opt)


def _lstm_cell(w, tb, fb):
    """An nn.LSTMCell: ``weight_ih`` / ``bias_ih`` and ``weight_hh`` /
    ``bias_hh`` (no ``.weight`` suffix)."""
    for side in ("ih", "hh"):
        w.put(f"{tb}.weight_{side}", w.shape(f"{fb}/{side}/kernel")[::-1])
        w.same(f"{tb}.bias_{side}", f"{fb}/{side}/bias")


def _additive_attention(w, tb, fb):
    w.linear(f"{tb}.linear1_h", f"{fb}/linear1_h")
    i = 0
    while w.has(f"{fb}/linear1_f_{i}/kernel"):
        w.linear(f"{tb}.linear1_f.{i}", f"{fb}/linear1_f_{i}")
        i += 1
    w.linear(f"{tb}.linear2", f"{fb}/linear2", bias=False)
    if w.has(f"{fb}/hybrid_bias"):
        w.same(f"{tb}.hybrid_bias", f"{fb}/hybrid_bias")


def _rnn_attention(w, tb, fb):
    if w.has(f"{fb}/query/kernel"):
        _mha(w, tb, fb)
    elif w.has(f"{fb}/temporal_aware_attention"):
        for sub in ("temporal_aware_attention", "modality_aware_attention"):
            _additive_attention(w, f"{tb}.{sub}", f"{fb}/{sub}")
    else:
        _additive_attention(w, tb, fb)


def _salstm(w, opt, v2h_v2c=True):
    _encoder_streams(w, opt)
    w.same("decoder.embedding.weight", "decoder/word_embeddings")
    w.ln("decoder.LayerNorm", "decoder/LayerNorm")
    _lstm_cell(w, "decoder.rnn", "decoder/rnn")
    if v2h_v2c:
        w.linear("decoder.v2h", "decoder/v2h")
        w.linear("decoder.v2c", "decoder/v2c")
    _rnn_attention(w, "decoder.att", "decoder/att")
    _head(w)


def _topdown(w, opt):
    _encoder_streams(w, opt)
    w.same("decoder.embedding.weight", "decoder/word_embeddings")
    w.ln("decoder.LayerNorm", "decoder/LayerNorm")
    _lstm_cell(w, "decoder.bottom_rnn", "decoder/bottom_rnn")
    _lstm_cell(w, "decoder.top_rnn", "decoder/top_rnn")
    for lin in ("v2h", "v2c"):          # Sequential(Linear, Tanh)
        w.linear(f"decoder.{lin}.0", f"decoder/{lin}")
    _rnn_attention(w, "decoder.att", "decoder/att")
    if w.has("decoder/semantic_att/linear1_h"):
        _additive_attention(w, "decoder.semantic_att", "decoder/semantic_att")
    _head(w)


def _voe(w, opt):
    # per-modality nn.GRUs: gates r, z, n stacked
    for char in opt["modality"]:
        if char == "t":
            continue
        tb, fb = f"encoder.RNN_{char}", f"encoder/RNN_{char}"
        n_in, h = w.shape(f"{fb}/ir/kernel")
        w.put(f"{tb}.weight_ih_l0", (3 * h, n_in))
        w.put(f"{tb}.weight_hh_l0", (3 * h, h))
        w.put(f"{tb}.bias_ih_l0", (3 * h,))
        w.put(f"{tb}.bias_hh_l0", (3 * h,))
    w.bn("encoder.bn.bn", "encoder/bn/bn")
    _salstm(w, {**opt, "modality": ""}, v2h_v2c=False)


def _highwaybn(w, opt):
    for char in opt["modality"]:
        C = char.upper()
        base_t, base_o = f"encoder.Encoder_{C}", f"encoder/Encoder_{C}"
        w.linear(f"{base_t}.0", f"{base_o}/linear")
        w.linear(f"{base_t}.1.w1", f"{base_o}/highway/w1")
        w.linear(f"{base_t}.1.w2", f"{base_o}/highway/w2")
        w.bn(f"{base_t}.2.bn", f"{base_o}/bn/bn")


STREAM_ENCODERS = ("ReLUEmbedder", "Identity", "SingleStreamEmbedder",
                   "MultiTransformerEncoder", "TransformerEncoder", "CNN1",
                   "CNN2", "CNN3")


def reference_state_dict(opt: dict, variables: dict, seed: int = 0) -> dict:
    """The reference captioner's state dict (bare keys, no ``captioner.``
    prefix) for the model ``opt`` builds, ``variables`` its flax-named
    tree; seeded noise of the right shapes."""
    w = _Writer(variables, seed)
    enc = opt.get("encoder", "Embedder")
    dec = opt["decoder"]
    t_opt = dict(opt)
    if dec == "VOERNNDecoder":
        _voe(w, opt)
    else:
        if enc == "EncoderWithHighWayBN":
            _highwaybn(w, opt)
            t_opt["modality"] = ""
        elif enc in STREAM_ENCODERS:
            _stream_encoder(w, opt)
            t_opt["modality"] = ""
        if dec in ("TransformerDecoder", "TwoStageTransformerDecoder"):
            _transformer(w, t_opt)
        elif dec == "SingleLayerRNNDecoder":
            _salstm(w, t_opt)
        elif dec == "TopDownAttentionRNNDecoder":
            _topdown(w, t_opt)
        else:
            raise NotImplementedError(dec)
    if w.has("pointer"):
        for proj in ("query", "key", "value"):
            w.linear(f"pointer.attention.{proj}", f"pointer/attention/{proj}")
        for lin in ("Wq", "Wc"):
            w.linear(f"pointer.{lin}", f"pointer/{lin}")
    if w.has("predictor/Predictor_length"):
        # the length predictor follows the other predictors in
        # ``predictor.nets``: Linear (0), ReLU, Dropout, Linear (3)
        index = sum(w.has(f"predictor/{name}") for name in (
            "Predictor_attribute", "SemanticContainer"))
        base = f"predictor.nets.{index}.net"
        w.linear(f"{base}.0", "predictor/Predictor_length/net1")
        w.linear(f"{base}.3", "predictor/Predictor_length/net2")
    return w.sd


def lightning_checkpoint(path: str, opt: dict, state_dict: dict,
                         teacher: dict = None) -> None:
    """Save ``state_dict`` as the reference's Lightning checkpoint: the
    captioner under ``captioner.`` (``Wrapper.py:32``), a mean teacher's
    copy under ``teacher_captioner.``, the options under
    ``hyper_parameters['opt']``."""
    sd = {f"captioner.{k}": v for k, v in state_dict.items()}
    if teacher is not None:
        sd.update({f"teacher_captioner.{k}": v for k, v in teacher.items()})
    torch.save({"state_dict": sd, "hyper_parameters": {"opt": dict(opt)}},
               path)
