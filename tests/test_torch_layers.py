"""The port's layers (``care_tpu_torch/ops/attention.py``,
``models/layers.py``, ``models/embeddings.py``, ``models/decoders.py``'s
masks) against the JAX package's on the same randomized weights and inputs.

Tolerance 2e-4, the JAX suite's logit tolerance: flax's LayerNorm takes
the variance in one pass (E[x^2] - E[x]^2), torch's in two, and the f32
sums run in other orders.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from care_tpu.models import decoders as jdec
from care_tpu.models import embeddings as jemb
from care_tpu.models import layers as jlay
from care_tpu.ops import attention as jatt
from care_tpu_torch.models import decoders as pdec
from care_tpu_torch.models import embeddings as pemb
from care_tpu_torch.models import layers as play
from care_tpu_torch.models.weights import params_from_jax
from care_tpu_torch.ops import attention as patt
from care_tpu_torch.ops import flash_attention as pflash

from test_torch_support import flagship_small_opt, randomized, to_numpy

TOL = 2e-4
D, HEADS, B, BEAM, L, LK = 32, 4, 2, 3, 5, 7


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _init(module, *args, **kwargs):
    key = jax.random.PRNGKey(0)
    variables = module.init({"params": key, "dropout": key}, *args, **kwargs)
    return randomized(to_numpy(variables["params"]), seed=1)


def _port(module, params):
    return params_from_jax(module.eval(), params)


def _mha_pair(hybrid_length=0, attend_to_video=None, **extra):
    """``extra``: pre_ln, have_relative_position_bias,
    max_relative_position, under the same names in both packages."""
    if attend_to_video is None:
        attend_to_video = bool(hybrid_length)
    jm = jlay.MultiHeadAttention(
        dim_hidden=D, num_attention_heads=HEADS, hidden_dropout_prob=0.1,
        attend_to_video=attend_to_video,
        add_hybrid_attention_bias=bool(hybrid_length),
        hybrid_length=hybrid_length, **extra)
    pm = play.MultiHeadAttention(D, HEADS, 0.1, 1e-12,
                                 torch.Generator().manual_seed(0),
                                 hybrid_length=hybrid_length,
                                 attend_to_video=attend_to_video, **extra)
    return jm, pm


def case_attention(rs):
    q, k, v = _rand(rs, B, HEADS, L, 8), _rand(rs, B, HEADS, LK, 8), \
        _rand(rs, B, HEADS, LK, 8)
    bias = np.where(rs.rand(B, 1, L, LK) < 0.3, -1e9, 0.0).astype(np.float32)
    bias = bias + _rand(rs, 1, HEADS, 1, LK)
    jc, jp = jatt.dot_product_attention(q, k, v, bias=bias)
    pc, pp = patt.dot_product_attention(*map(torch.as_tensor,
                                             (q, k, v, bias)))
    return [jc, jp], [pc, pp]


def case_attention_sigmoid(rs):
    """Sigmoid weights, plain and normalised over the keys."""
    q, k, v = _rand(rs, B, HEADS, L, 8), _rand(rs, B, HEADS, LK, 8), \
        _rand(rs, B, HEADS, LK, 8)
    bias = _rand(rs, 1, HEADS, 1, LK)
    want, got = [], []
    for normalize in (False, True):
        want += jatt.dot_product_attention(
            q, k, v, bias=bias, use_sigmoid=True, sigmoid_normalize=normalize)
        got += patt.dot_product_attention(
            *map(torch.as_tensor, (q, k, v, bias)), use_sigmoid=True,
            sigmoid_normalize=normalize)
    # with sigmoid weights use_flash must not take the flash path
    got += patt.dot_product_attention(
        *map(torch.as_tensor, (q, k, v, bias)), use_sigmoid=True,
        return_probs=False, use_flash=True)[:1]
    return want + want[:1], got


def case_attention_flash_switch(rs):
    """``use_flash`` takes the flash function only when no probabilities are
    asked for; both ways give the dense context."""
    q, k, v = _rand(rs, B, HEADS, L, 8), _rand(rs, B, HEADS, LK, 8), \
        _rand(rs, B, HEADS, LK, 8)
    bias = _rand(rs, 1, HEADS, 1, LK)
    want, _ = jatt.dot_product_attention(q, k, v, bias=bias)
    args = list(map(torch.as_tensor, (q, k, v, bias)))
    before = pflash.plain_forward_calls
    with_probs, probs = patt.dot_product_attention(*args, use_flash=True)
    assert probs is not None and pflash.plain_forward_calls == before
    flash, probs = patt.dot_product_attention(*args, use_flash=True,
                                              return_probs=False)
    assert probs is None and pflash.plain_forward_calls == before + 1
    return [want, want], [with_probs, flash]


def case_relative_position_index(rs):
    return ([jatt.relative_position_index(5, 9, 3),
             jatt.relative_position_index(5, 9, 3, bidirectional=False)],
            [patt.relative_position_index(5, 9, 3),
             patt.relative_position_index(5, 9, 3, bidirectional=False)])


def case_relative_position_bias(rs):
    """The table lookup, one-directional, and tiled over three streams of
    four frames for video keys."""
    jm = jemb.RelativePositionBias(max_relative_position=3, num_heads=HEADS,
                                   attend_to_video=True)
    params = _init(jm, L, 4)
    pm = _port(pemb.RelativePositionBias(
        3, HEADS, torch.Generator().manual_seed(0), attend_to_video=True),
        params)
    jt = jemb.RelativePositionBias(max_relative_position=3, num_heads=HEADS)
    pt = _port(pemb.RelativePositionBias(
        3, HEADS, torch.Generator().manual_seed(0)), params)
    return ([jm.apply({"params": params}, L, 4, tile_to=12),
             jt.apply({"params": params}, L, L, bidirectional=False)],
            [pm(L, 4, tile_to=12), pt(L, L, bidirectional=False)])


def case_mha_rpe_make_bias(rs):
    """``_make_bias`` with relative positions: the full table over text
    keys, and the one row of a KV-cached step, over text and over tiled
    video keys with the hybrid bias on top."""
    x = _rand(rs, B, L, D)
    mask = np.where(rs.rand(B, 1, L, L) < 0.3, -1e9, 0.0).astype(np.float32)
    rpe = dict(have_relative_position_bias=True, max_relative_position=3)
    jm, pm = _mha_pair(**rpe)
    params = _init(jm, x)
    pm = _port(pm, params)
    jv, pv = _mha_pair(hybrid_length=8, **rpe)
    vparams = _init(jv, x, encoder_hidden_states=_rand(rs, B, 8, D),
                    n_frames=4)
    pv = _port(pv, vparams)

    def make(m, *args, **kw):
        return m._make_bias(*args, **kw)
    row = dict(rpe_query_position=2, rpe_total_q=L)
    want = [jm.apply({"params": params}, mask, L, L, "ARFormer", 0,
                     method=make),
            jm.apply({"params": params}, mask[:, :, :1], 1, L, "ARFormer", 0,
                     method=make, **row),
            jm.apply({"params": params}, None, L, L, "NARFormer", 0,
                     method=make),
            jv.apply({"params": vparams}, None, 1, 8, "ARFormer", 4,
                     method=make, **row)]
    tmask = torch.as_tensor(mask)
    got = [pm._make_bias(tmask, L, L, "ARFormer", 0),
           pm._make_bias(tmask[:, :, :1], 1, L, "ARFormer", 0, **row),
           pm._make_bias(None, L, L, "NARFormer", 0),
           pv._make_bias(None, 1, 8, "ARFormer", 4, **row)]
    return want, got


def case_mha_rpe_forward(rs):
    """Cross attention over two streams of four frames with the tiled
    relative-position bias and the hybrid bias."""
    x, enc = _rand(rs, B, L, D), _rand(rs, B, 8, D)
    jm, pm = _mha_pair(hybrid_length=8, have_relative_position_bias=True,
                       max_relative_position=3)
    params = _init(jm, x, encoder_hidden_states=enc, n_frames=4)
    jh, jp, _ = jm.apply({"params": params}, x, encoder_hidden_states=enc,
                         n_frames=4)
    ph, pp, _ = _port(pm, params)(torch.as_tensor(x), torch.as_tensor(enc),
                                  n_frames=4)
    return [jh, jp], [ph, pp]


def case_mha_pre_ln(rs):
    """Pre-LN: the LN normalises the sublayer's input (the queries; the
    encoder states stay as they are) and the residual leaves unnormalised."""
    x, enc = _rand(rs, B, L, D), _rand(rs, B, LK, D)
    jm, pm = _mha_pair(hybrid_length=LK, pre_ln=True)
    params = _init(jm, x, encoder_hidden_states=enc)
    pm = _port(pm, params)
    jh, jp, jc = jm.apply({"params": params}, x, encoder_hidden_states=enc)
    ph, pp, pc = pm(torch.as_tensor(x), torch.as_tensor(enc))
    return [jh, jp, jc], [ph, pp, pc]


def case_mha_without_probs(rs):
    """``return_probs=False`` returns None for the probabilities and the
    same hidden states, in the plain and the beam-grouped layout."""
    x, enc = _rand(rs, B * BEAM, 1, D), _rand(rs, B, LK, D)
    jm, pm = _mha_pair(hybrid_length=LK)
    params = _init(jm, x[:B], encoder_hidden_states=enc)
    pm = _port(pm, params)
    xt, et = torch.as_tensor(x), torch.as_tensor(enc)
    k, v = pm.project_kv(et)
    bias = pm._make_bias(None, 1, LK, "ARFormer", 0)
    with_probs, _, _ = pm.attend(pm.project_q(xt), k, v, bias, xt)
    without, probs, _ = pm.attend(pm.project_q(xt), k, v, bias, xt,
                                  return_probs=False)
    assert probs is None
    _, probs, _ = pm(xt[:B], et, return_probs=False)
    assert probs is None

    def jax_attend(m, x, enc):
        k, v = m.project_kv(enc)
        return m.attend(m.project_q(x), k, v, m._make_bias(None, 1, LK,
                                                           "ARFormer", 0), x,
                        return_probs=False)
    jh, jp, _ = jm.apply({"params": params}, x, enc, method=jax_attend)
    assert jp is None
    return [jh, jh], [with_probs, without]


def case_mha_hybrid_bias(rs):
    x, enc = _rand(rs, B, L, D), _rand(rs, B, LK, D)
    jm, pm = _mha_pair(hybrid_length=LK)
    params = _init(jm, x, encoder_hidden_states=enc)
    jh, jp, _ = jm.apply({"params": params}, x, encoder_hidden_states=enc)
    ph, pp, _ = _port(pm, params)(torch.as_tensor(x), torch.as_tensor(enc))
    return [jh, jp], [ph, pp]


def case_mha_beam_grouped_attend(rs):
    """Queries at B*beam rows attend keys at B rows (the decode layout)."""
    x, enc = _rand(rs, B * BEAM, 1, D), _rand(rs, B, LK, D)
    jm, pm = _mha_pair(hybrid_length=LK)
    params = _init(jm, x[:B], encoder_hidden_states=enc)
    pm = _port(pm, params)

    def jax_attend(m, x, enc):
        k, v = m.project_kv(enc)
        return m.attend(m.project_q(x), k, v, m._make_bias(None, 1, LK,
                                                           "ARFormer", 0), x)
    jh, jp, _ = jm.apply({"params": params}, x, enc, method=jax_attend)
    xt, et = torch.as_tensor(x), torch.as_tensor(enc)
    k, v = pm.project_kv(et)
    ph, pp, _ = pm.attend(pm.project_q(xt), k, v,
                          pm._make_bias(None, 1, LK, "ARFormer", 0), xt)
    return [jh, jp], [ph, pp]


def case_mha_fused_qkv(rs):
    x = _rand(rs, B * BEAM, 1, D)
    jm, pm = _mha_pair()
    params = _init(jm, x)
    jq, (jk, jv) = jm.apply({"params": params}, x,
                            method=jlay.MultiHeadAttention.project_qkv)
    pq, (pk, pv) = _port(pm, params).project_qkv(torch.as_tensor(x))
    return [jq, jk, jv], [pq, pk, pv]


def case_ffn(rs):
    x = _rand(rs, B, L, D)
    jm = jlay.PositionwiseFeedForward(dim_hidden=D, dim_intermediate=2 * D)
    params = _init(jm, x)
    pm = play.PositionwiseFeedForward(D, 2 * D, "relu", 0.5, 1e-12,
                                      torch.Generator().manual_seed(0))
    return ([jm.apply({"params": params}, x)],
            [_port(pm, params)(torch.as_tensor(x))])


def case_ffn_pre_ln(rs):
    x = _rand(rs, B, L, D)
    jm = jlay.PositionwiseFeedForward(dim_hidden=D, dim_intermediate=2 * D,
                                      pre_ln=True)
    params = _init(jm, x)
    pm = play.PositionwiseFeedForward(D, 2 * D, "relu", 0.5, 1e-12,
                                      torch.Generator().manual_seed(0),
                                      pre_ln=True)
    return ([jm.apply({"params": params}, x)],
            [_port(pm, params)(torch.as_tensor(x))])


def case_embeddings_rpe_pre_ln(rs):
    """``RPE`` drops the absolute position term (unless
    ``RPE_keep_abs_pos``), ``transformer_pre_ln`` the LN."""
    want, got = [], []
    for extra in (dict(RPE=True), dict(RPE=True, RPE_keep_abs_pos=True),
                  dict(transformer_pre_ln=True)):
        opt = dict(flagship_small_opt(), **extra)
        ids = rs.randint(0, opt["vocab_size"], (B, L)).astype(np.int32)
        shs = _rand(rs, B, opt["dim_hidden"])
        jm = jemb.Embeddings(opt)
        params = _init(jm, ids, semantic_hidden_states=shs)
        pm = _port(pemb.Embeddings(opt, torch.Generator().manual_seed(0)),
                   params)
        want.append(jm.apply({"params": params}, ids,
                             semantic_hidden_states=shs))
        got.append(pm(torch.as_tensor(ids).long(),
                      semantic_hidden_states=torch.as_tensor(shs)))
    return want, got


def case_embeddings(rs):
    """Word + trainable position + the per-token GSG add of ``emb`` mode."""
    opt = flagship_small_opt()
    ids = rs.randint(0, opt["vocab_size"], (B, L)).astype(np.int32)
    shs = _rand(rs, B, opt["dim_hidden"])
    jm = jemb.Embeddings(opt)
    params = _init(jm, ids, semantic_hidden_states=shs)
    pm = _port(pemb.Embeddings(opt, torch.Generator().manual_seed(0)), params)
    ids_t = torch.as_tensor(ids).long()
    out = [jm.apply({"params": params}, ids, semantic_hidden_states=shs),
           jm.apply({"params": params}, ids[:, 2:3],
                    semantic_hidden_states=shs,
                    position_ids=jnp.full((B, 1), 2))]
    got = [pm(ids_t, semantic_hidden_states=torch.as_tensor(shs)),
           pm(ids_t[:, 2:3], semantic_hidden_states=torch.as_tensor(shs),
              position_ids=torch.full((B, 1), 2))]
    return out, got


def case_embeddings_sinusoid(rs):
    """The fixed sinusoid position table (``trainable_pe`` off)."""
    opt = dict(flagship_small_opt(), trainable_pe=False)
    ids = rs.randint(0, opt["vocab_size"], (B, L)).astype(np.int32)
    jm = jemb.Embeddings(opt)
    params = _init(jm, ids)
    pm = _port(pemb.Embeddings(opt, torch.Generator().manual_seed(0)), params)
    return ([jm.apply({"params": params}, ids)],
            [pm(torch.as_tensor(ids).long())])


def _decoder_layer_pair(rs, **extra):
    opt = dict(flagship_small_opt(), **extra)
    lk = jlay.compute_hybrid_length(opt)
    x, enc = _rand(rs, B, L, opt["dim_hidden"]), _rand(rs, B, lk,
                                                       opt["dim_hidden"])
    jm = jlay.DecoderLayer(opt)
    params = _init(jm, x, enc)
    pm = _port(play.DecoderLayer(opt, torch.Generator().manual_seed(0)),
               params)
    return opt, jm, params, pm, x, enc


def case_decoder_layer_forward_pre_ln(rs):
    return case_decoder_layer_forward(rs, transformer_pre_ln=True)


def case_decoder_layer_step_pre_ln_and_flash(rs):
    """The KV-cached step of pre-LN layers with the flash switch forced on
    for the cross attention. As in the JAX package, the step projects its
    queries from the unnormalised input."""
    before = pflash.plain_forward_calls
    out = case_decoder_layer_step(rs, transformer_pre_ln=True,
                                  use_pallas_attention=True)
    assert pflash.plain_forward_calls == before + 1
    return out


def case_decoder_layer_forward(rs, **extra):
    opt, jm, params, pm, x, enc = _decoder_layer_pair(rs, **extra)
    ids = rs.randint(1, 50, (B, L))
    ids[0, -2:] = 0                                     # PAD keys
    jbias = jdec.key_pad_bias(jnp.asarray(ids), L) + jdec.causal_bias(L)
    jh, (jp_self, jp_cross), _, _ = jm.apply({"params": params}, x, enc,
                                             attention_mask=jbias)
    tids = torch.as_tensor(ids)
    pbias = pdec.key_pad_bias(tids, L) + pdec.causal_bias(L)
    ph, (pp_self, pp_cross), _, _ = pm(torch.as_tensor(x),
                                       torch.as_tensor(enc),
                                       attention_mask=pbias)
    return [jh, jp_self, jp_cross], [ph, pp_self, pp_cross]


def case_decoder_layer_step(rs, **extra):
    """One KV-cached step with beam-grouped cross K/V: rows B*beam, the
    cache partly filled, the step written at ``position``."""
    opt, jm, params, pm, _, enc = _decoder_layer_pair(rs, **extra)
    dh = opt["dim_hidden"] // opt["num_attention_heads"]
    cache_len, position = 6, 3
    x = _rand(rs, B * BEAM, 1, opt["dim_hidden"])
    cache_k = _rand(rs, B * BEAM, opt["num_attention_heads"], cache_len, dh)
    cache_v = _rand(rs, B * BEAM, opt["num_attention_heads"], cache_len, dh)
    bias = np.where(np.arange(cache_len) <= position, 0.0, -1e9).astype(
        np.float32)[None, None, None]

    def jax_step(m, x, enc, ck, cv):
        q, (k, v) = m.self_qkv(x)
        ck = jnp.asarray(ck).at[:, :, position].set(k[:, :, 0])
        cv = jnp.asarray(cv).at[:, :, position].set(v[:, :, 0])
        return m.step(x, position, (ck, cv), m.init_step(enc)[0],
                      self_bias=bias, q=q)
    want = jm.apply({"params": params}, x, enc, cache_k, cache_v,
                    method=jax_step)
    xt = torch.as_tensor(x)
    q, (k, v) = pm.self_qkv(xt)
    ck, cv = torch.as_tensor(cache_k), torch.as_tensor(cache_v)
    ck[:, :, position:position + 1] = k
    cv[:, :, position:position + 1] = v
    inter_kv, _ = pm.init_step(torch.as_tensor(enc))
    got = pm.step(xt, position, (ck, cv), inter_kv,
                  self_bias=torch.as_tensor(bias), q=q)
    return [want], [got]


def case_masks(rs):
    ids = rs.randint(0, 4, (B, L))
    jb = [jdec.key_pad_bias(jnp.asarray(ids), 3), jdec.causal_bias(L),
          jdec.causal_bias(L, watch=2),
          jdec.prefix_mask_surgery(jdec.key_pad_bias(jnp.asarray(ids), L)
                                   + jdec.causal_bias(L), 2)]
    tids = torch.as_tensor(ids)
    pb = [pdec.key_pad_bias(tids, 3), pdec.causal_bias(L),
          pdec.causal_bias(L, watch=2),
          pdec.prefix_mask_surgery(pdec.key_pad_bias(tids, L)
                                   + pdec.causal_bias(L), 2)]
    return jb, pb


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case):
    rs = np.random.RandomState(7)
    with torch.no_grad():
        want, got = CASES[case](rs)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (case, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=case)
