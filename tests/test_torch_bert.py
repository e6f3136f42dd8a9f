"""BERT caption embeddings of the port (``care_tpu_torch/pretreatment/
bert.py``) against ``care_tpu/pretreatment/bert.py`` and HuggingFace, on a
tiny random-init HF ``BertModel`` and a local vocab.txt (no downloads):

* the WordPiece tokenizer: ids equal to ``care_tpu``'s and HF's
  ``BertTokenizer``'s on the texts of ``tests/test_bert.py``, and
  ``encode_batch``'s arrays equal to ``care_tpu``'s;
* the encoder on one converted ``BertModel``: the last hidden states
  within 2e-5 absolute + 1e-4 relative of ``care_tpu``'s and of HF's (the
  bound ``tests/test_bert.py`` holds ``care_tpu`` to), and the converted
  state equal to ``care_tpu``'s flax tree under its names;
* pooling (mean, max) of the same hidden states: within 1e-6 of
  ``care_tpu``'s (the mean sums in another order), max exactly;
* ``extract_text_embs``: the HDF5 file of each mode, video by video,
  within the encoder's bound of ``care_tpu``'s.

f32, the CPU.
"""

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.pretreatment import bert as jax_bert
from care_tpu_torch.models.weights import flat_leaves, params_from_jax
from care_tpu_torch.pretreatment import bert

VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
         "a", "man", "is", "running", "fast", "the", "dogs", "##s",
         "play", "##ing", "guitar", "##ist", "on", "stage", ",", ".", "!",
         "2", "##0", "co", "##ok", "dog"]
TEXTS = ["A man is running fast.", "the dogs are playing, on stage!",
         "cooking 20 guitarists", "the guitarist plays",
         "Ünïcode   spaces\tand\nnewlines", "a" * 120]
CAPTIONS = ["a man is running fast", "the dogs play!", "cooking",
            "a guitarist on stage , the man is playing guitar"]
BOUND = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("bert") / "vocab.txt"
    p.write_text("\n".join(VOCAB) + "\n")
    return str(p)


@pytest.fixture(scope="module")
def hf_bert():
    from transformers import BertConfig, BertModel
    torch.manual_seed(0)
    cfg = BertConfig(vocab_size=len(VOCAB), hidden_size=32,
                     num_hidden_layers=2, num_attention_heads=4,
                     intermediate_size=64, max_position_embeddings=40,
                     hidden_dropout_prob=0.0,
                     attention_probs_dropout_prob=0.0)
    return BertModel(cfg).eval()


def _converted(hf_bert):
    sd = {k: v.numpy() for k, v in hf_bert.state_dict().items()}
    state, config = bert.convert_hf_bert_state_dict(sd)
    variables, jax_config = jax_bert.convert_hf_bert_state_dict(sd)
    assert config == jax_config
    # the tiny model's 4 heads (hidden // 64 would floor to 1)
    config["heads"] = jax_config["heads"] = 4
    return state, config, variables, jax_config


@pytest.mark.parametrize("text", TEXTS)
def test_wordpiece_matches_care_tpu_and_hf(vocab_file, text):
    from transformers import BertTokenizer
    hf = BertTokenizer(vocab_file=vocab_file, do_lower_case=True)
    got = bert.WordPieceTokenizer(vocab_file).tokenize(text)
    assert got == jax_bert.WordPieceTokenizer(vocab_file).tokenize(text)
    assert got == hf.encode(text, add_special_tokens=False)


def test_encode_batch_equals_care_tpu(vocab_file):
    got = bert.WordPieceTokenizer(vocab_file).encode_batch(CAPTIONS,
                                                           max_len=8)
    want = jax_bert.WordPieceTokenizer(vocab_file).encode_batch(CAPTIONS,
                                                                max_len=8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_encoder_matches_care_tpu_and_hf(hf_bert, vocab_file):
    state, config, variables, jax_config = _converted(hf_bert)
    model = bert.load_bert(state, config, device="cpu")
    # the converted state is care_tpu's flax tree under the port's names
    carried = bert.BertEncoder(**config)
    params_from_jax(carried, variables["params"])
    for name, value in carried.state_dict().items():
        assert torch.equal(value, model.state_dict()[name]), name
    assert len(dict(flat_leaves(variables["params"]))) == len(state)

    ids, mask, lens = bert.WordPieceTokenizer(vocab_file).encode_batch(
        CAPTIONS)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(mask)).numpy()
        hf = hf_bert(input_ids=torch.from_numpy(ids).long(),
                     attention_mask=torch.from_numpy(mask).long()
                     ).last_hidden_state.numpy()
    want = np.asarray(jax_bert.BertEncoder(**jax_config).apply(
        variables, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, **BOUND)
    np.testing.assert_allclose(got, hf, **BOUND)

    # pooling of the same hidden states, numpy and tensor inputs
    for mode in ("mean", "max"):
        ref = jax_bert.pool_caption_embs(want, lens, mode)
        pooled = bert.pool_caption_embs(want, lens, mode)
        assert isinstance(pooled, np.ndarray)
        np.testing.assert_allclose(pooled, ref, rtol=0,
                                   atol=0 if mode == "max" else 1e-6)
        tensor = bert.pool_caption_embs(torch.from_numpy(np.array(want)),
                                        torch.from_numpy(lens), mode)
        np.testing.assert_array_equal(tensor.numpy(), pooled)
    embs = bert.embed_captions(model, bert.WordPieceTokenizer(vocab_file),
                               CAPTIONS, ("mean", "max"), batch_size=3)
    for mode in ("mean", "max"):
        np.testing.assert_allclose(
            embs[mode].numpy(), jax_bert.pool_caption_embs(want, lens, mode),
            **BOUND)


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_extract_text_embs_matches_care_tpu(hf_bert, vocab_file, tmp_path,
                                            mode):
    state, config, variables, jax_config = _converted(hf_bert)
    refs = {"video0": [{"caption": c} for c in CAPTIONS[:2]],
            "video1": [{"caption": CAPTIONS[2]}],
            "video2": [{"caption": c} for c in CAPTIONS]}
    got_path, want_path = str(tmp_path / "port.hdf5"), str(
        tmp_path / "jax.hdf5")
    bert.extract_text_embs(bert.load_bert(state, config, device="cpu"), refs,
                           bert.WordPieceTokenizer(vocab_file), got_path,
                           mode=mode)
    jax_bert.extract_text_embs(variables, refs,
                               jax_bert.WordPieceTokenizer(vocab_file),
                               want_path, mode=mode, config=jax_config)
    with h5py.File(got_path) as got, h5py.File(want_path) as want:
        assert sorted(got) == sorted(want) == sorted(refs)
        for vid in want:
            assert got[vid].dtype == want[vid].dtype == np.float32
            np.testing.assert_allclose(np.asarray(got[vid]),
                                       np.asarray(want[vid]), **BOUND)
