"""Analysis tools that take the place of the reference's notebooks.

Port of ``care_tpu/analysis.py``:

* ``hybrid_attention_bias``: the learned per-head bias over the
  [video frames | concept slots] key axis (the notebook's hybrid-attention
  study), with the frame-against-concept split of its mass;
* ``retrieval_robustness_sweep``: one checkpoint evaluated across
  corrupted retrieval databases (the ``--retrieval_db_ratio`` protocol,
  reference ``scripts/retrieval_db_ratio.sh``);
* ``concept_usage``: which predicted concepts appear in generated captions;
* ``topic_classification_probe``: an SVM probe of the GSG latent topic
  vector (the reference's MSRVTT_topic_classification_SVM notebook).
"""

from typing import Any, Dict, List

import numpy as np
import torch

from care_tpu_torch.models.weights import flat_leaves


def hybrid_attention_bias(variables, opt) -> Dict[str, Any]:
    """Collect the hybrid-bias parameters of the flax-named tree
    ``variables`` (``models/weights.py:variables_to_jax(model)``, or its
    ``params``) and summarise the split of attention mass between
    video-frame keys and concept-slot keys."""
    modality = opt.get("modality_for_decoder") or opt["modality"]
    n_video = opt["n_frames"] * len(modality.replace("t", "").replace("r", ""))
    out = {}
    for key, value in flat_leaves(variables.get("params", variables)):
        path = "/".join(key)
        if path.endswith("hybrid_bias"):
            bias = np.asarray(value)       # [n_heads, hybrid_length]
            video = bias[:, :n_video]
            concept = bias[:, n_video:]
            out[path] = {
                "bias": bias,
                "video_mean": float(video.mean()),
                "concept_mean": float(concept.mean()) if concept.size else None,
                "per_head_concept_minus_video":
                    (concept.mean(axis=1) - video.mean(axis=1)).tolist()
                    if concept.size else None,
            }
    return out


def concept_usage(preds: Dict[str, List[dict]], semantic_labels: np.ndarray,
                  video_ids: List[str], itow: Dict[int, str],
                  attribute_start: int = 6) -> Dict[str, float]:
    """Fraction of generated-caption words that are among the video's
    predicted top-k concepts."""
    vid2labels = {v: semantic_labels[i] for i, v in enumerate(video_ids)}
    used, total = 0, 0
    for vid, entries in preds.items():
        if vid not in vid2labels:
            continue
        concepts = {itow.get(int(c) + attribute_start)
                    for c in vid2labels[vid]}
        for e in entries:
            for w in e["caption"].split():
                total += 1
                if w in concepts:
                    used += 1
    return {"concept_word_ratio": used / max(total, 1)}


def retrieval_robustness_sweep(checkpoint_path: str, ratios=(0.1, 1, 10, 100),
                               device=None, **load_kwargs
                               ) -> Dict[float, Dict[str, float]]:
    """Evaluate one checkpoint across retrieval-database corruption ratios,
    on ``device`` (None = the CUDA card)."""
    from care_tpu_torch.data import get_loader
    from care_tpu_torch.data.corpus import load_info_corpus, load_references
    from care_tpu_torch.decoding import get_translator
    from care_tpu_torch.metrics import COCOScorer
    from care_tpu_torch.models.loading import (load_model,
                                               modify_opt_if_necessary)
    from care_tpu_torch.utils.logger import to_sentence

    results = {}
    for ratio in ratios:
        models, opt = load_model(checkpoint_path, device=device,
                                 **load_kwargs)
        opt = modify_opt_if_necessary(opt, retrieval_db_ratio=ratio)
        info = load_info_corpus(opt["info_corpus"])
        refs = load_references(opt["reference"])
        vocab = info["info"]["itow"]
        loader = get_loader(opt, "test", not_shuffle=True)
        translator = get_translator(opt, device)
        preds = {}
        for batch in loader:
            hyps, scores = translator.translate_batch(
                models, {"feats": batch["feats"]})
            for i, vid in enumerate(batch["video_ids"]):
                h = hyps[i][0] if isinstance(hyps[i][0], list) else hyps[i]
                preds[vid] = [{"image_id": vid,
                               "caption": to_sentence(h, vocab)}]
        scorer = COCOScorer()
        scores, _ = scorer.score(refs, preds, list(preds.keys()))
        results[ratio] = scores
    return results


@torch.no_grad()
def topic_classification_probe(model, loader, categories, n_train: int,
                               use_latent: bool = True,
                               seed: int = 0) -> Dict[str, float]:
    """SVM topic-classification probe (reference
    ``notebooks/MSRVTT_topic_classification_SVM.ipynb``): does the GSG
    latent topic vector carry category information?

    Encodes every video with the port's ``model.encoding_phase``
    (``loader`` must iterate the 'all' split unshuffled in video order),
    takes the GSG latent (``semantic_hidden_states``, GSG on) or the mean
    semantic embedding (``semantic_embs``, GSG off), fits an RBF SVC on
    the first ``n_train`` videos' categories, and reports test accuracy
    against a random-guess baseline.
    """
    from sklearn.svm import SVC

    device = next(model.parameters()).device
    feats_list = []
    for batch in loader:
        feats = [torch.as_tensor(np.asarray(f), device=device)
                 for f in batch["feats"]]
        out = model.encoding_phase(feats)
        x = (out["semantic_hidden_states"] if use_latent
             else out["semantic_embs"].mean(dim=1))
        feats_list.append(x.float().cpu().numpy())
    x = np.concatenate(feats_list, axis=0)
    y = np.asarray(categories)
    assert x.shape[0] == y.shape[0], (x.shape, y.shape)

    train_x, test_x = x[:n_train], x[n_train:]
    train_y, test_y = y[:n_train], y[n_train:]
    svc = SVC(random_state=seed, kernel="rbf")
    svc.fit(train_x, train_y)
    acc = float((svc.predict(test_x) == test_y).mean() * 100)

    rng = np.random.RandomState(seed)
    n_classes = int(y.max()) + 1
    rand_acc = float(
        (rng.randint(0, n_classes, test_y.shape) == test_y).mean() * 100)
    return {"accuracy": acc, "random_accuracy": rand_acc,
            "n_train": int(n_train), "n_test": int(len(test_y))}
