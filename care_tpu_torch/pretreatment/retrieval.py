"""Cross-modal retrieval database and its self-evaluation.

Port of ``care_tpu/pretreatment/retrieval.py`` (reference
``pretreatment/clip_retrieval.py``): a video's embedding is the mean of n
uniformly sampled frame embeddings; both sides are L2-normalised; the
cosine similarities ``image @ text.T`` rank the captions; the query
video's own caption range [start, end) is skipped and duplicate captions
dropped on the host, keeping the top k; each video's caption embeddings
go under ``<vid>`` and the flat caption indices under ``<vid>_i``.
``evaluate_retrieval`` reports R@{1,5,10}, mAP and the median and mean
rank.

The similarities are formed on the device in row chunks, each product
accumulated in f64 and rounded to f32: the f32 value of the exact dot
product, so the ranking does not depend on the order in which a device
sums, and the card ranks as the CPU does. Ties are broken as
``care_tpu``'s ``lax.top_k`` and stable ``argsort`` break them: the lower
caption index first.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from care_tpu_torch.data.samplers import get_uniform_ids_from_k_snippets
from care_tpu_torch.utils.device import resolve_device

# similarity entries held at once by a chunk (f64, then f32 and bools)
_CHUNK_ELEMENTS = 2 ** 27


def video_embeddings_from_frames(frame_embs: np.ndarray, n_frames: int):
    """(n_total_frames, d) -> (d,): the mean of uniformly sampled
    frames."""
    ids = get_uniform_ids_from_k_snippets(frame_embs.shape[0], n_frames)
    return frame_embs[ids].mean(axis=0)


def l2_normalize(x, axis=-1, eps=1e-12):
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, eps)


def _chunks(image: torch.Tensor, text: torch.Tensor):
    """(row offset, f32 similarities [rows, n_text]) over row chunks of
    ``image`` [n_image, d] against ``text`` [n_text, d] (both f64 on the
    device)."""
    rows = max(1, _CHUNK_ELEMENTS // text.shape[0])
    for start in range(0, image.shape[0], rows):
        yield start, (image[start:start + rows] @ text.T).float()


def _device_pair(image_features, text_features, device):
    img = torch.as_tensor(l2_normalize(np.asarray(image_features,
                                                  np.float32)),
                          dtype=torch.float32, device=device)
    txt = torch.as_tensor(l2_normalize(np.asarray(text_features,
                                                  np.float32)),
                          dtype=torch.float32, device=device)
    return img.double(), txt.double()


def topk_lowest_index(sims: torch.Tensor, k: int) -> torch.Tensor:
    """Per row of ``sims`` the indices of the ``k`` largest values in
    descending order, equal values lowest index first (``lax.top_k``'s
    order, which ``torch.topk`` does not promise)."""
    vals, idx = torch.topk(sims, k, dim=1)
    # within the chosen set: index order, then a stable sort by value
    idx, perm = idx.sort(dim=1)
    vals = vals.gather(1, perm)
    vals, order = vals.sort(dim=1, descending=True, stable=True)
    idx = idx.gather(1, order)
    # rows whose k-th value is tied with entries left out: the set itself
    # may be the wrong one, so those rows take a full stable sort
    kth = vals[:, -1:]
    left_out = (sims == kth).sum(dim=1) > (vals == kth).sum(dim=1)
    if bool(left_out.any()):
        rows = left_out.nonzero()[:, 0]
        idx[rows] = torch.sort(sims[rows], dim=1, descending=True,
                               stable=True)[1][:, :k]
    return idx


def sims_topk(image_features: np.ndarray, text_features: np.ndarray, k: int,
              device=None) -> np.ndarray:
    """The top ``k`` caption indices [n_image, k] of every video by cosine
    similarity (``care_tpu``'s ``_sims_topk``), on ``device`` (None: the
    card)."""
    img, txt = _device_pair(image_features, text_features,
                            resolve_device(device))
    return np.concatenate([topk_lowest_index(s, k).cpu().numpy()
                           for _, s in _chunks(img, txt)], axis=0)


def retrieve_topk(image_features: np.ndarray, text_features: np.ndarray,
                  topk: int,
                  own_ranges: Optional[List[Tuple[int, int]]] = None,
                  refs: Optional[List[str]] = None, unique: bool = False,
                  candidate_factor: int = 20,
                  device=None) -> List[List[int]]:
    """For each video the top-k caption indices after the own-video and
    duplicate filters: ``topk * candidate_factor + 64`` candidates come
    from the device, the filters walk them on the host."""
    k = min(topk * candidate_factor + 64, text_features.shape[0])
    indices = sims_topk(image_features, text_features, k, device)
    results = []
    for i in range(indices.shape[0]):
        start, end = own_ranges[i] if own_ranges is not None else (-1, -1)
        unique_caps = set()
        relevant = []
        for ind in indices[i]:
            ind = int(ind)
            if start <= ind < end:
                continue
            if unique:
                cap = refs[ind]
                if cap in unique_caps:
                    continue
                unique_caps.add(cap)
            relevant.append(ind)
            if len(relevant) == topk:
                break
        results.append(relevant)
    return results


def build_retrieval_db(out_path: str, video_keys: Sequence[str],
                       image_features: np.ndarray,
                       text_features: np.ndarray,
                       store_embs: np.ndarray,
                       topk: int,
                       own_ranges=None, refs=None, unique: bool = True,
                       device=None):
    """Write ``retrieval/*.hdf5``: per video its top-k caption embeddings
    under ``<vid>`` and the flat caption indices under ``<vid>_i``."""
    import h5py
    ids = retrieve_topk(image_features, text_features, topk,
                        own_ranges=own_ranges, refs=refs, unique=unique,
                        device=device)
    with h5py.File(out_path, "w") as hf:
        for vid, relevant in zip(video_keys, ids):
            hf.create_dataset(vid, data=store_embs[relevant])
            hf.create_dataset(vid + "_i",
                              data=np.asarray(relevant, np.int64))
    return ids


def own_caption_ranks(image_features: np.ndarray, text_features: np.ndarray,
                      own_ranges: List[Tuple[int, int]],
                      device=None) -> List[np.ndarray]:
    """Per video the 0-based ranks of its own captions among all captions
    in descending similarity, ties lowest index first: ``care_tpu``'s
    ``argsort(argsort(-sims))`` (a stable sort) at the own range, counted
    as the captions above plus the equal ones of lower index, with no
    sort."""
    device = resolve_device(device)
    img, txt = _device_pair(image_features, text_features, device)
    width = max(end - start for start, end in own_ranges)
    cols = torch.tensor([list(range(s, e)) + [s] * (width - e + s)
                         for s, e in own_ranges], device=device)
    col_ids = torch.arange(txt.shape[0], device=device)
    # the comparisons expand each row by its own captions: sub-chunks
    step = max(1, _CHUNK_ELEMENTS // (txt.shape[0] * width))
    ranks = []
    for start, chunk in _chunks(img, txt):
        for s in range(0, chunk.shape[0], step):
            sims = chunk[s:s + step]
            c = cols[start + s:start + s + sims.shape[0]]
            own = sims.gather(1, c)[:, :, None]               # [R, W, 1]
            above = (sims[:, None, :] > own).sum(dim=2)
            tied_before = ((sims[:, None, :] == own)
                           & (col_ids < c[:, :, None])).sum(dim=2)
            ranks.append(above + tied_before)
    ranks = torch.cat(ranks).cpu().numpy()
    return [ranks[i, :e - s] for i, (s, e) in enumerate(own_ranges)]


def evaluate_retrieval(image_features: np.ndarray, text_features: np.ndarray,
                       own_ranges: List[Tuple[int, int]],
                       k_list=(1, 5, 10), device=None) -> Dict[str, float]:
    """R@K, mAP, median and mean rank of the retrieval itself (reference
    ``clip_retrieval.py:192-234``)."""
    all_rank, all_precision = [], []
    recall = {k: [] for k in k_list}
    for gt_rank in own_caption_ranks(image_features, text_features,
                                     own_ranges, device):
        gt_rank = gt_rank.astype(np.float64)
        all_rank.append(gt_rank.min() + 1)
        for k in k_list:
            recall[k].append(1.0 if (gt_rank < k).sum() > 0 else 0.0)
        sorted_hit = np.sort(gt_rank)
        ids = np.arange(len(sorted_hit))
        all_precision.append(((ids + 1) / (sorted_hit + 1)).mean())

    out = {f"R@{k}": float(np.mean(recall[k]) * 100) for k in k_list}
    out["mAP"] = float(np.mean(all_precision) * 100)
    out["MedianRank"] = float(np.median(all_rank))
    out["MeanRank"] = float(np.mean(all_rank))
    return out
