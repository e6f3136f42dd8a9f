"""Logging helpers: AverageMeter, CSV results, caption-quality stats.

Port of ``care_tpu/utils/logger.py``; ``pandas`` is imported only inside
``save_dict_to_csv``, the one function that writes a table.

Parity targets: reference ``misc/logger.py:51-70`` (AverageMeter),
``misc/utils.py:363-372`` (save_dict_to_csv) and ``misc/utils.py:390-419``
(ave-length / novel / unique / vocab-usage analysis).
"""

import os
from collections import defaultdict
from typing import Dict


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1, multiply=True):
        self.val = val
        if multiply:
            self.sum += val * n
        else:
            self.sum += val
        self.count += n
        self.avg = self.sum / max(self.count, 1e-12)


class MetricTracker:
    """Accumulates (sum, count) style metrics across steps."""

    def __init__(self):
        self.sums = defaultdict(float)

    def update(self, metrics: Dict[str, float]):
        for k, v in metrics.items():
            self.sums[k] += float(v)

    def ratio(self, num_key: str, den_key: str, default=0.0):
        den = self.sums.get(den_key, 0.0)
        return self.sums.get(num_key, 0.0) / den if den else default

    def reset(self):
        self.sums.clear()


def save_dict_to_csv(path: str, file_name: str, dict_data: dict):
    import pandas

    os.makedirs(path, exist_ok=True)
    if ".csv" not in file_name:
        file_name += ".csv"
    csv_path = os.path.join(path, file_name)
    df = pandas.DataFrame([dict_data])
    if os.path.exists(csv_path):
        df.to_csv(csv_path, index=False, mode="a", header=False)
    else:
        df.to_csv(csv_path, index=False, mode="w")


def _ngram_counts_from_preds(data, n=1):
    gram_count, sents = {}, {}
    ave_length, count = 0, 0
    for k in data:
        for entry in data[k]:
            cap = entry["caption"]
            sents[cap] = sents.get(cap, 0) + 1
            toks = cap.split(" ")
            ave_length += len(toks)
            count += 1
            for j in range(len(toks) - n + 1):
                key = " ".join(toks[j:j + n])
                gram_count[key] = gram_count.get(key, 0) + 1
    return gram_count, sents, ave_length / max(count, 1), count


def analyze_length_novel_unique(gt_captions, preds, vocab, splits, n=1):
    """reference ``misc/utils.py:406-419``."""
    hy_res, hy_sents, ave_length, hy_count = _ngram_counts_from_preds(preds, n)

    gt_sents = {}
    for i in splits["train"]:
        caps = gt_captions["video%d" % int(i)]
        for tmp in caps:
            cap = " ".join(vocab[wid] for wid in tmp[1:-1])
            gt_sents[cap] = gt_sents.get(cap, 0) + 1

    novel_count = sum(1 for s in hy_sents if s not in gt_sents)
    novel = novel_count / max(hy_count, 1)
    unique = len(hy_sents) / max(hy_count, 1)
    usage = len(hy_res)
    return ave_length, novel, unique, usage


def to_sentence(hyp, vocab, break_words=(0, 3), skip_words=(2,)):
    """Token ids -> sentence; break at PAD/EOS, skip BOS
    (reference ``misc/utils.py:117``-ish semantics)."""
    tokens = []
    for wid in hyp:
        if wid in skip_words:
            continue
        if wid in break_words:
            break
        tokens.append(vocab[wid])
    return " ".join(tokens)
