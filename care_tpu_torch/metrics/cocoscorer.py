"""COCOScorer: the reference's scoring entry point (``misc/cocoeval.py:44-104``).

Port of ``care_tpu/metrics/cocoscorer.py``.

``score(GT, RES, IDs)`` takes references dict[vid] -> list of
{'image_id','caption', ('tokenized')} and predictions dict[vid] -> list with
one {'image_id','caption'}; tokenizes both and computes
Bleu_1..4 / METEOR / ROUGE_L / CIDEr, returning (scores, per-image scores).
"""

from typing import Dict, List

from care_tpu_torch.metrics.tokenizer import tokenize_corpus
from care_tpu_torch.metrics.bleu import compute_bleu
from care_tpu_torch.metrics.rouge import compute_rouge
from care_tpu_torch.metrics.cider import compute_cider
from care_tpu_torch.metrics.meteor import compute_meteor


class COCOScorer:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose
        self.eval: Dict[str, float] = {}
        self.img_to_eval: Dict[str, Dict[str, float]] = {}

    def score(self, GT, RES, IDs):
        gts = {}
        res = {}
        for vid in IDs:
            gts[vid] = GT[vid]
            res[vid] = RES[vid]

        # references may carry a pre-tokenized field like the reference
        # pipeline's refs.pkl; otherwise tokenize here
        def pick(entry):
            if isinstance(entry, dict):
                return {"caption": entry.get("tokenized")
                        or entry.get("caption")}
            return {"caption": entry}

        gts = {k: [pick(e) for e in v] for k, v in gts.items()}
        res = {k: [pick(e) for e in v] for k, v in res.items()}
        gts = tokenize_corpus(gts)
        res = tokenize_corpus(res)

        bleus, bleu_per_img = compute_bleu(gts, res)
        meteor, meteor_per_img = compute_meteor(gts, res)
        rouge, rouge_per_img = compute_rouge(gts, res)
        cider, cider_per_img = compute_cider(gts, res)

        scores = {
            "Bleu_1": bleus[0], "Bleu_2": bleus[1],
            "Bleu_3": bleus[2], "Bleu_4": bleus[3],
            "METEOR": meteor, "ROUGE_L": rouge, "CIDEr": cider,
        }
        self.eval = scores

        ids = list(gts.keys())
        self.img_to_eval = {}
        for i, vid in enumerate(ids):
            self.img_to_eval[vid] = {
                "Bleu_1": bleu_per_img[0][i], "Bleu_2": bleu_per_img[1][i],
                "Bleu_3": bleu_per_img[2][i], "Bleu_4": bleu_per_img[3][i],
                "METEOR": meteor_per_img[i], "ROUGE_L": rouge_per_img[i],
                "CIDEr": cider_per_img[i], "image_id": vid,
            }
        return scores, self.img_to_eval


def score_predictions(references: Dict[str, List[dict]],
                      predictions: Dict[str, List[dict]]):
    scorer = COCOScorer()
    return scorer.score(references, predictions, list(predictions.keys()))
