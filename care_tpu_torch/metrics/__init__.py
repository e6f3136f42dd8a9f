"""COCO caption metrics (port of ``care_tpu/metrics``)."""

from care_tpu_torch.metrics.cocoscorer import COCOScorer, score_predictions

__all__ = ["COCOScorer", "score_predictions"]
