"""Pretreatment: the CLIP and ImageNet towers' inference over frames, the
CLIP tokenizer, frame extraction and the retrieval database (port of
``care_tpu/pretreatment``'s image and retrieval side)."""
