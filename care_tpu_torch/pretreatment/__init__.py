"""Pretreatment: the CLIP and ImageNet towers' inference over frames, the
CLIP tokenizer, frame extraction and the retrieval database, and the text
side: annotation parsing, corpora, GloVe and BERT caption embeddings (port
of ``care_tpu/pretreatment``)."""
