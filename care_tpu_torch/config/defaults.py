"""Default option values.

One flat dict with the same key space as the reference CLI and as the JAX
package's ``care_tpu/config/defaults.py``, so presets and saved options
mean the same in both packages. Keys that only the JAX package reads
(``compute_dtype``, ``mesh_shape`` ...) stay, so that the two option dicts
compare equal; the port raises ``NotImplementedError`` where a value asks
for a branch it does not implement.
"""

import copy


_DEFAULTS = {
    # ----- experiment selection -------------------------------------------
    "dataset": "MSRVTT",            # MSVD | MSRVTT | VATEX
    "modality": "mi",               # chars in 'amiort'
    "scope": "",
    "method": "",
    "task": "",
    "feats": "",
    "arch": "base",
    "setup": "naive",
    "wrapper": "Model",             # Model | MultipleOptimizerModel | InterplayModel
    "pretrain_epochs": 10,

    # ----- module selection -----------------------------------------------
    "encoder": "Embedder",
    "decoder": "TransformerDecoder",
    "pointer": None,
    "cls_head": "NaiveHead",
    "decoding_type": "ARFormer",    # ARFormer | NARFormer
    "fusion": "temporal_concat",    # temporal_concat | addition | none | channel_concat

    # pointer-generator settings
    "copy_scale": 1.0,
    "exclude_eos": False,
    "has_retrieval_embs": False,
    "has_retrieval_rnn": False,
    "retrieval": False,
    "retrieval_topk": 20,
    "retrieval_arch": "ViT",
    "retrieval_unique_max_len": 50,

    # ----- common model settings --------------------------------------------
    "dim_hidden": 512,
    "encoder_dropout_prob": 0.5,
    "hidden_dropout_prob": 0.5,
    "with_category": False,
    "num_category": 20,
    "use_category_embs": False,
    "dim_category": 300,
    "pretrained_embs_path": "",
    "train_emb": False,
    "load_model_weights_from": "",
    "load_strictly": False,
    "freeze_parameters_except": [],
    "with_backbones": [],

    # ----- transformer model settings ---------------------------------------
    "transformer_pre_ln": False,
    "trainable_pe": False,
    "mha_exclude_bias": False,
    "num_hidden_layers_encoder": 1,
    "num_hidden_layers_decoder": 1,
    "num_hidden_layers_text": 1,
    "crosslayer_no_ffn": False,
    "num_attention_heads": 8,
    "intermediate_size": 2048,
    "hidden_act": "relu",
    "attention_probs_dropout_prob": 0.1,
    "layer_norm_eps": 1e-12,
    "watch": 0,
    "pos_attention": False,
    "enhance_input": 2,             # NAR decoder input enhancement: 0 none | 1 resample | 2 mean-pool
    "RPE": False,
    "RPE_keep_abs_pos": False,
    "max_relative_position": 30,

    # ----- rnn model settings -----------------------------------------------
    "rnn_type": "lstm",
    "with_multileval_attention": False,
    "feats_share_weights": False,
    "rnn_use_mha": False,

    # ----- training ----------------------------------------------------------
    "seed": 0,
    "epochs": 50,
    "batch_size": 64,
    "max_steps": None,
    "skip_substr_list": [],

    # scheduled sampling (rnn decoders)
    "scheduled_sampling_start": -1,
    "scheduled_sampling_increase_every": 5,
    "scheduled_sampling_increase_prob": 0.05,
    "scheduled_sampling_max_prob": 0.25,

    # non-autoregressive training
    "with_teacher_during_training": False,
    "teacher_path": "",
    "teacher_scope": "",
    "beta": [0, 1],                 # MLM masking-ratio range
    "visual_word_generation": False,
    "demand": ["VERB", "NOUN"],
    "nv_weights": [0.8, 1.0],
    "load_teacher_weights": False,
    "length_prediction": False,
    "length_prediction_scale": 1.0,

    # ----- optimizer / scheduler ---------------------------------------------
    "learning_rate": 5e-4,
    "learning_rate_warmup_steps": 1000,
    "learning_rate_warmup_ratio": 0.0,
    "weight_decay": 0.001,
    "filter_weight_decay": False,
    "filter_biases": False,
    "gradient_clip_val": 0.0,
    "lr_scheduler_type": "linear",  # linear | step | cosine | plateau
    "lr_decay": 0.9,
    "lr_step_size": 1,
    "lr_monitor_mode": "max",
    "lr_monitor_metric": "CIDEr",
    "lr_monitor_patience": 1,
    "min_lr": 1e-6,
    "low_learning_rate": 5e-5,
    "lowlr_start_epoch": 10,

    # ----- evaluation ----------------------------------------------------------
    "check_val_every_n_epoch": 1,
    "metric_sum": [1, 1, 1, 1],     # mask over [Bleu_4, METEOR, ROUGE_L, CIDEr]
    "save_csv": False,
    "VATEX_I3D_preds_json": "",

    # autoregressive decoding
    "beam_size": 5,
    "beam_alpha": 1.0,
    "topk": 1,

    # non-autoregressive decoding
    "paradigm": "mp",               # mp | l2r | ef
    "length_beam_size": 6,
    "iterations": 5,
    "q": 1,
    "q_iterations": 1,
    "use_ct": False,
    "length_bias": 0,
    "masking_decision": False,
    "no_candidate_decision": False,
    "algorithm_print_sent": False,
    "na_length_range": [5, 11],

    # ----- checkpointing --------------------------------------------------------
    "monitor_metric": "CIDEr",
    "monitor_mode": "max",
    "save_topk_models": 1,
    "start_saving_epoch": 0,

    # ----- dataloader -------------------------------------------------------------
    "base_data_path": "",
    "max_len": 30,
    "n_frames": 28,
    "n_caps_per_video": 0,
    "random_type": "equally_sampling",  # equally_sampling | segment_random | all_random
    "load_feats_type": 1,
    "num_workers": 1,
    "n_total_frames": 60,
    "dim_a": 1,
    "dim_m": 2048,
    "dim_i": 2048,
    "dim_o": 1,
    "dim_t": 1,
    "dim_r": 1,
    "feats_a_name": [],
    "feats_m_name": ["motion_resnext101_kinetics_duration16_overlap8.hdf5"],
    "feats_i_name": ["image_resnet101_imagenet_fps_max60.hdf5"],
    "feats_o_name": [],
    "feats_t_name": [],
    "feats_r_name": [],
    "itoc_path": "",
    "info_corpus_name": "info_corpus.pkl",
    "reference_name": "refs.pkl",

    # ----- multitask -----------------------------------------------------------------
    "crits": ["lang"],
    "language_generation_scale": 1.0,
    "label_smoothing": 0.0,
    "calculate_mAP": False,
    "save_AP_path": None,

    # precomputed semantic logits attached to the feature list
    "logits": [],

    # mean teacher
    "distillation_weight": 0.01,
    "ema_weight": 0.999,
    "eval_model": "teacher",

    # ----- attribute prediction (concept detection / MCD) -------------------------------
    "attribute_prediction": False,
    "attribute_prediction_k": 500,
    "attribute_prediction_channel_concat": False,
    "attribute_prediction_mean_pooling": False,
    "attribute_prediction_flags": "V",
    "attribute_prediction_scales": [1.0],
    "attribute_prediction_sparse_sampling": False,
    "attribute_prediction_share_prj": False,
    "TAP_pos": False,
    "TAP_ln": False,
    "modality_for_decoder": None,
    "modality_for_predictor": None,
    "decoder_modality_flags": None,
    "predictor_modality_flags": None,
    "global_semantic_guidance_not_detach": False,
    "add_hybrid_attention_bias": False,

    # ----- semantic container (G-LSG) ----------------------------------------------------
    "use_attr": False,
    "use_attr_type": "",
    "use_attr_flags": "G1Lc",
    "use_attr_topk": 30,
    "attr_layer_pos": "cross2attr",   # cross2attr | attr2cross | parallel
    "attr_embs_no_dropout": False,
    "compositional_intra": False,
    "compositional_inter": False,
    "compositional_ffn": False,
    "dim_factor_scale": 2,

    # ----- TPU-specific (new in this build) -----------------------------------------------
    "compute_dtype": "bfloat16",     # dtype for matmul-heavy compute on TPU
    "use_pallas_attention": "auto",  # 'auto' | True | False
    "mesh_shape": None,              # e.g. {'data': 8} or {'data': 4, 'model': 2}
    "remat": False,                  # jax.checkpoint on decoder layers
    "backbone_weights": [],          # local torch state_dicts per modality
    "resume": False,                 # save + restore sharded train state
    "train_state_dir": "",           # default <checkpoint_path>/train_state
    "prefetch_batches": 2,           # host pipeline prefetch depth
    "eval_fused_k": 4,               # K same-shape batches per fused
                                     # validation-decode program (<=1 =
                                     # pipelined per-batch decode)
    "compute_dtype_decode": None,    # e.g. 'bfloat16': half-precision
                                     # serving decode (scores stay f32)
    "decode_head_f32": False,        # bf16 decode: keep the vocab
                                     # projection f32 (measured: no beam
                                     # picks change, ~4% slower)
    "fused_head_topk": True,         # serving: stream the vocab projection
                                     # into the beam top-k (logits never in
                                     # HBM; ops/fused_head_topk.py) where
                                     # statically valid
    "fused_head_chunk": 1024,        # vocab chunk width of the fused head
    "fused_head_backend": "auto",    # 'auto' = pallas on TPU; 'xla' pins
                                     # the portable lax.scan form (bench
                                     # falls back here if mosaic rejects
                                     # the kernel on a chip)
    "fused_xent": "auto",            # training: chunked fused softmax-CE
                                     # statistics (ops/fused_xent.py) where
                                     # statically valid. 'auto' fuses only
                                     # when the dense [B, L, V] logits +
                                     # grad clear the threshold below (the
                                     # dense step is measurably faster at
                                     # flagship shapes); True/False force
    "fused_xent_auto_threshold_mb": 512,
    "fused_xent_chunk": 1024,
    "fused_xent_backend": "auto",
    "device_feature_cache": True,    # upload per-video feature tables to
                                     # HBM once; batches ship only indices
                                     # (data/feature_bank.py)
    "feature_cache_dtype": None,     # 'bfloat16' halves cache residency
}


def default_opt() -> dict:
    """Return a fresh copy of the default option dict."""
    return copy.deepcopy(_DEFAULTS)
