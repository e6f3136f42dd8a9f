"""Inference CLI of the port: load a checkpoint, caption a split, score it,
time it.

Port of ``translate.py`` (reference ``translate.py``): the manual eval loop
(pipelined: up to ``--fused_k`` decodes in flight, 2 without it), per-video
latency timing appended to ``latency.txt``
(``method\\ttask\\ttotal\\tn\\tavg``), prediction and per-sample detail-score
JSON dumps, CSV rows, and the ``--loop_n_frames`` /
``--loop_category`` sweeps.

    python -m care_tpu_torch.translate -cp exps/run/best.ckpt --fused_k 4

runs on the CUDA card; ``--device cpu`` runs on the host. A NAR checkpoint
(NAB, NACF) decodes by its ``paradigm`` with the NAR overrides
(``-i``, ``-lbs``, ``-q``, ``-qi``, ``-paradigm``, ``-use_ct``, ``-md``,
``-ncd``); ``--teacher_path`` names an AR checkpoint that rescores its
candidates:

    python -m care_tpu_torch.translate -cp exps/NACF/best.ckpt \
        --teacher_path exps/ARB/best.ckpt -paradigm mp

Several checkpoints decode as an ensemble (their log-probabilities averaged
at each beam step); checkpoints of different modalities read the union of
the modalities and each gets its own share of every batch:

    python -m care_tpu_torch.translate -cp exps/a/best.ckpt exps/b/best.ckpt

``--retrieval_db_ratio`` / ``--retrieval_datasets`` swap the retrieval
database a CARE or PointerGen model reads (``feats_r``, ``feats_t``).
"""

import argparse
import json
import os
import time

import numpy as np
import torch

# decode overrides of the NAR translator
NAR_OVERRIDES = ("iterations", "length_beam_size", "q", "q_iterations",
                 "paradigm", "use_ct", "masking_decision",
                 "no_candidate_decision")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-cp", "--checkpoint_paths", nargs="+", type=str,
                   required=True)
    p.add_argument("--mode", type=str, default="test",
                   choices=["train", "validate", "test", "all", "trainval"])
    p.add_argument("--base_data_path", type=str, default="")
    p.add_argument("-bs", "--beam_size", type=int, default=None)
    p.add_argument("-ba", "--beam_alpha", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--latency", action="store_true")
    p.add_argument("--loop_n_frames", nargs="+", type=int, default=[])
    p.add_argument("--loop_category", action="store_true",
                   help="evaluate each MSRVTT category subset separately "
                        "(reference translate.py loop_category)")
    p.add_argument("--specific", type=int, default=-1,
                   help="restrict evaluation to one category id")
    p.add_argument("--json_path", type=str, default="")
    p.add_argument("--json_name", type=str, default="preds.json")
    p.add_argument("--save_detail_scores_path", type=str, default="")
    p.add_argument("--retrieval_db_ratio", type=float, default=100)
    p.add_argument("--retrieval_datasets", nargs="+", type=str, default=[])
    # CSV results (reference translate.py:126-134): accumulate score rows
    # into a csv in the model folder (or --csv_path) for merge_csv
    p.add_argument("--save_csv", action="store_true")
    p.add_argument("--csv_path", type=str, default="")
    p.add_argument("--csv_name", type=str, default="test_result.csv")
    # NAR decoding overrides (reference translate.py:150-160)
    p.add_argument("-i", "--iterations", type=int, default=None)
    p.add_argument("-lbs", "--length_beam_size", type=int, default=None)
    p.add_argument("-q", "--q", type=int, default=None)
    p.add_argument("-qi", "--q_iterations", type=int, default=None)
    p.add_argument("-paradigm", "--paradigm", type=str, default=None,
                   choices=["mp", "ef", "l2r"])
    p.add_argument("-use_ct", "--use_ct", action="store_true", default=None)
    p.add_argument("-md", "--masking_decision", action="store_true",
                   default=None)
    p.add_argument("-ncd", "--no_candidate_decision", action="store_true",
                   default=None)
    p.add_argument("--teacher_path", type=str, default=None)
    p.add_argument("-topk", "--topk", type=int, default=None)
    p.add_argument("--devices", type=str, default="",
                   help="accepted for script parity with the reference CLI "
                        "(GPU index); a no-op")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; default the CUDA card, `cpu` for "
                        "the host")
    p.add_argument("--fused_k", type=int, default=0,
                   help="keep up to K decodes in flight before their "
                        "outputs are fetched (2 when not above 1)")
    return p.parse_args(argv)


def run_eval(models, opt, loader, references, vocab, latency=False,
             ensemble_spec=None, fused_k: int = 0, device=None,
             teacher_kwargs=None):
    """Caption ``loader`` and score it. Returns (scores, detail, preds,
    decode seconds, videos). ``teacher_kwargs`` (``teacher``,
    ``vocab_mapping``) go to the NAR translator with every batch."""
    from care_tpu_torch.decoding import get_translator
    from care_tpu_torch.metrics import COCOScorer
    from care_tpu_torch.utils.logger import to_sentence

    translator = get_translator(opt, device)
    tkw = teacher_kwargs or {}
    preds = {}
    total_time, n_videos = 0.0, 0

    def put(x):
        # f32 features (the translator casts them to its serving dtype);
        # the retrieved captions' token ids stay integers
        t = torch.as_tensor(np.asarray(x))
        return t.to(translator.device, torch.float32
                    if t.is_floating_point() else torch.long)

    def to_device(batch):
        feats = [put(f) for f in batch["feats"]]
        if ensemble_spec is not None:
            feats = ensemble_spec.split_feats(feats)
        b = {"feats": feats}
        for k in ("category", "category_embs"):
            if k in batch and isinstance(batch[k], np.ndarray):
                b[k] = torch.as_tensor(batch[k], device=translator.device)
        return b

    def decoded_batches():
        nonlocal total_time
        if latency:
            # per-sample timing protocol: strictly sequential
            for batch in loader:
                b = to_device(batch)
                t0 = time.perf_counter()
                out = translator.translate_batch(models, b, **tkw)
                total_time += time.perf_counter() - t0
                yield batch, out
        else:
            # throughput: up to K decodes in flight before their outputs
            # are fetched (2 without --fused_k), timed as wall clock over
            # the whole stream
            t0 = time.perf_counter()
            tagged = ((batch, to_device(batch)) for batch in loader)
            yield from translator.translate_batches_grouped(
                models, tagged, fused_k, **tkw)
            total_time += time.perf_counter() - t0

    for batch, (hyps, scores) in decoded_batches():
        n_videos += len(batch["video_ids"])
        for i, vid in enumerate(batch["video_ids"]):
            entries = []
            hyps_i = hyps[i] if isinstance(hyps[i][0], list) else [hyps[i]]
            for k, hyp in enumerate(hyps_i):
                caption = to_sentence(hyp, vocab)
                entries.append({"image_id": vid, "caption": caption,
                                "score": float(np.ravel(scores[i])[k]
                                               if np.ndim(scores[i]) else
                                               scores[i])})
            preds[vid] = entries[:1]

    scorer = COCOScorer()
    scores, detail = scorer.score(references, preds, list(preds.keys()))
    return scores, detail, preds, total_time, n_videos


def main(argv=None):
    from care_tpu_torch.data import get_loader
    from care_tpu_torch.data.corpus import load_info_corpus, load_references
    from care_tpu_torch.models.loading import (get_vocab_mapping,
                                               load_model,
                                               modify_opt_if_necessary)
    from care_tpu_torch.utils.device import resolve_device
    from care_tpu_torch.utils.logger import save_dict_to_csv
    from care_tpu_torch.utils.profiling import LatencyRecorder

    args = parse_args(argv)
    device = resolve_device(args.device)
    paths = args.checkpoint_paths
    decode_overrides = {k: getattr(args, k) for k in
                        ("beam_size", "beam_alpha") + NAR_OVERRIDES
                        + ("teacher_path", "topk")
                        if getattr(args, k) is not None}
    models, opt, ensemble_spec = load_model(
        paths if len(paths) > 1 else paths[0],
        new_opt_used_to_override=decode_overrides,
        base_data_path=args.base_data_path or None, return_spec=True,
        device=device)
    opt = modify_opt_if_necessary(opt, args.retrieval_datasets,
                                  args.retrieval_db_ratio)
    # the AR teacher named on the command line rescores a NAR model's
    # candidates; the JAX package's CLI only records the path
    teacher_kwargs = {}
    if args.teacher_path and opt["decoding_type"] == "NARFormer":
        teachers, teacher_opt = load_model(
            args.teacher_path, base_data_path=args.base_data_path or None,
            device=device)
        teacher_kwargs = {"teacher": teachers[0],
                          "vocab_mapping": get_vocab_mapping(opt,
                                                             teacher_opt)}

    info_corpus = load_info_corpus(opt["info_corpus"])
    references = load_references(opt["reference"])
    vocab = info_corpus["info"]["itow"]

    batch_size = 1 if args.latency else args.batch_size
    n_frames_list = args.loop_n_frames or [opt["n_frames"]]
    if args.loop_category:
        categories = list(range(opt.get("num_category", 20)))
    else:
        categories = [args.specific]

    results = []
    for n_frames in n_frames_list:
        for specific in categories:
            opt["n_frames"] = n_frames
            loader = get_loader(opt, args.mode, not_shuffle=True,
                                is_validation=(args.mode == "validate"),
                                batch_size=batch_size, specific=specific)
            scores, detail, preds, total, n = run_eval(
                models, opt, loader, references, vocab,
                latency=args.latency, ensemble_spec=ensemble_spec,
                fused_k=args.fused_k, device=device,
                teacher_kwargs=teacher_kwargs)
            results.append(scores)
            tag = f"n_frames={n_frames}" + (
                f" category={specific}" if specific != -1 else "")
            print(f"{tag}:", {k: round(v, 4) for k, v in scores.items()})

            # sweep CSVs (reference translate.py:92-116): n_frames /
            # category loops always accumulate rows under ./results_loop/
            if args.loop_n_frames or args.loop_category:
                row = dict(scores)
                row["scope"] = opt.get("scope", "")
                if args.loop_n_frames:
                    row["n_frames"] = n_frames
                    row["seed"] = opt.get("seed", 0)
                    save_dict_to_csv("./results_loop/", "n_frames.csv", row)
                else:
                    row["category"] = specific
                    save_dict_to_csv("./results_loop/", "category.csv", row)

            if args.save_csv:
                row = dict(scores)
                row["scope"] = opt.get("scope", "")
                row["seed"] = opt.get("seed", 0)
                row["mode"] = args.mode
                if args.loop_n_frames:
                    row["n_frames"] = n_frames
                if specific != -1:
                    row["category"] = specific
                if args.retrieval_db_ratio != 100:
                    row["retrieval_db_ratio"] = args.retrieval_db_ratio
                csv_dir = args.csv_path or os.path.dirname(paths[0]) or "."
                save_dict_to_csv(csv_dir, args.csv_name, row)

            if args.latency:
                rec = LatencyRecorder(opt.get("method", ""),
                                      opt.get("task", ""))
                rec.total, rec.n = total, n
                rec.append_to("latency.txt")
                print(f"- latency: total={total:.2f}s n={n} "
                      f"avg={rec.avg * 1000:.2f}ms")

            if args.json_path:
                os.makedirs(args.json_path, exist_ok=True)
                with open(os.path.join(args.json_path, args.json_name),
                          "w") as f:
                    json.dump(preds, f)
            if args.save_detail_scores_path:
                os.makedirs(os.path.dirname(args.save_detail_scores_path)
                            or ".", exist_ok=True)
                with open(args.save_detail_scores_path, "w") as f:
                    json.dump(detail, f)
    return results


if __name__ == "__main__":
    main()
