"""Pretreatment CLI of the port: raw frames and captions -> the training
artifacts (image features, caption embeddings, the retrieval database).

Port of ``pretreatment_cli.py`` (reference ``pretreatment/``
``extract_frames_from_videos.py``, ``extract_image_feats_from_frames.py``,
``clip_feats.py``, ``clip_text_embs.py``, ``clip_retrieval.py``), with the
same flags and HDF5 layout. Every input (videos, frames, CLIP and CNN
checkpoints, the BPE merges file) is a local file.

    python -m care_tpu_torch.pretreatment_cli frames --video_dir vids/ \\
        --out_dir frames/
    python -m care_tpu_torch.pretreatment_cli image_feats \\
        --frames_dir frames/ --clip_ckpt ViT-B-32.pt \\
        --out feats/CLIP_ViT-B-32.hdf5
    python -m care_tpu_torch.pretreatment_cli image_feats \\
        --frames_dir frames/ --model resnet101 --cnn_ckpt resnet101.pth \\
        --out feats/image_resnet101.hdf5
    python -m care_tpu_torch.pretreatment_cli text_embs \\
        --corpus_dir data/MSRVTT --clip_ckpt ViT-B-32.pt \\
        --bpe bpe_simple_vocab_16e6.txt.gz --out text_embs/CLIP_ViT-B-32.hdf5
    python -m care_tpu_torch.pretreatment_cli retrieval \\
        --corpus_dir data/MSRVTT --image_embs feats/CLIP_ViT-B-32.hdf5 \\
        --text_embs text_embs/CLIP_ViT-B-32.hdf5 \\
        --out retrieval/CLIP_ViT-B-32_unique.hdf5

The towers and the retrieval similarities run on the CUDA card;
``--device cpu`` runs them on the host. ``corpora``, ``glove`` and
``text_embs --arch bert`` are not ported yet and raise
``NotImplementedError``.
"""

import argparse
import os
import pickle

import numpy as np

from care_tpu_torch.models.common import unsupported


def cmd_corpora(args):
    raise unsupported("pretreatment corpora")


def cmd_glove(args):
    raise unsupported("pretreatment glove")


def cmd_frames(args):
    from care_tpu_torch.pretreatment.frames import extract_frames_for_dataset
    n = extract_frames_for_dataset(args.video_dir, args.out_dir,
                                   fps=args.fps)
    print(f"- extracted {n} frames")


def _load_state_dict(path):
    import torch
    sd = torch.load(path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.float().numpy() for k, v in sd.items()
            if hasattr(v, "numpy")}


def _load_clip(ckpt_path, device):
    """The CLIP towers of a local OpenAI checkpoint on ``device``, and its
    ``meta``."""
    import torch
    from care_tpu_torch.pretreatment.clip import (
        CLIPTextTransformer, CLIPVisionTransformer,
        convert_openai_clip_state_dict)
    vision_sd, text_sd, meta = convert_openai_clip_state_dict(
        _load_state_dict(ckpt_path))
    g = torch.Generator().manual_seed(0)
    vision = CLIPVisionTransformer(patch_size=meta["patch"],
                                   width=meta["width"],
                                   layers=meta["v_layers"], generator=g)
    text = CLIPTextTransformer(width=meta["t_width"], layers=meta["t_layers"],
                               heads=meta["t_width"] // 64, generator=g)
    vision.load_state_dict(vision_sd, strict=True)
    text.load_state_dict(text_sd, strict=True)
    return vision.eval().to(device), text.eval().to(device), meta


def _iter_video_frames(frames_dir, k, suffix="jpg", limit=0):
    """(video_id, frame paths): uniform-k sampling per video (reference
    ``extract_image_feats_from_frames.py:24-45``)."""
    import glob
    from care_tpu_torch.data.samplers import get_uniform_items_from_k_snippets
    for vid_dir in sorted(glob.glob(os.path.join(frames_dir, "*"))):
        vid = os.path.basename(vid_dir)
        if limit and vid.startswith("video") and int(vid[5:]) >= limit:
            continue
        frames = sorted(glob.glob(os.path.join(vid_dir, f"*.{suffix}")))
        if not frames:
            continue
        if k:
            frames = get_uniform_items_from_k_snippets(frames, k)
        yield vid, frames


def cmd_image_feats(args):
    """Per-video frame directories -> (k, d) HDF5 datasets, by the CLIP
    visual tower (reference ``pretreatment/clip_feats.py``) or an ImageNet
    CNN (reference ``extract_image_feats_from_frames.py``)."""
    import h5py
    import torch
    from PIL import Image
    from care_tpu_torch import constants
    from care_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    k = args.k if args.k is not None else constants.N_TOTAL_FRAMES
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    if args.model == "clip":
        assert args.clip_ckpt, "--clip_ckpt is required for --model clip"
        from care_tpu_torch.pretreatment.clip import (encode_images,
                                                      preprocess_images)
        vision, _, _ = _load_clip(args.clip_ckpt, device)

        def encode(frames):
            imgs = np.stack([
                np.asarray(Image.open(f).convert("RGB").resize((224, 224)))
                for f in frames])
            return encode_images(vision, preprocess_images(imgs))
    else:
        from care_tpu_torch.models.cnn import (convert_cnn_state_dict,
                                               create_cnn, encode_images,
                                               load_converted,
                                               preprocess_cnn_images)
        model = create_cnn(args.model, torch.Generator().manual_seed(0),
                           with_logits=args.logits)
        if args.cnn_ckpt:
            load_converted(model, convert_cnn_state_dict(
                _load_state_dict(args.cnn_ckpt), args.model))
        else:
            print("! no --cnn_ckpt given: random-init weights "
                  "(only useful for smoke tests)")
        model = model.eval().to(device)

        def encode(frames):
            imgs = np.stack([np.asarray(Image.open(f).convert("RGB"))
                             for f in frames])
            return encode_images(model, preprocess_cnn_images(imgs,
                                                              args.model))

    with h5py.File(args.out, "w") as hf:
        for vid, frames in _iter_video_frames(args.frames_dir, k,
                                              args.frame_suffix, args.limit):
            hf.create_dataset(vid, data=encode(frames).astype(np.float32))
    print("- wrote", args.out)


def cmd_text_embs(args):
    """Every reference caption -> (n_captions, d) HDF5 per video, by CLIP's
    text tower (reference ``clip_text_embs.py``)."""
    if args.arch == "bert":
        raise unsupported("pretreatment text_embs --arch", "bert")
    import h5py
    from care_tpu_torch.pretreatment.bpe import ClipTokenizer
    from care_tpu_torch.pretreatment.clip import encode_texts
    from care_tpu_torch.utils.device import resolve_device

    assert args.clip_ckpt, "--clip_ckpt is required for --arch clip"
    _, text, _ = _load_clip(args.clip_ckpt, resolve_device(args.device))
    tok = ClipTokenizer(args.bpe)
    with open(os.path.join(args.corpus_dir, "refs.pkl"), "rb") as f:
        refs = pickle.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with h5py.File(args.out, "w") as hf:
        for vid, entries in refs.items():
            ids = tok.tokenize([e["caption"] for e in entries],
                               truncate=True)
            hf.create_dataset(vid, data=encode_texts(text, ids).astype(
                np.float32))
    print("- wrote", args.out)


def cmd_retrieval(args):
    """The retrieval database (reference ``clip_retrieval.py``)."""
    import h5py
    from care_tpu_torch.data.corpus import get_ids_set, load_info_corpus
    from care_tpu_torch.data.samplers import get_uniform_ids_from_k_snippets
    from care_tpu_torch.pretreatment.retrieval import build_retrieval_db

    corpus = load_info_corpus(os.path.join(args.corpus_dir,
                                           "info_corpus.pkl"))
    with open(os.path.join(args.corpus_dir, "refs.pkl"), "rb") as f:
        refs_data = pickle.load(f)
    split = corpus["info"]["split"]
    video_keys = ["video%d" % i for i in get_ids_set("all", dict(split))]
    text_keys = ["video%d" % i for i in get_ids_set("train", dict(split))]

    ids = get_uniform_ids_from_k_snippets(60, args.n_frames)
    image_embs, own_ranges, text_embs, refs = [], [], [], []
    with h5py.File(args.image_embs) as vdb, h5py.File(args.text_embs) as tdb:
        start = 0
        ranges = {}
        for key in text_keys:
            t = np.asarray(tdb[key])
            text_embs.append(t)
            ranges[key] = (start, start + t.shape[0])
            start += t.shape[0]
            refs += [e["caption"] for e in refs_data[key]]
        for key in video_keys:
            image_embs.append(np.asarray(vdb[key])[ids].mean(0))
            own_ranges.append(ranges.get(key, (-1, -1)))
    image_embs = np.stack(image_embs)
    text_embs = np.concatenate(text_embs, axis=0)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    build_retrieval_db(args.out, video_keys, image_embs, text_embs,
                       text_embs, topk=args.topk, own_ranges=own_ranges,
                       refs=refs, unique=True, device=args.device)
    print("- wrote", args.out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="cpu to run on the host (default: the CUDA card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("corpora", parents=[dev])
    c.add_argument("--dataset", required=True,
                   choices=["MSVD", "MSRVTT", "VATEX"])
    c.add_argument("--annotation", required=True)
    c.add_argument("--val_annotation", default="")
    c.add_argument("--mapping", default="")
    c.add_argument("--frames_root", default="")
    c.add_argument("--out_dir", required=True)
    c.add_argument("--count_thr", type=int, default=2)
    c.add_argument("--no_attribute_first", action="store_true")
    c.set_defaults(func=cmd_corpora)

    f = sub.add_parser("frames", parents=[dev])
    f.add_argument("--video_dir", required=True)
    f.add_argument("--out_dir", required=True)
    f.add_argument("--fps", type=int, default=None)
    f.set_defaults(func=cmd_frames)

    i = sub.add_parser("image_feats", parents=[dev])
    i.add_argument("--frames_dir", required=True)
    i.add_argument("--model", default="clip",
                   choices=["clip", "resnet18", "resnet34", "resnet50",
                            "resnet101", "resnet152", "inceptionresnetv2"])
    i.add_argument("--clip_ckpt", default="",
                   help="OpenAI CLIP torch checkpoint (model=clip)")
    i.add_argument("--cnn_ckpt", default="",
                   help="torchvision/pretrainedmodels state_dict .pth "
                        "(CNN models)")
    i.add_argument("--logits", action="store_true",
                   help="keep the classifier head (semantic logits feats)")
    i.add_argument("--k", type=int, default=None,
                   help="uniformly sample k frames per video "
                        "(default n_total_frames; 0 = all frames)")
    i.add_argument("--frame_suffix", default="jpg")
    i.add_argument("--limit", type=int, default=0)
    i.add_argument("--out", required=True)
    i.set_defaults(func=cmd_image_feats)

    t = sub.add_parser("text_embs", parents=[dev])
    t.add_argument("--corpus_dir", required=True)
    t.add_argument("--arch", default="clip", choices=["clip", "bert"])
    t.add_argument("--clip_ckpt", default="")
    t.add_argument("--bpe", default="",
                   help="CLIP BPE vocab (arch=clip)")
    t.add_argument("--bert_ckpt", default="",
                   help="HF BertModel torch state_dict .pth (arch=bert)")
    t.add_argument("--vocab", default="",
                   help="bert-base-uncased vocab.txt (arch=bert)")
    t.add_argument("--mode", default="mean", choices=["mean", "max"],
                   help="BERT token pooling (BERT.hdf5 vs BERT_max.hdf5)")
    t.add_argument("--out", required=True)
    t.set_defaults(func=cmd_text_embs)

    r = sub.add_parser("retrieval", parents=[dev])
    r.add_argument("--corpus_dir", required=True)
    r.add_argument("--image_embs", required=True)
    r.add_argument("--text_embs", required=True)
    r.add_argument("--out", required=True)
    r.add_argument("--topk", type=int, default=20)
    r.add_argument("--n_frames", type=int, default=28)
    r.set_defaults(func=cmd_retrieval)

    g = sub.add_parser("glove", parents=[dev])
    g.add_argument("--glove_txt", required=True)
    g.add_argument("--corpus_dir", required=True)
    g.add_argument("--out", required=True)
    g.add_argument("--categories_out", default="",
                   help="also extract MSRVTT category embeddings and store "
                        "them in info_corpus.pkl")
    g.set_defaults(func=cmd_glove)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
