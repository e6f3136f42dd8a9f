"""Datasets: lazy HDF5 feature reading + caption target construction.

Parity targets: reference ``dataloader.py`` ``VideoOnlyDataset`` (per-
modality HDF5 lazy open, three ``load_feats_type`` modes, zero-fill for
missing vids, 1-D feature broadcast over time, multi-file channel concat),
``TextOnlyDataset`` (infoset with n_caps_per_video subsampling, AR shift /
NAR MLM / visual-word targets, masks, multi-hot concept labels) and
``JointDataset`` (merge + one-hot category for RNN decoders + retrieval
streams).

Port of ``care_tpu/data/datasets.py``. Pure numpy; samples are dicts of
np arrays batched by ``loader.py`` into fixed shapes. The device feature
bank (``skip_feats``) is not ported: every sample carries its features.
"""

from typing import Any, Dict, Optional

import numpy as np

from care_tpu_torch import constants
from care_tpu_torch.data import samplers, text
from care_tpu_torch.data.corpus import (get_ids_set, get_stop_words_list,
                                        load_info_corpus)


class VideoOnlyDataset:
    def __init__(self, opt: dict, mode: str, random_type: str,
                 specific: int = -1, rng: Optional[np.random.RandomState] = None,
                 **kwargs):
        assert mode in ["train", "validate", "test", "all", "trainval"]
        assert random_type in ["segment_random", "all_random",
                               "equally_sampling"]
        self.opt = opt
        self.mode = mode
        self.random_type = random_type
        self.rng = rng or np.random.RandomState(opt.get("seed", 0))

        info = load_info_corpus(opt["info_corpus"])["info"]
        self.itoc = info.get("itoc", None)
        self.vid2id = info.get("vid2id", None)

        is_vatex_activate = (opt.get("feats", "") != "I3D"
                             and opt.get("dataset", "MSRVTT") == "VATEX")
        self.ids_set = get_ids_set(mode, info["split"], specific,
                                   info.get("split_category"),
                                   is_vatex_activate)
        self._databases = None

    # ----- HDF5 management ------------------------------------------------
    def _load_database(self, path):
        import h5py
        if not path:
            return []
        if not isinstance(path, list):
            path = [path]
        return [h5py.File(p, "r") for p in path if ".hdf5" in p]

    @property
    def databases(self):
        if self._databases is None:
            self._databases = []
            for char in self.opt["modality"].lower():
                db = self._load_database(self.opt.get("feats_%s" % char))
                assert len(db) > 0, f"no feature files for modality `{char}`"
                self._databases.append([char, db, self.opt["dim_%s" % char]])
        return self._databases

    def __len__(self):
        return len(self.ids_set)

    def __getitem__(self, index) -> Dict[str, Any]:
        return self.get_video_features_by_vid("video%d" % self.ids_set[index])

    def get_video_features_by_vid(self, vid) -> Dict[str, Any]:
        _dict: Dict[str, Any] = {"video_ids": vid}

        if (self.opt.get("feats", "") == "I3D"
                and self.opt["dataset"] == "VATEX"):
            vid = self.vid2id[vid]

        frame_ids = None
        if self.opt["load_feats_type"] == 0:
            frame_ids = samplers.get_frame_ids(
                self.opt.get("n_total_frames", constants.N_TOTAL_FRAMES),
                self.opt["n_frames"], self.random_type, self.rng)
            _dict["frame_ids"] = frame_ids

        _dict["feats"] = []
        for item in self.databases:
            modality = item[0]
            if modality == "r":
                feats = self.load_r_feats(item, vid)
            elif modality == "t":
                feats = self.load_t_feats(item, vid)
            else:
                load_all = (self.opt.get("feats") == "SwinBERTDense"
                            and modality == "m")
                feats = self._load_feats(item[1:], vid, frame_ids=frame_ids,
                                         load_all=load_all)
            _dict["feats"].append(feats)

        if self.itoc is not None:
            _dict["category"] = np.asarray(
                [self.itoc[int(vid[5:])]] if vid.startswith("video") else [0],
                dtype=np.int64)
        return _dict

    def _load_feats(self, data, vid, frame_ids=None, load_all=False):
        databases, dim = data
        max_seq_len = self.opt["n_frames"]
        if "max_len" in databases[0]:
            max_seq_len = int(np.asarray(databases[0]["max_len"]))

        feats = []
        pre_len = None
        for database in databases:
            if vid not in database:
                # zero-fill for missing videos (dataloader.py:243-244)
                return np.zeros((max_seq_len, dim), dtype=np.float32)
            arr = np.asarray(database[vid])
            if arr.ndim == 1:
                reps = pre_len if pre_len is not None else \
                    self.opt.get("n_total_frames", constants.N_TOTAL_FRAMES)
                arr = np.repeat(arr[None, :], reps, axis=0)
            else:
                pre_len = arr.shape[0]
            feats.append(arr)

        feats = np.concatenate(feats, axis=1)
        if load_all:
            return feats.astype(np.float32)

        if self.opt["load_feats_type"] == 0:
            assert frame_ids is not None
        elif self.opt["load_feats_type"] == 1:
            source_length = feats.shape[0]
            if source_length >= self.opt["n_frames"]:
                frame_ids = samplers.get_frame_ids(
                    source_length, self.opt["n_frames"], self.random_type,
                    self.rng)
            else:
                frame_ids = samplers.resampling(source_length, max_seq_len)
        else:
            source_length = feats.shape[0]
            if source_length < max_seq_len:
                frame_ids = samplers.resampling(source_length, max_seq_len)
            else:
                frame_ids = list(range(feats.shape[0]))

        return feats[frame_ids].astype(np.float32)

    def load_r_feats(self, item, vid):
        db = item[1][0]
        feats = np.asarray(db[vid])[:self.opt["retrieval_topk"], :]
        return feats.astype(np.float32)

    def load_t_feats(self, item, vid):
        raise NotImplementedError  # provided by JointDataset


class TextOnlyDataset:
    def __init__(self, opt: dict, mode: str, n_caps_per_video: int,
                 specific: int = -1, make_infoset: bool = True, **kwargs):
        assert mode in ["train", "validate", "test", "all", "trainval"]
        self.opt = opt
        self.mode = mode
        self.n_caps_per_video = n_caps_per_video

        data = load_info_corpus(opt["info_corpus"])
        self.captions = data["captions"]
        self.pos_tags = data.get("pos_tags")
        self.clip_scores = data.get("clip_scores")
        info = data["info"]
        self.itow = info["itow"]
        self.wtoi = {w: i for i, w in self.itow.items()}
        self.itoc = info.get("itoc", None)
        self.itop = info.get("itop", None)
        self.category_embeddings = info.get("category_embeddings", None)
        self.length_info = info.get("length_info", None)
        self.random = np.random.RandomState(opt.get("seed", 0))

        is_vatex_activate = (opt.get("feats", "") != "I3D"
                             and opt.get("dataset", "MSRVTT") == "VATEX")
        self.ids_set = get_ids_set(mode, info["split"], specific,
                                   info.get("split_category"),
                                   is_vatex_activate)
        train_ids = get_ids_set("train", info["split"], specific,
                                info.get("split_category"),
                                is_vatex_activate)
        self.flat_captions = [c for tid in train_ids
                              for c in self.captions["video%d" % tid]]

        self.stop_words_list = get_stop_words_list()
        if make_infoset:
            self.infoset = self._make_infoset()

        self.vid2attr = None
        if data.get("attribute_flag"):
            self.vid2attr = text.vid2attribute_mappings(self.ids_set,
                                                        self.captions)

    def __len__(self):
        return len(self.infoset)

    def _make_infoset(self):
        infoset = []
        for idx in self.ids_set:
            vid = "video%d" % idx
            category = self.itoc[idx] if self.itoc is not None else 0
            category_embs = (self.category_embeddings[category]
                             if self.category_embeddings is not None else [0])
            captions = self.captions[vid]
            pos_tags = (self.pos_tags[vid] if self.pos_tags is not None
                        else [None] * len(captions))
            assert len(captions) == len(pos_tags)

            if self.length_info is None or vid not in self.length_info:
                length_target = np.zeros(self.opt["max_len"])
            else:
                lt = list(self.length_info[vid])[:self.opt["max_len"]]
                lt = lt + [0] * (self.opt["max_len"] - len(lt))
                total = sum(lt)
                length_target = (np.asarray(lt, dtype=np.float64)
                                 / (total if total else 1.0))

            if self.n_caps_per_video == 0:
                cap_id_set = list(range(len(captions)))
            elif self.n_caps_per_video == 1 and self.mode != "train":
                cap_id_set = [0]
            else:
                n = min(len(captions), self.n_caps_per_video)
                cap_id_set = self.random.choice(len(captions), n,
                                                replace=False)

            for cap_id in cap_id_set:
                item = {
                    "vid": vid, "labels": captions[cap_id],
                    "pos_tags": pos_tags[cap_id], "category": category,
                    "category_embs": category_embs,
                    "length_target": length_target, "cap_id": cap_id,
                }
                # distilled corpora may carry per-(caption, frame) CLIP
                # scores (reference ``dataloader.py:791-801``)
                if (self.clip_scores is not None
                        and vid in self.clip_scores):
                    item["clip_scores"] = self.clip_scores[vid][cap_id]
                infoset.append(item)
        return infoset

    def get_text_sample(self, index) -> Dict[str, Any]:
        item = self.infoset[index]
        vid, cap_id = item["vid"], item["cap_id"]
        labels, taggings = item["labels"], item["pos_tags"]
        opt = self.opt

        data: Dict[str, Any] = {"video_ids": vid, "caption_ids": cap_id}

        results = text.make_source_target(
            labels, taggings, opt["max_len"], self.mode,
            opt.get("decoding_type", "ARFormer"), self.random,
            beta=opt.get("beta", [0, 1]),
            visual_word_generation=opt.get("visual_word_generation", False),
            itow=self.itow, itop=self.itop,
            demand=tuple(opt.get("demand", ["VERB", "NOUN"])))

        tokens = results.get("dec_source")
        labels_out = results.get("dec_target")
        if results.get("tagging") is not None:
            data["taggings"] = np.asarray(results["tagging"], np.int64)

        if results.get("dec_source_1") is not None:
            data["input_ids"] = [np.asarray(results["dec_source_1"], np.int64),
                                 np.asarray(tokens, np.int64)]
            data["labels"] = [np.asarray(results["dec_target_1"], np.int64),
                              np.asarray(labels_out, np.int64)]
        else:
            data["input_ids"] = np.asarray(tokens, np.int64)
            data["labels"] = np.asarray(labels_out, np.int64)

        data["category"] = np.asarray([item["category"]], np.int64)
        data["category_embs"] = np.asarray(item["category_embs"], np.float32)
        data["length_target"] = np.asarray(item["length_target"], np.float32)
        if self.itop is not None and taggings is not None:
            data["tgt_visual_taggings"] = np.asarray(
                text.prepare_tgt_visual_taggings(labels, taggings, self.itow,
                                                 self.itop, opt["max_len"]),
                np.int64)
        data["non_stop_words_mask"] = np.asarray(
            text.prepare_non_stop_words_mask(
                data["labels"] if not isinstance(data["labels"], list)
                else [l.tolist() for l in data["labels"]],
                self.itow, self.stop_words_list), np.int64)
        data["attribute_mask"] = np.asarray(
            text.prepare_attribute_mask(
                data["labels"] if not isinstance(data["labels"], list)
                else [l.tolist() for l in data["labels"]],
                opt.get("attribute_prediction_k")), np.int64)
        if self.vid2attr is not None:
            data["labels_attr"] = self.vid2attr[vid].astype(np.float32)
        return data

    def get_references(self):
        from care_tpu_torch.data.corpus import load_references
        if getattr(self, "_references", None) is None:
            self._references = load_references(self.opt["reference"])
        return self._references

    def get_vocab(self):
        return self.itow


class JointDataset(VideoOnlyDataset, TextOnlyDataset):
    def __init__(self, opt: dict, mode: str, specific: int = -1,
                 is_validation: bool = False, all_caps: bool = False,
                 **kwargs):
        if mode != "train" or is_validation:
            random_type = "equally_sampling"
            n_caps_per_video = 0 if all_caps else 1
        else:
            random_type = opt.get("random_type", "segment_random")
            n_caps_per_video = opt.get("n_caps_per_video", 0)

        VideoOnlyDataset.__init__(self, opt, mode, random_type, specific,
                                  **kwargs)
        TextOnlyDataset.__init__(self, opt, mode, n_caps_per_video, specific,
                                 **kwargs)

    def __len__(self):
        return len(self.infoset)

    def __getitem__(self, index) -> Dict[str, Any]:
        vid = self.infoset[index]["vid"]
        data = {}
        data.update(self.get_video_features_by_vid(vid))
        data.update(self.get_text_sample(index))

        if "rnn" in self.opt.get("decoder", "").lower():
            one_hot = np.zeros(self.opt.get("num_category", 20), np.float32)
            one_hot[self.infoset[index]["category"]] = 1
            data["category"] = one_hot

        if "clip_scores" in self.infoset[index]:
            # slice the dense (caption-token x frame) CLIP scores to the
            # sampled frames (reference ``dataloader.py:791-801``)
            if self.opt["load_feats_type"] == 0:
                frame_ids = data["frame_ids"]
            else:
                frame_ids = list(range(self.opt["n_frames"]))
            cs = np.asarray(self.infoset[index]["clip_scores"])
            data["clip_scores"] = cs[:self.opt["max_len"] - 1,
                                     frame_ids].astype(np.float32)
        return data

    def get_specific_data_by_vid_and_cap_id(self, vid, cap_id=None,
                                            text=None):
        """Single-sample fetch for analysis (reference
        ``dataloader.py:745-772``); returns a batch of size 1."""
        assert cap_id is not None or text is not None
        data = self.get_video_features_by_vid(vid)
        if text is not None:
            label = [0] + [self.wtoi[w] for w in text.split()] + [0]
            label[0], label[-1] = 2, 3  # BOS, EOS
            tagging = None
            cap_id = -1
        else:
            label = self.captions[vid][cap_id]
            tagging = self.pos_tags[vid][cap_id] if self.pos_tags else None
        from care_tpu_torch.data import text as text_mod
        results = text_mod.make_source_target(
            label, tagging, self.opt["max_len"], self.mode,
            self.opt.get("decoding_type", "ARFormer"), self.random,
            beta=self.opt.get("beta", [0, 1]),
            visual_word_generation=self.opt.get("visual_word_generation",
                                                False),
            itow=self.itow, itop=self.itop)
        data["input_ids"] = np.asarray(results["dec_source"], np.int64)
        data["labels"] = np.asarray(results["dec_target"], np.int64)
        from care_tpu_torch.data.loader import collate
        return collate([data])

    def load_t_feats(self, item, vid):
        db = item[1][0]
        indices = np.asarray(db[vid + "_i"])[:self.opt["retrieval_topk"]]
        captions = [self.flat_captions[i] for i in indices]
        exclude_eos = self.opt.get("exclude_eos", False)
        rows = [text.padding(cap[1:-1] if exclude_eos else cap[1:],
                             self.opt["max_len"], add_eos=False)
                for cap in captions]
        return np.asarray(rows, np.int64)
