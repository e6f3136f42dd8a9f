"""Device-resident per-video feature bank for training and validation.

Port of ``care_tpu/data/feature_bank.py``. Video features are static per
video, so the bank uploads each modality's full per-video table once,
``[n_videos, rows_m, dim_m]`` (frame streams keep all ``n_total_frames``
rows, so every epoch's random frame sampling stays reachable), and from
then on a batch carries only indices (its video rows and sampled frame
ids). One indexing op per modality assembles the batch's features on the
device:

* frame streams (modality chars a/m/i/...): ``table[vidx[:, None], fidx]``,
  the host-side ``feats[frame_ids]`` of ``datasets.py:_load_feats``;
* static streams (r = retrieved-caption embeddings, t = retrieved-caption
  token ids): ``table[vidx]``.

Supported when ``load_feats_type == 0`` (frame ids drawn from
``n_total_frames`` ahead of the feature read) and the features are not
``SwinBERTDense`` (its ``load_all`` stream bypasses frame sampling); a
dataset without ``databases`` and ``ids_set`` has nothing to bank. In those
cases, and when a host table cannot be read or stacked (say, video ids
named another way), :func:`build_feature_bank` returns ``None`` and the
trainer keeps shipping features per batch. The copy to the device is not
covered by that fall-back: an error there propagates.

Tables default to f32 (training bit-identical to the shipping path);
``opt["feature_cache_dtype"] = "bfloat16"`` halves the device memory and
the upload at the cost of bf16-rounded features, gathered back to f32.
"""

from typing import Dict, List, Optional

import numpy as np
import torch

from care_tpu_torch.utils.device import resolve_device


class DeviceFeatureBank:
    """Per-modality tables on one device; ``lookups`` counts the batches it
    served."""

    def __init__(self, tables: List[torch.Tensor], kinds: List[str],
                 vid_to_row: Dict[str, int], cast_f32: bool):
        self.tables = tables          # one per modality, on the device
        self.kinds = kinds            # 'frame' | 'static' per modality
        self.vid_to_row = vid_to_row
        self.cast_f32 = cast_f32
        self.device = tables[0].device
        self._needs_frames = "frame" in kinds
        self.lookups = 0

    def covers(self, video_ids) -> bool:
        return all(v in self.vid_to_row for v in video_ids)

    def lookup(self, video_ids, frame_ids=None) -> List[torch.Tensor]:
        """video_ids: vid strings; frame_ids: [B][n_frames] (consulted only
        when a frame stream exists). Returns the batch's features on the
        device in modality order: floating streams in f32, token ids as
        int64 (the index type of ``trainer.device_batch``)."""
        vidx = torch.as_tensor([self.vid_to_row[v] for v in video_ids],
                               dtype=torch.long).to(self.device)
        if self._needs_frames:
            if frame_ids is None:
                raise ValueError("a frame stream needs frame_ids")
            fidx = torch.from_numpy(np.asarray(frame_ids, np.int64)).to(
                self.device)
        out = []
        for table, kind in zip(self.tables, self.kinds):
            g = table[vidx[:, None], fidx] if kind == "frame" else table[vidx]
            if not g.is_floating_point():
                g = g.long()
            elif self.cast_f32:
                g = g.float()
            out.append(g)
        self.lookups += 1
        return out

    def nbytes(self) -> int:
        return int(sum(t.numel() * t.element_size() for t in self.tables))

    def describe(self) -> str:
        shapes = ", ".join(f"{k}:{tuple(t.shape)}:{str(t.dtype)[6:]}"
                           for t, k in zip(self.tables, self.kinds))
        return (f"{len(self.vid_to_row)} videos, "
                f"{self.nbytes() / 1e6:.1f} MB resident [{shapes}]")


def _host_table(dataset, item, vids, is_vatex_remap) -> Optional[np.ndarray]:
    """One modality's table ``[n_videos, rows, dim]`` on the host, filled
    row by row; None for genuinely ragged tables."""
    modality = item[0]
    table = None
    for k, vid in enumerate(vids):
        inner = dataset.vid2id[vid] if is_vatex_remap else vid
        if modality == "r":
            row = dataset.load_r_feats(item, inner)
        elif modality == "t":
            row = dataset.load_t_feats(item, inner).astype(np.int32)
        else:
            row = dataset._load_feats(item[1:], inner, load_all=True)
        if table is None:
            table = np.empty((len(vids),) + row.shape, row.dtype)
        if row.shape != table.shape[1:]:
            # a missing video's zero-fill comes back at [n_frames, dim]
            # instead of the full table shape: normalise it to zeros
            if np.any(row):
                return None
            row = 0
        table[k] = row
    return table


def build_feature_bank(dataset, opt: dict,
                       device=None) -> Optional[DeviceFeatureBank]:
    """Build a bank on ``device`` (``None`` = the CUDA card; raises without
    one unless ``"cpu"``) from a ``VideoOnlyDataset`` / ``JointDataset``;
    None when the configuration is unsupported or the host tables cannot be
    read or stacked. The tables are read, uploaded and freed one modality at
    a time."""
    device = resolve_device(device)
    if opt.get("load_feats_type", 0) != 0:
        return None
    if opt.get("feats") == "SwinBERTDense":
        return None
    if not hasattr(dataset, "databases") or not hasattr(dataset, "ids_set"):
        return None
    dtype = opt.get("feature_cache_dtype")
    store = torch.bfloat16 if dtype in ("bfloat16", "bf16") else None

    vids = ["video%d" % i for i in dataset.ids_set]
    vid_to_row = {v: i for i, v in enumerate(vids)}
    is_vatex_remap = (opt.get("feats", "") == "I3D"
                      and opt.get("dataset") == "VATEX")
    tables, kinds = [], []
    try:
        databases = dataset.databases
    except Exception as e:  # unsupported layout: keep the shipping path
        print(f"- device feature cache disabled: {type(e).__name__}: {e}")
        return None
    for item in databases:
        try:
            host = _host_table(dataset, item, vids, is_vatex_remap)
        except Exception as e:  # unsupported layout: keep the shipping path
            print(f"- device feature cache disabled: {type(e).__name__}: {e}")
            return None
        if host is None:
            return None     # genuinely ragged tables: unsupported
        table = torch.from_numpy(host)
        if store is not None and table.dtype == torch.float32:
            table = table.to(store)
        tables.append(table.to(device))
        del host, table
        kinds.append("static" if item[0] in ("r", "t") else "frame")
    if not tables:
        return None
    return DeviceFeatureBank(tables, kinds, vid_to_row,
                             cast_f32=store is not None)
