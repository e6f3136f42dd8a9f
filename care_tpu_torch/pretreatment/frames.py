"""Frame extraction from raw videos (an ``ffmpeg`` subprocess).

Port of ``care_tpu/pretreatment/frames.py`` (reference
``pretreatment/extract_frames_from_videos.py:9-30``): one ``ffmpeg`` run per
video writes ``<out>/<vid>/%05d.jpg``. Without ``ffmpeg`` on the PATH a
video yields 0 frames, or with ``strict`` raises ``RuntimeError``.
"""

import glob
import os
import shutil
import subprocess
from typing import Optional


def has_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def extract_frames(video_path: str, out_dir: str, fps: Optional[int] = None,
                   frame_suffix: str = "jpg", strict: bool = False,
                   quality: int = 2) -> int:
    """Extract frames for one video; returns the number of frames written."""
    if not has_ffmpeg():
        if strict:
            raise RuntimeError("ffmpeg not found on PATH")
        return 0
    os.makedirs(out_dir, exist_ok=True)
    cmd = ["ffmpeg", "-y", "-i", video_path, "-q:v", str(quality)]
    if fps:
        cmd += ["-vf", f"fps={fps}"]
    cmd += [os.path.join(out_dir, f"%05d.{frame_suffix}")]
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return len(glob.glob(os.path.join(out_dir, f"*.{frame_suffix}")))


def extract_frames_for_dataset(video_dir: str, out_root: str,
                               suffixes=(".mp4", ".avi", ".mkv", ".webm"),
                               **kwargs) -> int:
    n = 0
    for fn in sorted(os.listdir(video_dir)):
        base, ext = os.path.splitext(fn)
        if ext.lower() not in suffixes:
            continue
        n += extract_frames(os.path.join(video_dir, fn),
                            os.path.join(out_root, base), **kwargs)
    return n
