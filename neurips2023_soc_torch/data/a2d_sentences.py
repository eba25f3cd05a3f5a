"""A2D-Sentences helpers (the port's copy of the parts of
neurips2023_soc_tpu/data/a2d_sentences.py that inference needs). The dataset
class comes with the training datasets."""
from __future__ import annotations

from typing import Optional

import numpy as np


def read_video_frames_cv2(video_path: str, start: Optional[int] = None,
                          end: Optional[int] = None) -> np.ndarray:
    """Decode frames [start, end) of a video file to (T, H, W, 3) float32
    RGB in [0, 1]; the whole video when no range is given. Seeking with
    CAP_PROP_POS_FRAMES decodes only the window."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if start is not None and start > 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        # seek can silently fail on some containers: verify, else grab forward
        if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
            cap.release()
            cap = cv2.VideoCapture(video_path)
            for _ in range(start):
                cap.grab()
    n = None if end is None else end - (start or 0)
    frames = []
    while n is None or len(frames) < n:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:  # seek past the real end (metadata overestimate) or a bad file
        return np.empty((0, 0, 0, 3), np.float32)
    return np.stack(frames).astype(np.float32) / 255.0
