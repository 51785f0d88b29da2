"""Video overlay rendering (avcer_tpu/utils/overlay.py): face boxes and
emotion labels drawn onto a copy of the video with cv2 (MJPG).

Capability parity with the reference's video/functions/get_visualization.py
+ video/visualization.py (bbox + top-emotion label per frame rendered into a
video file).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from avcer_tpu_torch.core import registry


def render_overlay_video(
    path_video: str,
    path_out: str,
    boxes_per_frame: Sequence[Optional[np.ndarray]],  # [4] xyxy or None
    probs_per_frame: np.ndarray,  # [T, 7] video-order probabilities
    emotions: Sequence[str] = registry.VIDEO_EMOTIONS,
    fps: Optional[float] = None,
) -> str:
    import cv2

    cap = cv2.VideoCapture(path_video)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out_fps = fps or cap.get(cv2.CAP_PROP_FPS) or 25
    vw = cv2.VideoWriter(path_out, cv2.VideoWriter_fourcc(*"MJPG"), out_fps, (w, h))
    t = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if t < len(boxes_per_frame) and boxes_per_frame[t] is not None:
            x1, y1, x2, y2 = np.asarray(boxes_per_frame[t][:4], int)
            cv2.rectangle(frame, (x1, y1), (x2, y2), (0, 255, 0), 2)
            if t < len(probs_per_frame):
                idx = int(np.argmax(probs_per_frame[t]))
                label = f"{emotions[idx]} {probs_per_frame[t][idx]:.2f}"
                cv2.putText(frame, label, (x1, max(0, y1 - 8)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 0), 2)
        vw.write(frame)
        t += 1
    cap.release()
    vw.release()
    return path_out
