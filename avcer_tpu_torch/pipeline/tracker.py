"""IoU face tracker (host-side, sequential by nature): the port's own copy
of avcer_tpu/pipeline/tracker.py (numpy and scipy only), pinned against it on
a seeded sequence of boxes in tests/test_torch_ops.py.

Behavior contract — src/data/face_detection/ibug/
face_detection/utils/simple_face_tracker.py:

- Hungarian assignment on 1 - IoU distance (:44-67)
- distances above 1 - iou_threshold never match (large fill value, :47-48)
- unmatched tracklets expire immediately (:74-75)
- new faces get monotonically increasing 1-based ids (:78-83)
- empty detection list clears all tracklets (:32-34)
- minimum_face_size**2 area gate (:46, :78)

This stays on host: it is O(faces^2) sequential state machine work on a
handful of boxes per frame — not worth a device program.

``gap_frames`` (1 by default — stride-1 serving is reference-exact) adapts
matching to detections that arrive every Nth frame (detect-stride
serving). Without it a small fast face moves far enough between strided
detections that the raw IoU falls under the 0.4 match threshold, the
immediate-expiry rule kills the tracklet, and the target identity (the
reference consumes tracklet "00" only — get_prob_video.py:79) is lost for
the rest of the clip (measured: a 25 px face at 7 px/frame has
inter-detection IoU 0.27 at stride 2). With gap_frames=N > 1:

- a tracklet with an ESTABLISHED velocity (matched at least once) is
  matched against the BETTER of (a) its last box advanced by that
  velocity, at the normal threshold, and (b) its raw last box, at the
  relaxed bootstrap threshold — (a) carries a face in steady motion, (b)
  carries a face that decelerates or stops (extrapolation overshoots
  there, and a stopped face must not lose the identity a raw-box match
  trivially keeps);
- a tracklet with no velocity yet (just created — nothing to extrapolate
  from) is matched at the relaxed threshold iou_threshold/N, which admits
  the IoU loss of an N-frame motion gap so the velocity can bootstrap.

Expiry stays immediate and the Hungarian assignment is unchanged.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy.optimize import linear_sum_assignment


class IoUTracker:
    def __init__(self, iou_threshold: float = 0.4, minimum_face_size: float = 0.0,
                 gap_frames: int = 1):
        self.iou_threshold = iou_threshold
        self.minimum_face_size = minimum_face_size
        self.gap_frames = max(int(gap_frames), 1)
        self._tracklets: list[dict] = []
        self._counter = 0

    def reset(self, reset_counter: bool = True) -> None:
        self._tracklets = []
        if reset_counter:
            self._counter = 0

    def __call__(self, boxes: np.ndarray) -> List[Optional[int]]:
        """boxes: [N, >=4] xyxy. Returns per-box tracklet id (1-based) or None."""
        if boxes.size <= 0:
            self._tracklets = []
            return []
        boxes = np.asarray(boxes, dtype=float)
        areas = np.abs((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]))
        dist_thresh = float(np.clip(1.0 - self.iou_threshold, 0.0, 1.0))
        # bootstrap threshold for velocity-less tracklets in gap mode
        boot_thresh = float(np.clip(
            1.0 - self.iou_threshold / self.gap_frames, 0.0, 1.0))
        min_area = max(self.minimum_face_size**2, np.finfo(float).eps)

        def iou_dist(bx: np.ndarray, b_area: float, tb: np.ndarray,
                     t_area: float) -> float:
            x_left = max(min(bx[0], bx[2]), min(tb[0], tb[2]))
            y_top = max(min(bx[1], bx[3]), min(tb[1], tb[3]))
            x_right = min(max(bx[2], bx[0]), max(tb[2], tb[0]))
            y_bottom = min(max(bx[3], bx[1]), max(tb[3], tb[1]))
            if x_right <= x_left or y_bottom <= y_top:
                return 1.0
            inter = (x_right - x_left) * (y_bottom - y_top)
            return 1.0 - inter / float(b_area + t_area - inter)

        n, m = boxes.shape[0], len(self._tracklets)
        fill = 2.0 * min(n, m) if m else 0.0
        distances = np.full((n, m), fill, dtype=float)
        for row in range(n):
            if areas[row] < min_area:
                continue
            bx = boxes[row]
            for col, t in enumerate(self._tracklets):
                if self.gap_frames > 1 and t["vel"] is not None:
                    tb = t["bbox"] + t["vel"]
                    cands = [
                        (iou_dist(bx, areas[row], tb,
                                  abs((tb[2] - tb[0]) * (tb[3] - tb[1]))),
                         dist_thresh),
                        (iou_dist(bx, areas[row], t["bbox"], t["area"]),
                         boot_thresh),
                    ]
                else:
                    gate = (boot_thresh if self.gap_frames > 1
                            else dist_thresh)
                    cands = [
                        (iou_dist(bx, areas[row], t["bbox"], t["area"]),
                         gate),
                    ]
                passing = [d for d, g in cands if d <= g]
                if passing:
                    distances[row, col] = min(passing)

        # acceptance must use the same per-tracklet threshold the distance
        # matrix was gated with (boot rows carry d in (dist_thresh,
        # boot_thresh]); entries above their gate kept the fill value
        accept = max(dist_thresh,
                     boot_thresh if self.gap_frames > 1 else dist_thresh)
        ids: list[Optional[int]] = [None] * n
        if m:
            for row, col in zip(*linear_sum_assignment(distances)):
                if distances[row, col] <= accept:
                    t = self._tracklets[col]
                    ids[row] = t["id"]
                    t["vel"] = boxes[row, :4] - t["bbox"]
                    t["bbox"] = boxes[row, :4].copy()
                    t["area"] = areas[row]
                    t["tracked"] = True
        self._tracklets = [t for t in self._tracklets if t.get("tracked")]
        for t in self._tracklets:
            t["tracked"] = False

        for row in range(n):
            if ids[row] is None and areas[row] >= min_area:
                self._counter += 1
                self._tracklets.append(
                    {"bbox": boxes[row, :4].copy(), "area": areas[row],
                     "vel": None, "id": self._counter,
                     "tracked": False}
                )
                ids[row] = self._counter
        return ids
