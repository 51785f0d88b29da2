"""The scripted face: the benchmark's stand-in for a trained detector's
answer, a frozen part of the yardstick.

The program's detect stage runs in full on the card (the wire, the I420
rebuild, the network, decoding, the top-64 candidates and NMS); then
``unpack`` hands the tracker one box a detected frame: the square's, which
the traffic knows. Seeded weights find no face, so the detector's own
candidates would make the host tracker the whole wall (up to 64 a frame),
and a top candidate chosen among near-ties would crop another region on the
reference's side. The detector's own outputs are kept, batch by batch, for
the correctness check.

It replaces ``chip_smoke.ForceTopFace``, which kept the detector's top
candidate.
"""

from __future__ import annotations

import numpy as np


class ScriptedFace:
    """Wraps a ``DetectStage``: everything the stage's own, but an
    ``unpack`` whose detections are the clip's scripted face. ``start_clip(boxes)`` gives the face's box in each frame of
    the next clip ([T, 4] native pixels); the runner unpacks the clip's
    batches in order, one batch of ``batch_size`` frames at a time, a row
    every ``stride``-th frame."""

    def __init__(self, inner):
        self.inner = inner
        self.batch_size = inner.cfg.batch_size
        self.stride = inner.cfg.stride
        self.boxes = np.zeros((0, 4))
        self.cursor = 0
        #: the packed detections of the current clip, batch by batch
        self.packed: list[np.ndarray] = []

    def start_clip(self, boxes: np.ndarray) -> None:
        self.boxes = np.asarray(boxes, np.float64)
        self.cursor = 0
        self.packed = []

    def __getattr__(self, name):
        # prepare_wire, dispatch_wire, dispatch, cfg, ...: the stage's own
        return getattr(self.inner, name)

    def face_rows(self, first: int, rows: int) -> np.ndarray:
        """The face's box in the detected frames of a batch that starts at
        frame ``first`` (frames past the clip: its last frame's box, as the
        reader pads a batch)."""
        t = np.minimum(first + self.stride * np.arange(rows), len(self.boxes) - 1)
        return self.boxes[t]

    def unpack(self, packed_np: np.ndarray, scale: float):
        self.packed.append(packed_np)
        det = self.inner.unpack(packed_np, scale)
        rows = det.boxes.shape[0]
        det.keep = np.zeros_like(det.keep)
        det.keep[:, 0] = True
        det.scores = np.array(det.scores)
        det.scores[:, 0] = 0.99
        det.boxes = np.array(det.boxes)
        det.boxes[:, 0] = self.face_rows(self.cursor, rows)
        self.cursor += self.batch_size
        return det
