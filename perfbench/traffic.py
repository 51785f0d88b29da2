"""The one traffic generator: a mix is a data file (``traffic/<name>.json``)
of parameters, read here.

The pattern is the smoke script's synthetic clip (``chip_smoke.make_clip``):
a seeded noise frame with one bright square that moves, and a wav of seeded
noise at 16 kHz. The square is the face (``face.ScriptedFace`` tells the
tracker where it is). One base clip of the longest length in the cycle is
made in set-up; each served clip is a slice of it at a seeded offset, its
wav the same span of the base wav. The square bounces off the frame's edges
so that it never jumps, and every frame holds it whole.

Every seed gives the same cycle of clip lengths (rotated by the seed), so the
work of a window is the same from seed to seed; what the seed changes is the
content: the base frame, the square's texture and path, the offsets, the wav.

Keys of a mix: ``clip_seconds`` (the cycle), ``width``, ``height``, ``fps``,
``faces`` (faces a frame; 1), ``face_px`` (the square's side),
``face_speed_px`` ([x, y] per frame), ``audio`` (``sample_rate``,
``noise_std``), ``loop`` (``kind`` "closed", ``clients`` 1), ``trace_clips``
(the whole clips a traced run profiles) and ``check_clips`` (the clips the
reference checks after the window).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

KEYS = ("clip_seconds", "width", "height", "fps", "faces", "face_px", "face_speed_px", "audio",
        "loop", "trace_clips", "check_clips")


def validate(mix: dict) -> dict:
    missing = [k for k in KEYS if k not in mix]
    if missing:
        raise ValueError(f"traffic mix lacks {missing}")
    if mix["faces"] != 1:
        raise ValueError("the generator draws one face a frame")
    if mix["loop"] != {"kind": "closed", "clients": 1}:
        raise ValueError("the generator serves one closed-loop client")
    if mix["audio"].get("sample_rate") != 16000:
        raise ValueError("the audio models take 16 kHz")
    return mix


@dataclass
class Clip:
    index: int
    name: str
    seconds: int
    offset: int  # first frame in the base clip
    frames: np.ndarray  # [T, H, W, 3] uint8 BGR (a view of the base)
    wav: np.ndarray  # [T / fps * sr] float32 (a view of the base wav)
    boxes: np.ndarray  # [T, 4] float64 xyxy native pixels: the face in each frame

    @property
    def video_seconds(self) -> float:
        return self.frames.shape[0] / self.fps

    fps: int = 25


def bounce(start: float, speed: float, span: float, n: int) -> np.ndarray:
    """Positions along [0, span] of a point moving ``speed`` a frame that
    turns back at either end."""
    p = np.mod(start + speed * np.arange(n, dtype=np.float64), 2 * span)
    return np.where(p > span, 2 * span - p, p)


class Traffic:
    """The clips of one run, from a mix and a seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = validate(mix)
        self.seed = seed
        rng = np.random.default_rng(seed)
        w, h, fps, s = mix["width"], mix["height"], mix["fps"], mix["face_px"]
        self.fps = fps
        self.sr = mix["audio"]["sample_rate"]
        cycle = list(mix["clip_seconds"])
        k = seed % len(cycle)
        self.cycle = cycle[k:] + cycle[:k]
        n = max(cycle) * fps
        base = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        self.frames = np.repeat(base[None], n, axis=0)
        xs = bounce(rng.uniform(0, w - s), mix["face_speed_px"][0], w - s, n).astype(np.int64)
        ys = bounce(rng.uniform(0, h - s), mix["face_speed_px"][1], h - s, n).astype(np.int64)
        texture = rng.integers(100, 256, (n, s, s, 3), dtype=np.uint8)
        for i in range(n):
            self.frames[i, ys[i]:ys[i] + s, xs[i]:xs[i] + s] = texture[i]
        self.boxes = np.stack([xs, ys, xs + s, ys + s], 1).astype(np.float64)
        self.wav = (rng.normal(size=max(cycle) * self.sr) * mix["audio"]["noise_std"]).astype(
            np.float32)
        self._rng = rng

    def clip(self, index: int, seconds: int | None = None, offset: int | None = None) -> Clip:
        """Clip ``index`` of the run: the cycle's length, at a seeded offset
        (the offset and length may be given)."""
        seconds = self.cycle[index % len(self.cycle)] if seconds is None else seconds
        t = seconds * self.fps
        if offset is None:
            offset = int(self._rng.integers(0, self.frames.shape[0] - t + 1))
        a = offset * self.sr // self.fps
        return Clip(index=index, name=f"clip{index:05d}.avi", seconds=seconds, offset=offset,
                    frames=self.frames[offset:offset + t],
                    wav=self.wav[a:a + seconds * self.sr], boxes=self.boxes[offset:offset + t],
                    fps=self.fps)

    def warmup_clips(self) -> list[Clip]:
        """One clip of each length in the cycle, at offset 0: the shapes the
        window will use."""
        return [self.clip(-1 - i, seconds=sec, offset=0)
                for i, sec in enumerate(sorted(set(self.cycle)))]
