"""Host-side media ingest (avcer_tpu/pipeline/media.py): frame readers with
fixed-size batching, wav I/O and the wav-sidecar audio extraction.

``VideoReader`` decodes with OpenCV, imported only when a reader is made.
``ArrayReader`` serves frames already in memory through the same
``meta``/``batches``/``release`` interface, for callers (and machines) that
decode elsewhere or have no OpenCV.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from avcer_tpu_torch.ops.audio import mixdown_mono, resample
from avcer_tpu_torch.ops.image import nearest_indices_np


@dataclass
class VideoMeta:
    path: str
    width: int
    height: int
    fps: int  # int-truncated like the reference
    total_frames: int


def _batched(frames: Iterator[np.ndarray], batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
    """([batch_size, H, W, 3] uint8, n_valid); the last batch is padded by
    repeating its last frame."""
    buf: list[np.ndarray] = []
    for frame in frames:
        buf.append(frame)
        if len(buf) == batch_size:
            yield np.stack(buf), batch_size
            buf = []
    if buf:
        n = len(buf)
        buf.extend([buf[-1]] * (batch_size - n))
        yield np.stack(buf), n


class VideoReader:
    """Sequential BGR frame reader over a video file (OpenCV)."""

    def __init__(self, path: str):
        import cv2

        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.meta = VideoMeta(
            path=path,
            width=int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
            fps=int(self.cap.get(cv2.CAP_PROP_FPS)),
            total_frames=int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        )

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            ret, frame = self.cap.read()
            if not ret:
                return
            yield frame

    def batches(self, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        return _batched(iter(self), batch_size)

    def release(self) -> None:
        self.cap.release()


class ArrayReader:
    """Frames held in memory ([T, H, W, 3] uint8 BGR) behind the
    ``VideoReader`` interface. ``path`` names the clip (outputs are named
    after it; a wav sidecar is looked up beside it)."""

    def __init__(self, frames: np.ndarray, fps: int, path: str = "clip.avi"):
        if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
            raise ValueError(f"frames must be [T, H, W, 3] uint8, got "
                             f"{frames.shape} {frames.dtype}")
        self.frames = frames
        self.meta = VideoMeta(path=path, width=frames.shape[2], height=frames.shape[1],
                              fps=int(fps), total_frames=frames.shape[0])

    def batches(self, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
        return _batched(iter(self.frames), batch_size)

    def release(self) -> None:
        pass


def prefetch_iter(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator in a background thread with a bounded queue, so host
    decode overlaps device work. An exception in the producer is re-raised
    here. The thread runs in a copy of the caller's ``contextvars`` context
    (the clip a span records for, ``utils.trace``)."""
    import contextvars
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    failure: list[BaseException] = []

    def producer() -> None:
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # handed to the consumer, re-raised there
            failure.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=contextvars.copy_context().run, args=(producer,),
                         daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            t.join()
            if failure:
                raise failure[0]
            return
        yield item


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """PCM wav -> (float32 [channels, samples] in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    return data.reshape(-1, ch).T, sr


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """float32 mono/stereo in [-1, 1] -> 16-bit PCM wav."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.clip(wav.T * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(wav.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def extract_audio(path_video: str, sample_rate: int = 16_000) -> np.ndarray:
    """Video (or wav) path -> mono float32 waveform at ``sample_rate``: the
    wav sidecar beside the video, else ffmpeg if present, else an error."""
    if path_video.lower().endswith(".wav"):
        wav_path = path_video
    else:
        wav_path = (path_video[:-3] + "wav" if "." in path_video[-5:]
                    else path_video + ".wav")
        if not os.path.exists(wav_path):
            ffmpeg = shutil.which("ffmpeg")
            if ffmpeg is None:
                raise RuntimeError(
                    f"no wav sidecar at {wav_path} and ffmpeg is unavailable; "
                    "provide audio as a .wav next to the video")
            subprocess.run(
                [ffmpeg, "-y", "-i", path_video, "-vn", "-acodec", "pcm_s16le",
                 "-ar", "44100", "-ac", "2", wav_path],
                check=True, capture_output=True)
    data, sr = read_wav(wav_path)
    mono = mixdown_mono(data)
    if sr != sample_rate:
        mono = resample(mono, sr, sample_rate)
    return np.asarray(mono, dtype=np.float32)


def resize_nearest_np(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """PIL-NEAREST resize on the host by an integer gather, bit for bit
    PIL's (``ops.image.nearest_indices_np``): the host-crop path's crops."""
    h, w = img.shape[:2]
    ri = nearest_indices_np(out_hw[0], h)
    ci = nearest_indices_np(out_hw[1], w)
    return img[ri[:, None], ci[None, :]]
