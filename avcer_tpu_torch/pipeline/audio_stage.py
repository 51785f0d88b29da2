"""Audio emotion stage (avcer_tpu/pipeline/audio_stage.py): every 4 s /
0.5 s window of the clip, extracted and normalised on the device from one
wav upload, through wav2vec2 + ExprModel V3 in batches of
``AudioConfig.batch_size``; one logits fetch per clip.

Windows map to frames (and overlaps average per frame) through index arrays
that ``fusion.compound.align_audio_to_frames`` consumes. The exact per-window
path is the only one: the shared extractor and int8 are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from avcer_tpu_torch.core.config import AudioConfig
from avcer_tpu_torch.ops import audio as audio_ops


@dataclass
class AudioWindows:
    spans: list[tuple[int, int]]  # sample spans
    frame_ids: np.ndarray  # [R] replicated frame index per row
    window_of_row: np.ndarray  # [R] window index per row


def make_windows(num_samples: int, cfg: AudioConfig, fps: float) -> AudioWindows:
    """Window spans of a clip and their window -> frame rows."""
    window = int(cfg.window_sec * cfg.sample_rate)
    step = int(cfg.step_sec * cfg.sample_rate)
    spans = audio_ops.enumerate_windows(num_samples, window, step)
    frame_ids: list[int] = []
    window_of_row: list[int] = []
    for wi, (s, e) in enumerate(spans):
        names = audio_ops.window_frame_names(s, e, cfg.sample_rate, fps)
        frame_ids.extend(names)
        window_of_row.extend([wi] * len(names))
    return AudioWindows(spans=spans, frame_ids=np.asarray(frame_ids, np.int64),
                        window_of_row=np.asarray(window_of_row, np.int64))


class AudioStage:
    def __init__(self, model: torch.nn.Module, cfg: AudioConfig,
                 device: torch.device | str = "cuda"):
        if cfg.quant != "none" or cfg.shared_extractor:
            raise ValueError(
                "int8 audio and the shared extractor are not ported (ROADMAP "
                "queue 1, int8 serving and serving presets)")
        if cfg.head != "v3" or cfg.num_classes != 8:
            raise ValueError(
                f"audio head {cfg.head!r} with {cfg.num_classes} classes: only "
                "ExprModel V3 with 8 classes is ported (ROADMAP queue 1, item 9)")
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)

    @torch.inference_mode()
    def run_from_wav(self, wav: np.ndarray, fps: float) -> tuple[np.ndarray, AudioWindows]:
        """Returns (logits [W, C] f32, AudioWindows for the frame mapping)."""
        meta = make_windows(len(wav), self.cfg, fps)
        if not meta.spans:
            return np.zeros((0, self.cfg.num_classes), np.float32), meta
        window = int(self.cfg.window_sec * self.cfg.sample_rate)
        # pad so every gather index is in bounds
        wav_dev = torch.from_numpy(
            np.pad(np.asarray(wav, np.float32), (0, window + 1))).to(self.device)
        starts = torch.tensor([s for s, _ in meta.spans], dtype=torch.long,
                              device=self.device)
        outs = []
        for i in range(0, len(meta.spans), self.cfg.batch_size):
            chunk = audio_ops.extract_windows(wav_dev, len(wav),
                                              starts[i:i + self.cfg.batch_size],
                                              window, self.cfg.padding)
            outs.append(self.model(audio_ops.feature_extractor_normalize(chunk)).float())
        return torch.cat(outs).cpu().numpy(), meta
