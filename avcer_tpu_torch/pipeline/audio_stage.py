"""Audio emotion stage (avcer_tpu/pipeline/audio_stage.py): every 4 s /
0.5 s window of the clip, extracted and normalised on the device from one
wav upload, through wav2vec2 + the ExprModel head (``AudioConfig.head`` V1,
V2 or V3, with ``num_classes`` 7 or 8) in batches of
``AudioConfig.batch_size``; one logits fetch per clip.

The encoder is the one ``AudioConfig.encoder`` names (wav2vec2 or WavLM,
held as ``model.wav2vec2`` either way); its forward in ``forward_windows``
is the span ``audio.encode`` (``utils.trace``).

Windows map to frames (and overlaps average per frame) through index arrays
that ``fusion.compound.align_audio_to_frames`` consumes.

``AudioConfig.shared_extractor``: the conv feature extractor runs once over
the whole clip, normalised per clip, and every full window takes its slice of
that feature stream (window starts are multiples of the extractor's total
stride); windows shorter than 4 s, the clip's tail, keep the exact per-window
path so that the padding modes hold.

int8 (``AudioConfig.quant == "int8"``): the model's activation scales are
seeded at build on two noise windows and refined once per process on the
first clip's first two windows (running max).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch

from avcer_tpu_torch.core.config import AudioConfig
from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.audio_heads import ENCODERS
from avcer_tpu_torch.ops import audio as audio_ops
from avcer_tpu_torch.utils import trace


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
                 device: torch.device | str = "cuda", mesh=None):
        if cfg.quant not in ("none", "int8") or (cfg.quant == "int8") != bool(
                model.wav2vec2.config.quant):
            raise ValueError(f"quant={cfg.quant!r} does not fit the model it was given")
        #: the ``ENCODERS`` name of the model's encoder
        self.encoder = {c: n for n, c in ENCODERS.items()}[type(model.wav2vec2.config)]
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        #: under a mesh the windows are not sharded (as in the JAX package,
        #: which replicates the weights): the stage runs on the first device
        self.mesh = mesh
        self.window = int(cfg.window_sec * cfg.sample_rate)
        self._real_calibrated = cfg.quant != "int8"
        self._calib_lock = threading.Lock()
        #: calibration forwards made so far (seed and refinement)
        self.calibration_forwards = 0
        if cfg.quant == "int8":
            self.calibrate(np.random.default_rng(0).normal(size=(2, self.window))
                           .astype(np.float32))

    @torch.inference_mode()
    def _calibrate_device(self, windows: torch.Tensor) -> None:
        with layers.calibrating(self.model):
            self.model(audio_ops.feature_extractor_normalize(windows))
        self.calibration_forwards += 1

    def calibrate(self, windows: np.ndarray) -> None:
        """Take the running max-abs of every int8 projection's input over
        ``windows`` ([N, window] raw samples) into the model's activation
        scales (cumulative: scales only grow)."""
        self._calibrate_device(
            torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(self.device))

    def merge_act_scales(self, scales: Mapping[str, torch.Tensor]) -> None:
        """Adopt calibration scales made elsewhere: the elementwise running
        max with the model's own. Raises on a structure mismatch."""
        cur = layers.act_scales(self.model)
        if not cur:
            return
        layers.load_act_scales(self.model, layers.merge_act_scales_trees(cur, scales))
        self._real_calibrated = True

    def shared_features(self, wav_dev: torch.Tensor, wav_len: int) -> torch.Tensor:
        """The conv feature extractor once over the whole waveform ``[L]``
        (zero-padded past ``wav_len``), normalised per clip over the true
        samples: the windows overlap eightfold and the extractor pads nothing,
        so stream frame ``start // stride + j`` is window frame ``j`` up to the
        normalisation (per clip here, per window on the exact path).
        Returns [F, conv_dim]."""
        mask = (torch.arange(wav_dev.shape[0], device=wav_dev.device) < wav_len).to(wav_dev.dtype)
        n = float(max(wav_len, 1))
        mean = (wav_dev * mask).sum() / n
        var = (((wav_dev - mean) ** 2) * mask).sum() / n
        xn = ((wav_dev - mean) / torch.sqrt(var + 1e-7)) * mask
        return self.model(xn[None], w2v_mode="features_only")[0]

    def from_features(self, feats: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
        """Logits of the windows starting at ``starts`` from the clip's
        feature stream ``[F, conv_dim]``: frames ``start // stride + j``,
        clipped to the stream, through the projection, encoder and head."""
        c = self.model.wav2vec2.config
        fpw = c.num_output_frames(self.window)
        stride_total = int(np.prod(c.conv_stride))
        f_idx = starts[:, None] // stride_total + torch.arange(fpw, device=feats.device)[None, :]
        f_idx = f_idx.clamp(0, feats.shape[0] - 1)
        return self.encode_and_head(feats[f_idx], "from_features")

    def encode_and_head(self, x: torch.Tensor, mode: str = "full") -> torch.Tensor:
        """``model(x, w2v_mode=mode)``, the encoder's forward inside the span
        ``audio.encode`` (``encoder``, ``layers``, ``windows``, ``frames``: a
        window's)."""
        enc = self.model.wav2vec2
        with trace.span("audio.encode") as sp:
            if sp:
                sp.note(encoder=self.encoder, layers=len(enc.encoder.layers),
                        windows=x.shape[0], frames=enc.config.num_output_frames(self.window))
            h = enc(x, mode=mode)
        return self.model.head(h)

    def forward_windows(self, wav_dev: torch.Tensor, wav_len: int, starts: torch.Tensor,
                        feats: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [N, C] f32 of one batch of windows starting at ``starts``:
        from the clip's shared feature stream ``feats``, or cut from
        ``wav_dev`` (zero-padded by a window past ``wav_len``) with the
        configured padding and normalised one by one."""
        if feats is not None:
            return self.from_features(feats, starts).float()
        windows = audio_ops.extract_windows(wav_dev, wav_len, starts, self.window,
                                            self.cfg.padding)
        return self.encode_and_head(audio_ops.feature_extractor_normalize(windows)).float()

    @torch.inference_mode()
    def run_from_wav(self, wav: np.ndarray, fps: float) -> tuple[np.ndarray, AudioWindows]:
        """Returns (logits [W, C] f32, AudioWindows for the frame mapping)."""
        meta = make_windows(len(wav), self.cfg, fps)
        if not meta.spans:
            return np.zeros((0, self.cfg.num_classes), np.float32), meta
        window, bs = self.window, self.cfg.batch_size
        # pad so every gather index is in bounds
        wav_dev = torch.from_numpy(
            np.pad(np.asarray(wav, np.float32), (0, window + 1))).to(self.device)
        starts = torch.tensor([s for s, _ in meta.spans], dtype=torch.long,
                              device=self.device)

        def windows_of(st: torch.Tensor) -> torch.Tensor:
            return audio_ops.extract_windows(wav_dev, len(wav), st, window, self.cfg.padding)

        if not self._real_calibrated:
            # the first clip's first two windows (one, twice, if it has one)
            with self._calib_lock:
                if not self._real_calibrated:
                    self._calibrate_device(windows_of(starts[[0, min(1, len(starts) - 1)]]))
                    self._real_calibrated = True

        def run_chunks(st: torch.Tensor, feats: Optional[torch.Tensor]) -> torch.Tensor:
            return torch.cat([self.forward_windows(wav_dev, len(wav), st[i:i + bs], feats)
                              for i in range(0, len(st), bs)])

        if not self.cfg.shared_extractor:
            return run_chunks(starts, None).cpu().numpy(), meta
        # full windows from the shared stream; the tail windows through the
        # exact path, which alone can fill with the mean or a repeat
        is_full = torch.tensor([e - s >= window for s, e in meta.spans], device=self.device)
        logits = torch.empty((len(starts), self.cfg.num_classes), dtype=torch.float32,
                             device=self.device)
        if bool(is_full.any()):
            feats = self.shared_features(wav_dev, len(wav))
            logits[is_full] = run_chunks(starts[is_full], feats)
        if not bool(is_full.all()):
            logits[~is_full] = run_chunks(starts[~is_full], None)
        return logits.cpu().numpy(), meta
