"""Audio front-end ops (avcer_tpu/ops/audio.py): window enumeration and
window -> frame mapping (host), window extraction with the reference's
padding modes, the HF feature-extractor normalisation, mono mixdown and the
sinc resampler (host numpy, once per clip).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def enumerate_windows(num_samples: int, window: int, step: int) -> list[tuple[int, int]]:
    """(start, end) pairs of ``range(0, len(wav) + 1, step)`` with
    ``end = min(start + window, len)`` — the reference's ``+1`` bound keeps an
    empty final window when the length is a multiple of ``step``."""
    return [(start, min(start + window, num_samples))
            for start in range(0, num_samples + 1, step)]


def window_frame_names(start: int, end: int, sr: int, fps: float) -> list[int]:
    """0-based frame indices a window covers: ``round(start/sr*fps)`` up to
    and including ``round(end/sr*fps)``."""
    return list(range(round(start / sr * fps), round(end / sr * fps + 1)))


def extract_windows(
    wav: torch.Tensor,  # [L] float32, zero-padded by at least ``window`` samples
    wav_len: int,  # true length
    starts: torch.Tensor,  # [B] int window starts
    window: int,
    padding: str = "mean",
) -> torch.Tensor:
    """[B, window] windows gathered on the device, padded past the end of the
    wav with the window's mean ("mean"), zeros ("constant") or a repeat of
    its own samples ("repeat"); an empty window is all zeros."""
    offs = torch.arange(window, device=wav.device)[None, :]
    idx = starts.long()[:, None] + offs
    in_range = idx < wav_len
    vals = wav[idx.clamp(0, wav.shape[0] - 1)] * in_range
    n = (wav_len - starts.long()).clamp(0, window)[:, None]
    nonempty = (n > 0).to(wav.dtype)
    if padding == "repeat":
        rep = wav[(starts.long()[:, None] + offs % n.clamp_min(1)).clamp(0, wav.shape[0] - 1)]
        return torch.where(offs < n, vals, rep) * nonempty
    if padding == "mean":
        fill = vals.sum(dim=1, keepdim=True) / n.clamp_min(1)
    elif padding == "constant":
        fill = torch.zeros_like(vals[:, :1])
    else:
        raise ValueError(f"unknown padding {padding!r}")
    return torch.where(offs < n, vals, fill) * nonempty


def feature_extractor_normalize(batch: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Per-window zero-mean unit-variance (biased variance), as HF
    ``Wav2Vec2FeatureExtractor``."""
    mean = batch.mean(dim=-1, keepdim=True)
    var = ((batch - mean) ** 2).mean(dim=-1, keepdim=True)
    return (batch - mean) / torch.sqrt(var + eps)


def mixdown_mono(wav: np.ndarray) -> np.ndarray:
    """Channel-mean mixdown of [C, L] (or [L]) audio."""
    wav = np.asarray(wav)
    if wav.ndim == 2 and wav.shape[0] > 1:
        return wav.mean(axis=0)
    return wav.reshape(-1)


def _sinc_resample_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                          rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Hann-windowed sinc polyphase kernel with torchaudio's defaults."""
    gcd = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // gcd, new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel *= window * base_freq / orig
    return kernel.astype(np.float32), orig


def resample(wav: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """Band-limited sinc resampling of a mono [L] waveform
    (``torchaudio.transforms.Resample`` defaults)."""
    wav = np.asarray(wav, dtype=np.float32)
    if orig_freq == new_freq:
        return wav
    kernel, orig = _sinc_resample_kernel(orig_freq, new_freq)
    new = new_freq // math.gcd(orig_freq, new_freq)
    length = wav.shape[-1]
    width = (kernel.shape[1] - orig) // 2
    padded = np.pad(wav[None], ((0, 0), (width, width + orig)))
    target_len = int(math.ceil(new * length / orig))
    n_frames = -(-target_len // new)
    out = np.zeros((1, new, n_frames), dtype=np.float32)
    for p in range(new):
        k = kernel[p]
        strided = np.lib.stride_tricks.sliding_window_view(padded, k.shape[0], axis=1)
        out[:, p, :] = strided[:, : n_frames * orig : orig] @ k
    return out.transpose(0, 2, 1).reshape(1, -1)[0, :target_len]
