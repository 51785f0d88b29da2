"""Vocal separation substitute for the reference's Spleeter stage: a copy of
avcer_tpu/pipeline/separate.py, pinned against it by the tests.

The reference (its audio/run_convert_video_to_audio.py:36-95)
extracts audio at 44.1 kHz, runs Spleeter 2-stems, keeps the ``vocals`` stem,
resamples it to 16 kHz mono, and asserts the duration is unchanged. Spleeter
(a TF U-Net) is not a dependency here; this module provides a
dependency-free classical substitute behind the same contract: a two-stage
harmonic/percussive source separation (Tachibana et al. 2010 style) where

- stage 1 uses a LONG STFT window (~93 ms): sustained instruments are
  time-stable ("harmonic" = horizontal ridges in the spectrogram) and are
  median-masked away; singing voice fluctuates (vibrato, formant motion) and
  survives with the percussive residual;
- stage 2 uses a SHORT window (~12 ms): at this timescale the voice is the
  stable component while drum hits are broadband verticals, so the harmonic
  mask now KEEPS the voice and drops percussion.

Everything is host-side scipy/numpy (STFT, median filter, polyphase
resample) — this is a preprocessing script surface, not a device compute
path (the reference runs Spleeter offline per corpus too).
"""

from __future__ import annotations

import math

import numpy as np


def _stft(x: np.ndarray, nperseg: int, hop: int):
    from scipy.signal import stft

    return stft(
        x, nperseg=nperseg, noverlap=nperseg - hop, window="hann",
        padded=True, boundary="zeros",
    )[2]


def _istft(S: np.ndarray, nperseg: int, hop: int, length: int) -> np.ndarray:
    from scipy.signal import istft

    y = istft(
        S, nperseg=nperseg, noverlap=nperseg - hop, window="hann",
        boundary=True,
    )[1]
    if len(y) < length:
        y = np.pad(y, (0, length - len(y)))
    return y[:length]


def _median_mask(S: np.ndarray, kt: int, kf: int, power: float = 2.0):
    """Soft (Wiener-like) harmonic/percussive masks from median filtering:
    the harmonic estimate smooths each frequency bin over TIME (kt frames),
    the percussive estimate smooths each frame over FREQUENCY (kf bins).
    S: complex [freq, time]. Returns (harmonic_mask, percussive_mask)."""
    from scipy.ndimage import median_filter

    mag = np.abs(S)
    h = median_filter(mag, size=(1, kt), mode="reflect") ** power
    p = median_filter(mag, size=(kf, 1), mode="reflect") ** power
    tot = h + p + 1e-12
    return h / tot, p / tot


def hpss_vocals(wav: np.ndarray, sr: int) -> np.ndarray:
    """Two-stage HPSS vocal estimate of a mono waveform (float [-1, 1])."""
    wav = np.asarray(wav, np.float64)
    length = len(wav)
    if length == 0:
        return wav.astype(np.float32)

    # stage 1: long window — suppress time-stable accompaniment
    n1 = 4096 if sr >= 32_000 else 1024
    n1 = min(n1, 1 << max(4, int(math.log2(max(length, 16)))))
    S1 = _stft(wav, n1, n1 // 4)
    _, pm = _median_mask(S1, kt=31, kf=31)
    resid = _istft(S1 * pm, n1, n1 // 4, length)

    # stage 2: short window — keep the now-stable voice, drop percussion
    n2 = 512 if sr >= 32_000 else 256
    n2 = min(n2, n1)
    S2 = _stft(resid, n2, n2 // 4)
    hm, _ = _median_mask(S2, kt=31, kf=31)
    vocals = _istft(S2 * hm, n2, n2 // 4, length)
    return vocals.astype(np.float32)


def resample(wav: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample with the exact output length the reference's
    duration sanity check expects (out/in sample-rate ratio of the input
    length, run_convert_video_to_audio.py:87-95)."""
    if sr_in == sr_out:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    g = math.gcd(sr_in, sr_out)
    y = resample_poly(np.asarray(wav, np.float64), sr_out // g, sr_in // g)
    want = int(round(len(wav) * sr_out / sr_in))
    if len(y) < want:
        y = np.pad(y, (0, want - len(y)))
    return y[:want].astype(np.float32)


def hpss_separator(
    in_wav: str, out_wav: str, out_sample_rate: int = 16_000
) -> str:
    """Drop-in ``separator(in_wav, out_wav)`` for
    ``preprocess.convert_video_to_audio(vocal_separation=True)``: reads the
    44.1 kHz extraction, writes a 16 kHz mono vocals wav of identical
    duration (the Spleeter stage's contract,
    run_convert_video_to_audio.py:58-86)."""
    from avcer_tpu_torch.pipeline.media import read_wav, write_wav

    data, sr = read_wav(in_wav)
    mono = data.mean(0) if data.shape[0] > 1 else data[0]
    vocals = hpss_vocals(mono, sr)
    write_wav(out_wav, resample(vocals, sr, out_sample_rate), out_sample_rate)
    return out_wav
