"""Corpus preprocessing (L1): audio extraction, VAD, mouth-open features. A
host numpy / scipy / cv2 copy of avcer_tpu/pipeline/preprocess.py, pinned
against it by the tests.

Reference mechanisms and their status here:

- video -> wav via ffmpeg, optional Spleeter vocal separation with duration
  sanity checks (the reference's audio/run_convert_video_to_audio.py:28-95).
  ffmpeg-gated; Spleeter is not a dependency, so the built-in HPSS separator
  (pipeline/separate.py) runs unless a separator callable is injected.
- silero VAD via torch.hub (audio/run_vad.py:8-34). torch.hub needs the
  network or its cache; when it fails the spectral silero-equivalent VAD with
  the same output schema ({"start": sample, "end": sample} dicts) is used.
- mediapipe FaceMesh mouth-open features
  (audio/run_open_mouth_features_extraction.py:22-130). mediapipe is not a
  dependency; the rolling-mean thresholding (:120-125) is implemented over
  any per-frame lip-area series, with a pluggable area extractor.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
from typing import Callable, Optional

import numpy as np


def convert_video_to_audio(
    path_video: str,
    path_wav: str,
    sample_rate: int = 16_000,
    vocal_separation: bool = False,
    separator: Optional[Callable[[str, str], None]] = None,
) -> str:
    """ffmpeg extraction (run_convert_video_to_audio.py:28: 16 kHz mono
    pcm_s16le). ``separator(in_wav, out_wav)`` hook replaces Spleeter;
    when none is injected the built-in two-stage HPSS vocal separator
    (pipeline/separate.py) runs, so ``vocal_separation=True`` works out of
    the box under the reference's duration-checked contract."""
    if os.path.exists(path_wav):
        return path_wav
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError("ffmpeg not available; cannot extract audio")
    if vocal_separation:
        tmp = path_wav + ".full.wav"
        subprocess.run(
            [ffmpeg, "-y", "-i", path_video, "-vn", "-acodec", "pcm_s16le",
             "-ar", "44100", "-ac", "1", tmp],
            check=True, capture_output=True,
        )
        if separator is None:
            from avcer_tpu_torch.pipeline.separate import hpss_separator

            separator = hpss_separator
        separator(tmp, path_wav)
        _check_durations(tmp, path_wav)
        os.remove(tmp)
    else:
        subprocess.run(
            [ffmpeg, "-y", "-i", path_video, "-vn", "-acodec", "pcm_s16le",
             "-ar", str(sample_rate), "-ac", "1", path_wav],
            check=True, capture_output=True,
        )
    return path_wav


def _check_durations(a: str, b: str, tol: float = 0.1) -> None:
    """Duration sanity check (run_convert_video_to_audio.py:87-95)."""
    from avcer_tpu_torch.pipeline.media import read_wav

    wa, sa = read_wav(a)
    wb, sb = read_wav(b)
    da, db = wa.shape[-1] / sa, wb.shape[-1] / sb
    if abs(da - db) > tol:
        raise RuntimeError(f"duration mismatch after separation: {da} vs {db}")


# ---------------------------------------------------------------------------
# VAD
# ---------------------------------------------------------------------------


def energy_vad(
    wav: np.ndarray,
    sr: int = 16_000,
    frame_ms: float = 30.0,
    threshold_db: float = -35.0,
    min_speech_ms: float = 250.0,
    min_silence_ms: float = 100.0,
) -> list[dict]:
    """Energy-gate VAD emitting silero-schema segments
    ([{"start": sample, "end": sample}, ...], run_vad.py output format).
    Fallback when the silero torch.hub model cannot be fetched."""
    frame = int(sr * frame_ms / 1000)
    n = len(wav) // frame
    if n == 0:
        return []
    frames = wav[: n * frame].reshape(n, frame)
    rms = np.sqrt((frames.astype(np.float64) ** 2).mean(1)) + 1e-12
    db = 20 * np.log10(rms)
    active = db > threshold_db
    segs: list[dict] = []
    start = None
    for i, a in enumerate(active):
        if a and start is None:
            start = i
        elif not a and start is not None:
            segs.append({"start": start * frame, "end": i * frame})
            start = None
    if start is not None:
        segs.append({"start": start * frame, "end": n * frame})
    # merge close, drop short
    min_sil = int(sr * min_silence_ms / 1000)
    min_sp = int(sr * min_speech_ms / 1000)
    merged: list[dict] = []
    for s in segs:
        if merged and s["start"] - merged[-1]["end"] < min_sil:
            merged[-1]["end"] = s["end"]
        else:
            merged.append(dict(s))
    return [s for s in merged if s["end"] - s["start"] >= min_sp]


def vad_speech_probs(
    wav: np.ndarray, sr: int = 16_000, window: int = 512
) -> np.ndarray:
    """Per-window speech probability — the model half of the
    silero-equivalent VAD (run_vad.py:8-34), with no model weights to
    fetch.

    Features per 32 ms frame, combined additively through a logistic
    (weights tuned on the synthetic benchmark in
    experiments/exp_vad_mouth.py — numbers in PARITY.md):

    - SNR over the clip's 10th-percentile noise floor;
    - speech-band (200-4000 Hz) energy concentration;
    - **harmonicity**: peak normalized autocorrelation in the 70-350 Hz
      pitch-lag range (voiced speech and tonal music high; noise and
      percussion low);
    - **pitch-contour variability**: context std of the autocorrelation
      pitch lag in semitones (speech f0 drifts and vibrates; sustained
      notes/chords hold a stable lag);
    - **syllabic modulation**: interquartile spread of the log-energy
      series over a ±0.5 s context — speech pulses at 3-5 Hz with a ~50%
      duty cycle, giving a large IQR, while steady noise/chords give ~0
      and sparse drum hits leave the quartiles on the sustained floor.
      Round-4: the energy series is the HARMONIC component only (HPSS-lite
      median masking, same idea as pipeline/separate.py, on the VAD's own
      spectrogram frames) — drum hits are frequency-smooth verticals that
      the percussive mask absorbs, so percussion no longer feeds the
      syllabic cue (the round-3 music failure mode, PARITY.md);
    - **chroma-stability penalty** (round-4): per-frame 12-bin pitch-class
      profile, cosine-matched against its ±1 s mean. Sustained chords and
      held notes keep one chroma shape for seconds; speech harmonics ride
      a drifting f0 whose pitch classes rotate. Frames that are strongly
      harmonic AND chroma-stable are accompaniment, and their harmonicity
      credit is withdrawn.

    The additive form (vs the round-2 product of gates) keeps recall when
    one cue is missing; music needs modulation, pitch movement, AND
    chroma motion to score, which the benchmark shows it doesn't.

    Round-5 (the 5 dB music cell was recall-limited — 47% of speech
    frames lost their score to the raised noise floor, while music false
    positives were already ~0): stationary-noise floor subtraction (per-
    bin 10th percentile) before the syllabic-modulation energy and the
    autocorrelation harmonicity, and the f0var weight raised to 1.2 —
    pitch-contour variability is the cue noise degrades least. The
    standalone official-seed gains are small (music F1 at 10/5 dB:
    0.851/0.729 -> 0.855/0.731, seed-dependent); what closes the 5 dB
    cell is the raw+separated max-fusion mode (spectral_vad
    separate_fusion=True, 0.861 at 5 dB) — PARITY.md has the tables."""
    n = len(wav) // window
    if n == 0:
        return np.zeros(0, np.float32)
    # all context/filter spans below are specified in SECONDS and derived
    # from the actual frame rate, so a non-default sr/window keeps the
    # advertised time spans (at the 16 kHz / 512 defaults: fps 31.25,
    # ctx 16 frames, HPSS time-median 17, chroma window 65 — the values
    # the exp_vad_mouth benchmark weights were tuned on)
    frames_per_sec = sr / window
    ctx = max(1, int(round(0.5 * frames_per_sec)))       # ±0.5 s
    tmed = max(3, int(round(0.5 * frames_per_sec)) | 1)  # ~0.5 s median
    # HPSS frequency median ~530 Hz of bins (bin width = sr / window)
    fmed = max(3, int(round(531.25 * window / sr)) | 1)
    cwin = 2 * int(np.ceil(frames_per_sec)) + 1          # ±1 s chroma
    frames = wav[: n * window].reshape(n, window).astype(np.float64)
    win = np.hanning(window)
    spec = np.abs(np.fft.rfft(frames * win, axis=1)) ** 2
    freqs = np.fft.rfftfreq(window, 1.0 / sr)
    total = spec.sum(1) + 1e-12
    voice = spec[:, (freqs >= 200) & (freqs <= 4000)].sum(1)
    band = voice / total
    log_e = 10 * np.log10(total)
    floor = np.percentile(log_e, 10)
    snr = np.clip((log_e - floor) / 20.0, 0.0, 1.0)

    # HPSS-lite split of the spectrogram (spec is [time, freq], so the
    # harmonic estimate medians along axis 0): harmonic-component energy
    # drives the syllabic-modulation cue, so drum hits (freq-smooth
    # verticals) can't fake speech pulsing
    from scipy.ndimage import median_filter

    # stationary-noise floor subtraction (round-5): a raised broadband
    # floor (low-SNR clips) fills the syllabic troughs, compressing the
    # log-energy IQR the modulation cue needs — at 5 dB SNR nearly half
    # the speech frames lost their score. Subtracting the per-bin 10th
    # percentile restores the trough depth; the music benchmark is
    # unaffected (held chords are near-stationary, so part of THEIR
    # energy is subtracted too — which only helps).
    floor_spec = np.percentile(spec, 10, axis=0)
    spec_d = np.maximum(spec - floor_spec[None, :], 0.0)

    mag = np.sqrt(spec_d)
    hh = median_filter(mag, size=(tmed, 1), mode="reflect") ** 2
    pp = median_filter(mag, size=(1, fmed), mode="reflect") ** 2
    hmask = hh / (hh + pp + 1e-12)
    log_he = 10 * np.log10((spec_d * hmask).sum(1) + 1e-12)

    # 12-bin chroma (100-2000 Hz) for the sustained-tonality penalty
    fsel = (freqs >= 100.0) & (freqs <= 2000.0)
    pc = (np.round(12.0 * np.log2(freqs[fsel] / 440.0)) % 12).astype(int)
    onehot = np.zeros((pc.size, 12))
    onehot[np.arange(pc.size), pc] = 1.0
    chroma = spec[:, fsel] @ onehot
    chroma /= np.linalg.norm(chroma, axis=1, keepdims=True) + 1e-12

    # harmonicity + pitch lag via FFT autocorrelation (unwindowed frames);
    # the same stationary-floor subtraction on the padded power spectrum
    # removes the flat noise term that dilutes the normalized peak at low
    # SNR (round-5, with the spec_d subtraction above)
    fft2 = np.abs(np.fft.rfft(frames, n=2 * window, axis=1)) ** 2
    fft2 = np.maximum(fft2 - np.percentile(fft2, 10, axis=0)[None, :], 0.0)
    ac = np.fft.irfft(fft2, axis=1)[:, :window]
    ac0 = ac[:, 0] + 1e-12
    lag_lo = max(2, int(sr / 350.0))
    lag_hi = min(window - 1, int(sr / 70.0))
    pitch_band = ac[:, lag_lo:lag_hi] / ac0[:, None]
    harm = np.clip(pitch_band.max(1), 0.0, 1.0)
    lag = (pitch_band.argmax(1) + lag_lo).astype(np.float64)

    # context features (±ctx frames ≈ ±0.5 s). The interior (full windows)
    # is vectorized with sliding windows — the per-frame python loop was
    # O(n*ctx) host work, tens of seconds on hour-long clips on a 1-core
    # host; only the 2*ctx boundary frames keep the direct form.
    width = 2 * ctx + 1
    mod = np.zeros(n)
    f0var = np.zeros(n)
    semis = 12.0 * np.log2(lag)
    voiced = harm > 0.5

    def _ctx_features(i: int) -> None:
        lo, hi = max(0, i - ctx), min(n, i + ctx + 1)
        e = log_he[lo:hi]
        mod[i] = np.percentile(e, 75) - np.percentile(e, 25)
        s = semis[lo:hi][voiced[lo:hi]]
        if s.size >= 3:
            f0var[i] = s.std()

    if n >= width:
        from numpy.lib.stride_tricks import sliding_window_view

        ew = sliding_window_view(log_he, width)         # [n-width+1, width]
        q25, q75 = np.percentile(ew, (25, 75), axis=1)
        mod[ctx:n - ctx] = q75 - q25
        sw = sliding_window_view(semis, width)
        vw = sliding_window_view(voiced, width)
        cnt = vw.sum(1)
        safe = np.maximum(cnt, 1)
        mean = (sw * vw).sum(1) / safe
        var = (((sw - mean[:, None]) ** 2) * vw).sum(1) / safe
        f0var[ctx:n - ctx] = np.where(cnt >= 3, np.sqrt(var), 0.0)
        edge_idx = list(range(ctx)) + list(range(n - ctx, n))
    else:
        edge_idx = list(range(n))
    for i in edge_idx:
        _ctx_features(i)
    mod = np.clip(mod / 6.0, 0.0, 1.0)        # 6 dB IQR = full evidence
    f0var = np.clip(f0var / 1.0, 0.0, 1.0)    # 1 semitone std = full

    # sustained-tonality penalty: chroma cosine-stability over ±1 s,
    # active only on confidently-harmonic frames (chords/held notes);
    # 0.90 -> no penalty, 0.98+ -> full penalty
    from scipy.ndimage import uniform_filter1d

    cmean = uniform_filter1d(chroma, size=cwin, axis=0, mode="nearest")
    stab = (chroma * cmean).sum(1) / (
        np.linalg.norm(cmean, axis=1) + 1e-12)
    tonal = np.clip((stab - 0.90) / 0.08, 0.0, 1.0) * harm

    score = (
        1.2 * harm
        + 1.5 * mod
        # f0var weight raised 0.8 -> 1.2 in round 5: pitch-contour
        # variability is the one cue the 5 dB noise floor barely touches
        # (speech 0.96 vs music 0.26 mean at 5 dB), and the sweep showed
        # zero regression on any other benchmark cell
        + 1.2 * f0var
        + 0.6 * snr
        + 0.4 * band
        - 1.6 * tonal
        - 2.0
    )
    # light temporal smoothing so intra-syllable troughs don't chatter
    k = np.array([0.2, 0.6, 1.0, 0.6, 0.2])
    score = np.convolve(score, k / k.sum(), mode="same")
    p = 1.0 / (1.0 + np.exp(-6.0 * score))
    # hard floor: frames at the clip's noise floor are never speech
    p = np.where(log_e - floor < 3.0, np.minimum(p, 0.1), p)
    return p.astype(np.float32)


def speech_timestamps_from_probs(
    probs: np.ndarray,
    wav_len: int,
    sr: int = 16_000,
    window: int = 512,
    threshold: float = 0.5,
    min_speech_duration_ms: float = 250.0,
    min_silence_duration_ms: float = 100.0,
    speech_pad_ms: float = 30.0,
) -> list[dict]:
    """The silero get_speech_timestamps post-processing state machine over a
    per-window probability series: trigger at ``threshold``, release after
    ``min_silence`` below ``threshold - 0.15``, drop short speeches, pad
    segments. Output schema matches run_vad.py's pickles
    ([{"start": sample, "end": sample}, ...])."""
    neg_threshold = max(threshold - 0.15, 0.01)
    min_speech = int(sr * min_speech_duration_ms / 1000)
    min_silence = int(sr * min_silence_duration_ms / 1000)
    pad = int(sr * speech_pad_ms / 1000)

    triggered = False
    temp_end = 0
    current: dict = {}
    speeches: list[dict] = []
    for i, p in enumerate(probs):
        pos = i * window
        if p >= threshold and temp_end:
            temp_end = 0
        if p >= threshold and not triggered:
            triggered = True
            current = {"start": pos}
            continue
        if p < neg_threshold and triggered:
            if not temp_end:
                temp_end = pos
            if pos - temp_end < min_silence:
                continue
            current["end"] = temp_end
            if current["end"] - current["start"] > min_speech:
                speeches.append(current)
            current = {}
            triggered = False
            temp_end = 0
    if triggered and wav_len - current["start"] > min_speech:
        current["end"] = wav_len
        speeches.append(current)
    for i, s in enumerate(speeches):
        if i == 0:
            s["start"] = max(0, s["start"] - pad)
        if i < len(speeches) - 1:
            gap = speeches[i + 1]["start"] - s["end"]
            if gap < 2 * pad:
                s["end"] += gap // 2
                speeches[i + 1]["start"] = max(0, speeches[i + 1]["start"] - gap // 2)
            else:
                s["end"] = min(wav_len, s["end"] + pad)
                speeches[i + 1]["start"] = max(0, speeches[i + 1]["start"] - pad)
        else:
            s["end"] = min(wav_len, s["end"] + pad)
    return speeches


def spectral_vad(
    wav: np.ndarray, sr: int = 16_000, threshold: float = 0.5,
    separate_fusion: bool = False, **kw
) -> list[dict]:
    """Offline silero-equivalent VAD: spectral speech probabilities +
    silero's exact segmentation state machine.

    separate_fusion (round-5): ALSO score the HPSS vocal estimate
    (pipeline/separate.py) and take the per-frame MAX of the two
    probability series before segmentation. Separation suppresses
    accompaniment 18-25 dB but distorts the voice (its own VAD recall
    suffers); the raw mix keeps the voice intact but the music pollutes
    it — the max combines both detectors' recall at near-zero
    false-positive cost (music FPs are the max of two ~0 values).
    Measured on the speech-over-music benchmark: frame F1 at 10/5 dB
    0.80/0.70 (raw) and 0.94/0.75 (separate-then-VAD, the reference's
    own chain) -> **0.97/0.86** fused (exp_separation_quality.py; the
    recommended mode when accompaniment is expected). Costs a second
    scoring pass + one HPSS, host-side."""
    window = 512 if sr == 16_000 else max(256, int(sr * 0.032))
    probs = vad_speech_probs(wav, sr, window)
    if separate_fusion:
        from avcer_tpu_torch.pipeline.separate import hpss_vocals

        sep = np.asarray(hpss_vocals(wav, sr), np.float32)[: len(wav)]
        p2 = vad_speech_probs(sep, sr, window)
        k = min(len(probs), len(p2))
        probs = np.concatenate([np.maximum(probs[:k], p2[:k]), probs[k:]])
    return speech_timestamps_from_probs(
        probs, len(wav), sr, window, threshold=threshold, **kw
    )


def silero_vad(wav: np.ndarray, sr: int = 16_000) -> list[dict]:
    """silero VAD if the hub cache is present (run_vad.py:8-34); falls back
    to the spectral silero-equivalent otherwise."""
    try:
        import torch

        model, utils = torch.hub.load(
            "snakers4/silero-vad", "silero_vad", trust_repo=True,
            skip_validation=True,
        )
        (get_speech_timestamps, *_rest) = utils
        return get_speech_timestamps(torch.from_numpy(wav), model, sampling_rate=sr)
    except Exception:
        return spectral_vad(wav, sr)


def build_vad_pickle(wav_dir: str, out_path: str, sr: int = 16_000,
                     separate_fusion: bool = False) -> str:
    """Per-file speech-timestamp pickle, the artifact MELD training consumes
    (run_vad.py output; meld_dataset.py:119-123 input). separate_fusion
    forces the spectral VAD's raw+separated max-fusion mode — the
    recommended setting when the wavs contain musical accompaniment
    (see spectral_vad)."""
    from avcer_tpu_torch.pipeline.media import read_wav

    info = {}
    for name in sorted(os.listdir(wav_dir)):
        if not name.endswith(".wav"):
            continue
        data, file_sr = read_wav(os.path.join(wav_dir, name))
        mono = data.mean(0) if data.shape[0] > 1 else data[0]
        info[name] = (
            spectral_vad(mono, file_sr, separate_fusion=True)
            if separate_fusion else silero_vad(mono, file_sr)
        )
    with open(out_path, "wb") as fh:
        pickle.dump(info, fh)
    return out_path


# ---------------------------------------------------------------------------
# Mouth-open features
# ---------------------------------------------------------------------------


def mouth_open_from_areas(
    areas: np.ndarray, window: int = 30
) -> np.ndarray:
    """Rolling(30).mean > global mean thresholding
    (run_open_mouth_features_extraction.py:120-125). ``areas`` is the
    per-frame lip surface-area series (NaN where no face). The first
    ``window - 1`` flags are 0 — the reference's rolling mean uses the
    default min_periods=window, leaving them NaN."""
    import pandas as pd

    s = pd.Series(areas)
    rolled = s.rolling(window).mean()
    return (rolled > np.nanmean(areas)).astype(int).values


def lip_area_from_crop(crop_bgr: np.ndarray) -> float:
    """Mouth-openness proxy from a face crop's pixels.

    The reference measures the mediapipe FaceMesh inner-lip band area
    (run_open_mouth_features_extraction.py:22-73); mediapipe is not a
    dependency and no trained landmark model is available, so this proxy
    measures the dark inter-lip cavity instead, within the canonical mouth
    region of a face crop (x 0.2-0.8 w, y 0.55-0.95 h). Round-4 hardening
    (driven by the adversarial-appearance study, PARITY.md):

    1. **illumination flattening**: the grayscale region is divided by its
       own large-kernel box blur before thresholding, so a lateral shadow
       ramp (which pushed half the raw region under a global mean-std
       threshold — flag agreement collapsed to 0.02) cancels out;
    2. **distance-weighted component score** instead of raw dark-pixel
       fraction: the dark mask is split into connected components, each
       scored area_fraction * exp(-3 * centroid_distance / region_diag),
       and the MAX component score is returned — so a component only wins
       if its area outweighs the exponential penalty for sitting off the
       mouth center. Beard stubble (scattered speckle) and moustache bands
       (top edge of the region) no longer flood the measure the way they
       flooded the raw fraction (mean agreement 0.64, min 0.03); a large
       off-center dark region can still outscore a tiny centered cavity,
       which the adversarial-appearance study shows is the right tradeoff
       (a genuinely open mouth is never a tiny blob).

    An open mouth exposes the oral cavity (one large centered dark blob);
    a closed mouth shows only the thin lip line. The scalar is a
    distance-discounted area fraction in [0, 1] — scale-invariant like
    the reference's normalized-coordinate areas (NOT a plain region
    fraction: the exponential discount rescales it) — and is consumed by
    the SAME rolling-mean thresholding (``mouth_open_from_areas``), which
    only compares the series against its own mean, so the scale change is
    immaterial."""
    import cv2

    h, w = crop_bgr.shape[:2]
    if h < 8 or w < 8:
        return float("nan")
    region = crop_bgr[int(0.55 * h) : int(0.95 * h), int(0.2 * w) : int(0.8 * w)]
    gray = region.astype(np.float32).mean(-1)
    rh, rw = gray.shape
    # illumination flattening: divide by the local mean at ~half-region
    # scale; a smooth shadow gradient divides out, the cavity (small
    # relative to the kernel) survives
    k = max(3, (max(rh, rw) // 2) | 1)
    illum = cv2.blur(gray, (k, k))
    flat = gray / np.maximum(illum, 1e-3)
    thresh = flat.mean() - flat.std()
    dark = (flat < thresh).astype(np.uint8)
    if not dark.any():
        return 0.0
    n_comp, labels, stats, centroids = cv2.connectedComponentsWithStats(dark)
    if n_comp <= 1:
        return 0.0
    # mouth center in region coordinates: x center, y at the lip line
    # (0.76 of the crop -> (0.76-0.55)/0.40 of the region)
    cx, cy = rw / 2.0, rh * 0.525
    diag = float(np.hypot(rh, rw))
    best = 0.0
    for i in range(1, n_comp):
        area = stats[i, cv2.CC_STAT_AREA] / float(rh * rw)
        dist = float(np.hypot(centroids[i][0] - cx, centroids[i][1] - cy))
        score = area * float(np.exp(-3.0 * dist / diag))
        best = max(best, score)
    return best


def extract_surface_area(
    path_to_images: str,
    path_to_landmarks: str,
    speaker_id: int = 0,
    area_fn: Optional[Callable[[np.ndarray], float]] = None,
) -> list[str]:
    """Per-video mouth-open CSVs from face-crop folders — the
    run_open_mouth_features_extraction.py:76-130 walk: for each
    ``<images>/<folder>/<speaker_id:02d>/*.jpg`` compute a per-frame lip
    area, threshold with rolling(30).mean > mean, write
    ``<out>/<folder>.csv`` with columns [frame, surface_area_mouth,
    mouth_open] (index written, like the reference)."""
    import glob

    import cv2
    import pandas as pd

    fn = area_fn or lip_area_from_crop
    written: list[str] = []
    os.makedirs(path_to_landmarks, exist_ok=True)
    for folder in sorted(os.listdir(path_to_images)):
        rows = []
        pattern = os.path.join(
            path_to_images, folder, str(speaker_id).zfill(2), "*.jpg"
        )
        for file in sorted(glob.glob(pattern)):
            image = cv2.imread(file)
            if image is None:
                continue
            area = fn(image)
            if np.isnan(area):  # no face / unusable crop -> skipped row
                continue
            rows.append([os.path.basename(file).split(".")[0], area])
        if not rows:
            continue
        df = pd.DataFrame(rows, columns=["frame", "surface_area_mouth"])
        df["mouth_open"] = mouth_open_from_areas(
            df["surface_area_mouth"].values
        )
        out = os.path.join(path_to_landmarks, folder + ".csv")
        df.to_csv(out, index=True)
        written.append(out)
    return written


def mouth_open_csv(
    areas: np.ndarray, out_path: str
) -> str:
    """Write the per-video CSV schema the ABAW dataset joins on
    (abaw_expr_dataset.py:240-247: columns feat_id, frame, surface_area_mouth,
    mouth_open; frame ids 1-based)."""
    import pandas as pd

    flags = mouth_open_from_areas(areas)
    df = pd.DataFrame(
        {
            "feat_id": np.arange(len(areas)),
            "frame": np.arange(1, len(areas) + 1),
            "surface_area_mouth": areas,
            "mouth_open": flags,
        }
    )
    df.to_csv(out_path, index=False)
    return out_path
