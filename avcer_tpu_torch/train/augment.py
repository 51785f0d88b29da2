"""Copy of avcer_tpu/train/augment.py (the port imports nothing of the JAX package),
pinned against the original in tests/test_torch_train_data.py.

Waveform augmentations for audio training.

Behavior contract — the reference's src/audio/augmentation/
wave_augmentation.py:8-161 (+ identity_augmentation.py):

- PolarityInversion: flip sign
- WhiteNoise: additive gaussian noise whose std is uniform in
  [min_snr, max_snr] * std(audio) (wave_augmentation.py:49-53)
- Gain: scale by uniform dB in [-20, -1]
- SoxEffect: sox effect chains (wave_augmentation.py:56-81) — reimplemented
  for the verbs that matter without a sox/torchaudio dependency (see
  ``sox_effect``); defined-but-unused by the reference training scripts
  (train_c_audio.py:116 uses only polarity/noise/gain)
- ResampleAudio: sample-rate conversion (wave_augmentation.py:137-161) —
  polyphase resampling here (functionally equivalent; the reference's
  torchaudio sinc interpolation is not bit-identical)
- RandomChoice: apply one randomly chosen augmentation
- Identity: passthrough

Host-side numpy (runs in the loader's prefetch thread); each call takes an
explicit ``np.random.Generator`` for reproducibility.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np

Aug = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def identity(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return wav


def polarity_inversion(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return -wav


def white_noise(
    min_snr: float = 1e-4, max_snr: float = 5e-3
) -> Aug:
    def f(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        std = float(np.std(wav))
        noise_std = rng.uniform(min_snr * std, max_snr * std)
        return wav + noise_std * rng.standard_normal(wav.shape).astype(wav.dtype)

    return f


def gain(min_db: float = -20.0, max_db: float = -1.0) -> Aug:
    def f(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        db = rng.uniform(min_db, max_db)
        return wav * (10.0 ** (db / 20.0))

    return f


def random_choice(augs: Sequence[Aug]) -> Aug:
    def f(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        i = int(rng.integers(0, len(augs)))
        return augs[i](wav, rng)

    return f


def resample(wav: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    """Polyphase sample-rate conversion (ResampleAudio equivalent,
    wave_augmentation.py:137-161). Identity when rates match."""
    if orig_sr == new_sr:
        return wav
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(new_sr))
    return resample_poly(
        wav.astype(np.float64), new_sr // g, orig_sr // g
    ).astype(wav.dtype)


def resample_audio(orig_sr: int = 32_000, new_sr: int = 16_000) -> Aug:
    def f(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        return resample(wav, orig_sr, new_sr)

    return f


def sox_effect(effects: Sequence[Sequence[str]], sr: int = 16_000) -> Aug:
    """SoxEffect equivalent (wave_augmentation.py:56-81) without a sox
    binary: interprets the common effect verbs. Supported: ``gain``/``vol``
    (dB), ``speed`` (rate factor; changes duration), ``rate`` (target sample
    rate, output returned at the original rate contract like sox chains
    ending in ``rate``), ``reverse``, ``norm``. Unsupported verbs raise."""

    def apply_one(wav: np.ndarray, eff: Sequence[str]) -> np.ndarray:
        verb, args = eff[0], [str(a) for a in eff[1:]]
        if verb in ("gain", "vol"):
            db = float(args[0]) if args else 0.0
            return wav * (10.0 ** (db / 20.0))
        if verb == "speed":
            factor = float(args[0]) if args else 1.0
            # sox speed = play faster: resample by 1/factor then treat as sr
            up, down = 1000, int(round(1000 * factor))
            from scipy.signal import resample_poly

            g = math.gcd(up, down)
            return resample_poly(
                wav.astype(np.float64), up // g, down // g
            ).astype(wav.dtype)
        if verb == "rate":
            target = int(float(args[-1]))
            return resample(wav, sr, target)
        if verb == "reverse":
            return wav[::-1].copy()
        if verb == "norm":
            peak = float(np.max(np.abs(wav))) or 1.0
            target_db = float(args[0]) if args else 0.0
            return wav * (10.0 ** (target_db / 20.0) / peak)
        raise NotImplementedError(f"sox effect verb {verb!r} not supported")

    def f(wav: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        for eff in effects:
            wav = apply_one(wav, eff)
        return wav

    return f


def default_train_augmentation() -> Aug:
    """The reference's enabled-augmentation setup (train_c_audio.py:112-121):
    random choice among polarity inversion, white noise, gain."""
    return random_choice([polarity_inversion, white_noise(), gain()])
