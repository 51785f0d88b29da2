"""The port's preprocessing copies (pipeline/preprocess.py, separate.py,
head_pose.py) against their JAX-package originals on seeded inputs: the
same numpy, scipy and cv2 code, so every comparison is exact (the head-pose
angles too: the same cv2 EPnP on the same inputs)."""

import os
import pickle

import numpy as np
import pandas as pd
import pytest

from avcer_tpu.pipeline import head_pose as jax_head_pose
from avcer_tpu.pipeline import preprocess as jax_pre
from avcer_tpu.pipeline import separate as jax_sep

from avcer_tpu_torch.pipeline import head_pose, preprocess, separate
from avcer_tpu_torch.pipeline.media import read_wav, write_wav

from test_aux import _project_shape
from test_datasets_and_misc import _synthetic_face, _voice_music_mix

SR = 16_000


def speech_like(seed: int, sec: float = 4.0) -> np.ndarray:
    """Silence, modulated harmonic bursts with vibrato and noise: segments
    for the VAD to find, with a noise floor."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sec * SR)) / SR
    f0 = 180 + 20 * np.sin(2 * np.pi * 3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR
    voiced = sum(np.sin(k * phase) / k for k in (1, 2, 3, 4))
    am = 0.55 + 0.45 * np.sin(2 * np.pi * 4 * t)
    gate = ((t > 0.6) & (t < 1.8)) | ((t > 2.4) & (t < 3.3))
    return (0.2 * am * voiced * gate + rng.normal(0, 3e-3, t.size)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_energy_vad_equals_original(seed):
    wav = speech_like(seed)
    got = preprocess.energy_vad(wav, SR)
    assert got == jax_pre.energy_vad(wav, SR) and len(got) >= 1


@pytest.mark.parametrize("seed", [0, 1])
def test_vad_probs_and_segments_equal_original(seed):
    wav = speech_like(seed)
    probs = preprocess.vad_speech_probs(wav, SR)
    np.testing.assert_array_equal(probs, jax_pre.vad_speech_probs(wav, SR))
    kw = dict(threshold=0.4, speech_pad_ms=50.0)
    got = preprocess.speech_timestamps_from_probs(probs, len(wav), SR, 512, **kw)
    assert got == jax_pre.speech_timestamps_from_probs(probs, len(wav), SR, 512, **kw)


@pytest.mark.parametrize("separate_fusion", [False, True])
def test_spectral_vad_equals_original(separate_fusion):
    voice, music = _voice_music_mix(SR, sec=3.0)
    wav = speech_like(2, 3.0) + 0.3 * music
    got = preprocess.spectral_vad(wav, SR, separate_fusion=separate_fusion)
    assert got == jax_pre.spectral_vad(wav, SR, separate_fusion=separate_fusion)
    assert len(got) >= 1


@pytest.mark.parametrize("sr", [16_000, 44_100])
def test_hpss_and_resample_equal_original(sr):
    voice, music = _voice_music_mix(sr, sec=1.5)
    mix = voice + music
    vocals = separate.hpss_vocals(mix, sr)
    np.testing.assert_array_equal(vocals, jax_sep.hpss_vocals(mix, sr))
    np.testing.assert_array_equal(separate.resample(vocals, sr, 16_000),
                                  jax_sep.resample(vocals, sr, 16_000))


def test_hpss_separator_file_equals_original(tmp_path):
    voice, music = _voice_music_mix(44_100, sec=1.0)
    src = str(tmp_path / "mix.wav")
    write_wav(src, voice + music, 44_100)
    got = separate.hpss_separator(src, str(tmp_path / "port.wav"))
    want = jax_sep.hpss_separator(src, str(tmp_path / "jax.wav"))
    (a, sa), (b, sb) = read_wav(got), read_wav(want)
    assert sa == sb == 16_000
    np.testing.assert_array_equal(a, b)
    preprocess._check_durations(src, got)  # must not raise


def test_build_vad_pickle_separate_fusion_equals_original(tmp_path):
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in range(2):
        write_wav(str(wav_dir / f"utt{i}.wav"), speech_like(10 + i, 3.0), SR)
    (wav_dir / "notes.txt").write_text("not a wav")
    got = preprocess.build_vad_pickle(str(wav_dir), str(tmp_path / "port.pkl"),
                                      separate_fusion=True)
    want = jax_pre.build_vad_pickle(str(wav_dir), str(tmp_path / "jax.pkl"),
                                    separate_fusion=True)
    with open(got, "rb") as fa, open(want, "rb") as fb:
        a, b = pickle.load(fa), pickle.load(fb)
    assert a == b and sorted(a) == ["utt0.wav", "utt1.wav"]


@pytest.mark.parametrize("window", [30, 5])
def test_mouth_open_from_areas_equals_original(window):
    areas = np.random.default_rng(3).random(80)
    areas[10] = np.nan
    np.testing.assert_array_equal(preprocess.mouth_open_from_areas(areas, window),
                                  jax_pre.mouth_open_from_areas(areas, window))


def test_lip_area_equals_original():
    rng = np.random.default_rng(4)
    crops = [_synthetic_face(True), _synthetic_face(False), _synthetic_face(True, 64),
             rng.integers(0, 255, (90, 70, 3), dtype=np.uint8), np.zeros((6, 6, 3), np.uint8),
             np.full((40, 40, 3), 128, np.uint8)]
    for crop in crops:
        got, want = preprocess.lip_area_from_crop(crop), jax_pre.lip_area_from_crop(crop)
        assert got == want or (np.isnan(got) and np.isnan(want))
    assert preprocess.lip_area_from_crop(crops[0]) > 2 * preprocess.lip_area_from_crop(crops[1])


def test_extract_surface_area_equals_original(tmp_path):
    import cv2

    for folder, n in (("vid1", 40), ("vid2", 12)):
        d = tmp_path / "faces" / folder / "00"
        d.mkdir(parents=True)
        for i in range(n):
            cv2.imwrite(str(d / f"{i:06d}.jpg"), _synthetic_face(i >= n // 2))
    (tmp_path / "faces" / "vid3" / "01").mkdir(parents=True)  # another speaker only
    got = preprocess.extract_surface_area(str(tmp_path / "faces"), str(tmp_path / "port"))
    want = jax_pre.extract_surface_area(str(tmp_path / "faces"), str(tmp_path / "jax"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "vid1.csv", "vid2.csv"]
    for a, b in zip(got, want):
        assert open(a).read() == open(b).read()


def test_mouth_open_csv_equals_original(tmp_path):
    areas = np.random.default_rng(5).random(50)
    got = preprocess.mouth_open_csv(areas, str(tmp_path / "port.csv"))
    want = jax_pre.mouth_open_csv(areas, str(tmp_path / "jax.csv"))
    assert open(got).read() == open(want).read()
    assert list(pd.read_csv(got).columns) == ["feat_id", "frame", "surface_area_mouth",
                                              "mouth_open"]


def test_convert_video_to_audio_equals_original(tmp_path):
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        pytest.skip("ffmpeg not available")
    sr = 44_100
    voice, music = _voice_music_mix(sr, sec=1.0)
    write_wav(str(tmp_path / "src.wav"), voice + music, sr)
    video = str(tmp_path / "clip.mp4")
    subprocess.run([ffmpeg, "-y", "-f", "lavfi", "-i", "color=c=black:s=64x64:r=5:d=1",
                    "-i", str(tmp_path / "src.wav"), "-shortest", "-c:v", "mjpeg", "-c:a",
                    "aac", video], check=True, capture_output=True)
    for sep in (False, True):
        got = preprocess.convert_video_to_audio(video, str(tmp_path / f"port{sep}.wav"),
                                                vocal_separation=sep)
        want = jax_pre.convert_video_to_audio(video, str(tmp_path / f"jax{sep}.wav"),
                                              vocal_separation=sep)
        np.testing.assert_array_equal(read_wav(got)[0], read_wav(want)[0])


def test_head_pose_equals_original():
    np.testing.assert_array_equal(head_pose.BFM_5PT_SHAPE, jax_head_pose.BFM_5PT_SHAPE)
    np.testing.assert_array_equal(head_pose.GENERIC_5PT_SHAPE, jax_head_pose.GENERIC_5PT_SHAPE)
    ms68 = np.random.default_rng(6).normal(size=(68, 3))
    np.testing.assert_array_equal(head_pose.derive_5pt_shape(ms68),
                                  jax_head_pose.derive_5pt_shape(ms68))
    w, h = 640, 480
    for shape in (None, head_pose.GENERIC_5PT_SHAPE):
        ours = head_pose.HeadPoseEstimator(mean_shape=shape)
        theirs = jax_head_pose.HeadPoseEstimator(mean_shape=shape)
        for euler in [(0, 0, 0), (10, 20, 5), (-15, -25, 10), (25, 5, -20), (0, 40, 0)]:
            proj = _project_shape(head_pose.BFM_5PT_SHAPE, euler, w, h)
            for pref in (0, 1, 2, 3):
                assert ours(proj, w, h, output_preference=pref) == theirs(
                    proj, w, h, output_preference=pref)
    assert head_pose.HeadPoseEstimator()(np.zeros((3, 2)), w, h) is None
    with pytest.raises(ValueError):
        head_pose.HeadPoseEstimator()(np.zeros((5, 2)))
