"""Checks a checkpoint release end to end (avcer_tpu/cli/convert_verify.py),
with the JAX module's flags and report keys.

Pointed at a ``weights_dir`` laid out like the reference's release (the
names of ``core.checkpoint.TORCH_FILES``), for each family found:

1. the release file is read and mapped to the port's names
   (``core.convert.release_state_dict``), and its parameters accounted for:
   every scalar of the port's state dict (parameters and BatchNorm running
   statistics) traced back to a scalar of the file;
2. the structure: every tensor the port's module holds is present with its
   shape, and nothing else (the module built on the meta device, no memory);
3. activation parity against the reference's own torch classes when a
   reference source tree is given (``--reference_src``, else probed at
   ``/root/reference/src``): one probe input through both, the largest
   absolute difference of the outputs under the family's f32 tolerance.

There is no conversion cache: the port reads the release files directly, so
``--no_cache`` is accepted and nothing is cached either way (the report's
``cache`` says so). Then, optionally:

4. ``--calib_video``: int8 activation scales recorded on representative
   clips (the detector on their frames, the emotion CNN on the crops it
   detects, the audio model on their wav sidecars) and written as the port's
   sidecars (``core.checkpoint.save_act_scales``), which every later int8
   build from this ``weights_dir`` adopts;
5. ``--golden``: the whole pipeline on a synthetic clip (``make_clip``) with
   the release's weights, its artifact set and finite outputs asserted.

Usage::

    python -m avcer_tpu_torch.cli.convert_verify --weights_dir weights/ \\
        [--reference_src /path/to/AVCER/src] [--calib_video clip.avi] [--golden] \\
        [--device cuda]

The exit code is 1 when a family's status starts with ``FAIL``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import Any, Callable, Optional

import numpy as np
import torch

FAMILIES = ("emotion_resnet50", "temporal_lstm", "retinaface", "expr_model_8cl", "expr_model_7cl")
REFERENCE_SRC = "/root/reference/src"
#: probe tolerances, the JAX module's: f32 activation parity with the reference
ATOL = {"emotion_resnet50": 1e-3, "temporal_lstm": 1e-4, "retinaface": 2e-3,
        "expr_model_8cl": 2e-3, "expr_model_7cl": 2e-3}
NO_CACHE = "none: the port reads the release files directly, no converted cache is written"


def _torch_param_count(sd: dict, family: str) -> int:
    """Scalars of the release file that the port is expected to carry (the
    JAX module's rule: step counters, the unused masked_spec_embed and
    position_ids buffers, the sinusoid buffer and the declared-but-unused
    feed-forward LayerNorm do not; a weight-norm gain merges into its
    direction)."""
    skip = ("num_batches_tracked", "masked_spec_embed", "position_ids",
            "positional_encoding.pe", "feed_forward.layer_norm")
    skip_exact = {k for k in sd
                  if (k.endswith("parametrizations.weight.original0")
                      and k[: -len("original0")] + "original1" in sd)
                  or (k.endswith("weight_g") and k[: -len("weight_g")] + "weight_v" in sd)}
    return int(sum(int(np.prod(tuple(v.shape))) for k, v in sd.items()
                   if not any(s in k for s in skip) and k not in skip_exact))


def _count_params(sd: dict) -> int:
    return int(sum(v.numel() for k, v in sd.items() if not k.endswith("num_batches_tracked")))


def _expr_layers(sd: dict) -> int:
    return 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("wav2vec2.encoder.layers."))


def _backbone(sd: dict) -> str:
    return "resnet50" if any(k.startswith(("body.layer4", "module.body.layer4")) for k in sd) \
        else "mobilenet0.25"


def _port_model(family: str, sd: dict) -> torch.nn.Module:
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
    from avcer_tpu_torch.models.retinaface import RetinaFace
    from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    if family == "emotion_resnet50":
        return EmotionResNet50(7)
    if family == "temporal_lstm":
        return TemporalLSTM(7)
    if family == "retinaface":
        return RetinaFace(backbone=_backbone(sd))
    return ExprModel("v3" if family.endswith("8cl") else "v2",
                     8 if family.endswith("8cl") else 7,
                     Wav2Vec2Config(num_layers=_expr_layers(sd)))


def _convert(family: str, sd: dict) -> dict:
    from avcer_tpu_torch.core import convert

    key = "expr_model" if family.startswith("expr_model") else family
    return convert.release_state_dict(key, sd, num_layers=_expr_layers(sd)
                                      if key == "expr_model" else 12)


def _structure_check(family: str, sd: dict, converted: dict) -> list[str]:
    """The converted state dict against the port's module built on the meta
    device: what the module holds and the dict lacks (a dropped tensor), what
    the dict holds and the module does not, and shapes that differ."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in _port_model(family, sd).state_dict().items()}
    got = {k: tuple(v.shape) for k, v in converted.items()}
    problems = [f"missing {k} {want[k]}" for k in sorted(set(want) - set(got))]
    problems += [f"unexpected {k} {got[k]}" for k in sorted(set(got) - set(want))]
    problems += [f"shape {k}: converted {got[k]} != model {want[k]}"
                 for k in sorted(set(want) & set(got)) if want[k] != got[k]]
    return problems


def _add_reference_paths(reference_src: str) -> None:
    for p in (reference_src, os.path.join(reference_src, "data", "face_detection")):
        if os.path.isdir(p) and p not in sys.path:
            sys.path.insert(0, p)


def _probe_parity(family: str, sd: dict, converted: dict, reference_src: str,
                  device: str) -> dict:
    """One probe through the reference's own torch class (on the CPU) and the
    port's model (on ``device``, f32); ``{max_abs_diff, atol, status}``, or
    ``status='skipped (...)'`` where the class cannot be imported."""
    _add_reference_paths(reference_src)
    rng = np.random.default_rng(0)
    try:
        if family == "emotion_resnet50":
            from architectures.video import ResNet50  # type: ignore

            real = ResNet50(num_classes=7, channels=3)
            x = rng.normal(size=(2, 3, 224, 224)).astype(np.float32) * 60
        elif family == "temporal_lstm":
            from architectures.video import LSTMPyTorch  # type: ignore

            real = LSTMPyTorch()
            x = rng.normal(size=(2, 10, 512)).astype(np.float32)
        elif family == "retinaface":
            from ibug.face_detection.retina_face import config as ref_cfg  # type: ignore
            from ibug.face_detection.retina_face.retina_face import (  # type: ignore
                RetinaFace as TorchRF)

            real = TorchRF(cfg=ref_cfg.cfg_re50 if _backbone(sd) == "resnet50"
                           else ref_cfg.cfg_mnet, phase="test")
            sd = {k.removeprefix("module."): v for k, v in sd.items()}
            x = rng.normal(size=(1, 3, 96, 80)).astype(np.float32) * 20
        else:
            if family.endswith("8cl"):
                import architectures.audio_8_cl as mod  # type: ignore
            else:
                import architectures.audio_7_cl as mod  # type: ignore
            from transformers import Wav2Vec2Config as HFConfig

            hidden = int(sd["wav2vec2.encoder.layers.0.attention.q_proj.weight"].shape[0])
            hf_cfg = HFConfig(
                hidden_size=hidden, num_hidden_layers=_expr_layers(sd), num_attention_heads=16,
                intermediate_size=4 * hidden, do_stable_layer_norm=True,
                feat_extract_norm="layer",
                conv_bias="wav2vec2.feature_extractor.conv_layers.0.conv.bias" in sd,
                apply_spec_augment=False, layerdrop=0.0)
            real = (mod.ExprModelV3 if family.endswith("8cl") else mod.ExprModelV2)(hf_cfg)
            x = rng.normal(size=(1, 17000)).astype(np.float32)
    except ImportError as e:
        return {"status": f"skipped ({e.name or e} not importable)"}
    try:
        real.eval().load_state_dict(sd)
        with torch.no_grad():
            want = real(torch.from_numpy(x))
            want = (want[0] if family == "retinaface" else want).float().numpy()
            model = _port_model(family, sd).eval()
            model.load_state_dict(converted, strict=True)
            model = model.to(device)
            if family == "retinaface":  # the port's detector takes NHWC
                got = model(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(device))[0]
            elif family == "emotion_resnet50":
                got = model(torch.from_numpy(x.transpose(0, 2, 3, 1)).to(device))[0]
            else:
                got = model(torch.from_numpy(x).to(device))
    except Exception as e:  # noqa: BLE001 - a load mismatch is the report's FAIL
        return {"status": f"FAIL ({type(e).__name__}: {e})"}
    diff = float(np.max(np.abs(got.float().cpu().numpy() - want)))
    return {"max_abs_diff": diff, "atol": ATOL[family],
            "status": "ok" if diff < ATOL[family] else "FAIL"}


def verify_weights_dir(weights_dir: str, reference_src: Optional[str] = None,
                       families: Optional[list[str]] = None, cache: bool = True,
                       progress: Callable[[str], None] = print, device: str = "cuda") -> dict:
    """Load, account, check the structure and (with ``reference_src``) the
    activations of each family on ``device`` (the card unless the caller asks
    for the CPU; "cuda" raises without one, as the CLI does); returns the
    report (what the CLI prints). ``cache`` is the JAX signature's: nothing
    is cached either way."""
    from avcer_tpu_torch.core import checkpoint

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")

    report: dict[str, Any] = {"weights_dir": os.path.abspath(weights_dir), "cache": NO_CACHE}
    for family in families or FAMILIES:
        rec: dict[str, Any] = {}
        report[family] = rec
        path = os.path.join(weights_dir, checkpoint.TORCH_FILES[family])
        if not os.path.exists(path):
            rec["status"] = "missing"
            progress(f"{family}: {path} missing — skipped")
            continue
        sd = checkpoint.load_torch_state_dict(path)
        try:
            converted = _convert(family, sd)
        except Exception as e:  # noqa: BLE001 - an unreadable release is the report's FAIL
            rec["status"] = f"FAIL (conversion: {type(e).__name__}: {e})"
            progress(f"{family}: {rec['status']}")
            continue
        rec["torch_scalars"] = _torch_param_count(sd, family)
        rec["converted_scalars"] = _count_params(converted)
        if rec["converted_scalars"] != rec["torch_scalars"]:
            rec["status"] = "FAIL (parameter accounting mismatch)"
            progress(f"{family}: converted {rec['converted_scalars']} scalars from "
                     f"{rec['torch_scalars']} — a layer was dropped or duplicated")
            continue
        problems = _structure_check(family, sd, converted)
        if problems:
            rec["structure"] = problems
            rec["status"] = "FAIL (structure mismatch)"
            progress(f"{family}: structure mismatch: {'; '.join(problems[:5])}")
            continue
        if reference_src:
            rec["parity"] = _probe_parity(family, sd, converted, reference_src, device)
            progress(f"{family}: parity {rec['parity']}")
            if rec["parity"]["status"].startswith("FAIL"):
                rec["status"] = "FAIL (activation parity)"
                continue
        rec["status"] = "ok"
        progress(f"{family}: ok ({rec['converted_scalars']} scalars)")
    return report


def _read_frames(path: str, n: int = 32) -> list[np.ndarray]:
    """Up to ``n`` frames spread over the clip (every len/16-th)."""
    import cv2

    cap = cv2.VideoCapture(path)
    every = max(1, int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) // 16)
    frames, i = [], 0
    while len(frames) < n:
        ok, frame = cap.read()
        if not ok:
            break
        if i % every == 0:
            frames.append(frame)
        i += 1
    cap.release()
    return frames


def run_calibration(weights_dir: str, calib_videos: list[str], progress=print, base_cfg=None,
                    wav2vec2_config=None, device: str = "cuda") -> dict:
    """int8 scales from representative clips (the detector on their frames,
    the emotion CNN on the top kept box of each frame, cropped as served, the
    audio model on up to 16 full windows of each clip's audio), persisted as
    ``<weights_dir>/torch/<family>_act_scales.pt``."""
    from avcer_tpu_torch.core import checkpoint
    from avcer_tpu_torch.core.config import PipelineConfig
    from avcer_tpu_torch.models import layers
    from avcer_tpu_torch.ops.image import clamp_boxes_valid
    from avcer_tpu_torch.pipeline import media
    from avcer_tpu_torch.pipeline.audio_stage import make_windows
    from avcer_tpu_torch.pipeline.builder import build_pipeline

    cfg = base_cfg if base_cfg is not None else PipelineConfig()
    cfg = dataclasses.replace(
        cfg, weights_dir=weights_dir,
        detector=dataclasses.replace(cfg.detector, quant="int8"),
        visual=dataclasses.replace(cfg.visual, quant="int8"),
        audio=dataclasses.replace(cfg.audio, quant="int8"))
    pipe = build_pipeline(cfg, wav2vec2_config=wav2vec2_config, device=device)
    n_frames = n_crops = n_windows = 0
    for path in calib_videos:
        frames = _read_frames(path)
        if frames:
            batch = np.stack(frames)
            prepped, _ = pipe.detect.prepare_batch(batch)
            pipe.detect.calibrate(prepped.cpu().numpy())
            n_frames += len(frames)
            packed, dscale, _ = pipe.detect.dispatch(batch)
            det = pipe.detect.unpack(packed.float().cpu().numpy(), dscale)
            crops = []
            for fi, frame in enumerate(frames):
                scores = np.where(det.keep[fi], det.scores[fi], -np.inf)
                if not np.isfinite(scores).any():
                    continue
                b, valid = clamp_boxes_valid(det.boxes[fi][int(np.argmax(scores))][None],
                                             frame.shape[1], frame.shape[0])
                if not valid[0]:
                    continue
                x1, y1, x2, y2 = b[0]
                crops.append(media.resize_nearest_np(frame[y1:y2, x1:x2], (224, 224)))
            if crops:
                pipe.visual.calibrate(np.stack(crops))
                n_crops += len(crops)
        try:
            wav = media.extract_audio(path, cfg.audio.sample_rate)
        except Exception:  # noqa: BLE001 - a clip without audio calibrates no audio
            wav = None
        if wav is not None and np.size(wav):
            wav = np.asarray(wav, np.float32).reshape(-1)
            win = pipe.audio.window
            spans = [(s, e) for s, e in make_windows(len(wav), cfg.audio, 25.0).spans
                     if e - s == win][:16]
            windows = (np.stack([wav[s:e] for s, e in spans]) if spans
                       else np.pad(wav[:win], (0, max(0, win - len(wav))))[None])
            pipe.audio.calibrate(windows)
            n_windows += len(windows)
    if n_frames == 0 and n_windows == 0:
        return {"status": "no frames decoded"}
    persisted = []
    for model, family in ((pipe.detect.model, checkpoint.detector_family(cfg.detector.backbone)),
                          (pipe.visual.static_model, "emotion_resnet50"),
                          (pipe.audio.model, checkpoint.audio_family(cfg.audio.num_classes))):
        scales = layers.act_scales(model)
        if scales:
            checkpoint.save_act_scales(weights_dir, family, scales)
            persisted.append(family)
    progress(f"calibrated act_scales on {n_frames} frames / {n_crops} crops / {n_windows} "
             f"audio windows; persisted sidecars: {persisted}")
    return {"status": "ok", "frames": n_frames, "crops": n_crops, "audio_windows": n_windows,
            "persisted": persisted}


def make_clip(video_path: str, wav_path: str, seconds: float = 2.0, fps: int = 25,
              size: tuple[int, int] = (640, 360), seed: int = 0) -> None:
    """A synthetic clip (MJPG ``.avi``): a random base frame with a bright
    square moving across it, and a 16 kHz noise wav beside it."""
    import cv2

    from avcer_tpu_torch.pipeline import media

    w, h = size
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
    side = min(120, h // 2, w // 2)
    out = cv2.VideoWriter(video_path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for i in range(int(seconds * fps)):
        frame = base.copy()
        x0, y0 = (i * 7) % (w - side), (i * 3) % (h - side)
        frame[y0:y0 + side, x0:x0 + side] = rng.integers(100, 255, (side, side, 3), np.uint8)
        out.write(frame)
    out.release()
    media.write_wav(wav_path, (rng.normal(size=int(seconds * 16000)) * 0.1).astype(np.float32),
                    16000)


def _golden_e2e(weights_dir: str, device: str = "cuda", base_cfg=None,
                wav2vec2_config=None) -> dict:
    from avcer_tpu_torch.core.config import PipelineConfig
    from avcer_tpu_torch.pipeline.builder import build_pipeline

    with tempfile.TemporaryDirectory() as td:
        video = os.path.join(td, "golden.avi")
        make_clip(video, os.path.join(td, "golden.wav"), seconds=2)
        cfg = dataclasses.replace(base_cfg if base_cfg is not None else PipelineConfig(),
                                  weights_dir=weights_dir)
        pipe = build_pipeline(cfg, wav2vec2_config=wav2vec2_config, device=device)
        clip = pipe.run(video)
        out = os.path.join(td, "out")
        pipe.save_outputs(clip, out)
        artifacts = sorted(os.listdir(out))
        finite = bool(np.isfinite(clip.stat_probs).all()
                      and np.isfinite(clip.audio_window_logits).all())
        return {"status": "ok" if finite else "FAIL (non-finite outputs)",
                "artifacts": artifacts}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="validate a checkpoint release")
    p.add_argument("--weights_dir", required=True)
    p.add_argument("--reference_src", default=None,
                   help="the reference repo's src/ for activation parity against the original "
                        f"torch classes (probed at {REFERENCE_SRC})")
    p.add_argument("--families", nargs="*", default=None)
    p.add_argument("--no_cache", action="store_true",
                   help="accepted for the JAX command line: the port caches nothing")
    p.add_argument("--calib_video", nargs="*", default=None)
    p.add_argument("--golden", action="store_true",
                   help="run the full pipeline on a synthetic clip with the release's weights "
                        "and assert the artifact set")
    p.add_argument("--device", default="cuda",
                   help="torch device of the parity probe, the calibration and the golden run; "
                        "'cuda' raises if CUDA is unavailable")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    ref = a.reference_src
    if ref is None and os.path.isdir(REFERENCE_SRC):
        ref = REFERENCE_SRC
    report = verify_weights_dir(a.weights_dir, reference_src=ref, families=a.families,
                                cache=not a.no_cache, device=a.device)
    if a.calib_video:
        report["calibration"] = run_calibration(a.weights_dir, a.calib_video, device=a.device)
    if a.golden:
        report["golden"] = _golden_e2e(a.weights_dir, device=a.device)
    print(json.dumps(report))
    bad = [k for k, v in report.items()
           if isinstance(v, dict) and str(v.get("status", "")).startswith("FAIL")]
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
