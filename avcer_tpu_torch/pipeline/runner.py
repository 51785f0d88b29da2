"""End-to-end clip inference (avcer_tpu/pipeline/runner.py): detect ->
track -> crop + CNN -> LSTM, with the audio stage on a worker thread, then
fusion and the reference's output tree.

Frames stay on the device from upload to crop: detection of batch N+1 is
enqueued before batch N's result is fetched for the host tracker, and the
crops for the CNN are gathered from the device frame buffer. ``--heatmaps``
fetches the step frames' crops on the side for its Grad-CAM overlays. With
``save_face_crops`` the clip takes the host-crop path instead: every
tracklet's crops are cut from the host frames and written as jpgs, the
reference's ``<save>/<clip>/<tid-1:02d>/<frame:06d>.jpg``, and tracklet 1's,
resized on the host, go to the CNN; it is host-bound by design. The serving
approximations of the presets live here: a detect stride (boxes interpolated
between detections), ``cnn_stride`` (the static CNN on a subset of frames,
the dynamic stream unchanged) and ``run_many`` (clips overlapped). The audio
thread runs on its own CUDA stream; its outputs reach the main thread as
host arrays after a synchronising copy.
"""

from __future__ import annotations

import contextvars
import logging
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.core.config import AudioConfig, PipelineConfig
from avcer_tpu_torch.pipeline.tracker import IoUTracker
from avcer_tpu_torch.fusion import compound as compound_mod
from avcer_tpu_torch.models.audio_heads import ENCODERS
from avcer_tpu_torch.ops import image as image_ops
from avcer_tpu_torch.pipeline import media
from avcer_tpu_torch.pipeline.audio_stage import AudioStage, AudioWindows
from avcer_tpu_torch.pipeline.detect import DetectStage, HostCopy
from avcer_tpu_torch.pipeline.visual import (TemporalPlan, VisualStage, build_temporal_plan,
                                             cnn_compute_sel, subset_forward_fill)
from avcer_tpu_torch.utils import trace

log = logging.getLogger("avcer_tpu_torch")

#: frames held on the device before the tracker's boxes are cropped into the
#: CNN (a chunk is at least one detect batch)
CHUNK_FRAMES = 512


@dataclass
class ClipResult:
    name_video: str
    fps: int
    total_frames: int
    stat_probs: np.ndarray  # [T, 7] video order
    dyn_logits: np.ndarray  # [T, 7] video order
    audio_window_logits: np.ndarray  # [W, C] fusion order
    audio_frame_ids: np.ndarray
    audio_window_of_row: np.ndarray
    compound: Optional[compound_mod.CompoundResult] = None
    timings: dict[str, float] = field(default_factory=dict)
    #: [T, 4] int32, -1 rows where no face; None on the host-crop path
    face_boxes: Optional[np.ndarray] = None

    @property
    def rtf(self) -> float:
        return self.timings["wall"] / (self.total_frames / max(self.fps, 1))


def check_supported(cfg: PipelineConfig) -> None:
    """Raise for configuration that does not exist. Nothing is quietly
    ignored."""
    encoder = getattr(cfg.audio, "encoder", AudioConfig.encoder)  # none in the JAX package's
    unsupported = {
        f"heatmaps={cfg.heatmaps!r} (only '', 'static' and 'dynamic' exist)":
            cfg.heatmaps not in ("", "static", "dynamic"),
        f"visual.quant={cfg.visual.quant!r} (only 'none' and 'int8' exist)":
            cfg.visual.quant not in ("none", "int8"),
        f"audio.encoder={encoder!r} (only {', '.join(ENCODERS)} exist)":
            encoder not in ENCODERS,
        "audio.encoder='wavlm-large' with audio.quant='int8' (WavLM is served in bf16 or f32: "
        "take an unquantised profile, parity or balanced)":
            encoder == "wavlm-large" and cfg.audio.quant == "int8",
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise ValueError("not ported yet: " + "; ".join(bad))


class Pipeline:
    """Holds the three model stages; reusable across clips."""

    def __init__(self, cfg: PipelineConfig, detect: DetectStage, visual: VisualStage,
                 audio: AudioStage, device: torch.device | str = "cuda", mesh=None):
        check_supported(cfg)
        self.cfg = cfg
        #: the data-parallel mesh of the stages (``pipeline.builder``), or None
        self.mesh = mesh
        self.detect = detect
        self.visual = visual
        self.audio = audio
        self.device = torch.device(device)
        # one stream for every clip's audio: the caching allocator reuses
        # memory only on the stream it was allocated on
        self._audio_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                              else None)
        self._save_lock = threading.Lock()  # pyplot state is global

    def _new_tracker(self) -> IoUTracker:
        # detections arrive every stride-th frame: gap mode extrapolates the
        # tracklet's motion across the gap; stride 1 is the reference's tracker
        return IoUTracker(iou_threshold=self.cfg.detector.tracker_iou,
                          minimum_face_size=self.cfg.detector.min_face_size,
                          gap_frames=self.cfg.detector.stride)

    def detect_and_crop(self, reader, save_dir: Optional[str] = None
                        ) -> tuple[np.ndarray, np.ndarray]:
        """The host-crop path (detect stride 1: ``PipelineConfig`` refuses
        ``save_face_crops`` with another): detection batches on the device (two
        in flight), the host tracker, and every tracklet's crop cut from the host
        frame with the reference's int cast and clamp; with ``save_dir`` each
        goes to ``<save_dir>/<clip>/<tid-1:02d>/<frame:06d>.jpg``. Returns
        (present [T] for tracklet 1, its crops [P, 224, 224, 3] uint8 BGR
        resized PIL-nearest on the host, in frame order)."""
        import cv2

        tracker = self._new_tracker()
        meta = reader.meta
        name = os.path.basename(meta.path)
        base = name[: name.rfind(".")] if "." in name else name
        present: list[bool] = []
        crops: list[np.ndarray] = []
        pending: list[tuple[np.ndarray, int, HostCopy, float]] = []

        def drain(frames_np: np.ndarray, n_valid: int, packed: HostCopy, scale: float):
            with trace.span("runner.fetch"):
                packed_np = packed.numpy()
            det = self.detect.unpack(packed_np, scale)
            frame0 = len(present)
            for i in range(n_valid):
                kept = det.keep[i]
                frame_dets = np.concatenate([det.boxes[i][kept], det.scores[i][kept][:, None]],
                                            axis=1)
                tids = tracker(frame_dets)
                cb, cb_ok = image_ops.clamp_boxes_valid(frame_dets, meta.width, meta.height)
                got_target = False
                for j, tid in enumerate(tids):
                    if tid is None or not cb_ok[j]:
                        continue
                    x1, y1, x2, y2 = cb[j]
                    crop = frames_np[i, y1:y2, x1:x2]
                    if save_dir is not None:
                        path = os.path.join(save_dir, base, str(tid - 1).zfill(2))
                        os.makedirs(path, exist_ok=True)
                        cv2.imwrite(os.path.join(path, str(frame0 + i).zfill(6) + ".jpg"), crop)
                    if tid == 1 and not got_target:
                        crops.append(media.resize_nearest_np(crop, (224, 224)))
                        got_target = True
                present.append(got_target)

        for frames_np, n_valid in media.prefetch_iter(reader.batches(self.cfg.detector.batch_size)):
            packed, scale, _ = self.detect.dispatch(frames_np)
            pending.append((frames_np, n_valid, HostCopy(packed), scale))
            if len(pending) > 2:  # keep 2 batches in flight
                drain(*pending.pop(0))
        while pending:
            drain(*pending.pop(0))
        return (np.asarray(present, bool),
                np.stack(crops) if crops else np.zeros((0, 224, 224, 3), np.uint8))

    def detect_track_device(self, reader, crop_step: Optional[int] = None,
                            cnn_step: Optional[int] = None
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray],
                                       np.ndarray]:
        """Detection batches on the device, the host tracker per detected
        frame, the target face (tracklet 1) cropped from the device frame
        buffer into the CNN once per chunk of ``CHUNK_FRAMES`` frames. Returns
        (present [T], stat_probs [P, C], feats [P, 512], step_crops,
        face_boxes [T, 4] int32 native int-cast+clamp coords, -1 rows where no
        face).

        ``crop_step``: also fetch the uint8 224x224 crops of the present
        frames whose index is a multiple of it (the step frames of
        ``build_temporal_plan``), for the heatmaps; ``step_crops`` is None
        without it.

        With ``DetectorConfig.stride`` > 1 the detector ran on every
        stride-th frame; the frames between get the linear interpolation of
        the surrounding detections' boxes (held at a chunk's tail).

        ``cnn_step``: the clip's dynamic step cadence, needed when
        ``VisualConfig.cnn_stride`` != 1: the static CNN then runs only on the
        frames ``visual.cnn_compute_sel`` selects (every cnn_stride-th present
        frame and every step frame) and the frames between hold the last
        computed row, across chunks too (``visual.subset_forward_fill``)."""
        cfg = self.cfg.detector
        if self.cfg.visual.cnn_stride != 1 and not cnn_step:
            raise ValueError(
                f"cnn_stride = {self.cfg.visual.cnn_stride} needs the clip's dynamic step "
                "cadence: pass cnn_step (registry.dynamic_step(fps))")
        tracker = self._new_tracker()
        w_native, h_native = reader.meta.width, reader.meta.height
        present_all: list[bool] = []
        boxes_nat_all: list[np.ndarray] = []
        stat_list, feats_list = [], []
        pending: list[tuple[HostCopy, int, torch.Tensor, float]] = []
        det_boxes_nat: list[Optional[np.ndarray]] = []
        step_crops_list: list[np.ndarray] = []
        drained = 0
        chunk_cap = max(cfg.batch_size, CHUNK_FRAMES)
        stride = cfg.stride
        # cnn_stride 0 aligns the static CNN to the dynamic step cadence
        cs = self.cfg.visual.cnn_stride or int(cnn_step)
        cnn_prev_gid: Optional[int] = None  # last computed frame id
        carry_stat: Optional[np.ndarray] = None
        carry_feat: Optional[np.ndarray] = None

        def drain_one() -> None:
            # pass 1, per detected frame: the tracker is sequential in frame order
            nonlocal drained
            packed, n_valid, _, scale = pending[drained]
            with trace.span("runner.fetch"):  # this batch's copy alone
                packed_np = packed.numpy()
            with trace.span("runner.track"):
                det = self.detect.unpack(packed_np, scale)
                for r in range(det.boxes.shape[0]):
                    if r * stride >= n_valid:
                        break
                    kept = det.keep[r]
                    frame_dets = np.concatenate(
                        [det.boxes[r][kept], det.scores[r][kept][:, None]], axis=1)
                    tbox = None
                    for det_row, tid in zip(frame_dets, tracker(frame_dets)):
                        if tid != 1:
                            continue
                        _, ok = image_ops.clamp_boxes_valid(det_row[None], w_native, h_native)
                        if ok[0]:
                            tbox = det_row[:4].astype(np.float64)
                        break  # tracker ids are unique
                    det_boxes_nat.append(tbox)
            drained += 1

        def flush_chunk() -> None:
            nonlocal pending, det_boxes_nat, drained, cnn_prev_gid, carry_stat, carry_feat
            if not pending:
                return
            while drained < len(pending):
                drain_one()
            with trace.span("runner.chunk"):
                frames_dev = torch.cat([f for _, _, f, _ in pending])
                scale = pending[0][3]
                bsz = pending[0][2].shape[0]
                lb_h, lb_w = frames_dev.shape[1], frames_dev.shape[2]
                # pass 2, per frame, in float64 and in the JAX package's order of
                # operations (the int cast below truncates: equal, not close): its
                # own detection, or between two detections their interpolation
                frame_ids = np.concatenate(
                    [np.arange(n) + bi * bsz for bi, (_, n, _, _) in enumerate(pending)])
                # every batch holds a valid frame, so a detection exists at or
                # before each frame: d indexes it, d1 the next one if there is one
                nd = len(det_boxes_nat)
                ok = np.array([b is not None for b in det_boxes_nat], bool)
                bx = np.stack([b if b is not None else np.zeros(4) for b in det_boxes_nat])
                d = frame_ids // stride
                frac = (frame_ids % stride) / stride
                d1 = np.minimum(d + 1, nd - 1)
                use1 = (frac > 0) & (d + 1 < nd) & ok[d1]
                b1 = np.where(use1[:, None], bx[d1], bx[d])
                box_f = (1 - frac[:, None]) * bx[d] + frac[:, None] * b1
                # the reference's int cast (truncation) + clamp
                bi_, box_ok = image_ops.clamp_boxes_valid(box_f, w_native, h_native)
                present = ok[d] & box_ok
                # clamp in native coordinates, then map into the letterboxed frame
                b = np.round(bi_.astype(np.float64) * scale).astype(np.int32)
                b[:, 0] = np.minimum(b[:, 0], lb_w - 2)
                b[:, 1] = np.minimum(b[:, 1], lb_h - 2)
                b[:, 2] = np.maximum(b[:, 2], b[:, 0] + 1)
                b[:, 3] = np.maximum(b[:, 3], b[:, 1] + 1)
                global_base = len(present_all)
                present_all.extend(present.tolist())
                boxes_nat_all.append(np.where(present[:, None], bi_.astype(np.int32), -1))
                present_idx = frame_ids[present].astype(np.int32)
                boxes_lb = b[present]
            if crop_step:
                gsel = present & ((global_base + frame_ids) % crop_step == 0)
                if gsel.any():
                    step_crops_list.append(self.visual.fetch_crops(frames_dev, frame_ids[gsel],
                                                                   b[gsel]))
            if present_idx.size:
                if cs > 1:
                    # int8: refine the scales on the same leading present
                    # frames as per-frame serving would, before the subset
                    # changes which crops the first forward sees
                    self.visual.ensure_calibrated_from_frames(frames_dev, present_idx, boxes_lb)
                    gids = global_base + present_idx.astype(np.int64)
                    sel, cnn_prev_gid = cnn_compute_sel(gids, int(cnn_step), cs, cnn_prev_gid)
                    if sel.any():
                        stat_c, feats_c = self.visual.run_static_from_frames(
                            frames_dev, present_idx[sel], boxes_lb[sel])
                    else:
                        stat_c = np.zeros((0, self.cfg.visual.num_classes), np.float32)
                        feats_c = np.zeros((0, 512), np.float32)
                    stat, carry_stat = subset_forward_fill(sel, stat_c, carry_stat)
                    feats, carry_feat = subset_forward_fill(sel, feats_c, carry_feat)
                else:
                    stat, feats = self.visual.run_static_from_frames(
                        frames_dev, present_idx, boxes_lb)
                stat_list.append(stat)
                feats_list.append(feats)
            pending, det_boxes_nat, drained = [], [], 0

        # letterbox + wire conversion in the prefetch thread, overlapping the
        # device work of the batches before (cv2 releases the GIL); a detect
        # stage without a host half (a stub) is dispatched whole
        can_prepare_ahead = hasattr(self.detect, "prepare_wire")

        def prepared():
            for frames_np, n_valid in reader.batches(cfg.batch_size):
                if can_prepare_ahead:
                    with trace.span("runner.wire"):  # the prefetch thread's
                        wire, scale = self.detect.prepare_wire(frames_np)
                    yield wire, scale, n_valid, frames_np.shape[0]
                else:
                    yield frames_np, None, n_valid, frames_np.shape[0]

        frames_in_pending = 0
        for wire, scale, n_valid, nbatch in media.prefetch_iter(prepared()):
            if can_prepare_ahead:
                packed, scale, frames_dev = self.detect.dispatch_wire(wire, scale)
            else:
                packed, scale, frames_dev = self.detect.dispatch(wire)
            # the result's copy to the host starts behind the batch's work
            pending.append((HostCopy(packed), n_valid, frames_dev, scale))
            frames_in_pending += nbatch
            while len(pending) - drained > 2:  # keep 2 batches in flight
                drain_one()
            if frames_in_pending >= chunk_cap:
                flush_chunk()
                frames_in_pending = 0
        flush_chunk()

        nc = self.cfg.visual.num_classes
        stat = np.concatenate(stat_list) if stat_list else np.zeros((0, nc), np.float32)
        feats = np.concatenate(feats_list) if feats_list else np.zeros((0, 512), np.float32)
        face_boxes = (np.concatenate(boxes_nat_all) if boxes_nat_all
                      else np.zeros((0, 4), np.int32))
        step_crops = None
        if crop_step:
            step_crops = (np.concatenate(step_crops_list) if step_crops_list
                          else np.zeros((0, 224, 224, 3), np.uint8))
        return np.asarray(present_all, bool), stat, feats, step_crops, face_boxes

    def _audio_task(self, path_video: str, wav: Optional[np.ndarray], fps: float,
                    duration_frames: int
                    ) -> tuple[Optional[np.ndarray], Optional[AudioWindows], float]:
        """Audio half of a clip, on a worker thread with its own CUDA stream
        (wav2vec2 overlaps detect/visual on the card)."""
        with trace.span("audio"):
            t0 = time.perf_counter()
            if wav is None:
                try:
                    wav = media.extract_audio(path_video, self.cfg.audio.sample_rate)
                except (RuntimeError, FileNotFoundError, subprocess.CalledProcessError) as e:
                    log.warning("audio unavailable for %s: %s", path_video, e)
                    if duration_frames <= 0:
                        return None, None, time.perf_counter() - t0
                    wav = np.zeros(int(duration_frames / max(fps, 1)
                                       * self.cfg.audio.sample_rate), np.float32)
            if self._audio_stream is not None:
                self._audio_stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(self._audio_stream):
                    logits, windows = self.audio.run_from_wav(wav, fps)
            else:
                logits, windows = self.audio.run_from_wav(wav, fps)
        trace.count("audio.windows", len(windows.spans))
        return logits, windows, time.perf_counter() - t0

    def run(self, video, path_save: str = "", wav: Optional[np.ndarray] = None) -> ClipResult:
        """``video``: a path (decoded with OpenCV) or a reader with the
        ``VideoReader`` interface (``media.ArrayReader``). Audio comes from
        ``wav`` (mono float32 at the configured rate) or the video's wav
        sidecar. While a profiler records, the clip's spans and counters are
        recorded (``utils.trace``)."""
        with trace.clip():
            return self._run(video, path_save, wav)

    def _run(self, video, path_save: str, wav: Optional[np.ndarray]) -> ClipResult:
        reader = media.VideoReader(video) if isinstance(video, str) else video
        meta = reader.meta
        name_video = os.path.basename(meta.path)
        name_video = name_video[: name_video.rfind(".")] if "." in name_video else name_video
        trace.annotate("clip", video=name_video, frames=meta.total_frames, fps=meta.fps)

        timings: dict[str, float] = {}
        wall0 = time.perf_counter()
        executor = ThreadPoolExecutor(max_workers=1)
        # the worker serves this clip: its spans carry the clip's id
        audio_future = executor.submit(contextvars.copy_context().run, self._audio_task,
                                       meta.path, wav, meta.fps, meta.total_frames)
        executor.shutdown(wait=False)  # the queued task still runs

        t0 = time.perf_counter()
        step = registry.dynamic_step(meta.fps)
        want_heatmaps = bool(self.cfg.heatmaps and path_save)
        crops = step_crops = face_boxes = None
        try:
            if self.cfg.save_face_crops:
                present, crops = self.detect_and_crop(reader, path_save or None)
            else:
                present, stat_probs_p, feats_p, step_crops, face_boxes = self.detect_track_device(
                    reader, crop_step=step if want_heatmaps else None, cnn_step=step)
        finally:
            reader.release()
        total_frames = meta.total_frames or len(present)
        total_frames = min(total_frames, len(present))
        timings["detect"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        if crops is not None:
            stat_probs_p, feats_p = self._static_of_crops(crops, present, step)
        plan = build_temporal_plan(present[:total_frames], step)
        dyn_logits_s = self.visual.run_dynamic(feats_p, plan)
        stat_probs, dyn_logits = self.visual.expand_to_frames(
            stat_probs_p, dyn_logits_s, plan, self.cfg.visual.num_classes)
        timings["visual"] = time.perf_counter() - t0

        if want_heatmaps and plan.step_frames.size:
            t0 = time.perf_counter()
            # host crops span every present frame; the device path fetched
            # the step frames' only, over the whole decode (the plan may be
            # cut to the metadata's frame count)
            self._save_heatmaps(crops if crops is not None else step_crops[:plan.step_frames.size],
                                stat_probs_p, dyn_logits_s, plan, name_video, path_save,
                                crops_are_step_subset=crops is None)
            timings["heatmaps"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        with trace.span("runner.audio_wait"):
            audio_logits, audio_windows, audio_thread_sec = audio_future.result()
        if audio_logits is None:  # the silent track needed the frame count
            silent = np.zeros(
                int(total_frames / max(meta.fps, 1) * self.cfg.audio.sample_rate), np.float32)
            audio_logits, audio_windows = self.audio.run_from_wav(silent, meta.fps)
        timings["audio"] = time.perf_counter() - t0  # wall time added past the overlap
        timings["audio_concurrent"] = audio_thread_sec

        t0 = time.perf_counter()
        with trace.span("fusion"):
            audio_frame_logits = compound_mod.align_audio_to_frames(
                audio_logits, audio_windows.frame_ids, audio_windows.window_of_row, total_frames)
            result = compound_mod.decide(stat_probs, dyn_logits, audio_frame_logits, name_video,
                                         self.cfg.fusion, device=self.device)
        timings["fusion"] = time.perf_counter() - t0
        timings["wall"] = time.perf_counter() - wall0

        clip = ClipResult(
            name_video=name_video, fps=meta.fps, total_frames=total_frames,
            stat_probs=stat_probs, dyn_logits=dyn_logits,
            audio_window_logits=audio_logits,
            audio_frame_ids=audio_windows.frame_ids,
            audio_window_of_row=audio_windows.window_of_row,
            compound=result, timings=timings,
            face_boxes=face_boxes[:total_frames] if face_boxes is not None else None,
        )
        if path_save:
            with trace.span("runner.save"), self._save_lock:
                self.save_outputs(clip, path_save)
        return clip

    def run_many(self, paths: list, path_save: str = "", overlap: int = 2) -> list[ClipResult]:
        """Serve several clips (paths or readers), up to ``overlap`` at a
        time, so that one clip's decoding and host tracking overlap another's
        device work. Per-clip state (tracker, plan, carries) is local to each
        ``run``; the stages are shared. On the card the clips' detect and CNN
        work queues on the one default stream in the order the threads enqueue
        it and every clip's audio on the one audio stream, so each clip's
        results equal those of a run on its own."""
        if overlap <= 1 or len(paths) == 1:
            return [self.run(p, path_save) for p in paths]
        with ThreadPoolExecutor(max_workers=overlap) as ex:
            futures = [ex.submit(self.run, p, path_save) for p in paths]
            return [f.result() for f in futures]

    def _static_of_crops(self, crops: np.ndarray, present: np.ndarray, step: int
                         ) -> tuple[np.ndarray, np.ndarray]:
        """The host-crop path's static CNN: every present frame's crop, or
        under ``cnn_stride`` the selected ones, held over the frames between
        (calibrated first on the same leading crops as per-frame serving)."""
        cs = self.cfg.visual.cnn_stride or step
        if cs <= 1 or not len(crops):
            return self.visual.run_static(crops)
        self.visual.ensure_calibrated_crops(crops)
        sel, _ = cnn_compute_sel(np.flatnonzero(present), step, cs)
        stat_c, feats_c = self.visual.run_static(crops[sel])
        return subset_forward_fill(sel, stat_c, None)[0], subset_forward_fill(sel, feats_c, None)[0]

    def _save_heatmaps(self, crops: np.ndarray, stat_probs_p: np.ndarray,
                       dyn_logits_s: np.ndarray, plan: TemporalPlan, name_video: str,
                       path_save: str, crops_are_step_subset: bool = False) -> None:
        """Grad-CAM overlays of the step frames (get_prob_video.py:131-152)
        as ``<save>/<clip>/heatmaps_<mode>/<frame:06d>.jpg``: the CAM's class
        is the argmax of the static probabilities or of the dynamic logits,
        as ``cfg.heatmaps`` says. ``crops`` are every present frame's, or with
        ``crops_are_step_subset`` the step frames' only; 32 at a time."""
        import cv2

        from avcer_tpu_torch.utils.gradcam import render_heatmap

        mode = self.cfg.heatmaps
        out_dir = os.path.join(path_save, name_video, f"heatmaps_{mode}")
        os.makedirs(out_dir, exist_ok=True)
        step_idx = plan.step_frames  # indices into the present-frame arrays
        classes = (dyn_logits_s.argmax(-1) if mode == "dynamic"
                   else stat_probs_p[step_idx].argmax(-1))
        present_frames = np.flatnonzero(plan.present)
        for s in range(0, len(step_idx), 32):
            idx = step_idx[s:s + 32]
            batch = crops[s:s + len(idx)] if crops_are_step_subset else crops[idx]
            masks = self.visual.gradcam(batch, classes[s:s + len(idx)])
            for j, ci in enumerate(idx):
                overlay = render_heatmap(masks[j], batch[j], use_rgb=False, image_weight=0.8)
                cv2.imwrite(os.path.join(out_dir, f"{present_frames[ci]:06d}.jpg"), overlay)

    def save_outputs(self, clip: ClipResult, path_save: str) -> None:
        """static/dynamic/audio CSVs, the compound txt and the plot, named as
        the reference names them (pandas and matplotlib imported here)."""
        import pandas as pd

        with pd.option_context("mode.string_storage", "python"):
            self._save_outputs_impl(clip, path_save, pd)

    def _save_outputs_impl(self, clip: ClipResult, path_save: str, pd) -> None:
        # python string storage + object-dtype column indexes: an
        # arrow-backed string array built on a worker thread can crash pyarrow
        def cols(names) -> "pd.Index":
            return pd.Index(list(names), dtype=object)

        os.makedirs(path_save, exist_ok=True)
        emo_video = cols(registry.VIDEO_EMOTIONS)
        pd.DataFrame(clip.dyn_logits, columns=emo_video).to_csv(
            os.path.join(path_save, f"dynamic__{clip.name_video}.csv"), index=False)
        pd.DataFrame(clip.stat_probs, columns=emo_video).to_csv(
            os.path.join(path_save, f"static__{clip.name_video}.csv"), index=False)
        # the 7-class front end writes under audio_{padding}_{step}
        # (get_prob_audio_7_cl.py:153)
        acfg = self.cfg.audio
        adf = pd.DataFrame(clip.audio_window_logits[clip.audio_window_of_row],
                           columns=cols(registry.AUDIO_EMOTIONS_8 if acfg.num_classes == 8
                                        else registry.AUDIO_EMOTIONS_7))
        adf["frames"] = [str(i).zfill(6) + ".jpg" for i in clip.audio_frame_ids]
        audio_dir = path_save
        if acfg.num_classes != 8:
            audio_dir = os.path.join(path_save, f"audio_{acfg.padding}_{acfg.step_sec}")
            os.makedirs(audio_dir, exist_ok=True)
        adf.to_csv(os.path.join(audio_dir, f"audio__{clip.name_video}.csv"), index=False)

        fcfg = self.cfg.fusion
        if self.cfg.save_probs and clip.compound is not None:
            ce_dir = os.path.join(path_save, "DF_C_EXPR_DB")
            os.makedirs(ce_dir, exist_ok=True)
            compound_mod.save_compound_txt(
                os.path.join(ce_dir, f"C_EXPR_DB_av_{fcfg.ce_weights_type}_"
                                     f"{fcfg.ce_mask}_{clip.name_video}.txt"),
                clip.compound.image_locations, clip.compound.av)
        if self.cfg.save_plot and clip.compound is not None:
            try:
                import matplotlib  # noqa: F401
            except ImportError:
                # the CSVs and the compound txt are written; only the picture needs it
                log.warning("matplotlib is not installed: the compound-expression plot "
                            "is not written")
                return
            from avcer_tpu_torch.utils import viz

            # "pedicted" typo kept for output-name parity (run.py:286)
            rule = "Rule 2" if fcfg.ce_weights_type else ("Rule 1" if fcfg.ce_mask else "none")
            viz.plot_compound_expression_prediction(
                {"VS": clip.compound.vs, "VD": clip.compound.vd,
                 "A": clip.compound.a, "AV": clip.compound.av},
                save_path=os.path.join(path_save, f"pedicted_CEs_{rule}.jpg"),
                title="Сompound expressions predicted by models",
            )
