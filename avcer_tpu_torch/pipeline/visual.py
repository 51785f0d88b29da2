"""Visual emotion stage (avcer_tpu/pipeline/visual.py): the static CNN over
device-cropped faces, the LSTM over step-frame windows, and the host
temporal plan that reproduces the reference's per-frame loop
(get_prob_video.py:67-204):

- dynamic cadence ``step = round(5 * fps / 25)``; features pushed on step
  frames only; the first step frame after a reset fills the whole window;
- a missing-face frame clears the window but not the last output;
- non-step present frames repeat the last step output (zeros before one);
- missing frames repeat the previous rows once a step output exists.

``VisualConfig.fused`` and ``fused_entries`` are the static model's switches:
``pipeline.builder`` hands them to ``EmotionResNet50``. ``cnn_compute_sel``
and ``subset_forward_fill`` are the host helpers of ``VisualConfig.cnn_stride``
serving (the runner applies them per chunk).

The device path crops from the frame buffer (``run_static_from_frames``);
the host-crop path of ``save_face_crops`` hands in crops made on the host
(``run_static``). ``gradcam`` gives the Grad-CAM masks of ``--heatmaps``,
whose crops the device path fetches with ``fetch_crops``.

int8 (``VisualConfig.quant == "int8"``): the static CNN's activation scales
are seeded at build on two noise crops and refined once per process on the
first real crops (running max); calibration forwards run the unfused int8
modules (``layers.calibrating``). The LSTM stays exact.

Data parallelism (``mesh``): one replica of the static CNN a device of the
data axis (the model itself where a device is named again); each batch of
``batch_size`` crops splits into N equal shards, one a replica, and the
results come back to the first device. ``batch_size`` must divide by N. The
LSTM and the Grad-CAM forward run on the first device; calibrated scales go
to every replica. The builder turns ``fused`` off under a mesh, as the JAX
package does.
"""

from __future__ import annotations

import copy
import threading
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from avcer_tpu_torch.models import layers
from avcer_tpu_torch.ops.image import crop_and_resize, vggface_normalize
from avcer_tpu_torch.parallel.mesh import split_rows
from avcer_tpu_torch.utils import trace
from avcer_tpu_torch.utils.gradcam import gradcam_masks


@dataclass
class TemporalPlan:
    """Host index plan for one clip."""

    present: np.ndarray  # [T] bool
    present_index: np.ndarray  # [T] index into present-frame arrays, -1 if absent
    step_frames: np.ndarray  # [S] present-array indices of step frames
    window_idx: np.ndarray  # [S, 10] indices into the step-feature array
    stat_src: np.ndarray  # [T] present static row, -1 => zeros
    dyn_src: np.ndarray  # [T] step output row, -1 => zeros


def build_temporal_plan(present: np.ndarray, step: int, window: int = 10) -> TemporalPlan:
    t_total = len(present)
    present_index = np.full(t_total, -1, np.int64)
    present_index[present] = np.arange(int(present.sum()))
    step_frames: list[int] = []
    window_rows: list[list[int]] = []
    stat_src = np.full(t_total, -1, np.int64)
    dyn_src = np.full(t_total, -1, np.int64)
    seg_start = 0  # step_frames index where the current reset segment starts
    last_step_out = -1
    last_stat = -1
    for t in range(t_total):
        if present[t]:
            stat_src[t] = present_index[t]
            last_stat = present_index[t]
            if t % step == 0:
                k = len(step_frames)
                window_rows.append([max(seg_start, k - (window - 1) + j) for j in range(window)])
                step_frames.append(present_index[t])
                last_step_out = k
            dyn_src[t] = last_step_out
        else:
            seg_start = len(step_frames)
            if last_step_out >= 0:
                stat_src[t] = last_stat
                dyn_src[t] = last_step_out
            else:
                last_stat = -1
    return TemporalPlan(
        present=present,
        present_index=present_index,
        step_frames=np.asarray(step_frames, np.int64),
        window_idx=np.asarray(window_rows, np.int64).reshape(-1, window),
        stat_src=stat_src,
        dyn_src=dyn_src,
    )


class VisualStage:
    def __init__(self, static_model: torch.nn.Module, lstm_model: torch.nn.Module,
                 num_classes: int = 7, batch_size: int = 256,
                 device: torch.device | str = "cuda", quant: str = "none", mesh=None):
        self.static_model = static_model
        self.lstm_model = lstm_model
        self.num_classes = num_classes
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.mesh = mesh
        #: (device, static model) of each shard of the data axis
        self.replicas = [(self.device, static_model)]
        if mesh is not None:
            if batch_size % mesh.local_data:
                raise ValueError(f"CNN batch {batch_size} does not divide over the data axis "
                                 f"of {mesh.local_data} devices")
            self.replicas = [
                (dev, static_model if dev == self.device else copy.deepcopy(static_model).to(dev))
                for dev in (mesh.row(d)[0] for d in range(mesh.local_data))]
        if quant not in ("none", "int8") or (quant == "int8") != bool(
                getattr(static_model, "quant", False)):
            raise ValueError(f"quant={quant!r} does not fit the static model it was given")
        self.quant = quant
        self._real_calibrated = quant != "int8"
        self._calib_lock = threading.Lock()
        #: calibration forwards made so far (seed and refinement)
        self.calibration_forwards = 0
        if quant == "int8":
            self.calibrate(np.random.default_rng(0).integers(0, 255, (2, 224, 224, 3), np.uint8))

    @torch.inference_mode()
    def _calibrate_device(self, crops: torch.Tensor) -> None:
        with layers.calibrating(self.static_model):
            self.static_model(vggface_normalize(crops))
        self.calibration_forwards += 1
        self._sync_replicas()

    def _sync_replicas(self) -> None:
        """The static model's activation scales into every other replica."""
        scales = layers.act_scales(self.static_model)
        for _, rep in self.replicas:
            if rep is not self.static_model and scales:
                layers.load_act_scales(rep, scales)

    def _static(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The static CNN on a normalised batch: (logits, features), under a
        mesh one shard a replica, gathered on the first device."""
        if len(self.replicas) == 1:
            return self.static_model(x)
        outs = [model(shard.to(dev)) for (dev, model), shard in
                zip(self.replicas, split_rows(x, len(self.replicas), "the CNN batch"))]
        return tuple(torch.cat([o[i].to(self.device) for o in outs]) for i in range(2))

    def calibrate(self, crops: np.ndarray) -> None:
        """Take the running max-abs of every int8 conv's input over ``crops``
        ([N, 224, 224, 3] uint8 BGR) into the static model's activation
        scales (cumulative: scales only grow)."""
        self._calibrate_device(torch.from_numpy(np.ascontiguousarray(crops)).to(self.device))

    def merge_act_scales(self, scales: Mapping[str, torch.Tensor]) -> None:
        """Adopt calibration scales made elsewhere: the elementwise running
        max with the model's own. Raises on a structure mismatch."""
        cur = layers.act_scales(self.static_model)
        if not cur:
            return
        layers.load_act_scales(self.static_model, layers.merge_act_scales_trees(cur, scales))
        self._sync_replicas()
        self._real_calibrated = True

    def ensure_calibrated_crops(self, crops: np.ndarray) -> None:
        """One refinement of the int8 scales on the first real crops (two of
        them, repeated if there is one); nothing once calibrated."""
        if self._real_calibrated or crops.shape[0] == 0:
            return
        with self._calib_lock:
            if not self._real_calibrated:
                self.calibrate(np.resize(crops, (2,) + crops.shape[1:]))
                self._real_calibrated = True

    def ensure_calibrated_from_frames(self, frames_dev: torch.Tensor, present_idx: np.ndarray,
                                      boxes: np.ndarray) -> None:
        """The same refinement from the device frame buffer: the first eight
        present frames' crops (repeated if there are fewer)."""
        p = present_idx.shape[0]
        if self._real_calibrated or p == 0:
            return
        with self._calib_lock:
            if not self._real_calibrated:
                sel = np.resize(np.arange(p), 8)
                idx = torch.from_numpy(present_idx[sel].astype(np.int64)).to(self.device)
                bxs = torch.from_numpy(boxes[sel].astype(np.int64)).to(self.device)
                self._calibrate_device(crop_and_resize(frames_dev, idx, bxs, 224))
                self._real_calibrated = True

    @torch.inference_mode()
    def run_static_from_frames(
        self,
        frames_dev: torch.Tensor,  # [N, H, W, 3] uint8 on the device
        present_idx: np.ndarray,  # [P] frame indices with a target face
        boxes: np.ndarray,  # [P, 4] int crop boxes in frame coordinates
    ) -> tuple[np.ndarray, np.ndarray]:
        """Crop + CNN on the device in sub-batches, one fetch at the end.
        Returns (probs [P, C] softmaxed in f32, features [P, 512]).

        Every sub-batch has exactly ``batch_size`` crops, the last one filled
        up by repeating its last crop, as in the JAX package: a library
        convolution or product may sum in another order at another batch size,
        and with one shape a crop's row does not depend on how many crops its
        chunk holds. ``cnn_stride`` serving rests on that: it computes a subset
        of the crops and its dynamic stream equals per-frame serving's bit for
        bit."""
        p = present_idx.shape[0]
        if p == 0:
            return (np.zeros((0, self.num_classes), np.float32),
                    np.zeros((0, 512), np.float32))
        with trace.span("visual.static"):
            trace.count("visual.crops", p)
            self.ensure_calibrated_from_frames(frames_dev, present_idx, boxes)
            bs = self.batch_size
            fill = (-p) % bs
            idx_all = torch.from_numpy(np.pad(present_idx.astype(np.int64), (0, fill), "edge"))
            boxes_all = torch.from_numpy(np.pad(boxes.astype(np.int64), ((0, fill), (0, 0)),
                                                "edge"))
            with trace.span("visual.upload"):
                idx_all, boxes_all = idx_all.to(self.device), boxes_all.to(self.device)
            out = torch.cat([self.static_batch(frames_dev, idx_all[s:s + bs],
                                               boxes_all[s:s + bs])
                             for s in range(0, p, bs)])[:p]
            with trace.span("visual.fetch"):
                packed = out.cpu().numpy()
        return packed[:, :self.num_classes], packed[:, self.num_classes:]

    def static_batch(self, frames_dev: torch.Tensor, idx: torch.Tensor,
                     boxes: torch.Tensor) -> torch.Tensor:
        """One CNN batch on the device: the crops of frames ``idx`` at
        ``boxes`` (both on the device) -> [N, C + 512] f32, softmaxed
        probabilities then features."""
        logits, feats = self._static(vggface_normalize(crop_and_resize(frames_dev, idx, boxes,
                                                                       224)))
        return torch.cat([torch.softmax(logits.float(), dim=-1), feats.float()], -1)

    @torch.inference_mode()
    def run_static(self, crops: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host crops [P, 224, 224, 3] uint8 BGR -> (probs [P, C], features
        [P, 512]), in batches of exactly ``batch_size`` crops, the last one
        filled up with the last crop (see ``run_static_from_frames``)."""
        p = crops.shape[0]
        if p == 0:
            return (np.zeros((0, self.num_classes), np.float32),
                    np.zeros((0, 512), np.float32))
        self.ensure_calibrated_crops(crops)
        bs = self.batch_size
        filled = np.concatenate([crops, np.repeat(crops[-1:], (-p) % bs, axis=0)])
        outs = []
        for s in range(0, p, bs):
            x = torch.from_numpy(np.ascontiguousarray(filled[s:s + bs])).to(self.device)
            logits, feats = self._static(vggface_normalize(x))
            outs.append(torch.cat([torch.softmax(logits.float(), dim=-1), feats.float()], -1))
        packed = torch.cat(outs)[:p].cpu().numpy()
        return packed[:, :self.num_classes], packed[:, self.num_classes:]

    @torch.inference_mode()
    def fetch_crops(self, frames_dev: torch.Tensor, idx: np.ndarray,
                    boxes: np.ndarray) -> np.ndarray:
        """The uint8 224x224 crops of frames ``idx`` of the device frame
        buffer, as the CNN sees them, fetched to the host: the step frames'
        for the heatmaps, without sending the whole clip down the host-crop
        path."""
        crops = crop_and_resize(frames_dev, torch.from_numpy(idx.astype(np.int64)).to(self.device),
                                torch.from_numpy(boxes.astype(np.int64)).to(self.device), 224)
        return crops.cpu().numpy()

    def gradcam(self, crops: np.ndarray, class_idx: np.ndarray) -> np.ndarray:
        """Grad-CAM masks [B, h4, w4] of crops [B, 224, 224, 3] uint8 BGR for
        the classes ``class_idx`` [B]: layer4's output from one forward of
        the static model (fused: K3's), then ``utils.gradcam.gradcam_masks``
        through the fc head in f32."""
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(crops)).to(self.device)
            _, _, act4 = self.static_model(vggface_normalize(x), return_act4=True)
        masks = gradcam_masks(act4, self.static_model.fc1, self.static_model.fc2, class_idx)
        return masks.cpu().numpy()

    @torch.inference_mode()
    def run_dynamic(self, feats: np.ndarray, plan: TemporalPlan) -> np.ndarray:
        """Step-frame features -> [S, C] raw logits from the LSTM."""
        if plan.step_frames.size == 0:
            return np.zeros((0, self.num_classes), np.float32)
        with trace.span("visual.dynamic"):
            trace.count("visual.lstm_windows", plan.step_frames.size)
            windows = feats[plan.step_frames][plan.window_idx]  # [S, 10, 512]
            x = torch.from_numpy(np.ascontiguousarray(windows, np.float32)).to(self.device)
            return self.lstm_model(x).float().cpu().numpy()

    @staticmethod
    def expand_to_frames(stat_probs: np.ndarray, dyn_logits: np.ndarray,
                         plan: TemporalPlan, num_classes: int = 7
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Per-frame [T, C] static probs and dynamic logits with the
        reference's forward-fill / zeros semantics."""
        t_total = plan.stat_src.shape[0]
        stat = np.zeros((t_total, num_classes), np.float32)
        dyn = np.zeros((t_total, num_classes), np.float32)
        m = plan.stat_src >= 0
        if stat_probs.size:
            stat[m] = stat_probs[plan.stat_src[m]]
        md = plan.dyn_src >= 0
        if dyn_logits.size:
            dyn[md] = dyn_logits[plan.dyn_src[md]]
        return stat, dyn


def cnn_compute_sel(frame_ids: np.ndarray, step: int, cnn_stride: int,
                    prev_gid: int | None = None) -> tuple[np.ndarray, int | None]:
    """Which present frames get a real static-CNN forward under
    ``VisualConfig.cnn_stride``: a frame whose last computed predecessor lies
    at least ``cnn_stride`` frame ids back (greedy in frame-id space, so static
    probabilities are never held longer than ``cnn_stride - 1`` frames however
    sparse the face's presence), and every dynamic step frame (``frame_id %
    step == 0``: the frames that feed the LSTM windows, so the dynamic stream
    is unchanged). ``frame_ids``: [P] global indices of this chunk's present
    frames; ``prev_gid``: the last computed frame id of earlier chunks (None
    at the clip's start, where the first present frame is always selected).
    Returns ([P] bool mask, the new ``prev_gid``)."""
    sel = np.zeros(frame_ids.shape[0], bool)
    last = prev_gid
    for i, g in enumerate(frame_ids.tolist()):
        if last is None or g - last >= cnn_stride or g % step == 0:
            sel[i] = True
            last = g
    return sel, last


def subset_forward_fill(sel: np.ndarray, rows: np.ndarray, carry: np.ndarray | None
                        ) -> tuple[np.ndarray, np.ndarray | None]:
    """Spread ``rows``, computed on the ``sel`` subset, back over the whole
    sequence by holding each row until the next computed one. ``carry`` is the
    previous chunk's last filled row (None before any row exists). Returns
    (filled [P, D] rows, the new carry)."""
    n = sel.shape[0]
    if n == 0:
        return rows[:0], carry
    src = np.cumsum(sel) - 1
    if carry is None and src[0] < 0:
        raise ValueError(
            "subset_forward_fill: leading unselected rows with no carry: select the clip's "
            "first present frame or hand over the previous chunk's carry")
    if rows.shape[0]:
        out = rows[np.maximum(src, 0)].copy()
        if src[0] < 0:
            out[src < 0] = carry
    else:
        out = np.tile(np.asarray(carry)[None], (n, 1))
    return out, out[-1].copy()
