"""Face detection stage (avcer_tpu/pipeline/detect.py): letterbox ->
normalise -> RetinaFace -> decode -> top-64 candidates -> greedy NMS, on the
device and batched over frames. Only the tracker stays on the host.

Frames cross to the device in ``DetectorConfig.transfer_format``, as in the
JAX package (``prepare_wire`` on the host, in the runner's prefetch thread,
then ``dispatch_wire``):

- ``"i420"``, the default: the host letterboxes each frame with
  ``cv2.resize(INTER_LINEAR)`` (or pads it to a multiple of 32 where
  ``long_side`` is 0) and converts it to I420 with cv2; the upload carries 1.5
  bytes a pixel and the device rebuilds BGR (``ops.cuda.image_kernel``, the
  CUDA kernel on the card). Detector, calibration and crop stage all read the
  rebuilt frames.
- ``"bgr"``: the native frames are uploaded and letterboxed on the device
  (bilinear, half-pixel centres, rounded to uint8, within 1 LSB of cv2).

Greedy NMS on the card is the CUDA kernel (``ops.cuda.nms_kernel``). The
detector's fused switches (``DetectorConfig.fused_*``) are the model's:
``pipeline.builder`` hands them to ``RetinaFace``, and the stage runs
whichever model it is given: the r50 or the mobilenet0.25 detector.
``DetectorConfig.stride`` runs the network on every stride-th frame of a
batch; the runner interpolates the boxes between.

int8 (``DetectorConfig.quant == "int8"``): the model's static activation
scales are seeded at build on two noise frames, refined once per process on
the first real batch's first two frames, and watched every ``RECALIB_EVERY``
batches (scales only grow; growth above 5 % is logged). Every calibration
forward runs the model's unfused int8 modules (``layers.calibrating``), also
when the stage serves through the fused kernels.

Data parallelism (``mesh``, ``--data_parallel N``): the stage keeps one
replica of the model a device of the mesh's data axis (the model itself where
a device is named again), splits each network batch of frames (the rebuilt
ones under I420) into N equal shards (raising where N does not divide it, as
the JAX package's ``device_put`` onto the sharded batch does), runs each shard
through the whole forward (network, decode, top-K, NMS: K1 at
``[B / N, 64, 4]``) on its device, and gathers the results onto the first
device. The builder turns the fused switches off under a mesh, as the JAX
package does. Calibrated scales go to every replica.

Enqueuing a batch waits for nothing on the card. On the card
``prepare_wire`` returns the wire as a pinned host tensor (the I420 wire
written straight into it), which goes up with ``non_blocking``: PyTorch's
pinned allocator reuses a buffer once the copy's event has passed. The
normalisation mean, the anchors and the decode's scales are kept on the
device per (h, w, device). ``HostCopy`` starts a result's copy back into
pinned memory and waits on that copy's event alone.

Piecewise graphs (``models.piecewise``): the network and the decode of a
batch, on the card, run as captured CUDA graphs between the model's eager
K3 / K4 calls (``retinaface.kernel``), one schedule per key (the model, the
frames' shape and device): a model without those calls is one piece. A key's
first batch on each thread runs eagerly (the warm-up, under the graphs'
lock), the thread's second is captured (never while a profiler records),
later ones replay. The stage stays eager on a CPU
tensor, under a mesh, for a model in ``training`` or ``calibrating``, and
for a key whose capture raised (logged once). The int8 scales and the folds
that hold them change at each calibration forward and ``merge_act_scales``:
every schedule is dropped then, and captured again. The clip counters
``detect.graph_replays``, ``detect.graph_captures`` and ``detect.graph_eager``
count the batches of each route.
"""

from __future__ import annotations

import copy
import logging
import threading
from dataclasses import dataclass
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.core.config import DetectorConfig
from avcer_tpu_torch.models import layers, piecewise
from avcer_tpu_torch.ops import boxes as box_ops
from avcer_tpu_torch.ops import nms as nms_ops
from avcer_tpu_torch.ops.cuda.image_kernel import i420_to_bgr
from avcer_tpu_torch.ops.cuda.nms_kernel import nms_mask
from avcer_tpu_torch.ops.image import (bgr_batch_to_i420, letterbox_params,
                                       resize_bilinear_uint8, retinaface_normalize)
from avcer_tpu_torch.parallel.mesh import split_rows
from avcer_tpu_torch.utils import trace


log = logging.getLogger("avcer_tpu_torch")


@dataclass
class Detections:
    """Fixed-shape per-batch detections (native-resolution pixel coords)."""

    boxes: np.ndarray  # [B, K, 4] float32 xyxy
    scores: np.ndarray  # [B, K]
    keep: np.ndarray  # [B, K] bool
    landmarks: np.ndarray  # [B, K, 10]


class DetectStage:
    #: int8 drift watch: batches between sampled re-calibration forwards
    RECALIB_EVERY = 64
    #: the anchors of a bucket (h, w): [A, 4] normalised (cx, cy, w, h)
    prior_boxes = staticmethod(box_ops.prior_boxes)

    def __init__(self, cfg: DetectorConfig, model: torch.nn.Module,
                 device: torch.device | str = "cuda", mesh=None):
        if cfg.transfer_format not in ("i420", "bgr"):
            raise ValueError(f"transfer_format={cfg.transfer_format!r}: only 'i420' and 'bgr' "
                             "exist")
        if cfg.stride > 1 and cfg.batch_size % cfg.stride:
            raise ValueError(
                f"detector stride {cfg.stride} must divide batch_size {cfg.batch_size} "
                "(keeps the detection cadence uniform across fixed-shape batches)")
        if cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant={cfg.quant!r}: only 'none' and 'int8' exist")
        if cfg.backbone != getattr(model, "backbone", cfg.backbone):
            raise ValueError(f"backbone={cfg.backbone!r} does not fit the model it was given")
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.mesh = mesh
        #: (device, model) of each shard of the data axis
        self.replicas = [(self.device, model)]
        if mesh is not None:
            if cfg.batch_size % mesh.local_data:
                raise ValueError(f"detect batch {cfg.batch_size} does not divide over the data "
                                 f"axis of {mesh.local_data} devices")
            self.replicas = [(dev, model if dev == self.device else copy.deepcopy(model).to(dev))
                             for dev in (mesh.row(d)[0] for d in range(mesh.local_data))]
        self._priors: dict[tuple, torch.Tensor] = {}
        #: (mean, anchors, box scale, landmark scale) on the device by (h, w, device)
        self._consts: dict[tuple, tuple] = {}
        self._graphs = piecewise.Graphs()
        #: bumped where the int8 scales change; the schedules are of one epoch
        self._epoch = 0
        self._graphs_epoch = 0
        self.quant = cfg.quant == "int8"
        if self.quant != bool(getattr(model, "quant", False)):
            raise ValueError(f"quant={cfg.quant!r} does not fit the model it was given")
        self._real_calibrated = False
        self._calib_lock = threading.Lock()
        self._batches_seen = 0
        #: calibration forwards made so far (seed, refinement, drift watch)
        self.calibration_forwards = 0
        if self.quant:
            # static scales: a dynamic scale costs every conv a reduction over
            # its whole input. Noise frames bound the first layers' ranges
            # until the first real batch refines them.
            self.calibrate(np.random.default_rng(0).integers(0, 255, (2, 160, 160, 3), np.uint8))

    @torch.inference_mode()
    def _calibrate_device(self, frames: torch.Tensor) -> None:
        with layers.calibrating(self.model):
            self.model(retinaface_normalize(frames))
        self.calibration_forwards += 1
        self._epoch += 1
        self._sync_replicas()

    def _sync_replicas(self) -> None:
        """The model's activation scales into every other replica."""
        scales = layers.act_scales(self.model)
        for _, rep in self.replicas:
            if rep is not self.model and scales:
                layers.load_act_scales(rep, scales)

    def calibrate(self, frames: np.ndarray) -> None:
        """Take the running max-abs of every int8 conv's input over ``frames``
        ([N, H, W, 3] uint8 BGR) into the model's activation scales. One
        unfused forward; scales only grow, so calling again is cumulative."""
        self._calibrate_device(torch.from_numpy(np.ascontiguousarray(frames)).to(self.device))

    def merge_act_scales(self, scales: Mapping[str, torch.Tensor]) -> None:
        """Adopt calibration scales made elsewhere: the elementwise running
        max with the model's own. Raises on a structure mismatch."""
        cur = layers.act_scales(self.model)
        if not cur:
            return
        layers.load_act_scales(self.model, layers.merge_act_scales_trees(cur, scales))
        self._epoch += 1
        self._sync_replicas()
        self._real_calibrated = True

    def _watch_calibration(self, frames_dev: torch.Tensor) -> None:
        """Before a batch is served in int8: refine the noise-seeded scales on
        the first real batch's first two frames (once per process, under the
        lock), then re-run that forward every ``RECALIB_EVERY`` batches and
        warn when a scale grew by more than 5 %: a quiet first clip would
        leave later, louder clips clipped."""
        if not self._real_calibrated:
            with self._calib_lock:
                if not self._real_calibrated:
                    self._calibrate_device(frames_dev[:2])
                    self._real_calibrated = True
            return
        with self._calib_lock:
            self._batches_seen += 1
            if self._batches_seen % self.RECALIB_EVERY:
                return
            old = layers.act_scales(self.model)
            self._calibrate_device(frames_dev[:2])
            new = layers.act_scales(self.model)
        growth = max(float(new[k] / torch.clamp_min(old[k], 1e-10)) for k in new)
        if growth > 1.05:
            log.warning(
                "int8 act_scales grew %.1f%% on a sampled batch: earlier clips were "
                "quantized with too-small scales; scales updated from here on. Consider "
                "calibrate() on representative frames up front.", (growth - 1) * 100)

    def letterbox_host(self, frames: np.ndarray) -> tuple[np.ndarray, float]:
        """The JAX package's host prep: [B, H, W, 3] uint8 BGR letterboxed to
        the configured bucket with ``cv2.resize(INTER_LINEAR)``, or padded to
        a multiple of 32 when long_side is 0. Returns (frames, scale bucket ->
        native)."""
        import cv2

        b, h, w = frames.shape[:3]
        if self.cfg.long_side > 0:
            nh, nw, scale = letterbox_params(h, w, self.cfg.long_side)
            if (nh, nw) != (h, w):
                out = np.empty((b, nh, nw, 3), dtype=frames.dtype)
                for i in range(b):
                    out[i] = cv2.resize(frames[i], (nw, nh), interpolation=cv2.INTER_LINEAR)
                frames = out
            return frames, scale
        pad_h, pad_w = (-h) % 32, (-w) % 32
        if pad_h or pad_w:
            frames = np.pad(frames, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
        return frames, 1.0

    def letterbox_device(self, frames: np.ndarray) -> tuple[torch.Tensor, float]:
        """The ``"bgr"`` route's prep: upload [B, H, W, 3] uint8 BGR and
        letterbox it on the device to the configured bucket (or pad to a
        multiple of 32 when long_side is 0). Returns (frames on the device,
        scale bucket -> native)."""
        x = self._upload(frames)
        b, h, w = frames.shape[:3]
        if self.cfg.long_side > 0:
            nh, nw, scale = letterbox_params(h, w, self.cfg.long_side)
            if (nh, nw) != (h, w):
                x = resize_bilinear_uint8(x, nh, nw)
            return x, scale
        pad_h, pad_w = (-h) % 32, (-w) % 32
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        return x, 1.0

    def prepare_batch(self, frames: np.ndarray) -> tuple[torch.Tensor, float]:
        """[B, H, W, 3] uint8 BGR letterboxed as the wire format letterboxes
        it (on the host with cv2 for ``"i420"``, on the device for
        ``"bgr"``), as BGR on the device, without the I420 round trip.
        Returns (frames on the device, scale bucket -> native)."""
        if self.cfg.transfer_format == "i420":
            prepped, scale = self.letterbox_host(frames)
            return torch.from_numpy(np.ascontiguousarray(prepped)).to(self.device), scale
        return self.letterbox_device(frames)

    def prepare_wire(self, frames: np.ndarray) -> tuple:
        """The host half of ``dispatch``, safe in a prefetch thread (cv2 and
        numpy release the GIL): with ``"i420"`` the letterboxed frames in
        I420, [B, H*3//2, W] uint8; with ``"bgr"`` the native frames as they
        are (the device letterboxes them). Returns (wire, scale): the wire is
        a pinned host tensor for a stage on the card, else the array."""
        card = self.device.type == "cuda"
        if self.cfg.transfer_format == "i420":
            prepped, scale = self.letterbox_host(frames)
            if not card:
                return bgr_batch_to_i420(prepped), scale
            b, h, w = prepped.shape[:3]
            wire = torch.empty((b, h * 3 // 2, w), dtype=torch.uint8, pin_memory=True)
            bgr_batch_to_i420(prepped, out=wire.numpy())
            return wire, scale
        h, w = frames.shape[1:3]
        scale = letterbox_params(h, w, self.cfg.long_side)[2] if self.cfg.long_side > 0 else 1.0
        if not card:
            return frames, scale
        return torch.from_numpy(np.ascontiguousarray(frames)).pin_memory(), scale

    def _upload(self, frames) -> torch.Tensor:
        """The host -> device copy of a wire from ``prepare_wire`` (a pinned
        tensor on the card: it waits for nothing) or of native frames (an
        array)."""
        with trace.span("detect.upload"):
            trace.count("detect.upload_bytes", frames.nbytes)
            if isinstance(frames, torch.Tensor):
                return frames.to(self.device, non_blocking=True)
            return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def upload_wire(self, wire) -> torch.Tensor:
        """The wire on the device as letterboxed BGR frames [B, H, W, 3]
        uint8: the I420 upload rebuilt by ``i420_to_bgr``, or the native
        frames uploaded and letterboxed."""
        if self.cfg.transfer_format == "i420":
            x = self._upload(wire)
            with trace.span("detect.rebuild"):
                return i420_to_bgr(x, wire.shape[1] * 2 // 3, wire.shape[2])
        return self.letterbox_device(wire)[0]

    def _priors_for(self, h: int, w: int, device: torch.device | None = None) -> torch.Tensor:
        device = self.device if device is None else device
        if (h, w, device) not in self._priors:
            self._priors[(h, w, device)] = torch.from_numpy(
                self.prior_boxes((h, w)).copy()).to(device)
        return self._priors[(h, w, device)]

    def _consts_for(self, h: int, w: int, device: torch.device) -> tuple:
        """(normalisation mean, anchors, box scale [w, h, w, h], landmark
        scale [w, h] * 5) on ``device`` for frames of h x w, made once."""
        key = (h, w, device)
        if key not in self._consts:
            self._consts[key] = (
                torch.tensor(registry.RETINAFACE_BGR_MEAN, dtype=torch.float32, device=device),
                self._priors_for(h, w, device),
                torch.tensor([w, h, w, h], dtype=torch.float32, device=device),
                torch.tensor([w, h] * 5, dtype=torch.float32, device=device))
        return self._consts[key]

    @torch.inference_mode()
    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        """frames: [B, H, W, 3] uint8 BGR on the device, letterboxed.
        Returns packed [B / stride, K, 16] f32: boxes 0:4, score 4, keep 5,
        landmarks 6:16, in bucket pixel coordinates. With a detect stride the
        network sees every stride-th frame only; the caller keeps the whole
        batch on the device for the crop stage. Under a mesh each shard runs
        on its replica and the results come back to the first device."""
        if self.cfg.stride > 1:
            frames = frames[::self.cfg.stride]
        if len(self.replicas) == 1:
            return self._forward_shard(self.model, frames)
        shards = split_rows(frames, len(self.replicas), "the detect batch")
        return torch.cat([self._forward_shard(model, shard.to(dev)).to(self.device)
                          for (dev, model), shard in zip(self.replicas, shards)])

    def _network(self, model: torch.nn.Module, frames: torch.Tensor) -> tuple:
        mean = self._consts_for(frames.shape[1], frames.shape[2], frames.device)[0]
        return model(retinaface_normalize(frames, mean=mean))

    def _decode(self, frames: torch.Tensor, loc: torch.Tensor, conf: torch.Tensor,
                landms: torch.Tensor) -> torch.Tensor:
        """Scales, decode, top-K, NMS, gather and pack of the network's
        outputs for ``frames``."""
        _, priors, scale, lscale = self._consts_for(frames.shape[1], frames.shape[2],
                                                    frames.device)
        boxes = box_ops.decode_boxes(loc.float(), priors) * scale
        landms = box_ops.decode_landmarks(landms.float(), priors) * lscale
        k = min(self.cfg.nms_candidates, 64)
        cand_boxes, cand_scores, valid, idx = nms_ops.topk_candidates(
            boxes, conf[..., 1], k, self.cfg.threshold)
        keep = nms_mask(cand_boxes.contiguous(), valid.contiguous(), self.cfg.nms_thresh)
        cand_landms = torch.gather(landms, 1, idx[..., None].expand(-1, -1, 10))
        return torch.cat([cand_boxes, cand_scores[..., None],
                          keep.float()[..., None], cand_landms], dim=-1)

    def _network_decode(self, model: torch.nn.Module, frames: torch.Tensor) -> torch.Tensor:
        """What the piecewise graphs capture: network and decode."""
        return self._decode(frames, *self._network(model, frames))

    def eager_reason(self, model: torch.nn.Module, device: torch.device) -> Optional[str]:
        """Why a batch on ``device`` runs ``model`` eagerly, or None where
        its piecewise graphs serve it."""
        if device.type != "cuda":
            return "not on the card"
        if self.mesh is not None:
            return "a mesh"
        if model.training:
            return "training"
        if getattr(model, "calibrating", False):
            return "calibrating"
        return None

    def _graph_key(self, model: torch.nn.Module, frames: torch.Tensor) -> Optional[tuple]:
        """The schedule's key of a batch (the model, which fixes the backbone
        and the fused switches, and the frames' shape, type and device), or
        None where ``eager_reason`` gives one."""
        if self.eager_reason(model, frames.device) is not None:
            return None
        return id(model), tuple(frames.shape), frames.dtype, frames.device

    def _forward_shard(self, model: torch.nn.Module, frames: torch.Tensor) -> torch.Tensor:
        key = self._graph_key(model, frames)
        if key is not None:
            with self._graphs.lock:
                if self._graphs_epoch != self._epoch:
                    self._graphs.clear()
                    self._graphs_epoch = self._epoch
                route, sched = self._graphs.route(key)
                if route == "capture":
                    try:
                        sched = self._graphs.capture(
                            key, lambda x: self._network_decode(model, x), frames)
                    except Exception:  # noqa: BLE001 - logged, the key stays eager
                        log.warning("detect: capturing the graphs of batch %s failed; that "
                                    "batch shape runs eagerly", tuple(frames.shape),
                                    exc_info=True)
                    else:
                        trace.count("detect.graph_captures")
                        trace.count("detect.frames", frames.shape[0])
                        return sched.first
                elif route == "replay":
                    with trace.span("detect.network"):
                        sched.replay_head(frames)
                    with trace.span("detect.decode"):
                        trace.count("detect.frames", frames.shape[0])
                        trace.count("detect.graph_replays")
                        return sched.replay_tail()
                elif route == "warm-up":
                    return self._forward_eager(model, frames)
        return self._forward_eager(model, frames)

    def _forward_eager(self, model: torch.nn.Module, frames: torch.Tensor) -> torch.Tensor:
        trace.count("detect.graph_eager")
        with trace.span("detect.network"):
            out = self._network(model, frames)
        with trace.span("detect.decode"):
            trace.count("detect.frames", frames.shape[0])
            return self._decode(frames, *out)

    def dispatch_wire(self, wire, scale: float
                      ) -> tuple[torch.Tensor, float, torch.Tensor]:
        """The device half of ``dispatch`` for a wire from ``prepare_wire``:
        upload, rebuild or letterbox, the int8 calibration watch on those
        frames, and the forward. Returns (packed on the device, scale,
        letterboxed BGR frames on the device for the crop stage)."""
        frames_dev = self.upload_wire(wire)
        if self.quant:
            with trace.span("detect.calibrate"):
                self._watch_calibration(frames_dev)
        return self.forward(frames_dev), scale, frames_dev

    def dispatch(self, frames: np.ndarray) -> tuple[torch.Tensor, float, torch.Tensor]:
        """Enqueue detection for a batch of native [B, H, W, 3] uint8 BGR
        frames: ``prepare_wire`` then ``dispatch_wire``."""
        return self.dispatch_wire(*self.prepare_wire(frames))

    @staticmethod
    def unpack(packed_np: np.ndarray, scale: float) -> Detections:
        inv = 1.0 / scale
        return Detections(
            boxes=packed_np[..., 0:4] * inv,
            scores=packed_np[..., 4],
            keep=packed_np[..., 5] > 0.5,
            landmarks=packed_np[..., 6:16] * inv,
        )


class HostCopy:
    """A device tensor's copy to the host, started at once: on the card into
    pinned memory with ``non_blocking`` and an event after it, so that
    ``numpy`` waits for that copy alone, not for the whole stream."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(t.device))
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
            return self.host.numpy()
        return self.host.cpu().numpy()
