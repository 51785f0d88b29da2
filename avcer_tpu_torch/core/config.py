"""Typed configuration of the inference pipeline: the port's own copy of the
dataclasses in avcer_tpu/core/config.py, field for field with the same
defaults (tests/test_torch_ops.py pins them), so that one side's values can
be handed to the other, the training configs ``OptimConfig`` and
``TrainConfig`` included. The JAX package's ``pipeline_config_from_args`` is
not copied: the port's CLI builds its config itself
(``avcer_tpu_torch.cli.run``). ``MeshConfig`` is kept because
``PipelineConfig`` and ``TrainConfig`` hold one; the port runs ``data ==
model == pipe == 1`` only.

Comments that speak of the TPU, the MXU, VMEM or Pallas describe the JAX
package's measurements and switches; on the card the fused switches select
the CUDA kernels in ``ops/cuda``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


@dataclass(frozen=True)
class DetectorConfig:
    """RetinaFace detector stage.

    Reference semantics: threshold 0.8, resnet50 backbone, conf_thresh 0.02,
    nms_thresh 0.4, nms_top_k 5000, top_k 750
    (.../retina_face/retina_face_predictor.py:18-57, get_face_images.py:27-31).
    """

    backbone: str = "resnet50"  # or "mobilenet0.25"
    threshold: float = 0.8
    conf_thresh: float = 0.02
    nms_thresh: float = 0.4
    #: Fixed candidate budget for the TPU NMS (reference nms_top_k=5000 is a
    #: cap on a variable-length list; we keep a static top-K instead).
    nms_candidates: int = 512
    top_k: int = 750
    max_faces: int = 8
    #: If >0, letterbox-resize frames so the long side equals this bucket and
    #: run the detector at fixed shape (TPU-friendly). 0 = native resolution
    #: padded to a bucket (parity mode).
    long_side: int = 640
    #: Wire format for frame upload: "i420" halves host->device bytes
    #: (lossless vs 4:2:0 video sources); "bgr" ships raw pixels.
    transfer_format: str = "i420"
    #: Detect every Nth frame (opt-in speed mode; 1 = reference parity, the
    #: reference detects every frame — get_face_images.py:44-61). Frames in
    #: between get linearly interpolated target boxes from the surrounding
    #: detections (held at chunk tails); the emotion CNN still runs on every
    #: frame. Must divide batch_size.
    stride: int = 1
    #: IoU tracker threshold (get_face_images.py:32).
    tracker_iou: float = 0.4
    min_face_size: float = 0.0
    batch_size: int = 32
    #: Compute dtype: "bfloat16" on TPU; "float32" for CPU differential runs.
    dtype: str = "bfloat16"
    #: Greedy-NMS implementation: "auto" = the XLA fori_loop (0.093 ms/batch
    #: vs 0.346 for the Pallas kernel on v5e in trustworthy in-program-loop
    #: timing — BENCH_NOTES.md round-4 table). "pallas" opts into the kernel
    #: (bit-exact, kept for study).
    nms_impl: str = "auto"
    #: Quantized serving: "int8" runs backbone+FPN+SSH convs dynamically
    #: quantized on the MXU (~1.85x conv speedup, models/retinaface.QConv);
    #: heads/decode/NMS stay bf16/fp32. "none" = exact bf16 path.
    quant: str = "none"
    #: Space-to-depth stem for the resnet50 backbone: exact reformulation of
    #: the 7x7/s2 stem conv (same parameters, same math — models/retinaface.py
    #: StemConv). Off by default: measured 0.635 vs 0.604 ms/frame on v5e at
    #: the 640 bucket (XLA's own stem lowering already wins there); kept as an
    #: option for other generations/buckets.
    s2d_stem: bool | str = False
    #: resnet50 layer1 as ONE fused Pallas program keeping all bottleneck
    #: intermediates in VMEM (ops/pallas/fused_resnet_kernel.py) — layer1 is
    #: the detector's HBM-bound worst section (~8% MFU, BENCH_NOTES round-4).
    #: Exact math over the same checkpoint tree; bf16 non-quant path only.
    fused_layer1: bool = False
    #: additionally fuse the stride-1 identity tails of layers 2-3 (their
    #: stride-2 entry bottlenecks stay in XLA) — same exactness contract.
    fused_tails: bool = False
    #: fuse the stride-2 entry bottlenecks of layers 2-3 into their chains
    #: too (models/retinaface.ResNet50Backbone.fused_entries) — layer2
    #: becomes ONE Pallas program; requires fused_tails, same exactness.
    fused_entries: bool = False
    #: each SSH context module + its three 1x1 heads as one fused Pallas
    #: program per FPN scale (models/retinaface.RetinaFace.fused_ssh) —
    #: the SSH output never touches HBM. Exact; int8 fold under quant.
    fused_ssh: bool = False
    #: with fused_ssh, fold the FPN (lateral + upsample-add + merge) into
    #: the same per-scale programs (RetinaFace.fused_fpn). Same exactness.
    fused_fpn: bool = False


@dataclass(frozen=True)
class VisualConfig:
    """Static CNN + dynamic LSTM stage (get_prob_video.py)."""

    num_classes: int = 7
    lstm_window: int = 10
    #: crop-CNN batch. Every CNN forward takes exactly this many crops (the
    #: last batch of a chunk is filled up with its last crop), so that a
    #: crop's row does not depend on how many crops its chunk holds: a
    #: 3-frame clip pays for a whole batch. Set it small for runs on the CPU.
    batch_size: int = 256
    dtype: str = "bfloat16"
    #: "int8" = quantized static-CNN serving (models/emotion_resnet.py quant;
    #: same checkpoint tree, calibrated activation scales). LSTM stays bf16.
    quant: str = "none"
    #: exact space-to-depth stem (models/emotion_resnet.py s2d_stem; same
    #: params/math). "auto" = on for bf16 TPU serving; bf16 path only.
    s2d_stem: bool | str = False
    #: bottleneck chains as fused Pallas programs (models/emotion_resnet.py
    #: fused) — same exactness contract as DetectorConfig.fused_layer1;
    #: bf16 non-quant single-chip path only.
    fused: bool = False
    #: with ``fused``, fuse the stride-2 entries of layers 2-3 too
    #: (models/emotion_resnet.py fused_entries — "s2pre" kernel blocks).
    fused_entries: bool = False
    #: run the static CNN only when the last computed present frame is
    #: >= cnn_stride frame ids old (greedy, so the <= cnn_stride-1-frame
    #: staleness bound holds even with sparse face presence), plus EVERY
    #: dynamic step frame — so the LSTM feature stream, and therefore the
    #: whole dynamic output, stays bit-exact (under int8, calibration also
    #: runs on the same leading crops as per-frame serving). Static probs
    #: on skipped frames hold the last computed row. 1 = reference-exact
    #: per-frame CNN; 0 = align to the dynamic step cadence
    #: round(5*fps/25), the reference's own legacy visual pipeline
    #: sampling rate (src/video/functions/get_face_areas.py:40). Serving
    #: approximation — drift numbers in PARITY.md (max preset).
    cnn_stride: int = 1


@dataclass(frozen=True)
class AudioConfig:
    """Audio stage (get_prob_audio_{7,8}_cl.py)."""

    num_classes: int = 8
    head: str = "v3"  # v1 | v2 | v3
    sample_rate: int = 16_000
    window_sec: float = 4.0
    step_sec: float = 0.5
    padding: str = "mean"  # mean | constant | repeat
    batch_size: int = 16
    dtype: str = "bfloat16"
    #: "int8" = quantized wav2vec2 encoder projections (Wav2Vec2Config.quant;
    #: same checkpoint tree, calibrated activation scales).
    quant: str = "none"
    #: Run the conv feature extractor once per clip instead of once per
    #: window (the 4 s / 0.5 s windows overlap 8x). Opt-in APPROXIMATION:
    #: normalization happens once per wav instead of per window
    #: (audio_stage._shared_features_impl); drift-gated in tests.
    shared_extractor: bool = False


@dataclass(frozen=True)
class FusionConfig:
    """Probability fusion + compound-expression decision (run.py:25-189)."""

    #: 3x7 per-(model, emotion) Dirichlet weights; None = plain average.
    use_published_weights: bool = True
    #: Scalar per-model weights (run.py:197 ``weights_model=[1, 1, 1]``).
    model_weights: tuple[float, float, float] = (1.0, 1.0, 1.0)
    #: Rule 2: pair-normalized prior weights (run.py:216).
    ce_weights_type: bool = False
    #: Rule 1: zero out probabilities <= 1/7 (run.py:217, CLI default True).
    ce_mask: bool = True


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh for scale-out. Inference shards the frame/window batch
    axis ("data"); training adds optional model-parallel sharding of the
    wav2vec2 encoder ("model") OR GPipe pipeline parallelism over the
    encoder layer stack ("pipe", parallel/pipeline.py) — mutually
    exclusive axes for now."""

    data: int = 1
    model: int = 1
    #: >1 = pipeline-parallel training: encoder layers stack on a leading
    #: [L] axis sharded over "pipe" (params/grads/moments scale 1/pipe);
    #: see train/trainer.py pp branch + parallel/pipeline.py.
    pipe: int = 1
    #: GPipe microbatches per step (bubble = (pipe-1)/(n_micro+pipe-1));
    #: batch_size must divide data * pipe_microbatches.
    pipe_microbatches: int = 2


@dataclass(frozen=True)
class PipelineConfig:
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    visual: VisualConfig = field(default_factory=VisualConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    #: Write face crops to ``<save>/<video>/<tid>/<frame>.jpg`` like the
    #: reference (get_face_images.py:57-60). Off by default: the TPU pipeline
    #: keeps crops in memory; this is an output-parity option only.
    save_face_crops: bool = False
    save_probs: bool = True
    save_plot: bool = True
    #: Grad-CAM heatmaps for step frames (run.py:214-215 flag_heatmaps /
    #: model_heatmaps). "" = off; "static" | "dynamic" choose which model's
    #: argmax class drives the CAM (get_prob_video.py:131-136).
    heatmaps: str = ""
    weights_dir: str = "weights"
    #: One-shot on-device batch-size calibration at build time (cached per
    #: device kind — pipeline/calibrate.py). Off by default: the checked-in
    #: defaults are the measured v5e optima.
    calibrate: bool = False

    def __post_init__(self) -> None:
        # fail at config time, not after minutes of device compiles: the
        # jpg crop dump is a per-frame parity artifact, incompatible with
        # detect-stride serving (heatmaps are fine — they use the
        # device-side step-crop fetch)
        if self.save_face_crops and self.detector.stride > 1:
            raise ValueError(
                "save_face_crops requires detector stride=1 (the jpg dump"
                " is a per-frame parity artifact); drop --save_face_crops"
                " or the stride/turbo preset"
            )
        if self.visual.cnn_stride < 0:
            raise ValueError(
                "cnn_stride must be >= 0 (0 = align to the dynamic step"
                f" cadence, 1 = per-frame); got {self.visual.cnn_stride}"
            )

    def to_json(self, **kw: Any) -> str:
        return json.dumps(_asdict(self), indent=2, **kw)


@dataclass(frozen=True)
class OptimConfig:
    """Adam + CosineAnnealingWarmRestarts with the reference's per-batch
    ``epoch + idx/iters`` stepping (net_trainer.py:437, train_c_audio.py:246-250)."""

    lr: float = 1e-4
    t0: int = 10
    t_mult: int = 1
    eta_min: float = 0.0
    weight_decay: float = 0.0


@dataclass(frozen=True)
class TrainConfig:
    model: str = "v3"
    num_classes: int = 8
    epochs: int = 100
    batch_size: int = 24
    seed: int = 0
    augmentation: bool = False
    filtered: bool = True
    label_smoothing: float = 0.2
    mixup_alpha: float = 0.3
    loss: str = "weighted_ce"  # weighted_ce | soft_focal | mse | ccc
    #: classification (EXPR) or regression (VA task, net_trainer.py:18-24)
    problem: str = "classification"
    optim: OptimConfig = field(default_factory=OptimConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    log_root: str = "logs"
    #: model-selection metric (train_c_audio.py:217)
    selection_metric: str = "f1"

    def to_json(self, **kw: Any) -> str:
        return json.dumps(_asdict(self), indent=2, **kw)
