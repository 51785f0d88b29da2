"""Pipeline construction (avcer_tpu/pipeline/builder.py): the four model
families at full width, placed on ``device`` in the compute dtype, with
weights from a JAX parameter tree handed in, else from the reference's
release file in ``weights_dir`` (``core.checkpoint.resolve``, mapped by
``core.convert.release_state_dict``), else from a seeded random init with a
warning, as the JAX package does. Every load is strict: a key left unknown
or missing raises.

The audio family is ``expr_model_8cl`` or ``expr_model_7cl`` by the class
count, built as ``AudioConfig.head`` says over the encoder ``AudioConfig.encoder``
names (``models.audio_heads.ENCODERS``: wav2vec2 or WavLM, whose release
checkpoint is not served: with no release file it is seeded, as every
family); the detector's is named after its backbone.

With ``quant == "int8"`` in a stage's config its model is built in the int8
variant over the same state dict; the stage then seeds the activation scales
(see each stage). A JAX tree that carries an ``act_scales`` collection hands
its calibrated scales to the model before that, so both sides quantise with
the same scales; the JAX package's calibration sidecars on disk are refused
(``core.checkpoint``). The port's own sidecars in ``weights_dir``
(``checkpoint.save_act_scales``, written by ``cli.convert_verify
--calib_video``) are adopted after that by every stage served in int8, as an
elementwise running max with the stage's scales; a sidecar that no longer
fits the model is warned about and skipped, as in the JAX package.

``cfg.mesh.data > 1``: the stages serve over a data-parallel mesh
(``parallel.mesh.make_mesh(data, 1)`` over ``mesh_devices``, default every
CUDA device, or the CPU where ``device`` is the CPU; too few raise the mesh
error). The detector and the static CNN keep a replica a device and shard
their batches, the fused switches are off (as in the JAX package), and the
stages live on the mesh's first device.

``cfg.calibrate`` (``cli.run --calibrate``): once the stages are built and
their sidecars adopted, ``pipeline.calibrate`` sets the CNN and audio batch
sizes from the cache in ``calibrate.DEFAULT_CACHE``, or measures them on the
device and caches them there.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Mapping, Optional

import torch

from avcer_tpu_torch.core.config import AudioConfig, PipelineConfig
from avcer_tpu_torch.core import checkpoint, convert
from avcer_tpu_torch.models.audio_heads import ENCODERS, ExprModel
from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
from avcer_tpu_torch.models.layers import cast_compute, load_act_scales, seeded_init_
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
from avcer_tpu_torch.parallel import mesh as mesh_lib
from avcer_tpu_torch.pipeline.audio_stage import AudioStage
from avcer_tpu_torch.pipeline.detect import DetectStage
from avcer_tpu_torch.pipeline.runner import Pipeline, check_supported
from avcer_tpu_torch.pipeline.visual import VisualStage
from avcer_tpu_torch.utils import trace

log = logging.getLogger("avcer_tpu_torch")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_pipeline(
    cfg: PipelineConfig,
    wav2vec2_config: Optional[Wav2Vec2Config] = None,
    device: torch.device | str = "cuda",
    seed: int = 0,
    jax_variables: Optional[Mapping[str, Mapping[str, Any]]] = None,
    mesh_devices: Optional[list] = None,
) -> Pipeline:
    """Build the detect, visual and audio stages on ``device``.

    ``wav2vec2_config``: the audio encoder's configuration (a
    ``Wav2Vec2Config`` or ``models.wavlm.WavLMConfig``, as tests shrink it);
    by default the one ``cfg.audio.encoder`` names, at its published widths.

    ``jax_variables``: optional ``{family: numpy variable tree}`` for the
    families "retinaface" (either backbone's tree, as ``cfg.detector.backbone``
    says), "emotion_resnet50", "temporal_lstm" and "expr_model", converted
    with ``core.convert`` and loaded strictly. Every family not given is
    loaded from its release file in ``cfg.weights_dir``, or where there is
    none initialised from ``torch.Generator().manual_seed(seed)``. The build
    is the span ``setup.build_pipeline`` (``utils.trace``).
    """
    with trace.setup("build_pipeline"):
        return _build_pipeline(cfg, wav2vec2_config, device, seed, jax_variables, mesh_devices)


def _build_pipeline(cfg: PipelineConfig, wav2vec2_config: Optional[Wav2Vec2Config],
                    device: torch.device | str, seed: int,
                    jax_variables: Optional[Mapping[str, Mapping[str, Any]]],
                    mesh_devices: Optional[list]) -> Pipeline:
    check_supported(cfg)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    mesh = None
    if cfg.mesh.data > 1:
        mesh = mesh_lib.make_mesh(cfg.mesh.data, 1, mesh_devices if mesh_devices is not None
                                  else mesh_lib.default_devices(device.type))
        device = mesh.first
        # the fused kernels serve one device, as the Pallas kernels do
        cfg = dataclasses.replace(
            cfg, detector=dataclasses.replace(
                cfg.detector, fused_layer1=False, fused_tails=False, fused_entries=False,
                fused_ssh=False, fused_fpn=False),
            visual=dataclasses.replace(cfg.visual, fused=False, fused_entries=False))
    # the JAX package's AudioConfig, which tests hand in, names no encoder
    w2v2 = wav2vec2_config or ENCODERS[getattr(cfg.audio, "encoder", AudioConfig.encoder)]()
    if cfg.audio.quant == "int8":
        w2v2 = dataclasses.replace(w2v2, quant=True)
    models = {
        # the fused switches select the CUDA kernels K3 / K4 inside the models
        "retinaface": RetinaFace(
            backbone=cfg.detector.backbone,
            fused_layer1=cfg.detector.fused_layer1, fused_tails=cfg.detector.fused_tails,
            fused_entries=cfg.detector.fused_entries, fused_ssh=cfg.detector.fused_ssh,
            fused_fpn=cfg.detector.fused_fpn, quant=cfg.detector.quant == "int8"),
        "emotion_resnet50": EmotionResNet50(cfg.visual.num_classes, fused=cfg.visual.fused,
                                            fused_entries=cfg.visual.fused_entries,
                                            quant=cfg.visual.quant == "int8"),
        "temporal_lstm": TemporalLSTM(cfg.visual.num_classes),
        "expr_model": ExprModel(cfg.audio.head, cfg.audio.num_classes, w2v2),
    }
    #: the release family of each model, and whether it is served in int8
    release = {
        "retinaface": (checkpoint.detector_family(cfg.detector.backbone),
                       cfg.detector.quant == "int8"),
        "emotion_resnet50": ("emotion_resnet50", cfg.visual.quant == "int8"),
        "temporal_lstm": ("temporal_lstm", False),
        "expr_model": (checkpoint.audio_family(cfg.audio.num_classes), cfg.audio.quant == "int8"),
    }
    given = dict(jax_variables or {})
    unknown = set(given) - set(models)
    if unknown:
        raise ValueError(f"jax_variables: unknown families {sorted(unknown)}")
    files = {family: checkpoint.resolve(cfg.weights_dir, *release[family])
             for family in models if family not in given}
    seeded = sorted(release[family][0] for family, sd in files.items() if sd is None)
    if seeded:
        log.warning("no checkpoints for %s under %s — using seeded random "
                    "initialization (outputs will not match the published models)",
                    seeded, cfg.weights_dir)
    gen = torch.Generator().manual_seed(seed)
    for family, model in models.items():
        if family in given:
            model.load_state_dict(convert.CONVERTERS[family](given[family]), strict=True)
            scales = convert.act_scales(family, given[family])
            if scales is not None:
                load_act_scales(model, scales)
        elif files[family] is not None:
            model.load_state_dict(convert.release_state_dict(
                family, files[family], num_layers=w2v2.num_layers), strict=True)
            log.info("%s: loaded from %s", release[family][0], cfg.weights_dir)
        else:
            seeded_init_(model, gen)
        model.eval().requires_grad_(False)

    def place(model: torch.nn.Module, dtype_name: str) -> torch.nn.Module:
        return cast_compute(model, _DTYPES[dtype_name]).to(device)

    detect = DetectStage(cfg.detector, place(models["retinaface"], cfg.detector.dtype),
                         device=device, mesh=mesh)
    visual = VisualStage(place(models["emotion_resnet50"], cfg.visual.dtype),
                         models["temporal_lstm"].to(device),
                         num_classes=cfg.visual.num_classes,
                         batch_size=cfg.visual.batch_size, device=device,
                         quant=cfg.visual.quant, mesh=mesh)
    audio = AudioStage(place(models["expr_model"], cfg.audio.dtype), cfg.audio, device=device,
                       mesh=mesh)
    for stage, (family, int8) in ((detect, release["retinaface"]),
                                  (visual, release["emotion_resnet50"]),
                                  (audio, release["expr_model"])):
        scales = checkpoint.load_act_scales(cfg.weights_dir, family) if int8 else None
        if scales is None:
            continue
        try:
            stage.merge_act_scales(scales)
            log.info("%s: int8 act_scales adopted from %s", family,
                     checkpoint.act_scales_path(cfg.weights_dir, family))
        except Exception as e:  # noqa: BLE001 - the model changed since the sidecar was written
            log.warning("act_scales sidecar for %s incompatible (%s) — ignored", family, e)
    pipe = Pipeline(cfg, detect, visual, audio, device=device, mesh=mesh)
    if cfg.calibrate:
        from avcer_tpu_torch.pipeline import calibrate

        calibrate.calibrate(pipe, calibrate.DEFAULT_CACHE)
    return pipe
