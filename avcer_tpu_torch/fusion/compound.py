"""Clip-level compound-expression decision (avcer_tpu/fusion/compound.py).

Audio window logits are averaged per frame over the overlapping windows
(frames past the video dropped, the uncovered tail forward-filled), the
visual rows are reordered to fusion order, and ``ops.fusion`` decides.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.core.config import FusionConfig
from avcer_tpu_torch.ops import fusion as fusion_ops


@dataclass
class CompoundResult:
    av: np.ndarray  # [T] compound class ids
    vs: np.ndarray
    vd: np.ndarray
    a: np.ndarray
    av_prob: np.ndarray  # [T, K]
    image_locations: list[str]


def align_audio_to_frames(
    window_logits: np.ndarray,  # [W, C]
    frame_ids: np.ndarray,  # [R]
    window_of_row: np.ndarray,  # [R]
    num_frames: int,
) -> np.ndarray:
    """Per-frame audio logits [T, C]: mean over the window rows that cover
    each frame; frames past the audio hold the last covered row."""
    c = window_logits.shape[1]
    if window_logits.size == 0 or frame_ids.size == 0:
        return np.zeros((num_frames, c), np.float32)
    in_range = frame_ids < num_frames
    fids = frame_ids[in_range]
    rows = window_logits[window_of_row[in_range]]
    sums = np.zeros((num_frames, c), np.float64)
    counts = np.zeros(num_frames, np.float64)
    np.add.at(sums, fids, rows)
    np.add.at(counts, fids, 1.0)
    covered = counts > 0
    out = np.zeros((num_frames, c), np.float32)
    out[covered] = (sums[covered] / counts[covered, None]).astype(np.float32)
    if covered.any() and not covered.all():
        last = np.max(np.nonzero(covered)[0])
        out[last + 1:] = out[last]
    return out


def decide(
    stat_video_order: np.ndarray,  # [T, 7] softmax probs, video order
    dyn_logits_video_order: np.ndarray,  # [T, 7] raw logits, video order
    audio_frame_logits: np.ndarray,  # [T, C>=7] raw logits, fusion order
    name_video: str,
    cfg: FusionConfig,
    device: torch.device | str = "cpu",
) -> CompoundResult:
    t = stat_video_order.shape[0]
    perm = np.asarray(registry.VIDEO_TO_FUSION)

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)

    w1 = (registry.AV_WEIGHTS_8CL if cfg.use_published_weights
          else np.ones((3, 7)))
    out = fusion_ops.fused_compound_decision(
        dev(stat_video_order[:, perm]), dev(dyn_logits_video_order[:, perm]),
        dev(audio_frame_logits[:, :7]), dev(w1), dev(np.asarray(cfg.model_weights)),
        ce_weights_type=cfg.ce_weights_type, ce_mask=cfg.ce_mask,
        use_weights=cfg.use_published_weights,
    )
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return CompoundResult(
        av=out["av"], vs=out["vs"], vd=out["vd"], a=out["a"],
        av_prob=out["av_prob"],
        image_locations=[f"{name_video}/{str(f + 1).zfill(5)}.jpg" for f in range(t)],
    )


def save_compound_txt(path: str, locations: list[str], labels: np.ndarray) -> None:
    """Challenge submission txt (run.py:167-188)."""
    lines = [",".join(registry.COMPOUND_TXT_COLUMNS)]
    lines += [f"{loc},{int(lab)}" for loc, lab in zip(locations, labels)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
