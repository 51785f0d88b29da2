"""The semantics around the models, in plain numpy and torch: what the
reference pipeline (ElenaRyumina/AVCER ``run.py``) does to a clip, with the
serving switches a configuration states (detector bucket, I420 wire, detect
stride, the static CNN's cadence, the shared audio feature extractor).

- the wire: BGR -> I420 with BT.601 studio-swing integer coefficients and
  the top-left pixel of each 2 x 2 quad for chroma, then I420 -> BGR
  (``1.164 (y - 16)`` and the chroma terms, round half to even, clamp); the
  letterbox to the bucket by bilinear interpolation with half-pixel centres;
- detection: anchors at strides 8, 16, 32 with min sizes (16, 32), (64, 128),
  (256, 512), decoding with variances (0.1, 0.2), the top-64 scores per frame
  (ties to the lower index), greedy NMS with the legacy +1 IoU;
- the face crop: the box truncated to int and clamped as the reference's
  ``get_face_images.py`` does, mapped into the letterboxed frame, and a
  nearest resize to 224 (row i reads ``y1 + ((2i + 1) h) // 448``);
- the temporal plan of ``get_prob_video.py``: step ``round(5 fps / 25)``,
  windows of the last 10 step features, forward fills;
- the audio windows of ``get_prob_audio_8_cl.py``: 4 s every 0.5 s, the tail
  padded with its mean, normalised one by one (or, with the shared
  extractor, the whole clip normalised once and each full window reading
  its slice of the clip's conv features), averaged per frame;
- the compound decision of ``run.py``: the published AV weights, Rule 1.

This module imports nothing of the program it checks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RETINAFACE_MEAN = (104.0, 117.0, 123.0)
VGGFACE2_MEAN = (91.4953, 103.8827, 131.0912)
VIDEO_EMOTIONS = ("Neutral", "Happiness", "Sadness", "Surprise", "Fear", "Disgust", "Anger")
AUDIO_EMOTIONS_7 = ("Neutral", "Anger", "Disgust", "Fear", "Happiness", "Sadness", "Surprise")
VIDEO_TO_FUSION = tuple(VIDEO_EMOTIONS.index(e) for e in AUDIO_EMOTIONS_7)
#: compound class -> its two basic emotions in AUDIO_EMOTIONS_7 order (run.py)
COMPOUND_PAIRS = ((3, 6), (4, 6), (5, 6), (2, 6), (1, 6), (3, 5), (1, 5))
#: the flagship's published AV weights, rows (static, dynamic, audio)
AV_WEIGHTS = np.array([
    [0.89900098, 0.10362151, 0.08577635, 0.04428126, 0.89679865, 0.02656456, 0.63040305],
    [0.01223291, 0.21364307, 0.66688002, 0.93791526, 0.0398964, 0.48670648, 0.22089692],
    [0.08876611, 0.68273542, 0.24734363, 0.01780348, 0.06330495, 0.48672896, 0.14870002],
])
TOP_K = 64


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def letterbox_size(h: int, w: int, long_side: int) -> tuple[int, int, float]:
    """(new h, new w, scale): the long side to ``long_side``, dims even."""
    scale = long_side / max(h, w)
    nh, nw = max(2, round(h * scale)), max(2, round(w * scale))
    return nh + nh % 2, nw + nw % 2, scale


def resize_bilinear(frames: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> [B, nh, nw, 3]: bilinear, half-pixel centres,
    rounded."""
    x = frames.permute(0, 3, 1, 2).float()
    y = torch.nn.functional.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False)
    return y.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def i420_roundtrip(frames: torch.Tensor) -> torch.Tensor:
    """uint8 BGR [B, H, W, 3] -> I420 -> BGR, as the wire carries it."""
    x = frames.long()
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    shift = 20
    half = 1 << (shift - 1)
    y = (269484 * r + 528482 * g + 102760 * b + half + (16 << shift)) >> shift
    r0, g0, b0 = r[:, ::2, ::2], g[:, ::2, ::2], b[:, ::2, ::2]
    u = (-155188 * r0 - 305135 * g0 + 460324 * b0 + half + (128 << shift)) >> shift
    v = (460324 * r0 - 385875 * g0 - 74448 * b0 + half + (128 << shift)) >> shift
    y, u, v = (t.clamp(0, 255).float() for t in (y, u, v))
    uf = u.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    vf = v.repeat_interleave(2, 1).repeat_interleave(2, 2) - 128.0
    yb = 1.164 * (y - 16.0)
    bgr = torch.stack([yb + 2.018 * uf, yb - 0.391 * uf - 0.813 * vf, yb + 1.596 * vf], -1)
    return torch.round(bgr).clamp(0.0, 255.0).to(torch.uint8)


def wire_frames(frames: torch.Tensor, long_side: int) -> tuple[torch.Tensor, float]:
    """Native uint8 BGR frames -> the detector's frames (letterboxed, then
    through the I420 wire) and the scale bucket / native."""
    h, w = frames.shape[1:3]
    nh, nw, scale = letterbox_size(h, w, long_side)
    if (nh, nw) != (h, w):
        frames = resize_bilinear(frames, nh, nw)
    return i420_roundtrip(frames), scale


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def priors(h: int, w: int, device) -> torch.Tensor:
    """[A, 4] anchors (cx, cy, w, h) normalised, in the heads' row order."""
    out = []
    for sizes, step in zip(((16, 32), (64, 128), (256, 512)), (8, 16, 32)):
        fh, fw = math.ceil(h / step), math.ceil(w / step)
        jj, ii = np.meshgrid(np.arange(fw), np.arange(fh))
        level = np.empty((fh, fw, len(sizes), 4), np.float32)
        for s, size in enumerate(sizes):
            level[..., s, 0] = (jj + 0.5) * step / w
            level[..., s, 1] = (ii + 0.5) * step / h
            level[..., s, 2] = size / w
            level[..., s, 3] = size / h
        out.append(level.reshape(-1, 4))
    return torch.from_numpy(np.concatenate(out)).to(device)


def decode(loc: torch.Tensor, landms: torch.Tensor, pri: torch.Tensor, h: int, w: int):
    """Regressions -> boxes [B, A, 4] and landmarks [B, A, 10] in bucket
    pixels."""
    centers = pri[:, :2] + loc[..., :2] * 0.1 * pri[:, 2:]
    sizes = pri[:, 2:] * torch.exp(loc[..., 2:] * 0.2)
    boxes = torch.cat([centers - sizes / 2, centers + sizes / 2], -1)
    boxes = boxes * torch.tensor([w, h, w, h], dtype=boxes.dtype, device=boxes.device)
    pts = landms.reshape(*landms.shape[:-1], 5, 2)
    pts = pri[:, None, :2] + pts * 0.1 * pri[:, None, 2:]
    pts = pts * torch.tensor([w, h], dtype=pts.dtype, device=pts.device)
    return boxes, pts.reshape(*landms.shape)


def top_candidates(scores: torch.Tensor, k: int = TOP_K) -> torch.Tensor:
    """Indices [B, k] of the k best scores, ties to the lower index."""
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


# ---------------------------------------------------------------------------
# the face crop
# ---------------------------------------------------------------------------

def crop_boxes(face: np.ndarray, width: int, height: int, scale: float, lb_h: int, lb_w: int):
    """Per-frame face boxes (float, native pixels) -> (present [T], boxes in
    the letterboxed frame [T, 4] int): the reference's int truncation and
    clamp, a face only where the clamped box is not empty."""
    b = face[:, :4].astype(np.int32)
    b[:, 0] = np.maximum(0, b[:, 0])
    b[:, 1] = np.maximum(0, b[:, 1])
    b[:, 2] = np.minimum(width - 1, b[:, 2])
    b[:, 3] = np.minimum(height - 1, b[:, 3])
    present = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
    lb = np.round(b.astype(np.float64) * scale).astype(np.int32)
    lb[:, 0] = np.minimum(lb[:, 0], lb_w - 2)
    lb[:, 1] = np.minimum(lb[:, 1], lb_h - 2)
    lb[:, 2] = np.maximum(lb[:, 2], lb[:, 0] + 1)
    lb[:, 3] = np.maximum(lb[:, 3], lb[:, 1] + 1)
    return present, lb


def interpolate_boxes(det_boxes: np.ndarray, n_frames: int, stride: int,
                      chunk: int = 512) -> np.ndarray:
    """Boxes of every frame from the detections of frames 0, stride, ...:
    a detected frame keeps its box, a frame between two detections of one
    chunk of ``chunk`` frames (the stretch of frames a detect-stride server
    holds before cropping) takes their linear interpolation, a frame past a
    chunk's last detection holds it."""
    t = np.arange(n_frames)
    d = t // stride
    frac = (t % stride) / stride
    d1 = np.minimum(d + 1, len(det_boxes) - 1)
    inside = ((d + 1) * stride < n_frames) & ((d + 1) * stride // chunk == t // chunk)
    b1 = np.where(((frac > 0) & inside)[:, None], det_boxes[d1], det_boxes[d])
    return (1 - frac[:, None]) * det_boxes[d] + frac[:, None] * b1


def crops(frames: torch.Tensor, boxes: torch.Tensor, out: int = 224) -> torch.Tensor:
    """Crops [B, out, out, 3] of frames [B, H, W, 3] at int boxes [B, 4]
    (exclusive ends) by nearest resize."""
    h, w = frames.shape[1:3]
    x1, y1, x2, y2 = boxes.long().unbind(-1)
    k = 2 * torch.arange(out, device=frames.device) + 1
    rows = (y1[:, None] + (k[None] * (y2 - y1).clamp_min(1)[:, None]) // (2 * out)).clamp(0, h - 1)
    cols = (x1[:, None] + (k[None] * (x2 - x1).clamp_min(1)[:, None]) // (2 * out)).clamp(0, w - 1)
    idx = torch.arange(frames.shape[0], device=frames.device)
    return frames[idx[:, None, None], rows[:, :, None], cols[:, None, :]]


# ---------------------------------------------------------------------------
# the visual stream's plan
# ---------------------------------------------------------------------------

def dynamic_step(fps: float) -> int:
    return max(1, round(5 * fps / 25))


def cnn_frames(present: np.ndarray, step: int, cnn_stride: int) -> np.ndarray:
    """Indices of the present frames the static CNN computes: every one at
    cnn_stride 1; else a frame at least ``cnn_stride`` (0: ``step``) after
    the last computed one, and every step frame."""
    cs = cnn_stride or step
    out, last = [], None
    for g in np.flatnonzero(present).tolist():
        if cs <= 1 or last is None or g - last >= cs or g % step == 0:
            out.append(g)
            last = g
    return np.asarray(out, np.int64)


def hold_rows(computed: np.ndarray, rows: np.ndarray, present: np.ndarray) -> np.ndarray:
    """Rows of every present frame (in order) from those of ``computed``
    frames: each holds the last computed row at or before it."""
    src = np.searchsorted(computed, np.flatnonzero(present), side="right") - 1
    return rows[src]


def temporal_plan(present: np.ndarray, step: int, window: int = 10):
    """(step present-indices [S], windows [S, window] into the step features,
    static source [T], dynamic source [T]; -1 = zeros) as the reference's
    per-frame loop builds them."""
    pidx = np.full(len(present), -1)
    pidx[present] = np.arange(int(present.sum()))
    steps, wins = [], []
    stat_src = np.full(len(present), -1)
    dyn_src = np.full(len(present), -1)
    seg, last_out, last_stat = 0, -1, -1
    for t in range(len(present)):
        if present[t]:
            stat_src[t] = last_stat = pidx[t]
            if t % step == 0:
                k = len(steps)
                wins.append([max(seg, k - (window - 1) + j) for j in range(window)])
                steps.append(pidx[t])
                last_out = k
            dyn_src[t] = last_out
        else:
            seg = len(steps)
            if last_out >= 0:
                stat_src[t], dyn_src[t] = last_stat, last_out
            else:
                last_stat = -1
    return (np.asarray(steps, np.int64), np.asarray(wins, np.int64).reshape(-1, window),
            stat_src, dyn_src)


def expand(rows: np.ndarray, src: np.ndarray, width: int) -> np.ndarray:
    out = np.zeros((len(src), width), np.float32)
    m = src >= 0
    if rows.size:
        out[m] = rows[src[m]]
    return out


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def audio_windows(n: int, sr: int = 16000, window_s: float = 4.0, step_s: float = 0.5):
    """(start, end) of each window: starts 0, step, ... up to n inclusive."""
    window, step = int(window_s * sr), int(step_s * sr)
    return [(s, min(s + window, n)) for s in range(0, n + 1, step)]


def window_rows(spans, sr: int, fps: float):
    """(frame of each row, window of each row): window [s, e) covers frames
    round(s / sr * fps) .. round(e / sr * fps + 1) - 1."""
    frames, wins = [], []
    for wi, (s, e) in enumerate(spans):
        names = list(range(round(s / sr * fps), round(e / sr * fps + 1)))
        frames += names
        wins += [wi] * len(names)
    return np.asarray(frames, np.int64), np.asarray(wins, np.int64)


def cut_windows(wav: torch.Tensor, spans, window: int) -> torch.Tensor:
    """[W, window] windows, the part past the clip filled with the
    window's mean, an empty window all zeros."""
    out = torch.zeros(len(spans), window, dtype=torch.float32, device=wav.device)
    for i, (s, e) in enumerate(spans):
        if e > s:
            seg = wav[s:e]
            out[i, : e - s] = seg
            out[i, e - s:] = seg.mean()
    return out


def normalise(x: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(((x - mean) ** 2).mean(dim=-1, keepdim=True) + eps)


def frame_audio(logits: np.ndarray, frames: np.ndarray, wins: np.ndarray, n: int) -> np.ndarray:
    """Per-frame logits: the mean over the windows covering a frame; frames
    past the last covered one hold it."""
    keep = frames < n
    sums = np.zeros((n, logits.shape[1]))
    counts = np.zeros(n)
    np.add.at(sums, frames[keep], logits[wins[keep]])
    np.add.at(counts, frames[keep], 1.0)
    out = np.zeros((n, logits.shape[1]), np.float32)
    cov = counts > 0
    out[cov] = sums[cov] / counts[cov, None]
    if cov.any() and not cov.all():
        last = np.flatnonzero(cov).max()
        out[last + 1:] = out[last]
    return out


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------

def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def fuse(stat: np.ndarray, dyn: np.ndarray, audio: np.ndarray) -> np.ndarray:
    """Static probabilities and dynamic logits [T, 7] (video order) and audio
    logits [T, >= 7] (fusion order) -> the fused basic-emotion
    probabilities [T, 7] (fusion order): each stream's probabilities times
    the published weights, summed."""
    perm = list(VIDEO_TO_FUSION)
    preds = np.stack([stat[:, perm].astype(np.float64), softmax(dyn[:, perm].astype(np.float64)),
                      softmax(audio[:, :7].astype(np.float64))])
    return (preds * AV_WEIGHTS[:, None, :]).sum(axis=0)


def compound(fused: np.ndarray) -> np.ndarray:
    """Fused probabilities -> AV compound probabilities [T, 7]: Rule 1 masks
    a basic emotion at or below 1/7, a compound sums its pair."""
    masked = np.where(fused > 1.0 / 7.0, fused, 0.0)
    i1, i2 = np.asarray(COMPOUND_PAIRS).T
    return masked[:, i1] + masked[:, i2]
