"""The reference's answer for one clip: every layer the benchmark checks,
worked out from the clip's frames, its face boxes, its wav and the weights
alone, by the model families the configuration names for the pipeline's
roles, in float32, in blocks that fit beside nothing else on the device.

``quant`` (``models.Ctx``) puts a lower precision in the int8 positions: the
benchmark's control. This module imports nothing of the program it checks.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Optional

import numpy as np
import torch

from perfbench.reference import models as M
from perfbench.reference import pipeline as P


@contextmanager
def exact_float32():
    """float32 products without TF32 (restored on leaving)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


#: the pipeline's roles, each computed by the model family a configuration names
ROLES = ("detector", "static", "dynamic", "audio")


class Reference:
    """``weights``: {role: {name: float32 tensor on the device}};
    ``serving``: the configuration's serving switches (``long_side``,
    ``det_stride``, ``cnn_stride``, ``shared_extractor``, ``quant``: whether
    its stages are int8, which says where ``quant`` applies); ``families``:
    {role: ``models.Family``} of every role in ``ROLES``."""

    def __init__(self, weights: dict, serving: dict, families: dict,
                 quant: Optional[Callable] = None, block: int = 32):
        missing = set(ROLES) - set(families)
        if missing:
            raise ValueError(f"the configuration's models name no family for {sorted(missing)}")
        self.w = weights
        self.s = serving
        self.f = families
        self.quant = quant
        self.block = block

    def ctx(self, role: str) -> M.Ctx:
        return M.Ctx(self.w[role], quant=self.quant)

    # -- layers ------------------------------------------------------------

    def detector(self, wire: torch.Tensor):
        """Wire frames [B, h, w, 3] uint8 -> (boxes [B, A, 4], landmarks
        [B, A, 10] in bucket pixels, scores [B, A], the regressions they
        decode from [B, A, 14], the anchors [A, 4] (cx, cy, w, h) in bucket
        pixels)."""
        mean = torch.tensor(P.RETINAFACE_MEAN, device=wire.device)
        loc, conf, landms = self.f["detector"].forward(self.ctx("detector"), wire.float() - mean,
                                                       self.s["quant"])
        h, w = wire.shape[1:3]
        pri = P.priors(h, w, wire.device)
        boxes, pts = P.decode(loc, landms, pri, h, w)
        scale = torch.tensor([w, h, w, h], dtype=pri.dtype, device=pri.device)
        return boxes, pts, conf[..., 1], torch.cat([loc, landms], -1), pri * scale

    def cnn(self, crops: torch.Tensor):
        mean = torch.tensor(P.VGGFACE2_MEAN, device=crops.device)
        logits, feats = self.f["static"].forward(self.ctx("static"), crops.float() - mean,
                                                 self.s["quant"])
        return torch.softmax(logits, -1), feats

    def audio(self, wav: np.ndarray, fps: float, n_frames: int, batch: int = 16):
        """(window logits [W, classes], per-frame logits [T, classes])."""
        dev = self.device
        ctx = self.ctx("audio")
        fam = self.f["audio"]
        a, shape = fam.module, fam.shape
        q = self.s["quant"]
        spans = P.audio_windows(len(wav))
        window = 64000
        x = torch.from_numpy(np.asarray(wav, np.float32)).to(dev)
        rows: list = [None] * len(spans)
        full = [i for i, (s, e) in enumerate(spans) if e - s >= window]
        exact = list(range(len(spans))) if not self.s["shared_extractor"] else [
            i for i in range(len(spans)) if i not in set(full)]
        for k in range(0, len(exact), batch):
            idx = exact[k:k + batch]
            win = P.normalise(P.cut_windows(x, [spans[i] for i in idx], window))
            for i, r in zip(idx, fam.forward(ctx, win, q)):
                rows[i] = r
        if self.s["shared_extractor"] and full:
            # the clip normalised once; each full window reads its slice of
            # the clip's conv features
            padded = torch.cat([P.normalise(x), x.new_zeros(window + 1)])
            feats = a.features(ctx, padded[None], shape, q)[0]
            stride = a.hop(shape)
            nf = a.frames_per_window(window, shape)
            for k in range(0, len(full), batch):
                idx = full[k:k + batch]
                starts = torch.tensor([spans[i][0] // stride for i in idx], device=dev)
                f_idx = (starts[:, None] + torch.arange(nf, device=dev)[None]).clamp(
                    0, feats.shape[0] - 1)
                h = a.encode(ctx, feats[f_idx], shape, q)
                for i, r in zip(idx, a.head(ctx, h, shape)):
                    rows[i] = r
        out = torch.stack(rows).cpu().numpy()
        frames, wins = P.window_rows(spans, 16000, fps)
        return out, P.frame_audio(out, frames, wins, n_frames)

    @property
    def device(self):
        return next(iter(self.w["detector"].values())).device

    # -- a clip ------------------------------------------------------------

    @torch.no_grad()
    def run(self, frames: np.ndarray, det_boxes: np.ndarray, wav: np.ndarray, fps: float,
            on_detections: Optional[Callable] = None) -> dict:
        """``frames`` [T, H, W, 3] uint8 BGR, ``det_boxes`` [D, 4] the face's
        box (native pixels) in each detected frame (0, stride, ...), ``wav``
        float32 at 16 kHz. ``on_detections(frame_ids, boxes, landmarks,
        scores, regressions, anchors)`` receives each block's detections. Returns the static
        probabilities and features of the frames the CNN computes
        (``computed``), the per-frame static probabilities and dynamic logits,
        the audio logits per window and per frame, and the compound
        probabilities."""
        with exact_float32():
            return self._run(frames, det_boxes, wav, fps, on_detections)

    def _run(self, frames, det_boxes, wav, fps, on_detections) -> dict:
        dev = self.device
        t_total, h, w = frames.shape[:3]
        stride = self.s["det_stride"]
        nh, nw, scale = P.letterbox_size(h, w, self.s["long_side"])
        boxes = P.interpolate_boxes(np.asarray(det_boxes, np.float64), t_total, stride)
        present, lb = P.crop_boxes(boxes, w, h, scale, nh, nw)
        step = P.dynamic_step(fps)
        computed = P.cnn_frames(present, step, self.s["cnn_stride"])
        probs, feats = [], []
        for s in range(0, t_total, self.block):
            e = min(s + self.block, t_total)
            wire, _ = P.wire_frames(torch.from_numpy(frames[s:e]).to(dev), self.s["long_side"])
            det = np.arange(s, e)[np.arange(s, e) % stride == 0]
            if on_detections is not None and det.size:
                on_detections(det, *self.detector(wire[torch.from_numpy(det - s).to(dev)]))
            sel = computed[(computed >= s) & (computed < e)]
            for k in range(0, len(sel), 64):
                part = sel[k:k + 64]
                c = P.crops(wire[torch.from_numpy(part - s).to(dev)],
                            torch.from_numpy(lb[part]).to(dev))
                p, f = self.cnn(c)
                probs.append(p.cpu().numpy())
                feats.append(f.cpu().numpy())
        probs = np.concatenate(probs) if probs else np.zeros((0, 7), np.float32)
        feats = np.concatenate(feats) if feats else np.zeros((0, 512), np.float32)
        stat_p = P.hold_rows(computed, probs, present)
        feat_p = P.hold_rows(computed, feats, present)
        steps, wins, stat_src, dyn_src = P.temporal_plan(present, step)
        dyn_s = np.zeros((0, 7), np.float32)
        if len(steps):
            x = torch.from_numpy(feat_p[steps][wins]).to(dev)
            dyn_s = self.f["dynamic"].forward(self.ctx("dynamic"), x).cpu().numpy()
        stat = P.expand(stat_p, stat_src, 7)
        dyn = P.expand(dyn_s, dyn_src, 7)
        audio_w, audio_f = self.audio(wav, fps, t_total)
        fused = P.fuse(stat, dyn, audio_f)
        return dict(computed=computed, probs=probs, feats=feats, present=present, stat=stat,
                    dyn=dyn, audio_windows=audio_w, audio_frames=audio_f, fused=fused,
                    av_prob=P.compound(fused))

