"""The comparison that decides ``correct``: what the timed path produced for
a sample of the window's clips against the plain reference
(``reference.clip.Reference``) on the same frames, face boxes, wav and
weights.

The numbers read (a cell compares those its ``limits/<workload>.json``
names, each against its limit; the others are printed as readings):

- ``det_topk_gap`` / ``det_topk_rms``: detect, the widest / the root mean
  square gap between the program's 64 candidate scores of a frame and the
  reference's 64 best, both sorted;
- ``det_regress_gap`` / ``det_regress_med``: detect, for each program
  candidate the anchor of its frame whose regressions come nearest to those
  that decode to the candidate's box and landmarks (centre and landmark
  offsets over a tenth of the anchor's size, log sizes over 0.2), the
  largest gap of the 14 from the reference's at that anchor: the widest /
  the median over the candidates;
- ``static_prob_gap``: visual, the widest gap of a frame's static
  probability;
- ``static_feat_gap``: visual, the widest gap of a computed crop's 512
  features, over the reference's largest feature of the clip;
- ``dynamic_logit_gap`` / ``dynamic_logit_rms``: visual, the widest gap of
  a frame's LSTM logit over the reference's largest / the root mean square
  gap over the reference's;
- ``audio_logit_gap`` / ``audio_logit_rms``: audio, the widest gap of a
  window's logit over the reference's largest / the root mean square gap
  over the reference's;
- ``fusion_prob_gap``: fusion, the widest gap of a compound probability,
  over the compound classes whose two basic emotions' fused probabilities
  lie more than ``RULE1_MARGIN`` from Rule 1's threshold in the reference
  (nearer, the mask turns on rounding and the probability jumps);
- ``fusion_decision_gap``: fusion, the widest amount by which the compound
  class the program decided lies below the reference's best, in the
  reference's probabilities (a near-tie decided either way reads 0);
- ``fusion_step_prob_gap`` / ``fusion_step_decision_gap``: the fusion step
  alone, followed from the program's own static probabilities, dynamic
  logits and audio logits (the reference's fusion in float64 on them): the
  widest gap of a compound probability, and the widest amount by which a
  decision lies below the best (leaving out, as above, what lies within
  ``STEP_MARGIN`` of Rule 1's threshold).

A number the program cannot produce (a clip without results, rows missing)
reads infinity.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import pipeline as P
from perfbench.reference.clip import Reference

NUMBERS = ("det_topk_gap", "det_topk_rms", "det_regress_gap", "det_regress_med",
           "static_prob_gap", "static_feat_gap", "dynamic_logit_gap", "dynamic_logit_rms",
           "audio_logit_gap", "audio_logit_rms", "fusion_prob_gap", "fusion_decision_gap", "fusion_step_prob_gap",
           "fusion_step_decision_gap")
#: fused probabilities this close to Rule 1's threshold (1/7) may be masked
#: on one side and not the other after any rounding: they are left out of the
#: fusion numbers
RULE1_MARGIN = 0.05
#: the same for the fusion step, followed from the program's own inputs:
#: only float32 rounding apart, so a far smaller margin
STEP_MARGIN = 1e-4


def sample(records: list, n: int, seed: int) -> list:
    """``n`` of the window's finished clips drawn from the seed, one of the
    longest among them."""
    done = [r for r in records if r["served"] is not None]
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (2 ** 63), 1])
    longest = max(r["clip"].seconds for r in done)
    first = rng.choice([i for i, r in enumerate(done) if r["clip"].seconds == longest])
    rest = [i for i in range(len(done)) if i != first]
    more = rng.choice(rest, size=min(n - 1, len(rest)), replace=False) if n > 1 else []
    return [done[i] for i in [first, *sorted(int(i) for i in more)]]


def worse(a: float, b: float) -> float:
    """The larger of two readings; not-a-number reads infinity."""
    return float("inf") if a != a or b != b else max(a, b)


def rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    return float(np.abs(got - want).max() / max(float(np.abs(want).max()), 1e-30))


def rms(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    if got.size == 0:
        return 0.0
    return float(np.sqrt(((got - want) ** 2).mean() / max(float((want ** 2).mean()), 1e-30)))


def gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if got.size else 0.0


class Detections:
    """Compares the program's packed detections with the reference's, block
    by block, as the reference produces them."""

    def __init__(self, packed: list, batch: int, stride: int, device):
        self.rows = np.concatenate(packed) if packed else np.zeros((0, 64, 16), np.float32)
        self.batch, self.stride, self.device = batch, stride, device
        self.topk = 0.0
        self.regress = 0.0
        self.sq = 0.0
        self.n = 0
        self.per_candidate: list = []

    def __call__(self, frames: np.ndarray, boxes, landms, scores, raw, anchors) -> None:
        per = self.batch // self.stride
        row = (frames // self.batch) * per + (frames % self.batch) // self.stride
        if row.max() >= len(self.rows):
            self.topk = self.regress = self.sq = float("inf")
            return
        got = torch.from_numpy(self.rows[row]).to(self.device)
        k = got.shape[1]
        want_scores = torch.sort(scores, dim=1, descending=True).values
        got_scores = torch.sort(got[..., 4], dim=1, descending=True).values
        d = got_scores - want_scores[:, :k]
        self.topk = worse(self.topk, float(d.abs().max()))
        self.sq += float((d ** 2).sum())
        self.n += d.numel()
        g = regression_gap(got, raw, anchors)
        self.regress = worse(self.regress, float(g.max()))
        self.per_candidate.append(g.flatten().cpu().numpy())

    @property
    def rms(self) -> float:
        return float(np.sqrt(self.sq / max(self.n, 1)))

    @property
    def median(self) -> float:
        return float(np.median(np.concatenate(self.per_candidate))) if self.per_candidate else \
            float("inf")


def implied(candidates: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """The regressions [B, K, A, 14] that would decode, at each anchor, to
    the packed candidates' [B, K, 16] boxes and landmarks."""
    c = anchors[:, :2]
    s = anchors[:, 2:]
    box = candidates[..., 0:4]
    centre = (box[..., :2] + box[..., 2:]) / 2
    size = box[..., 2:] - box[..., :2]
    off = (centre[:, :, None, :] - c) / (0.1 * s)
    logs = torch.log(size[:, :, None, :] / s) / 0.2
    pts = candidates[..., 6:16].reshape(*candidates.shape[:2], 1, 5, 2)
    lm = ((pts - c[:, None, :]) / (0.1 * s[:, None, :])).flatten(-2)
    return torch.cat([off, logs, lm], -1)


def regression_gap(got: torch.Tensor, raw: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """[B, K]: each candidate's smallest largest-coordinate gap over the
    anchors (not-a-number where a box cannot decode from any anchor)."""
    best = torch.full(got.shape[:2], float("inf"), device=got.device)
    for a in range(0, anchors.shape[0], 1024):
        d = (implied(got, anchors[a:a + 1024]) - raw[:, None, a:a + 1024]).abs().amax(-1)
        best = torch.minimum(best, torch.nan_to_num(d, nan=float("inf")).amin(-1))
    return best


def compare(served, clip, ref: Reference, serving: dict) -> dict:
    """The numbers of one clip."""
    from perfbench.program import static_rows

    res = served.result
    det = Detections(served.packed, serving["det_batch"], serving["det_stride"], ref.device)
    want = ref.run(clip.frames, clip.boxes[::serving["det_stride"]], clip.wav, clip.fps,
                   on_detections=det)
    _, feats = static_rows(served.static)
    av = np.asarray(res.compound.av)
    prob = np.asarray(res.compound.av_prob)
    t = len(want["stat"])
    if prob.shape != want["av_prob"].shape or av.shape != (t,):
        fusion = dict.fromkeys(("fusion_prob_gap", "fusion_decision_gap",
                                "fusion_step_prob_gap", "fusion_step_decision_gap"),
                               float("inf"))
    else:
        far = np.abs(want["fused"] - 1.0 / 7.0) > RULE1_MARGIN  # [T, 7] fusion order
        i1, i2 = np.asarray(P.COMPOUND_PAIRS).T
        diff = np.abs(prob - want["av_prob"])[far[:, i1] & far[:, i2]]
        fused, step = step_fusion(res, clip)
        sure = np.abs(fused - 1.0 / 7.0) > STEP_MARGIN
        step_diff = np.abs(prob - step)[sure[:, i1] & sure[:, i2]]
        rows = sure.all(axis=1)
        fusion = {
            "fusion_prob_gap": float(diff.max()) if diff.size else 0.0,
            "fusion_decision_gap": decision_gap(want["av_prob"], av),
            "fusion_step_prob_gap": float(step_diff.max()) if step_diff.size else 0.0,
            "fusion_step_decision_gap": decision_gap(step[rows], av[rows]),
        }
    numbers = {
        "det_topk_gap": det.topk,
        "det_topk_rms": det.rms,
        "det_regress_gap": det.regress,
        "det_regress_med": det.median,
        "static_prob_gap": gap(np.asarray(res.stat_probs), want["stat"]),
        "static_feat_gap": rel(feats, want["feats"]),
        "dynamic_logit_gap": rel(np.asarray(res.dyn_logits), want["dyn"]),
        "dynamic_logit_rms": rms(np.asarray(res.dyn_logits), want["dyn"]),
        "audio_logit_gap": rel(np.asarray(res.audio_window_logits), want["audio_windows"]),
        "audio_logit_rms": rms(np.asarray(res.audio_window_logits), want["audio_windows"]),
        **fusion,
    }
    return {k: worse(v, v) for k, v in numbers.items()}


def decision_gap(probs: np.ndarray, decided: np.ndarray) -> float:
    """The widest amount by which the decided class lies below the best, in
    ``probs`` [T, K]."""
    if not len(probs):
        return 0.0
    return float((probs.max(axis=1) - probs[np.arange(len(probs)), decided]).max())


def step_fusion(res, clip, fuse=None) -> tuple[np.ndarray, np.ndarray]:
    """(fused basic-emotion probabilities, compound probabilities) of the
    program's own static probabilities, dynamic logits and audio window
    logits (the windows mapped to frames by the reference), by the
    reference's fusion (or ``fuse``)."""
    spans = P.audio_windows(len(clip.wav))
    frames, wins = P.window_rows(spans, 16000, clip.fps)
    t = len(np.asarray(res.stat_probs))
    audio = P.frame_audio(np.asarray(res.audio_window_logits, np.float64), frames, wins, t)
    fused = (fuse or P.fuse)(np.asarray(res.stat_probs), np.asarray(res.dyn_logits), audio)
    return fused, P.compound(fused)


def worst(per_clip: list) -> dict:
    return {k: max(c[k] for c in per_clip) for k in NUMBERS} if per_clip else {
        k: float("inf") for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number the cell compares (those its limits name) within its
    limit."""
    return bool(limits) and all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
                                for k in limits)
