"""Fusion and compound-expression ops (avcer_tpu/ops/fusion.py): the whole
decision for all T frames in a few tensor ops, in the JAX package's
operation order. Argmax ties resolve to the first index, as in JAX.
"""

from __future__ import annotations

import torch

from avcer_tpu_torch.core import registry


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shifted softmax as data/utils.py:125-127 (x - max, exp, divide)."""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def compound_probabilities(
    pred: torch.Tensor,  # [T, C>=7] fusion-order probabilities
    ce_weights_type: bool,
    ce_mask: bool,
) -> torch.Tensor:
    """[T, K] pair-wise compound probabilities with Rule 1 (mask <= 1/7)
    and/or Rule 2 (pair-normalised prior weights)."""
    i1, i2 = (torch.as_tensor(a, dtype=torch.long, device=pred.device)
              for a in registry.compound_index_arrays())
    if ce_weights_type:
        w1, w2 = (torch.as_tensor(w, dtype=pred.dtype, device=pred.device)
                  for w in registry.rule2_pair_weights())
    else:
        w1 = w2 = torch.ones(len(registry.COMPOUND_NAMES), dtype=pred.dtype,
                             device=pred.device)
    if ce_mask:
        pred = torch.where(pred > registry.RULE1_MASK_THRESHOLD, pred,
                           torch.zeros((), dtype=pred.dtype, device=pred.device))
    return pred[:, i1] * w1[None, :] + pred[:, i2] * w2[None, :]


def fused_compound_decision(
    stat: torch.Tensor,  # [T, 7] static visual probs (softmaxed), fusion order
    dyn_logits: torch.Tensor,  # [T, 7] dynamic visual logits, fusion order
    audio_logits: torch.Tensor,  # [T, 7] per-frame audio logits
    weights_1: torch.Tensor,  # [3, 7]
    weights_2: torch.Tensor,  # [3]
    ce_weights_type: bool = False,
    ce_mask: bool = True,
    use_weights: bool = True,
) -> dict[str, torch.Tensor]:
    """Per-modality and AV compound class ids [T] plus the AV compound
    probabilities [T, K] (run.py:104-165)."""
    preds = torch.stack([stat, softmax(dyn_logits), softmax(audio_logits)])
    if use_weights:
        scaled = preds * (weights_1 * weights_2[:, None])[:, None, :]
        fused = scaled[0] + scaled[1] + scaled[2]
    else:
        scaled = preds
        fused = preds.mean(dim=0)

    def decide(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        prob = compound_probabilities(p, ce_weights_type, ce_mask)
        return prob[:, :7].argmax(dim=1), prob

    av_ce, av_prob = decide(fused)
    return {
        "av": av_ce,
        "vs": decide(scaled[0])[0],
        "vd": decide(scaled[1])[0],
        "a": decide(scaled[2])[0],
        "av_prob": av_prob,
    }
