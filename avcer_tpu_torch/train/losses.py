"""Training losses (avcer_tpu/train/losses.py) in PyTorch, with the JAX
package's arithmetic: every loss upcasts to f32 first.

- ``weighted_cross_entropy``: ``nn.CrossEntropyLoss(weight, label_smoothing)``
  semantics, the mean normalised by the sum of the samples' class weights;
- ``focal_loss`` (hard targets), ``soft_focal_loss`` (clip 1e-7, sum over
  classes, mean over the batch) and ``soft_focal_loss_onehot``;
- ``ccc_loss`` (1 - mean CCC over output dims, biased variances) and
  ``mse_loss`` for the regression task;
- ``mixup_batch``: one Beta(alpha, alpha) lambda a batch and a shuffled
  pairing, both drawn from an explicit ``torch.Generator`` (or handed in).

``tests/test_torch_train.py`` holds each against the JAX function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: Optional[torch.Tensor] = None,
                           label_smoothing: float = 0.0) -> torch.Tensor:
    """logits [B, C], labels [B] int: the smoothed target ``onehot * (1 -
    ls) + ls / C``; with weights, ``sum_i -sum_c q_c w_c logp_c`` over
    ``sum_i w[y_i]``."""
    c = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), c).float()
    target = onehot * (1.0 - label_smoothing) + label_smoothing / c
    if class_weights is None:
        return (-target * logp).sum(-1).mean()
    w = class_weights.float()
    per_sample = -(target * w[None, :] * logp).sum(-1)
    return per_sample.sum() / w[labels.long()].sum()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor,
               alpha: Optional[torch.Tensor] = None, gamma: float = 0.0,
               reduction: str = "mean") -> torch.Tensor:
    """``-alpha_y (1 - p_y)^gamma log p_y``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    log_pt = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    ce = -log_pt
    if alpha is not None:
        ce = ce * alpha.float()[labels.long()]
    loss = (1.0 - torch.exp(log_pt)) ** gamma * ce
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def soft_focal_loss(logits_or_probs: torch.Tensor, soft_targets: torch.Tensor,
                    alpha: Optional[torch.Tensor] = None, gamma: float = 0.0,
                    apply_softmax: bool = True) -> torch.Tensor:
    p = (torch.softmax(logits_or_probs.float(), dim=-1) if apply_softmax
         else logits_or_probs.float())
    eps = 1e-7
    p = torch.clamp(p, eps, 1.0 - eps)
    ce = -soft_targets.float() * torch.log(p)
    a = 1.0 if alpha is None else alpha.float()
    return (a * (1.0 - p) ** gamma * ce).sum(-1).mean()


def soft_focal_loss_onehot(logits: torch.Tensor, labels: torch.Tensor, num_classes: int,
                           alpha: Optional[torch.Tensor] = None,
                           gamma: float = 0.0) -> torch.Tensor:
    onehot = F.one_hot(labels.long(), num_classes).float()
    return soft_focal_loss(logits, onehot, alpha=alpha, gamma=gamma)


def ccc_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred, target [B, D]: ``1 - mean_d CCC_d``."""
    pred, target = pred.float(), target.float()
    pm, tm = pred.mean(0), target.mean(0)
    pv, tv = pred.var(0, unbiased=False), target.var(0, unbiased=False)
    cov = ((pred - pm) * (target - tm)).mean(0)
    ccc = 2 * cov / (pv + tv + (pm - tm) ** 2 + 1e-8)
    return 1.0 - ccc.mean()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred.float() - target.float()) ** 2)


def mixup_batch(generator: Optional[torch.Generator], x: torch.Tensor, alpha: float,
                lam: Optional[float] = None, perm: Optional[torch.Tensor] = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mixed x, permutation, lambda) with ``mixed = lam * x + (1 - lam) *
    x[perm]`` in f32. ``lam`` ~ Beta(alpha, alpha) and ``perm`` a random
    permutation of the batch, both from ``generator`` (on ``x``'s device)
    unless handed in: torch's Beta sampler takes no generator, so a seed
    drawn from ``generator`` seeds numpy's."""
    if lam is None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                 device=generator.device).item())
        lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    if perm is None:
        perm = torch.randperm(x.shape[0], generator=generator, device=generator.device)
    perm = perm.to(x.device)
    lam_t = torch.tensor(lam, dtype=torch.float32, device=x.device)
    return lam_t * x + (1.0 - lam_t) * x[perm], perm, lam_t
