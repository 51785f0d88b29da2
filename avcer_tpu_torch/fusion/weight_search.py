"""Fusion-weight optimisation (avcer_tpu/fusion/weight_search.py): Dirichlet
sampling and grid search over the weights of the three probability streams.

- Dirichlet search: 10,000 draws of [M, C] weights (np.random.dirichlet with
  alpha = 1 per class, transposed), keep the best fusion metric (the
  reference's data/utils.py:138-163, seeded 42 at get_pred_av.py:339).
- 2-way / 3-way grid search over np.arange(.01, .5, .05) (data/utils.py:166-209).
- The metric: macro precision / F1 / recall over classes 1..6; selection by
  recall (UAR), the earliest candidate with a strictly greater UAR.

The candidates are drawn on the host (``dirichlet_weights``, the JAX
package's ``RandomState`` draw order, so they are equal bit for bit) and
evaluated a chunk at a time on ``device``:

- the M <= 3 weighted sum is an f32 multiply, then an add, per stream, each
  rounded on its own: no matrix product, so no TF32 setting reaches it, and
  the card and the CPU give the same bits;
- the confusion counts come from integer indices (``torch.bincount`` of
  ``w * C^2 + t * C + p``), exact, with no [W, N, C] one-hot;
- recall, precision and F1 are f32 per class in the JAX package's order, then
  summed over classes 1..6 one class after another and divided by a tensor
  (a true division on the card too).

So a chunk's UARs do not depend on the device, and the selection does not
depend on the chunk size.
"""

from __future__ import annotations

import numpy as np
import torch

#: bytes one candidate holds at once per frame and class: the fused sum and
#: one product in f32
_BYTES_PER_ELEMENT = 8
#: per candidate and frame: the int64 argmax and the int64 count index
_BYTES_PER_FRAME = 16


def dirichlet_weights(
    num_weights: int, num_models: int, num_classes: int, seed: int = 42
) -> np.ndarray:
    """[W, M, C] candidates replicating np.random.dirichlet draw order
    (data/utils.py:141-145: per candidate, dirichlet(size=num_classes).T)."""
    rs = np.random.RandomState(seed)
    out = np.empty((num_weights, num_models, num_classes))
    for i in range(num_weights):
        out[i] = rs.dirichlet(alpha=np.ones(num_models), size=num_classes).T
    return out


def _class_mean(x: torch.Tensor, first: int, last: int) -> torch.Tensor:
    """Mean of x[:, first..last], summed one class after another."""
    total = x[:, first]
    for c in range(first + 1, last + 1):
        total = total + x[:, c]
    return total / total.new_full((1,), float(last - first + 1))


@torch.inference_mode()
def evaluate_candidates(
    preds: torch.Tensor,  # [M, N, C] f32 per-model probabilities
    labels: torch.Tensor,  # [N] int
    weights: torch.Tensor,  # [W, M, C] f32 candidate weight tensors
    num_classes: int = 7,
    first_class: int = 1,
    last_class: int = 6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For every candidate: fuse, argmax, macro precision/F1/UAR over classes
    [first_class..last_class]. Returns (uar [W], f1 [W], precision [W]) on
    the inputs' device."""
    c = num_classes
    w = weights.shape[0]
    fused = preds[0][None] * weights[:, 0, None, :]  # [W, N, C]
    for m in range(1, preds.shape[0]):
        fused += preds[m][None] * weights[:, m, None, :]
    pred_cls = fused.argmax(dim=-1)  # [W, N], ties to the first class
    del fused
    offset = torch.arange(w, device=preds.device)[:, None] * (c * c)
    index = offset + labels.long()[None, :] * c + pred_cls
    conf = torch.bincount(index.reshape(-1), minlength=w * c * c).reshape(w, c, c).float()
    tp = torch.diagonal(conf, dim1=1, dim2=2)  # [W, C]
    support = conf.sum(dim=2)
    predicted = conf.sum(dim=1)
    zero = conf.new_zeros(())
    recall = torch.where(support > 0, tp / support.clamp_min(1), zero)
    precision = torch.where(predicted > 0, tp / predicted.clamp_min(1), zero)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall / denom.clamp_min(1e-12), zero)
    return tuple(_class_mean(x, first_class, last_class) for x in (recall, f1, precision))


def _chunk_for(chunk: int, n: int, c: int, device: torch.device) -> int:
    """``chunk``, made smaller where the card's free memory would not hold a
    chunk's intermediates (the selection does not depend on the chunk)."""
    if device.type != "cuda":
        return chunk
    free, _ = torch.cuda.mem_get_info(device)
    per_candidate = n * (c * _BYTES_PER_ELEMENT + _BYTES_PER_FRAME)
    return max(1, min(chunk, int(0.8 * free) // per_candidate))


def _search(labels: np.ndarray, predictions, weights: np.ndarray, num_classes: int,
            chunk: int, device) -> tuple[int, float]:
    """(index of the earliest candidate with the greatest UAR, that UAR)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    preds = torch.as_tensor(np.stack(predictions).astype(np.float32), device=device)
    labels_t = torch.as_tensor(np.asarray(labels, np.int64), device=device)
    chunk = _chunk_for(chunk, preds.shape[1], num_classes, device)
    best_metric, best_idx = -1.0, 0
    for s in range(0, len(weights), chunk):
        w = torch.as_tensor(weights[s:s + chunk].astype(np.float32), device=device)
        uar = evaluate_candidates(preds, labels_t, w, num_classes=num_classes)[0]
        i = int(uar.argmax())
        value = float(uar[i])
        if value > best_metric:
            best_metric, best_idx = value, s + i
    return best_idx, best_metric


def search_dirichlet(
    ground_truth: np.ndarray,
    predictions: list[np.ndarray],  # list of [N, C]
    num_weights: int = 10_000,
    num_classes: int | None = None,
    seed: int = 42,
    chunk: int = 1024,
    device: torch.device | str = "cuda",
) -> tuple[np.ndarray, float]:
    """get_weights_prob_model equivalent. Returns (best [M, C] weights,
    best UAR). Selection ties resolve to the earliest candidate with a
    strictly greater metric, as the reference's ``>`` update does."""
    c = predictions[0].shape[-1] if num_classes is None else num_classes
    cands = dirichlet_weights(num_weights, len(predictions), c, seed)
    best_idx, best_metric = _search(ground_truth, predictions, cands, c, chunk, device)
    return cands[best_idx], best_metric


def search_grid(
    ground_truth: np.ndarray,
    predictions: list[np.ndarray],
    grid: np.ndarray | None = None,
    device: torch.device | str = "cuda",
) -> tuple[list[float], float]:
    """get_weights_v_model / get_weights_av_model equivalent: exhaustive
    scalar-weight grid over arange(.01, .5, .05) for 2 or 3 models
    (data/utils.py:166-209), evaluated as candidate tensors."""
    grid = np.arange(0.01, 0.5, 0.05) if grid is None else np.asarray(grid)
    m = len(predictions)
    combos = np.stack(np.meshgrid(*([grid] * m), indexing="ij"), axis=-1).reshape(-1, m)
    c = predictions[0].shape[-1]
    weights = np.repeat(combos[:, :, None], c, axis=2)  # scalar per model
    best_idx, best_metric = _search(ground_truth, predictions, weights, c, 4096, device)
    return combos[best_idx].tolist(), best_metric
