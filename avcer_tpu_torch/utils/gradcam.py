"""Grad-CAM heatmaps of the static emotion CNN (avcer_tpu/utils/gradcam.py;
the reference's data/utils.py:92-112 and get_prob_video.py:131-152): the
gradient of the chosen class's softmax probability with respect to layer4's
activation, pooled per channel, weights that activation; the channel mean,
ReLU'd and divided by its maximum, is the mask, and ``render_heatmap`` lays
it over the crop.

Everything after layer4 is mean -> fc1 -> ReLU -> fc2 -> softmax, so the
gradient comes from ``torch.autograd.grad`` through that head alone, in f32,
batched over crops: no backward pass through the backbone, so the fused
kernels need none.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def gradcam_masks(act4: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear,
                  class_idx: torch.Tensor | np.ndarray) -> torch.Tensor:
    """Layer4 activations [B, C, h, w] (the model's NCHW) -> [B, h, w] masks
    in [0, 1]. ``class_idx`` [B]: the class each crop's gradient is taken
    of. The gradient of the probabilities summed over the batch is each
    crop's own, as no crop's probability depends on another's activation.
    Safe to call inside ``torch.inference_mode``: it leaves it."""
    with torch.inference_mode(False), torch.enable_grad():
        a = act4.float().clone().requires_grad_(True)
        idx = torch.as_tensor(np.asarray(class_idx), dtype=torch.long, device=a.device)
        w1, b1 = fc1.weight.float(), fc1.bias.float()
        w2, b2 = fc2.weight.float(), fc2.bias.float()
        logits = F.linear(F.relu(F.linear(a.mean(dim=(2, 3)), w1, b1)), w2, b2)
        prob = torch.softmax(logits, dim=-1).gather(1, idx[:, None]).sum()
        (grads,) = torch.autograd.grad(prob, a)
        # the reference pools the gradient over (batch, h, w) of a
        # one-crop batch: here per crop over (h, w)
        heat = (a.detach() * grads.mean(dim=(2, 3))[:, :, None, None]).mean(dim=1).clamp_min(0.0)
        return heat / heat.amax(dim=(1, 2), keepdim=True).clamp_min(1e-12)


def render_heatmap(mask: np.ndarray, face_bgr: np.ndarray, use_rgb: bool = False,
                   image_weight: float = 0.6) -> np.ndarray:
    """The mask [h, w] and the uint8 crop [H, W, 3], both resized to 224 by
    cv2, as one overlay (data/utils.py:100-112)."""
    import cv2

    from avcer_tpu_torch.utils.viz import show_cam_on_image

    heat = cv2.resize(np.asarray(mask, np.float32), (224, 224))
    face = cv2.resize(face_bgr, (224, 224)).astype(np.float32) / 255.0
    return show_cam_on_image(face, heat, use_rgb=use_rgb, image_weight=image_weight)
