"""Result visualisation (avcer_tpu/utils/viz.py), the parts the ported paths
draw: the per-frame compound-prediction plot that ``Pipeline.save_outputs``
writes (the reference's visualization/visualize.py:175-215), rendered with
matplotlib, and the Grad-CAM overlay of ``--heatmaps`` (visualize.py:218-253),
with cv2. Confusion and weight matrices come with the modules that use them.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from avcer_tpu_torch.core import registry


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_compound_expression_prediction(
    preds: Mapping[str, np.ndarray],
    save_path: Optional[str] = None,
    title: str = "Compound expressions predicted by models",
):
    """Per-frame step plot of compound class ids per model
    (visualize.py:175-215 capability)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(12, 4))
    for name, series in preds.items():
        ax.plot(np.asarray(series), label=name, linewidth=1.2, alpha=0.85,
                drawstyle="steps-post")
    ax.set_yticks(range(len(registry.COMPOUND_NAMES)))
    ax.set_yticklabels(registry.COMPOUND_NAMES, fontsize=8)
    ax.set_xlabel("frame")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def show_cam_on_image(
    img: np.ndarray,  # float32 [H, W, 3] in [0, 1]
    mask: np.ndarray,  # float32 [H, W] in [0, 1]
    use_rgb: bool = False,
    colormap: int = 2,  # cv2.COLORMAP_JET
    image_weight: float = 0.5,
) -> np.ndarray:
    """Grad-CAM overlay: the mask colour-mapped, blended with the image,
    returned as uint8."""
    import cv2

    heatmap = cv2.applyColorMap(np.uint8(255 * mask), colormap)
    if use_rgb:
        heatmap = cv2.cvtColor(heatmap, cv2.COLOR_BGR2RGB)
    heatmap = np.float32(heatmap) / 255
    if np.max(img) > 1:
        raise ValueError("show_cam_on_image expects img in [0, 1]")
    cam = image_weight * img + (1 - image_weight) * heatmap
    cam = cam / np.max(cam)
    return np.uint8(255 * cam)
