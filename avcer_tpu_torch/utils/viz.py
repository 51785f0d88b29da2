"""Result visualisation (avcer_tpu/utils/viz.py): the confusion matrix of
the offline evaluation and the fusion weight matrices (the reference's
visualization/visualize.py:10-85 and 88-172), the per-frame
compound-prediction plot that ``Pipeline.save_outputs`` writes
(visualize.py:175-215), all rendered with matplotlib, and the Grad-CAM
overlay of ``--heatmaps`` (visualize.py:218-253), with cv2.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np

from avcer_tpu_torch.core import registry


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_conf_matrix(
    cm: np.ndarray,
    labels: Sequence[str],
    save_path: Optional[str] = None,
    title: str = "Confusion matrix",
    normalize: bool = True,
):
    plt = _plt()
    cm = np.asarray(cm, dtype=np.float64)
    if normalize:
        with np.errstate(invalid="ignore", divide="ignore"):
            cm = cm / cm.sum(axis=1, keepdims=True)
        cm = np.nan_to_num(cm)
    fig, ax = plt.subplots(figsize=(max(6, len(labels)), max(5, len(labels) * 0.9)))
    im = ax.imshow(cm, interpolation="nearest", cmap="Blues", vmin=0)
    fig.colorbar(im, ax=ax)
    ax.set(
        xticks=range(len(labels)), yticks=range(len(labels)),
        xticklabels=labels, yticklabels=labels,
        ylabel="True label", xlabel="Predicted label", title=title,
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    thresh = cm.max() / 2.0 if cm.size else 0.5
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(
                j, i, f"{cm[i, j]:.2f}", ha="center", va="center",
                color="white" if cm[i, j] > thresh else "black", fontsize=8,
            )
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


def plot_weights_matrix(
    weights: np.ndarray,
    row_labels: Sequence[str],
    col_labels: Sequence[str] = registry.AUDIO_EMOTIONS_7,
    save_path: Optional[str] = None,
    title: str = "Fusion weights",
):
    plt = _plt()
    weights = np.asarray(weights, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(1.2 * len(col_labels), 1.0 * len(row_labels) + 1.5))
    im = ax.imshow(weights, cmap="viridis")
    fig.colorbar(im, ax=ax, fraction=0.03)
    ax.set(
        xticks=range(len(col_labels)), yticks=range(len(row_labels)),
        xticklabels=col_labels, yticklabels=row_labels, title=title,
    )
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
    for i in range(weights.shape[0]):
        for j in range(weights.shape[1]):
            ax.text(j, i, f"{weights[i, j]:.2f}", ha="center", va="center",
                    color="white", fontsize=8)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=150)
        plt.close(fig)
        return None
    return fig


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
