"""Result visualisation (avcer_tpu/utils/viz.py), the part the ported path
draws: the per-frame compound-prediction plot that ``Pipeline.save_outputs``
writes (the reference's visualization/visualize.py:175-215). Rendered with
matplotlib on the host; confusion and weight matrices and the CAM overlay
come with the modules that use them.
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
