"""Plot the published fusion weight matrices (avcer_tpu/cli/plot_weights.py),
the reference's get_weights_matrices.py:5-72 equivalent; needs matplotlib:

    python -m avcer_tpu_torch.cli.plot_weights [--out_dir DIR] [--device cuda]

The plots are host work; ``--device`` is the port's common flag, and
``cuda`` (the default) raises where CUDA is unavailable, as every entry point
of the port does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from avcer_tpu_torch.core import registry
from avcer_tpu_torch.utils import viz


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out_dir", default="report/weights_matrices")
    p.add_argument("--device", default="cuda",
                   help="'cuda' raises if CUDA is unavailable")
    a = p.parse_args(argv)
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    os.makedirs(a.out_dir, exist_ok=True)
    emo8 = list(registry.AUDIO_EMOTIONS_7) + ["Mouth open"]
    viz.plot_weights_matrix(
        registry.AV_WEIGHTS_8CL,
        row_labels=["Static visual", "Dynamic visual", "Audio"],
        save_path=os.path.join(a.out_dir, "weights_av_8cl.pdf"),
        title="AV fusion weights (Dirichlet-optimized, 8-cl audio front-end)",
    )
    viz.plot_weights_matrix(
        registry.V_WEIGHTS.T, row_labels=["VS", "VD"], col_labels=emo8,
        save_path=os.path.join(a.out_dir, "weights_video.pdf"),
        title="Weights for video modality fusion",
    )
    viz.plot_weights_matrix(
        registry.AV_WEIGHTS_7CL.T, row_labels=["VS", "VD", "A"], col_labels=emo8,
        save_path=os.path.join(a.out_dir, "weights_av_7cl.pdf"),
        title="Weights for audio (7cl) and video modality fusion",
    )
    # Rule-2 pair weights as a matrix for reference
    w1, w2 = registry.rule2_pair_weights()
    viz.plot_weights_matrix(
        np.stack([w1, w2]),
        row_labels=["w1 (emotion 1)", "w2 (emotion 2)"],
        col_labels=list(registry.COMPOUND_NAMES),
        save_path=os.path.join(a.out_dir, "rule2_pair_weights.pdf"),
        title="Rule 2 pair-normalized prior weights",
    )
    print(f"wrote weight matrices to {a.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
