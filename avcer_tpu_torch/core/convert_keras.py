"""Keras ``.h5`` -> the port's state dicts for the legacy EMO-AffectNet visual
models (avcer_tpu/core/convert_keras.py).

Keras save_weights layout: one group per layer, attr ``weight_names`` listing
datasets like ``lstm_1/lstm_cell/kernel:0``. Keras LSTM kernels are ``[in,
4H]`` with the gates in the order (i, f, c, o) and a single bias, torch's
gate order; the port's ``TemporalLSTM`` takes ``weight_ih`` as ``[4H, in]``
and a zero hh bias. The backbone maps keras_vggface's ResNet50 layer names
(``conv1/7x7_s2``, ``conv{s}_{b}_1x1_reduce`` / ``_3x3`` / ``_1x1_increase``
and ``_proj``, each with ``/bn``) and the feature head (``features``,
``dense``) onto ``EmotionResNet50``, by structure, best effort as in the JAX
package. Both read the ``.h5`` into the JAX package's variable layout (numpy)
and hand it to ``core.convert``'s walkers; h5py is imported where a file is
read.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from avcer_tpu_torch.core import convert


def _names(attr) -> list[str]:
    return [n.decode() if isinstance(n, bytes) else n for n in attr]


def _layer_weights(h5file, layer_name: str) -> list[np.ndarray]:
    g = h5file[layer_name] if layer_name in h5file else h5file
    return [np.asarray(g[n]) for n in _names(g.attrs.get("weight_names", []))]


def keras_lstm_variables(path: str) -> dict[str, Any]:
    """The ``.h5``'s two LSTMs and last dense layer in the JAX package's
    ``TemporalLSTM`` variable layout."""
    import h5py

    params: dict[str, Any] = {}
    with h5py.File(path, "r") as f:
        layer_names = _names(f.attrs.get("layer_names", []))
        lstm_layers = [n for n in layer_names if "lstm" in n.lower()]
        dense_layers = [n for n in layer_names if "dense" in n.lower()]
        for i, lname in enumerate(lstm_layers[:2]):
            kernel, recurrent, bias = _layer_weights(f, lname)[:3]
            params[f"lstm{i + 1}"] = {"cell": {
                "ih": {"kernel": kernel.astype(np.float32), "bias": bias.astype(np.float32)},
                "hh": {"kernel": recurrent.astype(np.float32),
                       "bias": np.zeros(bias.shape, np.float32)}}}
        if dense_layers:
            dk, db = _layer_weights(f, dense_layers[-1])[:2]
            params["fc"] = {"kernel": dk.astype(np.float32), "bias": db.astype(np.float32)}
    return {"params": params}


def convert_keras_lstm(path: str) -> dict[str, torch.Tensor]:
    """Keras LSTM ``.h5`` (save_weights format) -> ``TemporalLSTM`` state dict."""
    return convert.temporal_lstm(keras_lstm_variables(path))


def keras_backbone_variables(path: str) -> dict[str, Any]:
    """The keras_vggface ResNet50 and feature head of the ``.h5`` in the JAX
    package's ``EmotionResNet50`` variable layout."""
    import h5py

    def conv_entry(w, b=None):
        e = {"kernel": np.asarray(w, np.float32)}
        if b is not None:
            e["bias"] = np.asarray(b, np.float32)
        return e

    def bn_entry(weights):
        gamma, beta, mean, var = (np.asarray(x, np.float32) for x in weights[:4])
        return {"scale": gamma, "bias": beta}, {"mean": mean, "var": var}

    params: dict[str, Any] = {}
    stats: dict[str, Any] = {}
    with h5py.File(path, "r") as f:
        layer_names = _names(f.attrs.get("layer_names", []))

        def w(name):
            return _layer_weights(f, name)

        if "conv1/7x7_s2" in layer_names:
            params["conv_stem"] = conv_entry(*w("conv1/7x7_s2"))
            params["batch_norm1"], stats["batch_norm1"] = bn_entry(w("conv1/7x7_s2/bn"))
            for stage, nblocks in enumerate((3, 4, 6, 3), start=2):
                for b in range(1, nblocks + 1):
                    fp = f"layer{stage - 1}_{b - 1}"
                    params[fp], stats[fp] = {}, {}
                    for kname, cname, bnname in (
                            (f"conv{stage}_{b}_1x1_reduce", "conv1", "batch_norm1"),
                            (f"conv{stage}_{b}_3x3", "conv2", "batch_norm2"),
                            (f"conv{stage}_{b}_1x1_increase", "conv3", "batch_norm3")):
                        params[fp][cname] = conv_entry(*w(kname))
                        params[fp][bnname], stats[fp][bnname] = bn_entry(w(f"{kname}/bn"))
                    proj = f"conv{stage}_{b}_1x1_proj"
                    if proj in layer_names:
                        params[fp]["downsample_conv"] = conv_entry(*w(proj))
                        params[fp]["downsample_bn"], stats[fp]["downsample_bn"] = bn_entry(
                            w(f"{proj}/bn"))
        for lname, target in (("features", "fc1"), ("dense", "fc2")):
            cand = [n for n in layer_names if n == lname or n.startswith(lname)]
            if cand:
                dk, db = w(cand[0])[:2]
                params[target] = {"kernel": np.asarray(dk, np.float32),
                                  "bias": np.asarray(db, np.float32)}
    return {"params": params, "batch_stats": stats}


def convert_keras_backbone(path: str) -> dict[str, torch.Tensor]:
    """keras_vggface ResNet50 (+ feature head) ``.h5`` -> ``EmotionResNet50``
    state dict (conv biases, which the model has none of, are left out)."""
    return convert.emotion_resnet50(keras_backbone_variables(path))
