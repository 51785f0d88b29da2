"""JAX parameter trees -> the port's state dicts: the inverse of
avcer_tpu/core/convert.py.

Input is a variable tree of numpy arrays as the JAX package holds it
(``{"params": ..., "batch_stats": ...}``, e.g. ``jax.tree.map(np.asarray,
variables)``). Output is a ``{name: torch.Tensor}`` state dict in the
reference torch modules' names, which the port's modules load with
``load_state_dict(strict=True)``. Layouts: flax conv kernels are HWIO (or
LIO) and torch's OIHW (OIL); a flax Dense kernel is the transpose of a torch
Linear weight. The wav2vec2 positional conv arrives with its weight norm
already fused (avcer_tpu/core/convert.py:167).

``act_scales`` carries the calibrated int8 activation scales of a variable
tree (its ``"act_scales"`` collection, one ``amax`` per quantised conv or
dense) into ``{module path: amax}`` for ``models.layers.load_act_scales``,
under the same path-to-name mapping as the weights. A tree without that
collection gives ``None``: the modules stay uncalibrated.

``release_state_dict`` maps a reference checkpoint (a release file, see
``core.checkpoint``) onto the port's names, which are already the
reference's: it strips RetinaFace's and S3FD's ``module.`` prefix, fuses the
positional conv's weight norm, and drops, with a log line each, the keys the
JAX package's converter does not read either.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Mapping

import numpy as np
import torch

log = logging.getLogger("avcer_tpu_torch")

Tree = Mapping[str, Any]
StateDict = dict[str, torch.Tensor]


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


class _SD:
    """Accumulates torch-named tensors from a flax variable tree."""

    def __init__(self, variables: Tree):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self.scales = variables.get("act_scales")
        self.sd: StateDict = {}
        self.names: dict[str, str] = {}  # flax path of a conv or dense -> torch module path

    @staticmethod
    def _get(root: Tree, path: str) -> Any:
        for part in path.split("/"):
            root = root[part]
        return root

    def p(self, path: str) -> Tree:
        return self._get(self.params, path)

    def conv2d(self, path: str, name: str, bias: bool = False) -> None:
        node = self.p(path)
        self.names[path] = name
        self.sd[f"{name}.weight"] = _t(np.transpose(node["kernel"], (3, 2, 0, 1)))
        if bias:
            self.sd[f"{name}.bias"] = _t(node["bias"])

    def conv1d(self, path: str, name: str) -> None:
        node = self.p(path)
        self.names[path] = name
        self.sd[f"{name}.weight"] = _t(np.transpose(node["kernel"], (2, 1, 0)))
        if "bias" in node:
            self.sd[f"{name}.bias"] = _t(node["bias"])

    def dense(self, path: str, name: str) -> None:
        node = self.p(path)
        self.names[path] = name
        self.sd[f"{name}.weight"] = _t(np.transpose(node["kernel"]))
        if "bias" in node:
            self.sd[f"{name}.bias"] = _t(node["bias"])

    def norm(self, path: str, name: str) -> None:
        """LayerNorm (params only) or BatchNorm (params + running stats)."""
        node = self.p(path)
        self.sd[f"{name}.weight"] = _t(node["scale"])
        self.sd[f"{name}.bias"] = _t(node["bias"])
        try:
            stats = self._get(self.stats, path)
        except KeyError:
            return
        self.sd[f"{name}.running_mean"] = _t(stats["mean"])
        self.sd[f"{name}.running_var"] = _t(stats["var"])
        self.sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    def act_scales(self) -> dict[str, torch.Tensor] | None:
        """``{torch module path: amax}`` from the tree's ``act_scales``
        collection (call after the weights were walked), or None."""
        if self.scales is None:
            return None
        out: dict[str, torch.Tensor] = {}

        def walk(node: Tree, path: str) -> None:
            if "amax" in node:
                out[self.names[path]] = _t(node["amax"]).reshape(())
                return
            for key, child in node.items():
                walk(child, f"{path}/{key}" if path else key)

        walk(self.scales, "")
        return out


def _emotion_resnet50(variables: Tree) -> _SD:
    c = _SD(variables)
    c.conv2d("conv_stem", "conv_layer_s2_same")
    c.norm("batch_norm1", "batch_norm1")
    for li, blocks in enumerate((3, 4, 6, 3)):
        for bi in range(blocks):
            fp, tp = f"layer{li + 1}_{bi}", f"layer{li + 1}.{bi}"
            for ci in (1, 2, 3):
                c.conv2d(f"{fp}/conv{ci}", f"{tp}.conv{ci}")
                c.norm(f"{fp}/batch_norm{ci}", f"{tp}.batch_norm{ci}")
            if "downsample_conv" in c.p(fp):
                c.conv2d(f"{fp}/downsample_conv", f"{tp}.i_downsample.0")
                c.norm(f"{fp}/downsample_bn", f"{tp}.i_downsample.1")
    c.dense("fc1", "fc1")
    c.dense("fc2", "fc2")
    return c


def _temporal_lstm(variables: Tree) -> _SD:
    c = _SD(variables)
    for name in ("lstm1", "lstm2"):
        for gate in ("ih", "hh"):
            node = c.p(f"{name}/cell/{gate}")
            c.sd[f"{name}.weight_{gate}_l0"] = _t(np.transpose(node["kernel"]))
            c.sd[f"{name}.bias_{gate}_l0"] = _t(node["bias"])
    c.dense("fc", "fc")
    return c


def _convbn(c: _SD, path: str, name: str) -> None:
    """A ``ConvBN`` (conv + bn) -> the reference's ``Sequential(conv, bn)``."""
    c.conv2d(f"{path}/conv", f"{name}.0")
    c.norm(f"{path}/bn", f"{name}.1")


def _retinaface(variables: Tree) -> _SD:
    """RetinaFace with either backbone: the tree's ``body`` says which. Names
    on the torch side are the reference state dict's, as the JAX package's
    ``convert_retinaface`` reads them."""
    c = _SD(variables)
    if "stage1_0" in c.p("body"):  # mobilenet0.25: conv_bn, then conv_dw blocks
        _convbn(c, "body/stage1_0", "body.stage1.0")
        for stage, blocks in (("stage1", range(1, 6)), ("stage2", range(6)),
                              ("stage3", range(2))):
            for i in blocks:
                fp, tp = f"body/{stage}_{i}", f"body.{stage}.{i}"
                c.conv2d(f"{fp}/dw/conv", f"{tp}.0")
                c.norm(f"{fp}/dw/bn", f"{tp}.1")
                c.conv2d(f"{fp}/pw/conv", f"{tp}.3")
                c.norm(f"{fp}/pw/bn", f"{tp}.4")
    else:
        c.conv2d("body/conv1", "body.conv1")
        c.norm("body/bn1", "body.bn1")
        for li, blocks in enumerate((3, 4, 6, 3)):
            for bi in range(blocks):
                fp, tp = f"body/layer{li + 1}_{bi}", f"body.layer{li + 1}.{bi}"
                for ci in (1, 2, 3):
                    c.conv2d(f"{fp}/conv{ci}", f"{tp}.conv{ci}")
                    c.norm(f"{fp}/bn{ci}", f"{tp}.bn{ci}")
                if "downsample_conv" in c.p(fp):
                    c.conv2d(f"{fp}/downsample_conv", f"{tp}.downsample.0")
                    c.norm(f"{fp}/downsample_bn", f"{tp}.downsample.1")
    convbns = [f"fpn/output{i}" for i in (1, 2, 3)] + [f"fpn/merge{i}" for i in (1, 2)]
    convbns += [f"ssh{s}/{n}" for s in (1, 2, 3) for n in
                ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")]
    for path in convbns:
        _convbn(c, path, path.replace("/", "."))
    for i in range(3):
        for head in ("ClassHead", "BboxHead", "LandmarkHead"):
            c.conv2d(f"{head}_{i}", f"{head}.{i}.conv1x1", bias=True)
    return c


def _wav2vec2(c: _SD, fp: str, tp: str) -> None:
    fe = c.p(f"{fp}/feature_extractor")
    i = 0
    while f"conv_layers_{i}_conv" in fe:
        c.conv1d(f"{fp}/feature_extractor/conv_layers_{i}_conv",
                 f"{tp}.feature_extractor.conv_layers.{i}.conv")
        c.norm(f"{fp}/feature_extractor/conv_layers_{i}_layer_norm",
               f"{tp}.feature_extractor.conv_layers.{i}.layer_norm")
        i += 1
    c.norm(f"{fp}/feature_projection/layer_norm", f"{tp}.feature_projection.layer_norm")
    c.dense(f"{fp}/feature_projection/projection", f"{tp}.feature_projection.projection")
    c.conv1d(f"{fp}/pos_conv_embed/conv", f"{tp}.encoder.pos_conv_embed.conv")
    li = 0
    while f"layers_{li}" in c.p(fp):
        lf, lt = f"{fp}/layers_{li}", f"{tp}.encoder.layers.{li}"
        c.norm(f"{lf}/layer_norm", f"{lt}.layer_norm")
        for proj in ("q", "k", "v", "out"):
            c.dense(f"{lf}/attention_{proj}_proj", f"{lt}.attention.{proj}_proj")
        c.norm(f"{lf}/final_layer_norm", f"{lt}.final_layer_norm")
        c.dense(f"{lf}/intermediate_dense", f"{lt}.feed_forward.intermediate_dense")
        c.dense(f"{lf}/output_dense", f"{lt}.feed_forward.output_dense")
        li += 1
    c.norm(f"{fp}/layer_norm", f"{tp}.encoder.layer_norm")


def _transformer_layer(c: _SD, fp: str, tp: str) -> None:
    for w in ("query_w", "keys_w", "values_w", "ff_layer_after_concat"):
        c.dense(f"{fp}/self_attention/{w}", f"{tp}.self_attention.{w}")
    for n in ("add_norm_after_attention", "add_norm_after_ff"):
        c.norm(f"{fp}/{n}/layer_norm", f"{tp}.{n}.layer_norm")
    for n in ("layer_1", "layer_2"):
        c.dense(f"{fp}/feed_forward/{n}", f"{tp}.feed_forward.{n}")


def _expr_model(variables: Tree) -> _SD:
    """ExprModel with its wav2vec2: V1 (a ``gru`` in the tree: two layers of
    torch-gate-order cells) or V2 / V3 (two transformer layers)."""
    c = _SD(variables)
    _wav2vec2(c, "wav2vec2", "wav2vec2")
    if "gru" in c.params:
        for layer in (0, 1):
            for gate in ("ih", "hh"):
                node = c.p(f"gru/cell_{layer}/{gate}")
                c.sd[f"gru.weight_{gate}_l{layer}"] = _t(np.transpose(node["kernel"]))
                c.sd[f"gru.bias_{gate}_l{layer}"] = _t(node["bias"])
    else:
        _transformer_layer(c, "tl1", "tl1")
        _transformer_layer(c, "tl2", "tl2")
    c.conv1d("time_downsample/conv1", "time_downsample.0")
    c.norm("time_downsample/bn1", "time_downsample.1")
    c.conv1d("time_downsample/conv2", "time_downsample.4")
    c.norm("time_downsample/bn2", "time_downsample.5")
    c.dense("feature_downsample", "feature_downsample")
    return c


#: S3FD's trunk convs: the flax names, the torch ModuleList indices (fc6 and
#: fc7 are vgg_31 / vgg_33 in the flax tree, vgg.30 / vgg.32 in the release
#: file, avcer_tpu/core/convert.py:343-354)
_S3FD_VGG = {f"vgg_{i}": f"vgg.{i}" for i in (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)}
_S3FD_VGG.update(vgg_31="vgg.30", vgg_33="vgg.32")
_S3FD_NORMS = ("L2Norm3_3", "L2Norm4_3", "L2Norm5_3")


def _s3fd(variables: Tree) -> _SD:
    c = _SD(variables)
    for flax_name, torch_name in _S3FD_VGG.items():
        c.conv2d(flax_name, torch_name, bias=True)
    for norm in _S3FD_NORMS:
        c.sd[f"{norm}.weight"] = _t(c.p(norm)["weight"])
    for i in range(4):
        c.conv2d(f"extras_{i}", f"extras.{i}", bias=True)
    for i in range(6):
        c.conv2d(f"loc_{i}", f"loc.{i}", bias=True)
        c.conv2d(f"conf_{i}", f"conf.{i}", bias=True)
    return c


def _s3fd_read(key: str) -> bool:
    """Whether the JAX package's ``convert_s3fd`` reads ``key`` (after the
    ``module.`` prefix is stripped)."""
    m = re.fullmatch(r"(vgg|extras|loc|conf)\.(\d+)\.(weight|bias)", key)
    if m:
        kind, i = m.group(1), int(m.group(2))
        if kind == "vgg":
            return f"vgg.{i}" in _S3FD_VGG.values()
        return i < (4 if kind == "extras" else 6)
    return key in {f"{norm}.weight" for norm in _S3FD_NORMS}


_WALKERS = {
    "retinaface": _retinaface,
    "emotion_resnet50": _emotion_resnet50,
    "temporal_lstm": _temporal_lstm,
    "expr_model": _expr_model,
    "s3fd": _s3fd,
}


def s3fd(variables: Tree) -> StateDict:
    return _s3fd(variables).sd


def retinaface(variables: Tree) -> StateDict:
    return _retinaface(variables).sd


def emotion_resnet50(variables: Tree) -> StateDict:
    return _emotion_resnet50(variables).sd


def temporal_lstm(variables: Tree) -> StateDict:
    return _temporal_lstm(variables).sd


def expr_model(variables: Tree) -> StateDict:
    return _expr_model(variables).sd


def act_scales(family: str, variables: Tree) -> dict[str, torch.Tensor] | None:
    """The calibrated int8 activation scales of ``variables`` for the port's
    model of ``family`` (``models.layers.load_act_scales``), or None when the
    tree has no ``act_scales`` collection."""
    return _WALKERS[family](variables).act_scales()


def _fused_pos_conv_weight(sd: dict[str, torch.Tensor], prefix: str) -> None:
    """Replace torch weight norm's factors (``g * v / ||v||``, the norm over
    dims 0 and 1) of ``prefix.conv`` by the plain weight, in either naming
    scheme, in f64 as avcer_tpu/core/convert.py:167-182 does; a fused weight
    stays as it is."""
    new, old = f"{prefix}.conv.parametrizations.weight", f"{prefix}.conv"
    if f"{new}.original0" in sd:
        g, v = sd.pop(f"{new}.original0"), sd.pop(f"{new}.original1")
    elif f"{old}.weight_g" in sd:
        g, v = sd.pop(f"{old}.weight_g"), sd.pop(f"{old}.weight_v")
    else:
        return
    g, v = g.float().numpy(), v.float().numpy()
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    sd[f"{old}.weight"] = torch.from_numpy((g * v / norm).astype(v.dtype))


#: keys of the reference's expr-model checkpoints that the JAX converter
#: does not read, and why
_EXPR_IGNORED = (
    (re.compile(r"(^|\.)masked_spec_embed$"), "HF's SpecAugment vector, used in training only"),
    (re.compile(r"\.positional_encoding\.pe$"), "the sinusoid, recomputed at build"),
    (re.compile(r"\.feed_forward\.layer_norm\."),
     "declared but never applied in the reference's forward"),
)


def release_state_dict(family: str, sd: Mapping[str, torch.Tensor], *,
                       num_layers: int = 12) -> StateDict:
    """A reference state dict of ``family`` (a key of ``CONVERTERS``) in the
    port's names, for ``load_state_dict(strict=True)``: the caller's strict
    load raises on any key left unknown or missing. The expr model's encoder
    layers at or beyond ``num_layers`` are dropped (the JAX converter reads
    the first ``num_layers``); the head's variant needs nothing here, as its
    modules carry the reference's names."""
    out: StateDict = {}
    dropped: dict[str, list[str]] = {}
    deep = re.compile(r"^wav2vec2\.encoder\.layers\.(\d+)\.")
    for key, value in sd.items():
        if family in ("retinaface", "s3fd"):
            key = re.sub(r"^module\.", "", key)
        why = None
        if family == "s3fd" and not _s3fd_read(key):
            why = "not read by the JAX package's convert_s3fd"
        if family == "expr_model":
            why = next((w for pat, w in _EXPR_IGNORED if pat.search(key)), None)
            m = deep.match(key)
            if m and int(m.group(1)) >= num_layers:
                why = f"encoder layers at or beyond num_layers = {num_layers}"
        if why:
            dropped.setdefault(why, []).append(key)
            continue
        out[key] = value
    for why, keys in dropped.items():
        log.info("%s checkpoint: %d keys dropped (%s): %s", family, len(keys), why,
                 ", ".join(keys[:4]) + (", ..." if len(keys) > 4 else ""))
    if family == "expr_model":
        _fused_pos_conv_weight(out, "wav2vec2.encoder.pos_conv_embed")
    return out


CONVERTERS = {
    "retinaface": retinaface,
    "emotion_resnet50": emotion_resnet50,
    "temporal_lstm": temporal_lstm,
    "expr_model": expr_model,
    "s3fd": s3fd,
}
