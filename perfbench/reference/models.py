"""Plain forward passes of the four model families the benchmark serves,
written from their published descriptions over a flat dict of parameters:

- RetinaFace (Deng et al. 2019) with the ResNet50 body of biubug6's
  ``cfg_re50`` (torchvision v1.5 bottlenecks, FPN and SSH 256 wide, ReLU) or
  the MobileNetV1-0.25 body of ``cfg_mnet`` (64 wide, leaky ReLU 0.1), two
  anchors a cell, heads for boxes, scores and five landmarks;
- the static emotion CNN of ElenaRyumina/AVCER: a TF-flavoured ResNet50
  (stride on the first 1x1 conv, TF "same" stem padding, BatchNorm eps
  1e-3), fc 2048 -> 512 (its ReLU'd output is the feature) -> 7;
- the dynamic model: LSTM 512 -> 512, LSTM 512 -> 256, fc on the last step;
- ExprModel V3 over wav2vec2-large-robust-12 (audeering's
  ``wav2vec2-large-robust-12-ft-emotion-msp-dim``): the layer-norm conv
  feature extractor, the feature projection, the grouped positional conv,
  12 pre-LN encoder layers and a final LayerNorm, then two post-LN
  transformer layers (32 and 16 heads) with a sinusoidal encoding, the
  conv / BatchNorm / max-pool time downsample and a linear head.

Everything runs in float32 on whatever device the inputs are on. Parameter
names are those of the published torch modules (biubug6's RetinaFace,
AVCER's models, Hugging Face's ``Wav2Vec2Model``), so that one dict of
tensors serves as the state dict of any implementation that keeps them.

A ``Ctx`` says where parameters come from: in spec mode a forward records
each name, shape and kind and computes on zeros (on the ``meta`` device it
computes nothing); otherwise it reads them from ``weights``. ``calibrate``
makes every BatchNorm take its input's batch statistics as its running ones,
in place in ``weights``. ``quant`` replaces the convolutions and products that
an int8 serving configuration quantises by a function of the caller's, for
a lower-precision control or for counting operations: the detector's
bottleneck, FPN and SSH convs (of the mobilenet body its pointwise convs
only; the stem and the heads stay exact), every conv of the emotion CNN
(not its fc head), and wav2vec2's extractor convs past the first and its
encoder layers' q, k, v, out and feed-forward products.

This module imports torch and nothing of the program it checks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

#: wav2vec2-large-robust-12 and the ExprModel V3 head
W2V2 = dict(hidden_size=1024, num_layers=12, num_heads=16, intermediate_size=4096,
            conv_dim=(512,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
            conv_kernel=(10, 3, 3, 3, 3, 2, 2), num_conv_pos_embeddings=128,
            num_conv_pos_embedding_groups=16, layer_norm_eps=1e-5, num_classes=8,
            head_heads=(32, 16))


class Ctx:
    """Where a forward pass takes its parameters (see the module docstring)."""

    def __init__(self, weights: Optional[dict] = None, calibrate: bool = False,
                 quant: Optional[Callable] = None):
        self.weights = weights
        self.spec: Optional[list] = [] if weights is None else None
        self.calibrate = calibrate
        self.quant = quant

    def p(self, name: str, shape: tuple, kind: str, like: torch.Tensor) -> torch.Tensor:
        if self.spec is not None:
            self.spec.append((name, tuple(int(s) for s in shape), kind))
            if kind == "count":
                return torch.zeros((), dtype=torch.long, device=like.device)
            fill = 1.0 if kind in ("bn_weight", "bn_residual", "bn_var", "ln_weight") else 0.0
            return torch.full(shape, fill, dtype=torch.float32, device=like.device)
        return self.weights[name]


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def conv2d(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
           padding: int = 0, groups: int = 1, bias: bool = False,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[1] // groups, k, k), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    kw = dict(stride=stride, padding=padding, groups=groups)
    if quant and ctx.quant is not None:
        return ctx.quant(F.conv2d, x, w, b, kw)
    return F.conv2d(x, w, b, **kw)


def conv1d(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
           padding: int = 0, groups: int = 1, dilation: int = 1, bias: bool = True,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[1] // groups, k), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    kw = dict(stride=stride, padding=padding, groups=groups, dilation=dilation)
    if quant and ctx.quant is not None:
        return ctx.quant(F.conv1d, x, w, b, kw)
    return F.conv1d(x, w, b, **kw)


def linear(ctx: Ctx, name: str, x: torch.Tensor, cout: int, bias: bool = True,
           quant: bool = False) -> torch.Tensor:
    w = ctx.p(name + ".weight", (cout, x.shape[-1]), "kernel", x)
    b = ctx.p(name + ".bias", (cout,), "bias", x) if bias else None
    if quant and ctx.quant is not None:
        return ctx.quant(F.linear, x, w, b, {})
    return F.linear(x, w, b)


def batch_norm(ctx: Ctx, name: str, x: torch.Tensor, eps: float,
               residual: bool = False) -> torch.Tensor:
    """Inference BatchNorm over dim 1; with ``ctx.calibrate`` the running
    statistics first become the batch's (biased variance). ``residual``
    marks the last BatchNorm of a residual branch (its scale's kind is
    ``bn_residual``)."""
    c = x.shape[1]
    w = ctx.p(name + ".weight", (c,), "bn_residual" if residual else "bn_weight", x)
    b = ctx.p(name + ".bias", (c,), "bn_bias", x)
    mean = ctx.p(name + ".running_mean", (c,), "bn_mean", x)
    var = ctx.p(name + ".running_var", (c,), "bn_var", x)
    ctx.p(name + ".num_batches_tracked", (), "count", x)
    if ctx.calibrate:
        dims = [0] + list(range(2, x.dim()))
        mean.copy_(x.mean(dims))
        var.copy_(x.var(dims, unbiased=False))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(var + eps) * w
    return x * inv.view(shape) + (b - mean * inv).view(shape)


def layer_norm(ctx: Ctx, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    c = x.shape[-1]
    return F.layer_norm(x, (c,), ctx.p(name + ".weight", (c,), "ln_weight", x),
                        ctx.p(name + ".bias", (c,), "ln_bias", x), eps)


def act(x: torch.Tensor, leaky: Optional[float]) -> torch.Tensor:
    """None: none; 0: ReLU; else leaky ReLU with that slope."""
    if leaky is None:
        return x
    return F.relu(x) if leaky == 0.0 else F.leaky_relu(x, leaky)


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest to an exact size: source index floor(i * in / out)."""
    ri = (torch.arange(hw[0], device=x.device) * x.shape[2]) // hw[0]
    ci = (torch.arange(hw[1], device=x.device) * x.shape[3]) // hw[1]
    return x[:, :, ri][:, :, :, ci]


# ---------------------------------------------------------------------------
# RetinaFace
# ---------------------------------------------------------------------------

def _conv_bn(ctx: Ctx, name: str, x: torch.Tensor, cout: int, k: int, stride: int = 1,
             leaky: Optional[float] = 0.0, quant: bool = False) -> torch.Tensor:
    """biubug6's ``conv_bn``: conv (no bias, padding (k - 1) / 2) ``.0``,
    BatchNorm ``.1``, then the activation."""
    y = conv2d(ctx, name + ".0", x, cout, k, stride, (k - 1) // 2, quant=quant)
    return act(batch_norm(ctx, name + ".1", y, 1e-5), leaky)


def _tv_bottleneck(ctx: Ctx, name: str, x: torch.Tensor, planes: int, stride: int,
                   downsample: bool, quant: bool) -> torch.Tensor:
    idn = x
    if downsample:
        idn = batch_norm(ctx, name + ".downsample.1",
                         conv2d(ctx, name + ".downsample.0", x, planes * 4, 1, stride,
                                quant=quant), 1e-5)
    h = F.relu(batch_norm(ctx, name + ".bn1", conv2d(ctx, name + ".conv1", x, planes, 1,
                                                     quant=quant), 1e-5))
    h = F.relu(batch_norm(ctx, name + ".bn2", conv2d(ctx, name + ".conv2", h, planes, 3, stride,
                                                     1, quant=quant), 1e-5))
    h = batch_norm(ctx, name + ".bn3", conv2d(ctx, name + ".conv3", h, planes * 4, 1,
                                              quant=quant), 1e-5, residual=True)
    return F.relu(h + idn)


def _r50_body(ctx: Ctx, x: torch.Tensor, quant: bool) -> list:
    h = F.relu(batch_norm(ctx, "body.bn1", conv2d(ctx, "body.conv1", x, 64, 7, 2, 3), 1e-5))
    h = F.max_pool2d(h, 3, stride=2, padding=1)
    outs, cin = [], 64
    for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(blocks):
            s = (1 if li == 0 else 2) if bi == 0 else 1
            h = _tv_bottleneck(ctx, f"body.layer{li + 1}.{bi}", h, planes, s,
                               bi == 0 and (s != 1 or cin != planes * 4), quant)
            cin = planes * 4
        if li >= 1:
            outs.append(h)
    return outs


def _conv_dw(ctx: Ctx, name: str, x: torch.Tensor, cout: int, stride: int,
             quant: bool) -> torch.Tensor:
    """MobileNetV1 ``conv_dw``: depthwise 3x3 ``.0`` (never quantised), BN
    ``.1``, leaky 0.1, pointwise ``.3``, BN ``.4``, leaky 0.1."""
    cin = x.shape[1]
    h = conv2d(ctx, name + ".0", x, cin, 3, stride, 1, groups=cin)
    h = act(batch_norm(ctx, name + ".1", h, 1e-5), 0.1)
    h = conv2d(ctx, name + ".3", h, cout, 1, quant=quant)
    return act(batch_norm(ctx, name + ".4", h, 1e-5), 0.1)


def _mnet_body(ctx: Ctx, x: torch.Tensor, quant: bool) -> list:
    h = _conv_bn(ctx, "body.stage1.0", x, 8, 3, 2, leaky=0.1)
    for k, (o, s) in enumerate(((16, 1), (32, 2), (32, 1), (64, 2), (64, 1)), start=1):
        h = _conv_dw(ctx, f"body.stage1.{k}", h, o, s, quant)
    s1 = h
    for k, (o, s) in enumerate([(128, 2)] + [(128, 1)] * 5):
        h = _conv_dw(ctx, f"body.stage2.{k}", h, o, s, quant)
    s2 = h
    for k, (o, s) in enumerate(((256, 2), (256, 1))):
        h = _conv_dw(ctx, f"body.stage3.{k}", h, o, s, quant)
    return [s1, s2, h]


def _ssh(ctx: Ctx, name: str, x: torch.Tensor, c: int, leaky: float,
         quant: bool) -> torch.Tensor:
    c3 = _conv_bn(ctx, name + ".conv3X3", x, c // 2, 3, leaky=None, quant=quant)
    c5_1 = _conv_bn(ctx, name + ".conv5X5_1", x, c // 4, 3, leaky=leaky, quant=quant)
    c5 = _conv_bn(ctx, name + ".conv5X5_2", c5_1, c // 4, 3, leaky=None, quant=quant)
    c7_2 = _conv_bn(ctx, name + ".conv7X7_2", c5_1, c // 4, 3, leaky=leaky, quant=quant)
    c7 = _conv_bn(ctx, name + ".conv7x7_3", c7_2, c // 4, 3, leaky=None, quant=quant)
    return F.relu(torch.cat([c3, c5, c7], dim=1))


def retinaface(ctx: Ctx, x: torch.Tensor, backbone: str, quant: bool = False):
    """Normalised BGR frames [B, H, W, 3] (pixel minus (104, 117, 123)) ->
    (loc [B, A, 4], conf [B, A, 2] softmaxed, landms [B, A, 10]), anchor
    rows in (level, h, w, anchor) order."""
    x = x.permute(0, 3, 1, 2)
    if backbone == "resnet50":
        feats, c, leaky = _r50_body(ctx, x, quant), 256, 0.0
    elif backbone == "mobilenet0.25":
        feats, c, leaky = _mnet_body(ctx, x, quant), 64, 0.1
    else:
        raise ValueError(backbone)
    o = [_conv_bn(ctx, f"fpn.output{i + 1}", f, c, 1, leaky=leaky, quant=quant)
         for i, f in enumerate(feats)]
    o2 = _conv_bn(ctx, "fpn.merge2", o[1] + upsample_nearest(o[2], o[1].shape[2:]), c, 3,
                  leaky=leaky, quant=quant)
    o1 = _conv_bn(ctx, "fpn.merge1", o[0] + upsample_nearest(o2, o[0].shape[2:]), c, 3,
                  leaky=leaky, quant=quant)
    ssh = [_ssh(ctx, f"ssh{i + 1}", f, c, leaky, quant) for i, f in enumerate((o1, o2, o[2]))]

    def head(kind: str, width: int) -> torch.Tensor:
        outs = []
        for i, f in enumerate(ssh):
            y = conv2d(ctx, f"{kind}.{i}.conv1x1", f, 2 * width, 1, bias=True).permute(0, 2, 3, 1)
            outs.append(y.reshape(y.shape[0], -1, width))
        return torch.cat(outs, dim=1)

    return (head("BboxHead", 4), torch.softmax(head("ClassHead", 2), dim=-1),
            head("LandmarkHead", 10))


# ---------------------------------------------------------------------------
# the emotion CNN and the LSTM
# ---------------------------------------------------------------------------

def same_pad(i: int, k: int, s: int) -> tuple[int, int]:
    """TF "same" padding (lo, hi) of one spatial dim."""
    total = max((-(-i // s) - 1) * s + k - i, 0)
    return total // 2, total - total // 2


def emotion_resnet(ctx: Ctx, x: torch.Tensor, quant: bool = False, num_classes: int = 7):
    """Crops [B, 224, 224, 3] minus the VGGFace2 BGR means -> (logits [B, 7],
    features [B, 512] = relu(fc1))."""
    eps = 1e-3
    x = x.permute(0, 3, 1, 2)
    ph, pw = same_pad(x.shape[2], 7, 2), same_pad(x.shape[3], 7, 2)
    x = F.pad(x, [pw[0], pw[1], ph[0], ph[1]])
    x = F.relu(batch_norm(ctx, "batch_norm1",
                          conv2d(ctx, "conv_layer_s2_same", x, 64, 7, 2, quant=quant), eps))
    x = F.max_pool2d(x, 3, stride=2)
    cin = 64
    for li, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for bi in range(blocks):
            s = (1 if li == 0 else 2) if bi == 0 else 1
            name = f"layer{li + 1}.{bi}"
            idn = x
            if bi == 0 and (s != 1 or cin != planes * 4):
                idn = batch_norm(ctx, name + ".i_downsample.1",
                                 conv2d(ctx, name + ".i_downsample.0", x, planes * 4, 1, s,
                                        quant=quant), eps)
            h = F.relu(batch_norm(ctx, name + ".batch_norm1",
                                  conv2d(ctx, name + ".conv1", x, planes, 1, s, quant=quant), eps))
            h = F.relu(batch_norm(ctx, name + ".batch_norm2",
                                  conv2d(ctx, name + ".conv2", h, planes, 3, 1, 1, quant=quant),
                                  eps))
            h = batch_norm(ctx, name + ".batch_norm3",
                           conv2d(ctx, name + ".conv3", h, planes * 4, 1, quant=quant), eps,
                           residual=True)
            x = F.relu(h + idn)
            cin = planes * 4
    feats = F.relu(linear(ctx, "fc1", x.mean(dim=(2, 3)), 512))
    return linear(ctx, "fc2", feats, num_classes), feats


def _lstm(ctx: Ctx, name: str, x: torch.Tensor, hidden: int) -> torch.Tensor:
    """One LSTM layer over [B, T, in], gates (i, f, g, o) as torch orders them."""
    w_ih = ctx.p(name + ".weight_ih_l0", (4 * hidden, x.shape[-1]), "kernel", x)
    w_hh = ctx.p(name + ".weight_hh_l0", (4 * hidden, hidden), "kernel", x)
    b_ih = ctx.p(name + ".bias_ih_l0", (4 * hidden,), "bias", x)
    b_hh = ctx.p(name + ".bias_hh_l0", (4 * hidden,), "bias", x)
    b, t = x.shape[0], x.shape[1]
    h = x.new_zeros(b, hidden)
    c = x.new_zeros(b, hidden)
    xs = F.linear(x, w_ih, b_ih)
    outs = []
    for step in range(t):
        i, f, g, o = (xs[:, step] + F.linear(h, w_hh, b_hh)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    return torch.stack(outs, dim=1)


def temporal_lstm(ctx: Ctx, x: torch.Tensor, num_classes: int = 7) -> torch.Tensor:
    """Feature windows [S, 10, 512] -> logits [S, 7] of the last step."""
    h = _lstm(ctx, "lstm2", _lstm(ctx, "lstm1", x, 512), 256)
    return linear(ctx, "fc", h[:, -1], num_classes)


# ---------------------------------------------------------------------------
# wav2vec2 and ExprModel V3
# ---------------------------------------------------------------------------

def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    b, t, d = q.shape

    def split(y: torch.Tensor) -> torch.Tensor:
        return y.reshape(b, t, heads, d // heads).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(d // heads)
    out = torch.softmax(logits, dim=-1) @ split(v)
    return out.transpose(1, 2).reshape(b, t, d)


def wav2vec2_features(ctx: Ctx, wav: torch.Tensor, cfg: dict = W2V2,
                      quant: bool = False) -> torch.Tensor:
    """Normalised waveform [B, T] -> conv features [B, F, conv_dim]."""
    h = wav[:, None, :]
    for i, (c, k, s) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"], cfg["conv_stride"])):
        name = f"wav2vec2.feature_extractor.conv_layers.{i}"
        h = conv1d(ctx, name + ".conv", h, c, k, s, quant=quant and i > 0)
        h = F.gelu(layer_norm(ctx, name + ".layer_norm", h.transpose(1, 2),
                              cfg["layer_norm_eps"])).transpose(1, 2)
    return h.transpose(1, 2)


def wav2vec2_encode(ctx: Ctx, feats: torch.Tensor, cfg: dict = W2V2,
                    quant: bool = False) -> torch.Tensor:
    """Conv features [B, F, conv_dim] -> hidden states [B, F, hidden]."""
    eps, d = cfg["layer_norm_eps"], cfg["hidden_size"]
    h = linear(ctx, "wav2vec2.feature_projection.projection",
               layer_norm(ctx, "wav2vec2.feature_projection.layer_norm", feats, eps), d)
    k = cfg["num_conv_pos_embeddings"]
    pos = conv1d(ctx, "wav2vec2.encoder.pos_conv_embed.conv", h.transpose(1, 2), d, k,
                 padding=k // 2, groups=cfg["num_conv_pos_embedding_groups"])
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + F.gelu(pos).transpose(1, 2)
    for li in range(cfg["num_layers"]):
        name = f"wav2vec2.encoder.layers.{li}"
        x = layer_norm(ctx, name + ".layer_norm", h, eps)
        a = name + ".attention"
        attn = _attention(linear(ctx, a + ".q_proj", x, d, quant=quant),
                          linear(ctx, a + ".k_proj", x, d, quant=quant),
                          linear(ctx, a + ".v_proj", x, d, quant=quant), cfg["num_heads"])
        h = h + linear(ctx, a + ".out_proj", attn, d, quant=quant)
        x = layer_norm(ctx, name + ".final_layer_norm", h, eps)
        f = name + ".feed_forward"
        x = F.gelu(linear(ctx, f + ".intermediate_dense", x, cfg["intermediate_size"],
                          quant=quant))
        h = h + linear(ctx, f + ".output_dense", x, d, quant=quant)
    return layer_norm(ctx, "wav2vec2.encoder.layer_norm", h, eps)


def sinusoidal_encoding(d: int, t: int, device) -> torch.Tensor:
    position = np.arange(t, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((t, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe.astype(np.float32)).to(device)


def _transformer_layer(ctx: Ctx, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Post-LN layer of the audio head: the sinusoidal encoding added once and
    used as Q, K and V, bias-free projections, residual on Q."""
    d = x.shape[-1]
    q = x + sinusoidal_encoding(d, x.shape[1], x.device)
    a = name + ".self_attention"
    attn = _attention(linear(ctx, a + ".query_w", q, d, bias=False),
                      linear(ctx, a + ".keys_w", q, d, bias=False),
                      linear(ctx, a + ".values_w", q, d, bias=False), heads)
    h = layer_norm(ctx, name + ".add_norm_after_attention.layer_norm",
                   linear(ctx, a + ".ff_layer_after_concat", attn, d, bias=False) + q, 1e-5)
    f = name + ".feed_forward"
    ff = linear(ctx, f + ".layer_2", F.relu(linear(ctx, f + ".layer_1", h, d)), d)
    return layer_norm(ctx, name + ".add_norm_after_ff.layer_norm", ff + h, 1e-5)


def expr_head(ctx: Ctx, h: torch.Tensor, cfg: dict = W2V2) -> torch.Tensor:
    """ExprModel V3 after wav2vec2: hidden states [B, F, hidden] -> logits."""
    h = _transformer_layer(ctx, "tl1", h, cfg["head_heads"][0])
    h = _transformer_layer(ctx, "tl2", h, cfg["head_heads"][1])
    d = h.shape[-1]
    y = conv1d(ctx, "time_downsample.0", h.transpose(1, 2), d, 5, stride=3, dilation=2)
    y = F.relu(F.max_pool1d(batch_norm(ctx, "time_downsample.1", y, 1e-5), 5))
    y = batch_norm(ctx, "time_downsample.5", conv1d(ctx, "time_downsample.4", y, d, 3), 1e-5)
    return linear(ctx, "feature_downsample", F.relu(y.mean(dim=-1)), cfg["num_classes"])


def expr_model(ctx: Ctx, wav: torch.Tensor, cfg: dict = W2V2, quant: bool = False):
    """Normalised 4 s windows [B, 64000] -> logits [B, num_classes]."""
    return expr_head(ctx, wav2vec2_encode(ctx, wav2vec2_features(ctx, wav, cfg, quant), cfg,
                                          quant), cfg)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def spec(family: str, backbone: str = "resnet50", w2v: dict = W2V2) -> list:
    """[(name, shape, kind)] of every parameter and buffer a family's state
    dict holds, in the order its forward reads them."""
    ctx = Ctx()
    meta = torch.device("meta")
    if family == "retinaface":
        retinaface(ctx, torch.zeros(1, 64, 64, 3, device=meta), backbone)
    elif family == "emotion_resnet50":
        emotion_resnet(ctx, torch.zeros(1, 224, 224, 3, device=meta))
    elif family == "temporal_lstm":
        temporal_lstm(ctx, torch.zeros(1, 10, 512, device=meta))
    elif family == "expr_model":
        expr_model(ctx, torch.zeros(1, 64000, device=meta), w2v)
    else:
        raise ValueError(family)
    return ctx.spec
