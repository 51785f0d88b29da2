"""Seeded weights for the fused-kernel tests of avcer_tpu_torch, as numpy
arrays (for both the JAX side and the port) or as tensors. Imports no jax:
the card tests (tests/test_torch_cuda.py) use it too."""

import numpy as np
import torch


def conv_triple(rng, shape):
    """(w, inv, shift) of one folded conv, as numpy f32."""
    c = shape[-1]
    fan_in = int(np.prod(shape[:-1]))
    return [(rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32),
            rng.uniform(0.5, 1.5, (1, c)).astype(np.float32),
            (rng.normal(size=(1, c)) * 0.1).astype(np.float32)]


def chain_weights(rng, cin, planes, blocks, cout=None):
    """The flat ``folded`` list of a bottleneck chain with ``cout`` (default 4
    * planes) output channels."""
    out, cout = [], cout or planes * 4
    for kind in blocks:
        out += conv_triple(rng, (cin, planes)) + conv_triple(rng, (3, 3, planes, planes))
        out += conv_triple(rng, (planes, cout))
        if kind != "id":
            out += conv_triple(rng, (cin, cout))
        cin = cout
    return out


def ssh_weights(rng, ci, c, lat, merge):
    """(conv_folded, head_folded, fpn_lat or None, fpn_merge or None)."""
    q = c // 4
    convs = sum((conv_triple(rng, s) for s in ((3, 3, c, c // 2), (3, 3, c, q), (3, 3, q, q),
                                               (3, 3, q, q), (3, 3, q, q))), [])
    heads = []
    for n in (8, 4, 20):
        heads += [(rng.normal(size=(c, n)) / np.sqrt(c)).astype(np.float32),
                  (rng.normal(size=(n,)) * 0.1).astype(np.float32)]
    return (convs, heads, conv_triple(rng, (ci, c)) if lat else None,
            conv_triple(rng, (3, 3, c, c)) if merge else None)


def tensors(arrays, dtype=torch.float32, device="cpu"):
    if arrays is None:
        return None
    return [torch.from_numpy(a).to(device, dtype).contiguous() for a in arrays]


def quantize_folded(rng, folded, amax=(2.0, 5.0)):
    """The int8 fold of a flat list of exact ``(w, inv, shift)`` triples:
    ``(wq int8, mult = (sw * sx) * inv, shift)`` per conv with one weight
    scale per output channel, and the activation scales ``sx`` (one per conv,
    ``amax / 127`` with ``amax`` drawn from the range given), as numpy."""
    out, sxs = [], []
    for w, inv, shift in zip(folded[0::3], folded[1::3], folded[2::3]):
        sw = np.maximum(np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / np.float32(127.0),
                        np.float32(1e-10)).astype(np.float32)
        wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        sx = np.float32(rng.uniform(*amax)) / np.float32(127.0)
        out += [wq, ((sw * sx) * inv).astype(np.float32), shift]
        sxs.append(sx)
    return out, np.asarray(sxs, np.float32)


def quant_tensors(arrays, device="cpu"):
    """``tensors`` for an int8 fold: every array keeps its own dtype."""
    if arrays is None:
        return None
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
