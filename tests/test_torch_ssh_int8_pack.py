"""The int8 weights of ``fused_ssh_heads`` as its CUDA product reads them
(``pack_chain_q``: ``[taps, co, ci]``, input channels contiguous) against the
JAX package's layout and its kernel's own int8 conv helpers, the fold cache
that keeps the packed copy of each scale across forwards, and the wrapper's
check of a packed copy. CPU, small widths: the JAX side runs its helpers as
they are, the Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avcer_tpu.ops.pallas.fused_ssh_kernel import _cbn3, _mm1
from avcer_tpu.ops.pallas.fused_ssh_kernel import fused_ssh_heads as jax_fused_ssh_heads

from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.retinaface import RetinaFace
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk
from avcer_tpu_torch.ops.cuda import fused_ssh_kernel as fsk

from test_torch_int8 import rel_max
from test_torch_int8_pack import OFFSET, packed_product
from test_torch_mobilenet import MNET
from torch_fused_cases import quant_tensors, quantize_folded, ssh_weights, tensors

torch.set_num_threads(2)


def scale_folds(rng, ci, c, lat=True, merge=True):
    """The int8 folds of one scale (lateral, merge, the five SSH convs, in
    the kernel's order), their activation scales, and the exact heads, as
    numpy."""
    convs, heads, fl, fm = ssh_weights(rng, ci, c, lat, merge)
    folds, scales = [], []
    for part in (fl, fm, convs):
        if part is not None:
            q, sx = quantize_folded(rng, part)
            folds.append(q)
            scales.append(sx)
    return folds, np.concatenate(scales), heads


def test_pack_chain_q_of_a_scale_against_the_jax_helpers():
    """``pack_chain_q`` of a scale's seven int8 folds (the 1x1 lateral from
    128 channels, the merge and the five SSH 3x3s at C = 64): each packed tap
    is the JAX weight's ``[ky, kx]`` transposed, and the sums taken from the
    packed copy equal those of the JAX kernel's own int8 conv helpers
    (``_mm1`` for the lateral, ``_cbn3`` for the 3x3s, which read the JAX
    layout) bit for bit."""
    rng = np.random.default_rng(70)
    ci, c = 128, 64
    folds, act_s, _ = scale_folds(rng, ci, c)
    flat = [a for part in folds for a in part]
    packed = frk.pack_chain_q(quant_tensors(flat))
    assert len(packed) == 7
    for p, wq, sx in zip(packed, flat[0::3], act_s):
        k_in, co = wq.shape[-2:]
        taps = wq.size // (k_in * co)
        assert p.dtype == torch.int8 and p.is_contiguous()
        assert tuple(p.shape) == (taps, co, k_in)
        jw = wq.reshape(taps, k_in, co)
        for tap in range(taps):
            np.testing.assert_array_equal(p[tap].numpy(), jw[tap].T)

        a = np.maximum(rng.normal(size=(9, 7, k_in)), 0).astype(np.float32)
        mult = jnp.ones((1, co), jnp.float32)
        shift = jnp.full((1, co), OFFSET, jnp.float32)
        if taps == 1:
            want = _mm1(jnp.asarray(a), jnp.asarray(wq), mult, shift, 0.0, sx=sx,
                        out_dt=jnp.float32)
        else:
            want = _cbn3(jnp.asarray(a), jnp.asarray(wq), mult, shift, None, sx=sx,
                         out_dt=jnp.float32)
        got = packed_product(frk.quantize_plain(torch.from_numpy(a), torch.tensor(sx)), p)
        # every sum, and the sum plus the offset, is exact in f32
        assert float(got.abs().max()) < float(OFFSET)
        np.testing.assert_array_equal(got.numpy() + float(OFFSET),
                                      np.asarray(want).astype(np.float64))


@pytest.mark.parametrize("backbone,switches", [
    ("resnet50", dict(fused_ssh=True, fused_fpn=True)),
    (MNET, dict(fused_ssh=True, fused_fpn=True)),
    (MNET, dict(fused_ssh=True)),
], ids=["r50_fused_ssh_fpn", "mnet_fused_ssh_fpn", "mnet_fused_ssh"])
def test_second_fused_forward_reuses_the_packed_scales(backbone, switches):
    """An int8 detector (f32 compute dtype) loaded from the state dict and
    activation scales of a seeded one: its first fused forward packs each of
    the three scales once and the fold cache keeps the copies (the lateral,
    the merge and the five SSH convs, six at scale 3, which has no merge;
    with ``fused_ssh`` alone the kernel takes the last five); a second
    forward packs nothing, finds the same tensors and gives the same
    outputs."""
    rng = np.random.default_rng(73)
    shared = layers.seeded_init_(RetinaFace(backbone=backbone, quant=True),
                                 torch.Generator().manual_seed(73))
    model = RetinaFace(backbone=backbone, quant=True, **switches)
    model.load_state_dict(shared.state_dict(), strict=True)
    model = model.eval().requires_grad_(False)
    layers.load_act_scales(model, {name: torch.tensor(rng.uniform(2.0, 8.0), dtype=torch.float32)
                                   for name in layers.q_modules(model)})
    x = torch.from_numpy((rng.normal(size=(1, 48, 40, 3)) * 20).astype(np.float32))
    before = frk.pack_chain_q.calls
    first = model(x)
    assert frk.pack_chain_q.calls == before + 3
    held = {k: v[5] for k, v in model._folds.items()}
    assert len(held) == 3
    assert sorted(len(p) for p in held.values()) == [6, 7, 7]
    assert all(t.dtype == torch.int8 for p in held.values() for t in p)
    second = model(x)
    assert frk.pack_chain_q.calls == before + 3
    assert all(model._folds[k][5] is p for k, p in held.items())
    for a, b in zip(first, second):
        assert torch.isfinite(a).all() and torch.equal(a, b)


# name, ci, C, leaky, lateral, merge, up, emit_feature
PLAIN_CASES = [("ssh_heads", 32, 32, 0.0, False, False, False, False),
               ("leaky_c64_fpn", 48, 64, 0.1, True, True, True, True)]


@pytest.mark.parametrize("name,ci,c,leaky,lat,merge,has_up,emit", PLAIN_CASES)
def test_fused_ssh_heads_plain_unchanged_by_the_packed_copy(name, ci, c, leaky, lat, merge,
                                                            has_up, emit):
    """On the CPU ``fused_ssh_heads`` takes its plain version, which reads
    the JAX layout: the same folds give the same bits with and without the
    packed copy, and that result is the Pallas kernel's int8 option
    (interpret mode) within tests/test_torch_int8.py's bound."""
    rng = np.random.default_rng(71)
    x = np.maximum(rng.normal(size=(2, 13, 11, ci)), 0).astype(np.float32)
    up = rng.normal(size=(2, 13, 11, c)).astype(np.float32) if has_up else None
    folds, act_s, heads = scale_folds(rng, ci, c, lat, merge)
    fl = folds[0] if lat else None
    fm = folds[1] if merge else None
    convs = folds[-1]
    kw = dict(leaky=leaky, fpn_lat=quant_tensors(fl), fpn_merge=quant_tensors(fm),
              up=None if up is None else torch.from_numpy(up), emit_feature=emit,
              act_s=torch.from_numpy(act_s))
    tx, tconvs, theads = torch.from_numpy(x), quant_tensors(convs), tensors(heads)
    packed = frk.pack_chain_q([t for part in folds for t in quant_tensors(part)])
    plain = fsk.fused_ssh_heads_plain(tx, tconvs, theads, **kw)
    got = fsk.fused_ssh_heads(tx, tconvs, theads, packed=packed, **kw)
    assert len(got) == len(plain) == 3 + emit
    assert all(torch.equal(g, p) for g, p in zip(got, plain))

    def j(arrays):
        return None if arrays is None else tuple(jnp.asarray(a) for a in arrays)

    want = jax_fused_ssh_heads(jnp.asarray(x), j(convs), j(heads), leaky=leaky, interpret=True,
                               band=8, act_s=jnp.asarray(act_s), fpn_lat=j(fl), fpn_merge=j(fm),
                               up=None if up is None else jnp.asarray(up), emit_feature=emit)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_max(g.numpy(), w) < 1e-4


@pytest.mark.parametrize("change", [
    lambda p: [p[0].reshape(1, 128, 64)] + p[1:],  # the lateral not transposed
    lambda p: p[:-1],
    lambda p: p + [p[-1]],
    lambda p: [p[0].float()] + p[1:],
], ids=["wrong shape", "missing conv", "extra tensor", "wrong dtype"])
def test_packed_check_refuses_what_is_not_the_folds_copy(change):
    """The wrapper's check of a packed copy, which runs before any launch
    and needs no card: ``pack_chain_q`` of the call's folds puts each copy in
    its conv's weight slot and leaves the multiplies and shifts; a copy of
    another shape or type, one conv too few and one tensor too many raise
    ``ValueError``."""
    rng = np.random.default_rng(72)
    folds, _, _ = scale_folds(rng, 128, 64)
    conv_weights = [t for part in folds for t in quant_tensors(part)]
    packed = list(frk.pack_chain_q(conv_weights))
    got = fsk.kernel_conv_weights(conv_weights, packed)
    assert len(got) == 21
    assert all(g is p for g, p in zip(got[0::3], packed))
    assert all(g is t for i, (g, t) in enumerate(zip(got, conv_weights)) if i % 3)
    with pytest.raises(ValueError):
        fsk.kernel_conv_weights(conv_weights, change(packed))
