"""The int8 weights of ``fused_chain`` as its CUDA product reads them
(``pack_chain_q``: ``[taps, co, ci]``, input channels contiguous) against the
JAX package's layout (``[kh, kw, ci, co]``), and the fold cache that keeps the
packed copy across forwards. CPU, small widths: the JAX side runs its int8
conv helpers and its folded bottlenecks as they are, the Pallas kernel in
interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avcer_tpu.models.retinaface import TVBottleneckFolded
from avcer_tpu.ops.pallas import fused_resnet_kernel as jax_frk

from avcer_tpu_torch.models import layers
from avcer_tpu_torch.models.retinaface import RetinaFace, TVBottleneck, fold_pairs
from avcer_tpu_torch.ops.cuda import fused_resnet_kernel as frk

from test_torch_models import randomize_stats
from torch_fused_cases import chain_weights, quant_tensors, quantize_folded

#: shift that keeps every sum of the layout test positive and exact in f32
#: (|sum| <= 9 * 32 * 127^2 < 2^23), so ReLU and the epilogue drop nothing
OFFSET = np.float32(2 ** 23)


def packed_product(q: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The sums as the kernel's product takes them from the packed weights:
    ``q`` the quantised ``[r, c, ci]`` input, ``packed`` ``[taps, co, ci]``;
    tap ``3 ky + kx`` reads the pixel ``(y + ky, x + kx)`` (a 3x3 over the
    band, VALID as the JAX helper computes it). Exact in float64."""
    taps, co, _ = packed.shape
    k = 3 if taps == 9 else 1
    r, c = q.shape[0] - k + 1, q.shape[1] - k + 1
    acc = torch.zeros((r * c, co), dtype=torch.float64)
    for tap in range(taps):
        ky, kx = divmod(tap, k)
        rows = q[ky:ky + r, kx:kx + c].reshape(r * c, -1).double()
        acc += rows @ packed[tap].double().t()
    return acc.reshape(r, c, co)


@pytest.mark.parametrize("kernel", [1, 3])
def test_pack_chain_q_against_the_jax_layout(kernel):
    """``pack_chain_q`` of a 1x1 and a 3x3 int8 fold: each packed tap is the
    JAX weight's ``[ky, kx]`` transposed, and the sums taken from the packed
    copy equal those of the JAX package's int8 conv helpers (``_mm_q``,
    ``_conv3x3_q``, which read the JAX layout) bit for bit."""
    rng = np.random.default_rng(50)
    ci, co = 32, 48
    shape = (ci, co) if kernel == 1 else (3, 3, ci, co)
    w = (rng.normal(size=shape) / np.sqrt(ci * kernel * kernel)).astype(np.float32)
    (wq, _, _), sx = quantize_folded(rng, [w, np.ones((1, co), np.float32),
                                           np.zeros((1, co), np.float32)])
    packed = frk.pack_chain_q(quant_tensors([wq, np.ones((1, co), np.float32),
                                             np.zeros((1, co), np.float32)]))
    assert len(packed) == 1 and packed[0].dtype == torch.int8 and packed[0].is_contiguous()
    taps = packed[0]
    assert tuple(taps.shape) == (kernel * kernel, co, ci)
    jw = wq.reshape(kernel * kernel, ci, co)
    for tap in range(kernel * kernel):
        np.testing.assert_array_equal(taps[tap].numpy(), jw[tap].T)

    a = np.maximum(rng.normal(size=(9, 7, ci)), 0).astype(np.float32)
    mult = np.ones((1, co), np.float32)
    shift = np.full((1, co), OFFSET, np.float32)
    if kernel == 1:
        want = jax_frk._mm_q(jnp.asarray(a.reshape(-1, ci)), sx[0], jnp.asarray(wq),
                             jnp.asarray(mult), jnp.asarray(shift), jnp.float32)
        want = np.asarray(want).reshape(9, 7, co)
    else:
        want = np.asarray(jax_frk._conv3x3_q(jnp.asarray(a), sx[0], jnp.asarray(wq),
                                              jnp.asarray(mult), jnp.asarray(shift), jnp.float32))
    q = frk.quantize_plain(torch.from_numpy(a), torch.tensor(sx[0]))
    got = packed_product(q, taps)
    np.testing.assert_array_equal(got.numpy() + float(OFFSET), want.astype(np.float64))


def layer1_int8():
    """The JAX package's folded int8 bottlenecks of the r50 detector's layer1
    (``TVBottleneckFolded``: a projection block, two identity blocks) from a
    seeded init with random BatchNorm statistics and activation scales, and
    the port's ``TVBottleneck``s with the same weights, statistics and
    scales."""
    rng = np.random.default_rng(51)
    jax_folds, jax_sx, blocks = [], [], []
    in_ch = 64
    for bi in range(3):
        module = TVBottleneckFolded(64, downsample=bi == 0, quant=True)
        tree = randomize_stats(jax.tree.map(np.asarray, dict(
            module.init(jax.random.PRNGKey(bi), in_ch))), bi)
        tree["act_scales"] = jax.tree.map(lambda a: np.float32(rng.uniform(2.0, 8.0)),
                                          tree["act_scales"])
        got, sx = module.apply(tree, in_ch)
        jax_folds += [np.asarray(t) for triple in got for t in triple]
        jax_sx.append(np.asarray(sx))
        blk = TVBottleneck(in_ch, 64, downsample=bi == 0, quant=True)
        pairs = dict(zip(("conv1", "conv2", "conv3", "downsample_conv"), blk.fold_pairs()))
        with torch.no_grad():
            for name, (conv, bn) in pairs.items():
                bn_name = "downsample_bn" if name == "downsample_conv" else "bn" + name[-1]
                conv.weight.copy_(torch.from_numpy(
                    np.transpose(tree["params"][name]["kernel"], (3, 2, 0, 1)).copy()))
                bn.weight.copy_(torch.from_numpy(tree["params"][bn_name]["scale"]))
                bn.bias.copy_(torch.from_numpy(tree["params"][bn_name]["bias"]))
                bn.running_mean.copy_(torch.from_numpy(tree["batch_stats"][bn_name]["mean"]))
                bn.running_var.copy_(torch.from_numpy(tree["batch_stats"][bn_name]["var"]))
                conv.amax.copy_(torch.tensor(tree["act_scales"][name]["amax"]))
                conv.calibrated = True
        blocks.append(blk.eval())
        in_ch = 256
    return jax_folds, np.concatenate(jax_sx), blocks


def test_pack_chain_q_of_a_whole_layer():
    """Every conv of the detector's layer1: the port's int8 fold equals the
    JAX package's ``TVBottleneckFolded`` quant fold, and its packed copy is
    that JAX weight with the taps leading and the input channels last."""
    jax_folds, jax_sx, blocks = layer1_int8()
    folded, act_s = fold_pairs([p for blk in blocks for p in blk.fold_pairs()], torch.float32)
    packed = frk.pack_chain_q(folded)
    assert len(packed) == len(jax_folds) // 3 == 10
    np.testing.assert_allclose(act_s.numpy(), jax_sx, rtol=1e-6)
    for i, (p, jw) in enumerate(zip(packed, jax_folds[0::3])):
        np.testing.assert_array_equal(folded[3 * i].numpy(), jw)
        ci, co = jw.shape[-2:]
        np.testing.assert_array_equal(p.numpy(), jw.reshape(-1, ci, co).transpose(0, 2, 1))


def test_second_fused_forward_reuses_the_packed_copy():
    """The packed weights are made once per fold: the first fused forward of
    the int8 r50 detector (f32 compute dtype, seeded weights and scales)
    packs each of the body's five fused chains once and the fold cache keeps
    the copies; a second forward packs nothing, finds the same tensors and
    gives the same outputs."""
    model = layers.seeded_init_(
        RetinaFace(quant=True, fused_layer1=True, fused_tails=True, fused_entries=True),
        torch.Generator().manual_seed(54)).eval().requires_grad_(False)
    rng = np.random.default_rng(54)
    layers.load_act_scales(model, {name: torch.tensor(rng.uniform(2.0, 8.0), dtype=torch.float32)
                                   for name in layers.q_modules(model)})
    x = torch.from_numpy((rng.normal(size=(1, 48, 40, 3)) * 20).astype(np.float32))
    before = frk.pack_chain_q.calls
    first = model(x)
    assert frk.pack_chain_q.calls == before + 5
    held = {k: v[2] for k, v in model.body._folds.items()}
    assert len(held) == 5 and all(p is not None and p[0].dtype == torch.int8
                                  for p in held.values())
    second = model(x)
    assert frk.pack_chain_q.calls == before + 5
    assert all(model.body._folds[k][2] is p for k, p in held.items())
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("blocks,cin,planes", [(("ds", "id"), 16, 16), (("s2ds", "id"), 32, 16),
                                               (("id",), 128, 32)])
def test_fused_chain_plain_unchanged_by_the_packed_copy(blocks, cin, planes):
    """On the CPU ``fused_chain`` takes its plain version, which reads the JAX
    layout: the same folds give the same result with and without the packed
    copy, and that result is the Pallas kernel's int8 mode (interpret mode)
    within the JAX package's bound for its fused int8 chains."""
    rng = np.random.default_rng(53)
    x = np.maximum(rng.normal(size=(2, 13, 11, cin)), 0).astype(np.float32)
    folded, act_s = quantize_folded(rng, chain_weights(rng, cin, planes, blocks))
    tf, ts = quant_tensors(folded), torch.from_numpy(act_s)
    plain = frk.fused_chain_plain(torch.from_numpy(x), tf, blocks, act_s=ts)
    got = frk.fused_chain(torch.from_numpy(x), tf, blocks, act_s=ts, packed=frk.pack_chain_q(tf))
    assert torch.equal(got, plain)
    want = np.asarray(jax_frk.fused_chain(jnp.asarray(x), tuple(jnp.asarray(a) for a in folded),
                                          blocks, interpret=True, act_s=jnp.asarray(act_s)))
    assert got.shape == want.shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())
