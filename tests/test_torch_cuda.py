"""CUDA kernels of avcer_tpu_torch against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU with nvcc and skips without
one. This file imports no jax, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from avcer_tpu_torch.ops.cuda import (attention_kernel, fused_resnet_kernel, fused_ssh_kernel,
                                      nms_kernel)

from torch_fused_cases import (chain_weights, quant_tensors, quantize_folded, ssh_weights,
                               tensors)

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def nms_case(seed: int, b: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Boxes as in tests/test_pallas_kernels.py, plus exact duplicates and
    integer boxes whose IoU is exactly 0.4 (kept) or 0.5 (suppressed)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 200, (b, k)).astype(np.float32)
    cy = rng.uniform(0, 200, (b, k)).astype(np.float32)
    w = rng.uniform(5, 80, (b, k)).astype(np.float32)
    h = rng.uniform(5, 80, (b, k)).astype(np.float32)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
    scores = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
    if k >= 8:
        boxes[:, 2] = boxes[:, 1]  # exact duplicate of a higher-scored row
        boxes[:, 5] = [300, 300, 309, 309]  # area 100 (legacy +1)
        boxes[:, 6] = [300, 300, 309, 303]  # IoU with row 5: 40/100 = 0.4
        boxes[:, 7] = [300, 300, 309, 304]  # IoU with row 5: 50/100 = 0.5
    return boxes, scores > 0.3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("b,k", [(32, 64), (128, 64), (3, 8), (1, 1), (2, 65), (2, 1000),
                                 (1, 1024)])
def test_nms_kernel_equals_plain(cuda_device, seed, b, k):
    """The bitmask kernel at the main paths' detect batches (K = 64: one
    64-bit word a row), one word and a bit more (K = 65), and up to the 16
    words of K = 1024 (128 KB of suppression bits in shared memory)."""
    boxes, valid = nms_case(seed, b, k)
    bt = torch.from_numpy(boxes).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    want = nms_kernel.nms_mask_plain(bt, vt, 0.4).cpu().numpy()
    before = nms_kernel.nms_mask.launches
    got = nms_kernel.nms_mask(bt, vt, 0.4)
    torch.cuda.synchronize()
    assert nms_kernel.nms_mask.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("b,k", [(32, 64), (3, 8), (2, 65), (1, 1024)])
def test_nms_kernel_no_plus_one_equals_plain(cuda_device, seed, b, k):
    """S3FD's mode (``plus_one=False``) at IoU 0.3, bit for bit the plain
    version: the main path's [32, 64], and boxes that touch along an edge,
    zero-width and zero-area boxes and their duplicates (IoU 0 / 0)."""
    boxes, valid = nms_case(seed, b, k)
    if k >= 8:
        boxes[:, 0] = [200, 200, 210, 210]
        boxes[:, 1] = [210, 200, 220, 210]  # touches row 0: IoU 0 without the +1
        boxes[:, 3] = [230, 230, 230, 240]  # zero width
        boxes[:, 4] = [230, 230, 230, 240]
        boxes[:, 6] = [250, 250, 250, 250]  # a point
        valid[:, :8] = True
    bt = torch.from_numpy(boxes).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    want = nms_kernel.nms_mask_plain(bt, vt, 0.3, plus_one=False).cpu().numpy()
    before = dict(nms_kernel.nms_mask.launches_by_mode)
    got = nms_kernel.nms_mask(bt, vt, 0.3, plus_one=False)
    torch.cuda.synchronize()
    assert nms_kernel.nms_mask.launches_by_mode[False] == before[False] + 1
    assert nms_kernel.nms_mask.launches_by_mode[True] == before[True]
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    if k >= 8:
        assert want[:, 1].all()  # kept: only the +1 makes the touching rows overlap


def test_nms_kernel_threshold_rows(cuda_device):
    boxes, valid = nms_case(0, 1, 8)
    valid[:] = True
    keep = nms_kernel.nms_mask(
        torch.from_numpy(boxes).to(cuda_device),
        torch.from_numpy(valid).to(cuda_device), 0.4).cpu().numpy()[0]
    assert not keep[2]  # duplicate of row 1
    assert keep[5] and keep[6] and not keep[7]  # IoU 0.4 kept, 0.5 suppressed


@pytest.mark.parametrize("shape", [(16, 16, 199, 64), (2, 4, 33, 16), (1, 2, 1024, 128)])
def test_attention_kernel_f32(cuda_device, shape):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
               for _ in range(3))
    want = attention_kernel.mha_plain(q, k, v)
    got = attention_kernel.mha(q, k, v)
    torch.cuda.synchronize()
    # the JAX package's own bound for the Pallas kernel (test_pallas_mha_matches_xla)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape", [
    (16, 16, 199, 64), (2, 4, 33, 16),
    # ragged and edge lengths of the tensor-core kernel, and its head dims
    (2, 3, 1, 64), (2, 3, 17, 64), (2, 3, 64, 64), (2, 3, 200, 64), (2, 3, 256, 64),
    (2, 3, 199, 16), (2, 3, 199, 128),
    # past the tensor-core kernel's 256 keys: the exact kernel
    (2, 3, 257, 64)])
def test_attention_kernel_bf16(cuda_device, shape):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    kernel = "tc" if shape[2] <= 256 else "exact"
    assert attention_kernel.kernel_for(torch.bfloat16, shape[2], shape[3]) == kernel
    before = dict(attention_kernel.mha.launches_by_kernel)
    got = attention_kernel.mha(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    after = attention_kernel.mha.launches_by_kernel
    assert {name: after[name] - before[name] for name in after} == {
        name: int(name == kernel) for name in after}
    # both sides compute in f32 from the same bf16 inputs; the kernel then
    # rounds to bf16, which is within 2**-8 relative of the f32 result
    want = attention_kernel.mha_plain(q.float(), k.float(), v.float())
    torch.testing.assert_close(got.float(), want, atol=1e-5, rtol=4e-3)


def test_kernels_raise_on_bad_input(cuda_device):
    q = torch.zeros((1, 1, 8, 256), device=cuda_device)
    with pytest.raises(ValueError):
        attention_kernel.mha(q, q, q)
    with pytest.raises(ValueError):
        attention_kernel.mha(q.half(), q.half(), q.half())
    boxes = torch.zeros((1, 8, 4), device=cuda_device)
    with pytest.raises(ValueError):
        nms_kernel.nms_mask(boxes, torch.ones((1, 8), device=cuda_device), 0.4)


# Frames smaller and larger than a tile (one tile up to 32, else tiles of at
# most 24: every frame edge falls inside some tile's halo), odd sizes for the
# stride-2 entries, batches that do not fill a work item's frame group.
CHAIN_CASES = [
    ((2, 24, 16, 16), 16, ("ds", "id", "id")), ((2, 23, 17, 64), 16, ("id", "id")),
    ((2, 23, 17, 32), 16, ("s2ds", "id")), ((2, 24, 16, 32), 16, ("s2pre", "id", "id")),
    ((5, 7, 7, 64), 16, ("id",)), ((2, 45, 40, 32), 16, ("s2ds", "id", "id", "id")),
    ((2, 55, 55, 32), 16, ("s2pre", "id", "id")), ((1, 90, 37, 16), 16, ("ds", "id", "id")),
    ((3, 33, 50, 64), 16, ("id", "id", "id")), ((2, 49, 67, 16), 8, ("s2ds",)),
]


@pytest.mark.parametrize("shape,planes,blocks", CHAIN_CASES)
def test_fused_chain_kernel_f32(cuda_device, shape, planes, blocks):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    folded = tensors(chain_weights(rng, shape[-1], planes, blocks), torch.float32, cuda_device)
    want = fused_resnet_kernel.fused_chain_plain(x, folded, blocks)
    before = fused_resnet_kernel.fused_chain.launches
    got = fused_resnet_kernel.fused_chain(x, folded, blocks)
    torch.cuda.synchronize()
    assert fused_resnet_kernel.fused_chain.launches == before + 1
    # the JAX package's bound for the Pallas kernel (test_fused_layer1_matches_xla)
    torch.testing.assert_close(got, want, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape,planes,blocks", CHAIN_CASES[:7])
def test_fused_chain_kernel_bf16(cuda_device, shape, planes, blocks):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    folded = tensors(chain_weights(rng, shape[-1], planes, blocks), torch.bfloat16, cuda_device)
    want = fused_resnet_kernel.fused_chain_plain(x, folded, blocks)
    got = fused_resnet_kernel.fused_chain(x, folded, blocks)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # same bf16 inputs and rounding points; a sum on a rounding boundary may
    # fall to either side after another summation order: a few bf16 ulps
    # (2**-8 relative each) through up to 12 convs
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -5, rtol=2 ** -5)


# shape, C, leaky, lateral, merge, up, emit_feature
SSH_CASES = [
    ((2, 12, 9, 32), 32, 0.0, False, False, False, False),
    ((2, 7, 5, 48), 32, 0.0, True, False, False, True),
    ((2, 23, 17, 48), 32, 0.0, True, True, True, True),
    ((2, 40, 37, 64), 64, 0.1, True, True, True, False),
    ((3, 9, 9, 64), 64, 0.1, False, False, False, False),
    ((1, 45, 80, 32), 32, 0.0, True, True, True, True),
    # the mobilenet0.25 detector: scale 2 of the 640 bucket at its full detect
    # batch, scale 1 of the 448 bucket (a 640 x 360 clip) and scale 3 (no merge)
    ((128, 23, 40, 128), 64, 0.1, True, True, True, True),
    ((8, 32, 56, 64), 64, 0.1, True, True, True, False),
    ((8, 8, 14, 256), 64, 0.1, True, False, False, True),
    # the r50 detector's 256 channels: the lateral and the merge (N = 256) and
    # c3 (N = 128) on the bf16 product's 128 x 128 tiles, the C/4 convs on
    # its 128 x 64 tiles
    ((2, 12, 20, 512), 256, 0.0, True, True, True, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c,leaky,lat,merge,has_up,emit", SSH_CASES)
def test_fused_ssh_heads_kernel(cuda_device, shape, c, leaky, lat, merge, has_up, emit, dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, dtype)
    up = (torch.from_numpy(rng.normal(size=shape[:3] + (c,)).astype(np.float32))
          .to(cuda_device, dtype) if has_up else None)
    convs, heads, fl, fm = (tensors(t, dtype, cuda_device)
                            for t in ssh_weights(rng, shape[-1], c, lat, merge))
    want = fused_ssh_kernel.fused_ssh_heads_plain(x, convs, heads, leaky, fl, fm, up, emit)
    before = fused_ssh_kernel.fused_ssh_heads.launches
    got = fused_ssh_kernel.fused_ssh_heads(x, convs, heads, leaky, fl, fm, up, emit)
    torch.cuda.synchronize()
    assert fused_ssh_kernel.fused_ssh_heads.launches == before + 1
    assert len(got) == len(want) == 3 + emit
    # f32: the JAX package's bound (test_fused_ssh_heads_match_xla); bf16: a
    # few ulps through up to 7 convs, as for the chain kernel
    atol, rtol = (2e-5, 1e-4) if dtype == torch.float32 else (2 ** -5, 2 ** -5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=atol, rtol=rtol)


# Convs with N >= 128 output channels, which the bf16 product computes in
# tiles of 128 x 128 (the narrower ones in 128 x 64): every kind, frames
# smaller and larger than a tile
WIDE_CASES = [((2, 24, 20, 512), 128, ("id", "id")), ((2, 23, 17, 64), 64, ("ds", "id")),
              ((2, 23, 17, 128), 128, ("s2ds", "id")), ((2, 36, 30, 256), 128, ("s2pre", "id")),
              ((3, 7, 7, 1024), 256, ("id",))]


@pytest.mark.parametrize("shape,planes,blocks", WIDE_CASES)
def test_fused_chain_kernel_bf16_wide(cuda_device, shape, planes, blocks):
    """The bf16 product on 128 x 128 tiles against the plain version, at the
    bound of test_fused_chain_kernel_bf16; for a stride-1 chain also against
    fused_chain_flat, whose product (the same block_gemm_tc over flat bands)
    sums the same terms in the same order: equal bit for bit."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    folded = tensors(chain_weights(rng, shape[-1], planes, blocks), torch.bfloat16, cuda_device)
    want = fused_resnet_kernel.fused_chain_plain(x, folded, blocks)
    got = fused_resnet_kernel.fused_chain(x, folded, blocks)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -5, rtol=2 ** -5)
    if blocks[0] in ("ds", "id"):
        assert torch.equal(got, fused_resnet_kernel.fused_chain_flat(x, folded, blocks))


# The int8 mode copies its weights 16 channels at a time: channel counts are
# multiples of 16. Otherwise the geometry of CHAIN_CASES: every frame edge,
# sizes that are no multiple of the tile, odd stride-2 sizes, the four kinds.
QCHAIN_CASES = [
    ((2, 24, 16, 16), 16, ("ds", "id", "id")), ((2, 23, 17, 64), 16, ("id", "id")),
    ((2, 23, 17, 32), 16, ("s2ds", "id")), ((2, 24, 16, 32), 16, ("s2pre", "id", "id")),
    ((5, 7, 7, 64), 16, ("id",)), ((2, 45, 40, 32), 16, ("s2ds", "id", "id", "id")),
    ((2, 55, 55, 32), 16, ("s2pre", "id", "id")), ((1, 90, 37, 16), 16, ("ds", "id", "id")),
    ((2, 49, 67, 16), 16, ("s2ds",)), ((2, 30, 41, 48), 48, ("ds", "id")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,planes,blocks", QCHAIN_CASES)
def test_fused_chain_kernel_int8(cuda_device, shape, planes, blocks, dtype):
    """The int8 mode against its plain version. Both quantise with the same
    true f32 division and round half to even, sum the int8 products exactly
    and apply the same two f32 roundings, so they agree bit for bit unless the
    compilers differ by an ulp somewhere; then a quantised value may flip and
    move one term by one step (amax / 127 times a weight). The bound leaves
    room for that: the chain kernel's own bf16 bound, in both dtypes."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(np.maximum(rng.normal(size=shape), 0).astype(np.float32))
    x = x.to(cuda_device, dtype)
    folded, act_s = quantize_folded(rng, chain_weights(rng, shape[-1], planes, blocks))
    folded = quant_tensors(folded, cuda_device)
    act_s = torch.from_numpy(act_s).to(cuda_device)
    want = fused_resnet_kernel.fused_chain_plain(x, folded, blocks, act_s=act_s)
    before = fused_resnet_kernel.fused_chain.launches
    got = fused_resnet_kernel.fused_chain(x, folded, blocks, act_s=act_s)
    torch.cuda.synchronize()
    assert fused_resnet_kernel.fused_chain.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -5, rtol=2 ** -5)
    # and almost everywhere exactly
    assert float((got != want).float().mean()) < 1e-3


# Deep, narrow shapes as the detector's layer3 gives them (few work items,
# wide channels), where the plan spreads a work item over a cluster
CLUSTER_CASES = [((4, 12, 20, 256), ("id", "id", "id")), ((4, 12, 20, 256), ("s2ds", "id")),
                 ((3, 7, 7, 256), ("id",))]


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8 f32", "int8 bf16"])
@pytest.mark.parametrize("shape,blocks", CLUSTER_CASES)
@pytest.mark.parametrize("cluster", [2, 3, 4])
def test_fused_chain_cluster_equals_one_block(cuda_device, shape, blocks, cluster, mode):
    """A work item shared by a cluster of C thread blocks gives the result of
    one block bit for bit: each output is summed by the same instructions in
    the same order, whichever block of the cluster computes it. C is forced
    through the wrapper's private launch path."""
    rng = np.random.default_rng(10)
    dtype = torch.bfloat16 if mode.endswith("bf16") else torch.float32
    x = torch.from_numpy(np.maximum(rng.normal(size=shape), 0).astype(np.float32))
    x = x.to(cuda_device, dtype)
    weights = chain_weights(rng, shape[-1], shape[-1] // 4, blocks)
    act_s = None
    if mode.startswith("int8"):
        folded, act_s = quantize_folded(rng, weights)
        folded = quant_tensors(folded, cuda_device)
        act_s = torch.from_numpy(act_s).to(cuda_device)
    else:
        folded = tensors(weights, dtype, cuda_device)
    launch = fused_resnet_kernel._fused_chain_cuda
    one = launch(x, folded, blocks, act_s, cluster=1)
    before = fused_resnet_kernel.fused_chain.launches
    got = launch(x, folded, blocks, act_s, cluster=cluster)
    torch.cuda.synchronize()
    assert fused_resnet_kernel.fused_chain.launches == before + 1
    assert torch.equal(got, one)
    # and the plan's own C, which the public wrapper launches
    assert torch.equal(fused_resnet_kernel.fused_chain(x, folded, blocks, act_s=act_s), one)


def test_fused_chain_refused_cluster_raises(cuda_device):
    """A cluster size the kernel or the card refuses raises; nothing retries
    at another size, on the plain version or on the CPU."""
    rng = np.random.default_rng(11)
    x = torch.zeros((2, 12, 20, 64), device=cuda_device)
    folded = tensors(chain_weights(rng, 64, 16, ("id",)), device=cuda_device)
    before = fused_resnet_kernel.fused_chain.launches
    with pytest.raises(RuntimeError):
        fused_resnet_kernel._fused_chain_cuda(x, folded, ("id",), None, cluster=16)
    assert fused_resnet_kernel.fused_chain.launches == before


QSSH_CASES = [
    ((2, 12, 9, 64), 64, 0.0, False, False, False, False),
    ((2, 7, 5, 48), 64, 0.0, True, False, False, True),
    ((2, 23, 17, 48), 64, 0.0, True, True, True, True),
    ((2, 40, 37, 64), 64, 0.1, True, True, True, False),
    ((1, 45, 80, 32), 128, 0.0, True, True, True, True),
    # the mobilenet0.25 detector's shapes, as in SSH_CASES
    ((128, 23, 40, 128), 64, 0.1, True, True, True, True),
    ((8, 32, 56, 64), 64, 0.1, True, True, True, False),
    ((8, 8, 14, 256), 64, 0.1, True, False, False, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,c,leaky,lat,merge,has_up,emit", QSSH_CASES)
def test_fused_ssh_heads_kernel_int8(cuda_device, shape, c, leaky, lat, merge, has_up, emit,
                                     dtype):
    """The int8 option (lateral, merge and the five SSH convs in int8, heads
    exact) against its plain version; bounds as for the int8 chain, and for
    the heads' f32 sums in another order the exact kernel's."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.maximum(rng.normal(size=shape), 0).astype(np.float32))
    x = x.to(cuda_device, dtype)
    up = (torch.from_numpy(rng.normal(size=shape[:3] + (c,)).astype(np.float32))
          .to(cuda_device, dtype) if has_up else None)
    convs, heads, fl, fm = ssh_weights(rng, shape[-1], c, lat, merge)
    scales = []
    if lat:
        fl, sx = quantize_folded(rng, fl)
        scales.append(sx)
    if merge:
        fm, sx = quantize_folded(rng, fm)
        scales.append(sx)
    convs, sx = quantize_folded(rng, convs)
    act_s = torch.from_numpy(np.concatenate(scales + [sx])).to(cuda_device)
    convs, fl, fm = (quant_tensors(t, cuda_device) for t in (convs, fl, fm))
    heads = tensors(heads, dtype, cuda_device)
    kw = dict(leaky=leaky, fpn_lat=fl, fpn_merge=fm, up=up, emit_feature=emit, act_s=act_s)
    want = fused_ssh_kernel.fused_ssh_heads_plain(x, convs, heads, **kw)
    before = fused_ssh_kernel.fused_ssh_heads.launches
    got = fused_ssh_kernel.fused_ssh_heads(x, convs, heads, **kw)
    torch.cuda.synchronize()
    assert fused_ssh_kernel.fused_ssh_heads.launches == before + 1
    assert len(got) == len(want) == 3 + emit
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=2 ** -5, rtol=2 ** -5)


# Few work items, as the r50 detector's scales 2 and 3 give them: with and
# without the lateral, the merge, up and the emitted feature; C = 256 on the
# bf16 product's 128 x 128 tiles
SSH_CLUSTER_CASES = [((3, 12, 20, 128), 64, True, False, True),
                     ((2, 23, 40, 64), 64, True, True, True),
                     ((2, 12, 9, 64), 64, False, False, False),
                     ((2, 12, 20, 512), 256, True, True, True)]


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8 f32", "int8 bf16"])
@pytest.mark.parametrize("shape,c,lat,merge,emit", SSH_CLUSTER_CASES)
@pytest.mark.parametrize("cluster", [2, 3, 4])
def test_fused_ssh_cluster_equals_one_block(cuda_device, shape, c, lat, merge, emit, cluster,
                                            mode):
    """A work item of fused_ssh_heads shared by a cluster of C thread blocks
    gives the result of one block bit for bit: every conv output and every
    head output is summed by the same instructions in the same order,
    whichever block computes it. C is forced through the wrapper's private
    launch path."""
    rng = np.random.default_rng(13)
    dtype = torch.bfloat16 if mode.endswith("bf16") else torch.float32
    x = torch.from_numpy(np.maximum(rng.normal(size=shape), 0).astype(np.float32))
    x = x.to(cuda_device, dtype)
    up = (torch.from_numpy(rng.normal(size=shape[:3] + (c,)).astype(np.float32))
          .to(cuda_device, dtype) if merge else None)
    convs, heads, fl, fm = ssh_weights(rng, shape[-1], c, lat, merge)
    act_s = None
    if mode.startswith("int8"):
        scales = []
        if lat:
            fl, sx = quantize_folded(rng, fl)
            scales.append(sx)
        if merge:
            fm, sx = quantize_folded(rng, fm)
            scales.append(sx)
        convs, sx = quantize_folded(rng, convs)
        act_s = torch.from_numpy(np.concatenate(scales + [sx])).to(cuda_device)
        convs, fl, fm = (quant_tensors(t, cuda_device) for t in (convs, fl, fm))
    else:
        convs, fl, fm = (tensors(t, dtype, cuda_device) for t in (convs, fl, fm))
    heads = tensors(heads, dtype, cuda_device)
    kw = dict(leaky=0.0, fpn_lat=fl, fpn_merge=fm, up=up, emit_feature=emit, act_s=act_s)
    launch = fused_ssh_kernel._fused_ssh_cuda
    one = launch(x, convs, heads, cluster=1, **kw)
    before = fused_ssh_kernel.fused_ssh_heads.launches
    got = launch(x, convs, heads, cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert fused_ssh_kernel.fused_ssh_heads.launches == before + 1
    assert len(got) == len(one) == 3 + emit
    assert all(torch.equal(g, o) for g, o in zip(got, one))
    # and the plan's own C, which the public wrapper launches
    assert all(torch.equal(g, o) for g, o in zip(
        fused_ssh_kernel.fused_ssh_heads(x, convs, heads, **kw), one))


def test_fused_ssh_refused_cluster_raises(cuda_device):
    """A cluster size the kernel or the card refuses raises; nothing retries
    at another size, on the plain version or on the CPU."""
    rng = np.random.default_rng(14)
    x = torch.zeros((2, 12, 20, 64), device=cuda_device)
    convs, heads, _, _ = (tensors(t, device=cuda_device)
                          for t in ssh_weights(rng, 64, 64, False, False))
    before = fused_ssh_kernel.fused_ssh_heads.launches
    with pytest.raises(RuntimeError):
        fused_ssh_kernel._fused_ssh_cuda(x, convs, heads, cluster=16)
    assert fused_ssh_kernel.fused_ssh_heads.launches == before


# the three cases of the JAX package's test of its flat kernel, and two more:
# a pitch that is no multiple of 8 before rounding up, and layer1's width
FLAT_CASES = [((2, 13, 17, 64), 24, ("ds", "id", "id"), 8), ((1, 37, 29, 128), 24, ("id", "id"), 16),
              ((1, 24, 16, 64), 24, ("ds",), 24), ((3, 41, 23, 16), 8, ("ds", "id"), 32),
              ((1, 90, 160, 64), 16, ("ds", "id", "id"), 32)]


@pytest.mark.parametrize("shape,planes,blocks,band", FLAT_CASES)
def test_fused_chain_flat_kernel_equals_chain_kernel_f32(cuda_device, shape, planes, blocks, band):
    """The flat kernel's contract: in f32 it equals ``fused_chain`` bit for
    bit (the same device routines sum the same terms in the same order), and
    it is within the chain kernel's bound of its own plain version."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device)
    cin = shape[-1]
    folded = chain_weights(rng, cin, planes, blocks)
    if blocks[0] == "id":  # chain_weights makes 4 * planes outputs: an identity needs cin
        folded = chain_weights(rng, cin, cin // 4, blocks)
    folded = tensors(folded, torch.float32, cuda_device)
    want = fused_resnet_kernel.fused_chain(x, folded, blocks)
    before = (fused_resnet_kernel.fused_chain_flat.launches, fused_resnet_kernel.fused_chain.launches)
    got = fused_resnet_kernel.fused_chain_flat(x, folded, blocks, band=band)
    torch.cuda.synchronize()
    assert (fused_resnet_kernel.fused_chain_flat.launches,
            fused_resnet_kernel.fused_chain.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, fused_resnet_kernel.fused_chain_flat_plain(x, folded, blocks, band=band),
        atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape,planes,blocks,band", FLAT_CASES[:4])
def test_fused_chain_flat_kernel_bf16(cuda_device, shape, planes, blocks, band):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    cin = shape[-1]
    folded = chain_weights(rng, cin, cin // 4 if blocks[0] == "id" else planes, blocks)
    folded = tensors(folded, torch.bfloat16, cuda_device)
    got = fused_resnet_kernel.fused_chain_flat(x, folded, blocks, band=band)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_resnet_kernel.fused_chain(x, folded, blocks))
    torch.testing.assert_close(
        got.float(), fused_resnet_kernel.fused_chain_flat_plain(x, folded, blocks).float(),
        atol=2 ** -5, rtol=2 ** -5)


# the seven stride-1 chains of the main paths (input shape, planes, blocks):
# detector layer1, layer3 tail and last at batch 32, emotion layer1, layer2
# last, layer3 tail and layer4 tail at batch 256
FLAT_MAIN_PATH = [((32, 90, 160, 64), 64, ("ds", "id", "id")),
                  ((32, 23, 40, 1024), 256, ("id", "id", "id")),
                  ((32, 23, 40, 1024), 256, ("id",)),
                  ((256, 55, 55, 64), 64, ("ds", "id", "id")),
                  ((256, 28, 28, 512), 128, ("id",)),
                  ((256, 14, 14, 1024), 256, ("id", "id", "id")),
                  ((256, 7, 7, 2048), 512, ("id",))]


@pytest.mark.parametrize("shape,planes,blocks", FLAT_MAIN_PATH)
def test_fused_chain_flat_kernel_main_path_shapes(cuda_device, shape, planes, blocks):
    """K5 at the main paths' stride-1 chains in bf16 equals K3 bit for bit."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, torch.bfloat16)
    folded = tensors(chain_weights(rng, shape[-1], planes, blocks), torch.bfloat16, cuda_device)
    got = fused_resnet_kernel.fused_chain_flat(x, folded, blocks)
    torch.cuda.synchronize()
    assert torch.equal(got, fused_resnet_kernel.fused_chain(x, folded, blocks))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,planes,blocks", FLAT_MAIN_PATH)
def test_fused_chain_flat_cluster_equals_one_block(cuda_device, shape, planes, blocks, dtype):
    """A band shared by a cluster of C = 2, 3 or 4 thread blocks gives the
    result of one block bit for bit, at the plan's band height (f32 on the
    first 4 frames, bf16 at the full batch)."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda_device, dtype)
    if dtype == torch.float32:
        x = x[:4].contiguous()
    folded = tensors(chain_weights(rng, shape[-1], planes, blocks), dtype, cuda_device)
    th = fused_resnet_kernel.flat_card_plan(x, folded, blocks)["th"]
    launch = fused_resnet_kernel._fused_chain_flat_cuda
    one = launch(x, folded, blocks, cluster=1, th=th)
    for c in (2, 3, 4):
        got = launch(x, folded, blocks, cluster=c, th=th)
        torch.cuda.synchronize()
        assert torch.equal(got, one), c


def test_fused_chain_flat_refused_cluster_raises(cuda_device):
    """A cluster size the kernel or the card refuses raises; nothing retries
    with another size or launches."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(2, 7, 7, 64)).astype(np.float32)).to(cuda_device)
    folded = tensors(chain_weights(rng, 64, 16, ("id",)), torch.float32, cuda_device)
    before = fused_resnet_kernel.fused_chain_flat.launches
    with pytest.raises(RuntimeError):
        fused_resnet_kernel._fused_chain_flat_cuda(x, folded, ("id",), cluster=16)
    assert fused_resnet_kernel.fused_chain_flat.launches == before


def test_fused_chain_flat_pads_input_channels(cuda_device):
    """20 bf16 input channels are no multiple of 16 bytes: a projection entry
    pads them with zeros (and the rows of the two weights that read them); an
    identity entry cannot and is refused."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(size=(2, 11, 9, 20)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    folded = tensors(chain_weights(rng, 20, 8, ("ds", "id")), torch.bfloat16, cuda_device)
    got = fused_resnet_kernel.fused_chain_flat(x, folded, ("ds", "id"))
    torch.cuda.synchronize()
    want = fused_resnet_kernel.fused_chain_flat_plain(x, folded, ("ds", "id"))
    torch.testing.assert_close(got.float(), want.float(), atol=2 ** -5, rtol=2 ** -5)
    ident = tensors(chain_weights(rng, 20, 5, ("id",)), torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="projection entry"):
        fused_resnet_kernel.fused_chain_flat(x, ident, ("id",))


def test_int8_products_on_the_card_are_exact(cuda_device):
    """``layers.int8_conv`` and ``int8_matmul`` on the card (``torch._int_mm``
    over the unfolded input) against the same functions on the CPU: the sums
    are integers on both, so the results are equal."""
    from avcer_tpu_torch.models import layers

    rng = np.random.default_rng(9)
    for k, stride, pad, ci, co in ((1, 1, 0, 64, 256), (3, 1, 1, 64, 64), (3, 2, 1, 128, 128),
                                   (7, 2, 0, 3, 64), (1, 2, 0, 2048, 24)):
        x = torch.from_numpy(rng.normal(size=(2, ci, 19, 23)).astype(np.float32))
        w = torch.from_numpy((rng.normal(size=(co, ci, k, k)) * 0.1).astype(np.float32))
        amax = torch.tensor(3.0)
        want = layers.int8_conv(x, w, stride=(stride, stride), padding=pad,
                                out_dtype=torch.float32, act_amax=amax)
        got = layers.int8_conv(x.to(cuda_device), w.to(cuda_device), stride=(stride, stride),
                               padding=pad, out_dtype=torch.float32,
                               act_amax=amax.to(cuda_device))
        assert torch.equal(got.cpu(), want), (k, stride, ci, co)
    x = torch.from_numpy(rng.normal(size=(3, 5, 1024)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(4096, 1024)) * 0.05).astype(np.float32))
    want = layers.int8_matmul(x, w, out_dtype=torch.float32)
    got = layers.int8_matmul(x.to(cuda_device), w.to(cuda_device), out_dtype=torch.float32)
    assert torch.equal(got.cpu(), want)


def test_fused_kernels_raise_on_bad_input(cuda_device):
    rng = np.random.default_rng(3)
    x = torch.zeros((1, 8, 8, 16), device=cuda_device)
    folded = tensors(chain_weights(rng, 16, 8, ("ds",)), device=cuda_device)
    with pytest.raises(ValueError):
        fused_resnet_kernel.fused_chain(x.half(), folded, ("ds",))
    with pytest.raises(ValueError):  # weights of another dtype
        fused_resnet_kernel.fused_chain(x.bfloat16(), folded, ("ds",))
    with pytest.raises(ValueError):  # 10 channels: not a multiple of 16 bytes
        fused_resnet_kernel.fused_chain(
            x[..., :10].contiguous(),
            tensors(chain_weights(rng, 10, 8, ("ds",)), device=cuda_device), ("ds",))
    with pytest.raises(ValueError):  # the int8 mode takes int8 weights
        fused_resnet_kernel.fused_chain(x, folded, ("ds",), act_s=torch.ones(4))
    convs, heads = (tensors(t, device=cuda_device)
                    for t in ssh_weights(rng, 16, 16, False, False)[:2])
    with pytest.raises(ValueError):  # x has 8 channels, the convs read 16
        fused_ssh_kernel.fused_ssh_heads(x[..., :8].contiguous(), convs, heads)


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_mobilenet_detector_fused_matches_unfused(cuda_device, mode):
    """The mobilenet0.25 RetinaFace on the card, 448 x 252 frames: with
    ``fused_ssh + fused_fpn`` (three launches of the kernel with leaky 0.1 a
    forward) against the unfused model over the same seeded weights. f32: the
    kernel's own bound against cuDNN's sums in another order (1e-4 of the
    largest value); bf16: the unfused model rounds after the conv and again in
    its BatchNorm, the kernel once (relative L2 under 2 %); int8 (f32 between
    the exact int8 products, the same calibrated scales): almost every value
    agrees to 1e-8, but the unfused model dequantises and normalises in two
    roundings and the kernel in one, so here and there a value quantises one
    step apart downstream (measured: 3e-3 of the largest value): 2e-2 of the
    largest value and a relative L2 under 5e-3."""
    from avcer_tpu_torch.models import layers
    from avcer_tpu_torch.models.retinaface import RetinaFace

    quant = mode == "int8"
    dtype = torch.bfloat16 if mode == "bf16" else torch.float32
    rng = np.random.default_rng(9)
    x = torch.from_numpy((rng.normal(size=(4, 252, 448, 3)) * 40).astype(np.float32))
    models = []
    for switches in ({}, dict(fused_ssh=True, fused_fpn=True)):
        m = RetinaFace(backbone="mobilenet0.25", quant=quant, **switches)
        layers.seeded_init_(m, torch.Generator().manual_seed(0)).eval().requires_grad_(False)
        models.append(layers.cast_compute(m, dtype).to(cuda_device))
    unfused, fused = models
    with torch.inference_mode():
        if quant:
            with layers.calibrating(unfused):
                unfused(x.to(cuda_device))
            layers.load_act_scales(fused, layers.act_scales(unfused))
        want = unfused(x.to(cuda_device))
        before = fused_ssh_kernel.fused_ssh_heads.launches
        fused_ssh_kernel.fused_ssh_heads.launches_by_leaky.clear()
        got = fused(x.to(cuda_device))
        torch.cuda.synchronize()
    assert fused_ssh_kernel.fused_ssh_heads.launches == before + 3
    assert fused_ssh_kernel.fused_ssh_heads.launches_by_leaky == {0.1: 3}
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] == (32 * 56 + 16 * 28 + 8 * 14) * 2
        g, w = g.float(), w.float()
        rel_l2, rel_max = float((g - w).norm() / w.norm()), float(
            (g - w).abs().max() / w.abs().max())
        if mode == "bf16":
            assert rel_l2 < 0.02
        elif quant:
            assert rel_max < 2e-2 and rel_l2 < 5e-3
        else:
            assert rel_max < 1e-4


def test_gradcam_from_fused_cnn_matches_cpu(cuda_device):
    """Grad-CAM on the card: layer4's output from K3 (the fused emotion CNN,
    f32) and the gradient through the fc head, against the unfused model's
    on the CPU with the same weights, for each crop's most probable class:
    masks within 1e-3."""
    from avcer_tpu_torch.models.emotion_resnet import EmotionResNet50
    from avcer_tpu_torch.models.temporal_lstm import TemporalLSTM
    from avcer_tpu_torch.pipeline.visual import VisualStage

    torch.manual_seed(0)
    cpu = EmotionResNet50(7).eval().requires_grad_(False)
    card = EmotionResNet50(7, fused=True, fused_entries=True)
    card.load_state_dict(cpu.state_dict())
    card = card.eval().requires_grad_(False).to(cuda_device)
    crops = np.random.default_rng(0).integers(0, 255, (4, 224, 224, 3), np.uint8)
    stage = VisualStage(cpu, TemporalLSTM(7), batch_size=4, device="cpu")
    classes = stage.run_static(crops)[0].argmax(-1)  # the class the heatmaps take
    want = stage.gradcam(crops, classes)
    before = fused_resnet_kernel.fused_chain.launches
    got = VisualStage(card, TemporalLSTM(7), batch_size=4, device=cuda_device).gradcam(
        crops, classes)
    assert fused_resnet_kernel.fused_chain.launches == before + 7
    assert got.shape == want.shape == (4, 7, 7) and (want.max(axis=(1, 2)) == 1).all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_expr_model_v1_bf16_on_card(cuda_device):
    """ExprModel V1 in the pipeline's bf16 on the card (the GRU in f32,
    cuDNN's) against f32 on the CPU: relative L2 of the logits under 5 %."""
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.layers import cast_compute
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config

    torch.manual_seed(0)
    cfg = Wav2Vec2Config(hidden_size=256, num_layers=2, num_heads=4, intermediate_size=512)
    cpu = ExprModel("v1", 7, cfg).eval()
    card = cast_compute(ExprModel("v1", 7, cfg), torch.bfloat16)
    card.load_state_dict(cpu.state_dict())
    card = card.eval().to(cuda_device)
    wav = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 64000)).astype(np.float32))
    with torch.inference_mode():
        want = cpu(wav)
        got = card(wav.to(cuda_device)).float().cpu()
    assert got.shape == (3, 7)
    assert float((got - want).norm() / want.norm()) < 0.05


def test_mha_refuses_operands_that_require_grad(cuda_device):
    """The kernel has no backward: under grad mode a grad-requiring operand
    raises; under no_grad, or without requires_grad, it launches."""
    q = torch.randn(2, 4, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    for which in range(3):
        args = [q.clone(), q.clone(), q.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="requires grad"):
            attention_kernel.mha(*args)
        before = attention_kernel.mha.launches
        with torch.no_grad():
            attention_kernel.mha(*args)
        assert attention_kernel.mha.launches == before + 1
    attention_kernel.mha(q, q, q)


def test_autocast_bf16_train_step_on_card(cuda_device):
    """One train step of the tiny ExprModel V3 on the card in bf16 under
    autocast, mixup and dropout on: K2 runs once (the frozen layer 0), the
    trainable layer 1 takes the autograd attention, its q, k, v get a
    non-zero gradient, the loss is finite and the parameters stay f32."""
    from avcer_tpu_torch.core.config import OptimConfig, TrainConfig
    from avcer_tpu_torch.models.audio_heads import ExprModel
    from avcer_tpu_torch.models.wav2vec2 import Wav2Vec2Config
    from avcer_tpu_torch.train.trainer import Trainer

    w2v = Wav2Vec2Config(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                         conv_dim=(16,) * 7, remat=True)
    cfg = TrainConfig(augmentation=True, optim=OptimConfig(lr=1e-3))
    trainer = Trainer(ExprModel("v3", 8, w2v), cfg, iters_per_epoch=2, unfreeze_last_n=1,
                      wav2vec2_layers=2, device=cuda_device, dtype="bfloat16")
    state = trainer.init_state()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 17600)).astype(np.float32)
    y = rng.integers(0, 8, 4)
    before = attention_kernel.mha.launches
    state, loss, logits = trainer.train_step(state, x, y)
    assert attention_kernel.mha.launches == before + 1
    assert np.isfinite(loss) and logits.shape == (4, 8)
    attn = state.model.wav2vec2.encoder.layers[1].attention
    for proj in (attn.q_proj, attn.k_proj, attn.v_proj):
        assert float(proj.weight.grad.norm()) > 0 and proj.weight.dtype == torch.float32
