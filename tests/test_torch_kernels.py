"""The CUDA kernels' plain versions against the JAX package's Pallas kernels,
run in interpret mode on the CPU, and the dispatch rule of the wrappers: a
CPU tensor takes the plain path and launches nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avcer_tpu.ops.pallas.attention_kernel import pallas_mha
from avcer_tpu.ops.pallas.nms_kernel import pallas_nms_mask

from avcer_tpu_torch.ops import nms as nms_ops
from avcer_tpu_torch.ops.cuda import attention_kernel, nms_kernel

torch.set_num_threads(2)


def nms_case(seed: int, b: int, k: int, ties: bool):
    """Boxes as tests/test_pallas_kernels.py makes them; ``ties`` adds exact
    duplicate rows and integer boxes whose legacy IoU is exactly 0.4 (kept)
    or 0.5 (suppressed)."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 200, (b, k)).astype(np.float32)
    cy = rng.uniform(0, 200, (b, k)).astype(np.float32)
    w = rng.uniform(5, 80, (b, k)).astype(np.float32)
    h = rng.uniform(5, 80, (b, k)).astype(np.float32)
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)
    scores = -np.sort(-rng.random((b, k)).astype(np.float32), axis=1)
    valid = scores > 0.3
    if ties:
        boxes[:, 2] = boxes[:, 1]
        boxes[:, 5] = [300, 300, 309, 309]
        boxes[:, 6] = [300, 300, 309, 303]
        boxes[:, 7] = [300, 300, 309, 304]
        valid[:, :8] = True
    return boxes, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("ties", [False, True])
def test_nms_plain_equals_pallas_interpret(seed, k, ties):
    boxes, valid = nms_case(seed, 4, k, ties)
    want = np.asarray(pallas_nms_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.4,
                                      interpret=True))
    got = nms_kernel.nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.4)
    np.testing.assert_array_equal(got.numpy(), want)
    if ties:
        assert not got[:, 2].any() and got[:, 5].all() and got[:, 6].all()
        assert not got[:, 7].any()


def nms_bitmask_model(boxes: torch.Tensor, valid: torch.Tensor, thresh: float) -> torch.Tensor:
    """``csrc/nms.cu``'s algorithm on the CPU: the suppression bits of a frame
    packed into 64-bit words (``sup[i, w]`` bit b: row i suppresses column j
    = 64 w + b > i, IoU > thresh strictly), then the greedy sweep word by
    word, ``alive`` starting as the valid mask and row i, while alive,
    clearing ``sup[i]`` from it. Words are Python ints."""
    b, k, _ = boxes.shape
    nw = -(-k // 64)
    later = torch.arange(k)[None, :] > torch.arange(k)[:, None]
    sup_bits = (nms_ops.iou_matrix_legacy(boxes) > thresh) & later  # [B, K, K]
    keep = torch.zeros((b, k), dtype=torch.bool)
    for f in range(b):
        def words(bits):
            return [sum(1 << j for j in range(64) if 64 * w + j < k and bits[64 * w + j])
                    for w in range(nw)]

        sup = [words(sup_bits[f, i].tolist()) for i in range(k)]
        alive = words(valid[f].tolist())
        for i in range(k):
            if (alive[i // 64] >> (i % 64)) & 1:
                alive = [a & ~s for a, s in zip(alive, sup[i])]
        keep[f] = torch.tensor([bool((alive[j // 64] >> (j % 64)) & 1) for j in range(k)])
    return keep


@pytest.mark.parametrize("k", [1, 8, 63, 64, 65, 200, 1000])
def test_nms_bitmask_model_equals_pallas_and_plain(k):
    """The word-wise sweep of the card's kernel gives the keep masks of the
    Pallas kernel (interpret mode) and of the plain version at one to 16
    words a row, with the tie rows of ``nms_case`` (K >= 8)."""
    boxes, valid = nms_case(k, 2, k, k >= 8)
    want = np.asarray(pallas_nms_mask(jnp.asarray(boxes), jnp.asarray(valid), 0.4,
                                      interpret=True))
    bt, vt = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = nms_bitmask_model(bt, vt, 0.4)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(nms_kernel.nms_mask_plain(bt, vt, 0.4).numpy(), want)
    if k >= 8:
        assert not got[:, 2].any() and got[:, 5].all() and got[:, 6].all()
        assert not got[:, 7].any()


@pytest.mark.parametrize("shape", [(2, 4, 33, 16), (1, 2, 199, 64)])
def test_attention_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    want = np.asarray(pallas_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 interpret=True))
    got = attention_kernel.mha(*(torch.from_numpy(a) for a in (q, k, v)))
    # the bound of test_pallas_mha_matches_xla
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-4)


def test_attention_plain_keeps_input_dtype():
    q = torch.randn(1, 2, 9, 8, generator=torch.Generator().manual_seed(0)).bfloat16()
    out = attention_kernel.mha(q, q, q)
    assert out.dtype == torch.bfloat16
    want = attention_kernel.mha_plain(q.float(), q.float(), q.float())
    torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=4e-3)


@pytest.mark.parametrize("dtype,t,d,kernel", [
    (torch.bfloat16, 199, 64, "tc"), (torch.bfloat16, 1, 16, "tc"),
    (torch.bfloat16, 256, 128, "tc"), (torch.bfloat16, 257, 64, "exact"),
    (torch.bfloat16, 199, 8, "exact"), (torch.bfloat16, 199, 72, "exact"),
    (torch.float32, 199, 64, "exact")])
def test_attention_kernel_choice(dtype, t, d, kernel):
    """On the card the dtype and the shape alone choose the kernel."""
    assert attention_kernel.kernel_for(dtype, t, d) == kernel


@pytest.mark.parametrize("split", [True, False])
def test_attention_split_p_keeps_the_bound(split):
    """The tensor-core kernel's arithmetic, replayed in f32 on the CPU at the
    wav2vec2 shape (two heads): logits of bf16 operands, exp(logit - row
    max), its product with V in bf16 with the exp values as bf16 hi + lo
    parts, divided by the row sum, rounded to bf16. With the split it stays
    within the bound the card holds it to against the f32 plain version
    (atol 1e-5, rtol 4e-3); the exp values rounded once to bf16 do not, at
    the outputs near zero."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 199, 64)).astype(np.float32)).bfloat16()
               for _ in range(3))
    want = attention_kernel.mha_plain(q.float(), k.float(), v.float())
    logits = q.float() @ k.float().transpose(-1, -2) / torch.tensor(64.0).sqrt()
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    hi = e.bfloat16().float()
    parts = (hi, (e - hi).bfloat16().float()) if split else (hi,)
    got = (sum(part @ v.float() for part in parts) / e.sum(-1, keepdim=True)).bfloat16().float()
    ok = bool(((got - want).abs() <= 1e-5 + 4e-3 * want.abs()).all())
    assert ok == split


def test_cpu_tensors_launch_no_kernel():
    n0, a0 = nms_kernel.nms_mask.launches, attention_kernel.mha.launches
    boxes, valid = nms_case(0, 2, 8, False)
    nms_kernel.nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.4)
    q = torch.zeros(1, 1, 4, 8)
    attention_kernel.mha(q, q, q)
    assert (nms_kernel.nms_mask.launches, attention_kernel.mha.launches) == (n0, a0)
