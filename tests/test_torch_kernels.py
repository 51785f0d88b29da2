"""The CUDA kernels' plain versions against the JAX package's Pallas kernels,
run in interpret mode on the CPU, and the dispatch rule of the wrappers: a
CPU tensor takes the plain path and launches nothing."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avcer_tpu.ops.pallas.attention_kernel import pallas_mha
from avcer_tpu.ops.pallas.nms_kernel import pallas_nms_mask

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


def test_cpu_tensors_launch_no_kernel():
    n0, a0 = nms_kernel.nms_mask.launches, attention_kernel.mha.launches
    boxes, valid = nms_case(0, 2, 8, False)
    nms_kernel.nms_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.4)
    q = torch.zeros(1, 1, 4, 8)
    attention_kernel.mha(q, q, q)
    assert (nms_kernel.nms_mask.launches, attention_kernel.mha.launches) == (n0, a0)
