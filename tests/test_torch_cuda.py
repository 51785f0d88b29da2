"""CUDA kernels of avcer_tpu_torch against their plain PyTorch versions, on
the card. Every test here needs an NVIDIA GPU with nvcc and skips without
one. This file imports no jax, so it runs on a machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from avcer_tpu_torch.ops.cuda import attention_kernel, nms_kernel

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
@pytest.mark.parametrize("b,k", [(32, 64), (3, 8), (2, 1000)])
def test_nms_kernel_equals_plain(cuda_device, seed, b, k):
    boxes, valid = nms_case(seed, b, k)
    bt = torch.from_numpy(boxes).to(cuda_device)
    vt = torch.from_numpy(valid).to(cuda_device)
    want = nms_kernel.nms_mask_plain(bt, vt, 0.4).cpu().numpy()
    before = nms_kernel.nms_mask.launches
    got = nms_kernel.nms_mask(bt, vt, 0.4)
    torch.cuda.synchronize()
    assert nms_kernel.nms_mask.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


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


@pytest.mark.parametrize("shape", [(16, 16, 199, 64), (2, 4, 33, 16)])
def test_attention_kernel_bf16(cuda_device, shape):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               .to(cuda_device, torch.bfloat16) for _ in range(3))
    got = attention_kernel.mha(q, k, v)
    assert got.dtype == torch.bfloat16
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
