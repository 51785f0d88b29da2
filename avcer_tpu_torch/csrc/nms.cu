// Batched greedy NMS keep mask for the RetinaFace detect stage.
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/nms_kernel.py
// (pallas_nms_mask, body _nms_kernel): per frame, the legacy IoU with +1 on
// widths and heights, suppression where IoU > thresh strictly, and a greedy
// sweep over the score-sorted candidate rows. keep = survived & valid.
//
// What bounds it on the H100: nothing the card is short of. The detect path
// calls it with B = 32 frames of K = 64 candidates (1 KB of boxes per frame),
// so the time is one launch plus a K-step sequential sweep; each step is a
// barrier and one IoU per thread. The design keeps the whole sweep in one
// block per frame with the boxes and the keep flags in shared memory, so the
// K steps cost block barriers, not launches or device-memory round trips.
// The TPU kernel materialised the full K x K IoU matrix in VMEM; here each
// thread recomputes its column's IoU against row i only when row i is
// still kept, which needs no K x K storage and so works up to K = 1024.
//
// The keep set must equal the JAX reference bit for bit, so every IoU
// operation uses the round-to-nearest intrinsics in the order of
// avcer_tpu/ops/boxes.py iou_matrix_legacy, and the file is compiled with
// --fmad=false (see avcer_tpu_torch/_build.py): no fused multiply-add can
// move an IoU across the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nms_kernel(const float* __restrict__ boxes,
                           const uint8_t* __restrict__ valid,
                           uint8_t* __restrict__ keep_out, int k,
                           float thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;
  int* keep = reinterpret_cast<int*>(area + k);

  const int frame = blockIdx.x;
  const int j = threadIdx.x;
  const float* fb = boxes + static_cast<size_t>(frame) * k * 4;
  const uint8_t* fv = valid + static_cast<size_t>(frame) * k;

  if (j < k) {
    const float a = fb[4 * j], b = fb[4 * j + 1];
    const float c = fb[4 * j + 2], d = fb[4 * j + 3];
    x1[j] = a;
    y1[j] = b;
    x2[j] = c;
    y2[j] = d;
    // areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    area[j] = __fmul_rn(__fadd_rn(__fsub_rn(c, a), 1.0f),
                        __fadd_rn(__fsub_rn(d, b), 1.0f));
    keep[j] = 1;
  }
  __syncthreads();

  for (int i = 0; i < k; ++i) {
    // Row i suppresses later rows iff it is itself valid and still kept.
    // Only thread j writes keep[j], and keep[i] was last written in a
    // step before i, so one barrier per step orders every read and write.
    if (j > i && j < k && keep[i] && fv[i]) {
      const float xx1 = fmaxf(x1[i], x1[j]);
      const float yy1 = fmaxf(y1[i], y1[j]);
      const float xx2 = fminf(x2[i], x2[j]);
      const float yy2 = fminf(y2[i], y2[j]);
      const float w = fmaxf(0.0f, __fadd_rn(__fsub_rn(xx2, xx1), 1.0f));
      const float h = fmaxf(0.0f, __fadd_rn(__fsub_rn(yy2, yy1), 1.0f));
      const float inter = __fmul_rn(w, h);
      const float iou =
          __fdiv_rn(inter, __fsub_rn(__fadd_rn(area[i], area[j]), inter));
      if (iou > thresh) keep[j] = 0;
    }
    __syncthreads();
  }

  if (j < k) {
    keep_out[static_cast<size_t>(frame) * k + j] =
        static_cast<uint8_t>(keep[j] && fv[j]);
  }
}

}  // namespace

// boxes [b, k, 4] f32 contiguous, valid [b, k] bool, keep [b, k] bool.
// Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int avcer_nms_mask(const void* boxes, const void* valid, void* keep,
                              int b, int k, float thresh, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  const int threads = ((k + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(k) * (5 * sizeof(float) + sizeof(int));
  nms_kernel<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
