// Batched greedy NMS keep mask for the RetinaFace detect stage.
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/nms_kernel.py
// (pallas_nms_mask, body _nms_kernel): per frame, the legacy IoU with +1 on
// widths and heights, suppression where IoU > thresh strictly, and a greedy
// sweep over the score-sorted candidate rows. keep = survived & valid; an
// invalid row can be suppressed but never suppresses.
//
// What bounds it on the H100: nothing the card is short of. The detect path
// calls it with B = 32 or 128 frames of K = 64 candidates (1 KB of boxes a
// frame): about 2016 IoUs of some 20 f32 operations a frame, 15 ns of the
// card's f32 rate for the whole batch. The real floor is one launch plus
// the K-step dependent chain of the greedy sweep.
//
// Design: one block of 1024 threads per frame, in two phases.
//  1. Suppression bits, all at once. Every warp takes (row i, 32 columns)
//     items; lane l computes the IoU of row i with column j = 32 c + l and
//     __ballot_sync packs "j > i and IoU > thresh" into one 32-bit word:
//     sup[i] has bit j set when row i, if it survives, suppresses column j.
//     The whole upper triangle (about K^2 / 2 IoUs, 2 a thread at K = 64)
//     is computed in parallel, 32 warps hiding each other's latency, into
//     shared memory (K^2 / 8 bytes: 128 KB at
//     K = 1024, dynamic shared memory opted in above 48 KB). Items wholly
//     below the diagonal store 0 without an IoU.
//  2. The greedy sweep, in one warp and in registers. Lane w holds 64-bit
//     word w of the `alive` mask (W = ceil(K / 64) <= 16 words), which
//     starts as the valid mask. For i = 0 .. K - 1 the warp fetches row i's
//     alive bit with one __shfl_sync; if it is set, each lane clears its
//     word of sup[i] from `alive`. No block barrier in the sweep: each step
//     is a shuffle, a shared-memory load that does not depend on the chain
//     (issued a step ahead), and an and-not. keep = alive at the end.
// The K x K IoU work, which a sweep of one block barrier and one IoU a step
// would serialise behind the chain, is off the dependent path.
//
// The keep set must equal the JAX reference bit for bit, so every IoU
// operation uses the round-to-nearest intrinsics in the order of
// avcer_tpu/ops/boxes.py iou_matrix_legacy, and the file is compiled with
// --fmad=false (see avcer_tpu_torch/_build.py): no fused multiply-add can
// move an IoU across the threshold.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Shared memory of one frame: the suppression words (sup32 rows of w32
// words, w32 even so that two of them read as one 64-bit word), the alive
// words, the valid words, then the boxes and areas.
struct Layout {
  int w32, w64;
  size_t sup, alive, valid, x1, bytes;
  __host__ __device__ explicit Layout(int k) {
    w64 = (k + 63) / 64;
    w32 = 2 * w64;
    sup = 0;
    alive = sup + sizeof(uint32_t) * k * w32;
    valid = alive + sizeof(uint64_t) * w64;
    x1 = valid + sizeof(uint32_t) * w32;
    bytes = x1 + sizeof(float) * 5 * k;
  }
};

__device__ __forceinline__ float legacy_iou(float ax1, float ay1, float ax2, float ay2,
                                            float aarea, float bx1, float by1, float bx2,
                                            float by2, float barea) {
  const float xx1 = fmaxf(ax1, bx1);
  const float yy1 = fmaxf(ay1, by1);
  const float xx2 = fminf(ax2, bx2);
  const float yy2 = fminf(ay2, by2);
  const float w = fmaxf(0.0f, __fadd_rn(__fsub_rn(xx2, xx1), 1.0f));
  const float h = fmaxf(0.0f, __fadd_rn(__fsub_rn(yy2, yy1), 1.0f));
  const float inter = __fmul_rn(w, h);
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(aarea, barea), inter));
}

__global__ void __launch_bounds__(kThreads)
    nms_bitmask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                       uint8_t* __restrict__ keep_out, int k, float thresh) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(k);
  uint32_t* sup = reinterpret_cast<uint32_t*>(smem + L.sup);
  uint64_t* alive_out = reinterpret_cast<uint64_t*>(smem + L.alive);
  uint32_t* validw = reinterpret_cast<uint32_t*>(smem + L.valid);
  float* x1 = reinterpret_cast<float*>(smem + L.x1);
  float* y1 = x1 + k;
  float* x2 = y1 + k;
  float* y2 = x2 + k;
  float* area = y2 + k;

  const int frame = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* fb = boxes + static_cast<size_t>(frame) * k * 4;
  const uint8_t* fv = valid + static_cast<size_t>(frame) * k;

  // boxes, areas and the valid words (kThreads is a multiple of 32: a warp
  // covers one 32-column chunk at a time)
  for (int j = tid; j < 32 * L.w32; j += kThreads) {
    bool ok = false;
    if (j < k) {
      const float a = fb[4 * j], b = fb[4 * j + 1];
      const float c = fb[4 * j + 2], d = fb[4 * j + 3];
      x1[j] = a;
      y1[j] = b;
      x2[j] = c;
      y2[j] = d;
      // areas = (x2 - x1 + 1) * (y2 - y1 + 1)
      area[j] = __fmul_rn(__fadd_rn(__fsub_rn(c, a), 1.0f), __fadd_rn(__fsub_rn(d, b), 1.0f));
      ok = fv[j] != 0;
    }
    const uint32_t bits = __ballot_sync(kFull, ok);
    if (lane == 0) validw[j / 32] = bits;
  }
  __syncthreads();

  // phase 1: sup[i][c] bit l <=> j = 32 c + l > i and IoU(i, j) > thresh
  const int items = k * L.w32;
  for (int it = warp; it < items; it += kThreads / 32) {
    const int i = it / L.w32, c = it % L.w32;
    uint32_t bits = 0;
    if (32 * c + 31 > i) {  // some column of the chunk lies after row i
      const int j = 32 * c + lane;
      bool sup_ij = false;
      if (j > i && j < k)
        sup_ij = legacy_iou(x1[i], y1[i], x2[i], y2[i], area[i], x1[j], y1[j], x2[j], y2[j],
                            area[j]) > thresh;
      bits = __ballot_sync(kFull, sup_ij);
    }
    if (lane == 0) sup[it] = bits;
  }
  __syncthreads();

  // phase 2: the greedy sweep in warp 0, lane w holding alive word w; the
  // next row's word is loaded while this one is applied, and a row that does
  // not survive clears nothing (no branch on the chain)
  if (warp == 0) {
    const uint64_t* sup64 = reinterpret_cast<const uint64_t*>(sup);
    const bool mine = lane < L.w64;
    uint64_t alive = 0, next = 0;
    if (mine) {
      alive = static_cast<uint64_t>(validw[2 * lane]) |
              (static_cast<uint64_t>(validw[2 * lane + 1]) << 32);
      next = sup64[lane];
    }
    for (int i = 0; i < k; ++i) {
      const uint64_t row = next;
      if (mine && i + 1 < k) next = sup64[(i + 1) * L.w64 + lane];
      const uint64_t word = __shfl_sync(kFull, alive, i / 64);
      // all ones if row i survived and is valid: it suppresses
      const uint64_t live = 0ull - ((word >> (i % 64)) & 1ull);
      alive &= ~(row & live);
    }
    if (mine) alive_out[lane] = alive;
  }
  __syncthreads();

  for (int j = tid; j < k; j += kThreads)
    keep_out[static_cast<size_t>(frame) * k + j] =
        static_cast<uint8_t>((alive_out[j / 64] >> (j % 64)) & 1);
}

}  // namespace

// boxes [b, k, 4] f32 contiguous, valid [b, k] bool, keep [b, k] bool;
// k <= 1024. Launches on `stream` and returns a CUDA error code as an
// int (cudaErrorInvalidValue for a k the kernel does not take).
extern "C" int avcer_nms_mask(const void* boxes, const void* valid, void* keep, int b, int k,
                              float thresh, void* stream) {
  if (b <= 0 || k <= 0) return 0;
  if (k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(k).bytes;
  // above 48 KB (K > 532) a block's shared memory must be opted in
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_bitmask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nms_bitmask_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), k, thresh);
  return static_cast<int>(cudaGetLastError());
}
