// Unmasked multi-head self-attention for the wav2vec2 encoder layers.
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/attention_kernel.py
// (pallas_mha, body _attn_kernel): per (batch, head), softmax(Q K^T / sqrt(d))
// V with Q, K and V upcast to f32, the logits divided by sqrt(d) in f32, the
// softmax in f32 (max, exp, sum, divide), P V in f32 and the output stored in
// the input dtype. Accepts f32 and bf16, T <= 1024 and D <= 128.
//
// What bounds it on the H100: at the wav2vec2 shape (B 16, H 16, T 199,
// D 64, bf16) one call reads and writes 26 MB (8 us at 3.35 TB/s) and does
// 2.6 GFLOP. This kernel does that arithmetic in f32 on the CUDA cores, not
// on the tensor cores, so the f32 FMA rate bounds it (about 40 us at the
// card's 67 TFLOP/s f32 peak). It is written to be right first: wgmma, TMA
// and an online softmax are later work.
//
// Design: one block per (batch*head, tile of 32 queries), 8 warps. The block
// keeps its query tile, the logits of its 32 rows over all T keys, and one
// 64-key tile of K (rows padded to D+1 floats, so the 32 lanes of a warp read
// 32 different banks) or V in dynamic shared memory, all in f32. Each warp
// owns 4 query rows: it computes their logits over the K tiles, then the row
// max, exp and sum with warp shuffles, then accumulates P V over the V tiles
// in registers (each lane owns output columns lane, lane+32, ...). Nothing
// but Q, K, V and the output touches device memory, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kQTile = 32;
constexpr int kKTile = 64;
constexpr int kRowsPerWarp = kQTile / kWarps;
constexpr int kMaxT = 1024;
constexpr int kMaxD = 128;
constexpr int kColsPerLane = kMaxD / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_floats(int t, int d) {
  return static_cast<size_t>(kQTile) * d        // query tile
         + static_cast<size_t>(kKTile) * (d + 1)  // K tile, padded rows
         + static_cast<size_t>(kKTile) * d        // V tile
         + static_cast<size_t>(kQTile) * t;       // logits, then probabilities
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int t, int d) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kQTile * d;
  float* vs = ks + kKTile * (d + 1);
  float* s = vs + kKTile * d;

  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const int q0 = blockIdx.y * kQTile;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float sqrt_d = sqrtf(static_cast<float>(d));

  for (int idx = tid; idx < kQTile * d; idx += kThreads) {
    const int row = q0 + idx / d;
    qs[idx] = row < t ? to_f32(q[base + static_cast<size_t>(row) * d + idx % d])
                      : 0.0f;
  }

  // logits = (q . k) / sqrt(d), over K tiles
  for (int k0 = 0; k0 < t; k0 += kKTile) {
    const int nk = min(kKTile, t - k0);
    __syncthreads();  // the previous tile is consumed (and qs is loaded)
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      const int r = idx / d, c = idx % d;
      ks[r * (d + 1) + c] = to_f32(k[base + static_cast<size_t>(k0 + r) * d + c]);
    }
    __syncthreads();
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const int r = warp + ri * kWarps;
      const float* qr = qs + r * d;
      for (int kk = lane; kk < nk; kk += 32) {
        const float* kr = ks + kk * (d + 1);
        float acc = 0.0f;
        for (int c = 0; c < d; ++c) acc += qr[c] * kr[c];
        s[r * t + k0 + kk] = acc / sqrt_d;
      }
    }
  }
  __syncwarp();

  // f32 softmax over each of this warp's rows: max, exp, sum, divide
  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    float* sr = s + (warp + ri * kWarps) * t;
    float m = -INFINITY;
    for (int kk = lane; kk < t; kk += 32) m = fmaxf(m, sr[kk]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int kk = lane; kk < t; kk += 32) {
      const float e = expf(sr[kk] - m);
      sr[kk] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int kk = lane; kk < t; kk += 32) sr[kk] = sr[kk] / sum;
  }

  // out = P V, over V tiles, accumulated in registers
  float acc[kRowsPerWarp][kColsPerLane];
  for (int ri = 0; ri < kRowsPerWarp; ++ri)
    for (int ci = 0; ci < kColsPerLane; ++ci) acc[ri][ci] = 0.0f;
  for (int k0 = 0; k0 < t; k0 += kKTile) {
    const int nk = min(kKTile, t - k0);
    __syncthreads();  // every warp is done with the previous V tile
    for (int idx = tid; idx < nk * d; idx += kThreads) {
      vs[idx] = to_f32(v[base + static_cast<size_t>(k0) * d + idx]);
    }
    __syncthreads();
    for (int ri = 0; ri < kRowsPerWarp; ++ri) {
      const float* pr = s + (warp + ri * kWarps) * t + k0;
      for (int kk = 0; kk < nk; ++kk) {
        const float p = pr[kk];
        const float* vr = vs + kk * d;
#pragma unroll
        for (int ci = 0; ci < kColsPerLane; ++ci) {
          const int c = lane + 32 * ci;
          if (c < d) acc[ri][ci] += p * vr[c];
        }
      }
    }
  }

  for (int ri = 0; ri < kRowsPerWarp; ++ri) {
    const int row = q0 + warp + ri * kWarps;
    if (row >= t) continue;
#pragma unroll
    for (int ci = 0; ci < kColsPerLane; ++ci) {
      const int c = lane + 32 * ci;
      if (c < d) o[base + static_cast<size_t>(row) * d + c] = from_f32<T>(acc[ri][ci]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int t,
           int d, cudaStream_t stream) {
  const size_t smem = smem_floats(t, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + kQTile - 1) / kQTile);
  mha_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, dtype 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns a CUDA error code (0 = success);
// cudaErrorInvalidValue for shapes outside t <= 1024, d <= 128.
extern "C" int avcer_mha(const void* q, const void* k, const void* v, void* o,
                         int bh, int t, int d, int dtype, void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (t > kMaxT || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(q, k, v, o, bh, t, d, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, bh, t, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
