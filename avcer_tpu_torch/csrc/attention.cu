// Multi-head self-attention for the audio encoders' layers: unmasked for
// wav2vec2, with WavLM's gated relative position bias on the tensor cores;
// hand-written kernels behind one wrapper (ops/cuda/attention_kernel.py).
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/attention_kernel.py
// (pallas_mha, body _attn_kernel): per (batch, head), softmax(Q K^T / sqrt(d))
// V with Q, K and V upcast to f32, the logits divided by sqrt(d) in f32, the
// softmax in f32 (max, exp, sum, divide), P V in f32 and the output stored in
// the input dtype.
//
// What bounds it on the H100: at the wav2vec2 shape (B 16, H 16, T 199,
// D 64, bf16) one call reads Q, K, V and writes O: 26 MB, 7.8 us at
// 3.35 TB/s. It does 2.6 GFLOP, about 133 FLOP a byte against the bf16 ridge
// of about 295, so on the tensor cores bytes and latency bind, not the
// arithmetic. On the CUDA cores in f32 (67 TFLOP/s) the same work takes at
// least 39 us: the arithmetic must go to the tensor cores.
//
// mha_tc_kernel (bf16, D a multiple of 16 up to 128, T <= 256; the main
// path's kernel):
// - One block per (batch*head), 6 warps; warp w takes the head's 16-row
//   query tiles w, w + 6, ... (13 tiles at T = 199: three rounds for warp 0,
//   two for the others). The block copies the head's Q, K and V once into
//   shared memory with 16-byte cp.async, in groups: the first round's query
//   tiles with keys 0-63, then keys 64-127, 128-191 and 192-255, then V and
//   the other query tiles. The first round starts on keys 0-63 as soon as
//   they land and takes each later group as it comes; V lands while the
//   logits are computed. Rows past T and columns past D are zero-filled.
//   Rows are padded by 16 bytes, so the eight 16-byte rows of an ldmatrix
//   phase fall in eight different bank groups. Each head's operands cross
//   from device memory once: 256 blocks at the wav2vec2 shape, two an SM
//   (168 registers and 88 KB of shared memory each), one wave.
// - Q K^T on the tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32, fed by
//   ldmatrix (K rows are the B operand's columns as stored). A bf16 x bf16
//   product is exact in f32, so the logits differ from the f32 plain
//   version's only in the order of the sums. They are divided by sqrt(d) in
//   f32, as the TPU kernel does; where d is a power of 4 (64 on the main
//   path) sqrt(d) is a power of 2 and the kernel multiplies by its
//   reciprocal instead, which gives the same number bit for bit.
// - The exact two-pass softmax in registers: a warp keeps its 16 rows of
//   logits over all keys in the mma accumulators (16 x 208 f32 at T = 199:
//   104 registers a thread), masks key columns at T and beyond to -inf, and
//   takes row max and row sum of exp(logit - max) with the quad shuffles of
//   the fragment layout (expf, not __expf). No online rescaling.
// - P V on the tensor cores with P straight from registers: the m16n8
//   accumulator layout of two adjacent key tiles is the A fragment of the
//   next m16n8k16, and V comes in through ldmatrix.trans. The exp values
//   (in (0, 1]) are split into two bf16 parts, e_hi = bf16(e) and e_lo =
//   bf16(e - e_hi), with one mma each into the same f32 sums: rounded once
//   to bf16 they would carry 2^-9 relative error per term, and outputs near
//   zero would leave the tolerance the f32 plain version sets (atol 1e-5,
//   rtol 4e-3); split, the error is about 2^-17. PV is half the operations
//   and they do not bind, so the second mma costs little. The output
//   columns are taken 64 at a time, so at D = 128 only 32 accumulators are
//   live beside the logits.
// - The f32 sums are divided by the row sum (a true division) once per
//   output, not once per probability, rounded once to bf16 and stored, rows
//   at T and beyond masked. An IEEE division is a sequence of some ten
//   instructions: 104 a thread by sqrt(d) and 104 by the sum made most of
//   the time of a version that divided each logit and each probability
//   (PERF.md, section 6). Dividing the sums instead of
//   the probabilities changes the order of the roundings only; the result
//   stays within the tolerance above.
// The number of 16-row tiles is a template bucket (4, 8, 13 or 16) and the
// head dim one of 16, 32, 64 or 128 columns, and the kernel computes the
// padded head (zero rows and columns, key columns at T and beyond masked):
// every loop is unrolled with compile-time indices and no branch inside, so
// the logits and fragments stay in registers and the compiler starts the
// next ldmatrix while the tensor cores work (behind a run-time branch per key
// tile, each ldmatrix would wait for the mma before it).
// At T = 199 (13 tiles) nothing is padded. The register file bounds the
// occupancy: up to 13 key tiles and 64 columns the kernel is held to 168
// registers, 2 blocks (12 warps) an SM; larger buckets to 1.
//
// mha_exact_kernel (f32 at any shape, and bf16 where the tensor-core kernel
// does not apply; T <= 1024, D <= 128): the port's first attention kernel,
// kept f32-exact on the CUDA cores. One block per (batch*head, tile of 32
// queries), 8 warps. The block keeps its query tile, the logits of its 32
// rows over all T keys, and one 64-key tile of K (rows padded to D+1 floats,
// so the 32 lanes of a warp read 32 different banks) or V in dynamic shared
// memory, all in f32. Each warp owns 4 query rows: it computes their logits
// over the K tiles, then the row max, exp and sum with warp shuffles, then
// accumulates P V over the V tiles in registers (each lane owns output
// columns lane, lane+32, ...). No path on the card calls it.
//
// Nothing but Q, K, V and the output touches device memory, as in the TPU
// kernel.
//
// mha_tc_bias_kernel (the same body with a relative position bias, WavLM's
// gated bias): the f32 logits, after the division by sqrt(d), gain
// gate[bh, i] * table[h, buckets[j - i + T - 1]] (h = bh % heads). The block
// first writes its head's bias of every relative position j - i into shared
// memory (2 * 16 KT f32, from the [heads, nb] table and the [2T - 1] bucket
// map; zero past |j - i| >= T), each thread reads its two rows' gates into
// registers, and each logit adds one product of a register and a shared word:
// the [B, H, T, T] bias is never formed. At T = 199 this reads 0.2 MB of
// gates beside the 26 MB of Q, K, V and O. The unbiased kernel is the same
// body with the bias compiled out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using avcer::ldmatrix_x4;
using avcer::ldmatrix_x4_trans;
using avcer::mma_bf16;
using avcer::smem_addr;

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
    mha_exact_kernel(const T* __restrict__ q, const T* __restrict__ k,
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
int launch_exact(const void* q, const void* k, const void* v, void* o, int bh, int t,
           int d, cudaStream_t stream) {
  const size_t smem = smem_floats(t, d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mha_exact_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(bh, (t + kQTile - 1) / kQTile);
  mha_exact_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), t, d);
  return static_cast<int>(cudaGetLastError());
}

// ---- mha_tc_kernel: bf16 on the tensor cores ----

constexpr int kTcWarps = 6;  // 16 query rows a warp at a time
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcMaxT = 256;
constexpr int kPad = 8;  // bf16 elements (16 bytes) after every shared row
constexpr int kGroupTiles = 4;  // 16-key tiles of K a copy group brings (64 keys)
constexpr int kKeyGroups = kTcMaxT / 16 / kGroupTiles;  // K's copy groups, then V's

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x0 and x1 as hi + lo, each part a pair of bf16 in one mma operand register:
// hi = bf16(x), lo = bf16(x - hi) (the difference is exact in f32)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The key-tile buckets of the tensor-core kernel: t in (16 * (previous
// bucket), 16 * KT] runs the KT instantiation.
__host__ __device__ constexpr int min_t(int kt_bucket) {
  return kt_bucket <= 4 ? 1 : kt_bucket <= 8 ? 65 : kt_bucket <= 13 ? 129 : 209;
}

// WavLM's relative position bias: the [heads, nb] f32 table, the [2T - 1]
// int32 bucket of each relative position j - i (at j - i + T - 1) and the
// [bh, T] f32 gate of each query row.
struct RelBias {
  const float* table;
  const int* buckets;
  const float* gate;
  int heads;
  int nb;
};

// The head padded to KT 16-row tiles and DK 16-column parts (see the note
// at the top); with BIAS the relative position bias joins the logits.
template <int KT, int DK, bool BIAS>
__device__ __forceinline__ void mha_tc_body(const __nv_bfloat16* __restrict__ q,
                                            const __nv_bfloat16* __restrict__ k,
                                            const __nv_bfloat16* __restrict__ v,
                                            __nv_bfloat16* __restrict__ o, int t, int d,
                                            const RelBias& bias) {
  constexpr int kRows = KT * 16;
  constexpr int kLd = DK * 16 + kPad;  // shared row length in elements
  constexpr int kPieces = DK * 2;  // 16-byte pieces of a shared row
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* ks = qs + kRows * kLd;
  __nv_bfloat16* vs = ks + kRows * kLd;

  const size_t base = static_cast<size_t>(blockIdx.x) * t * d;
  const int kt = (t + 15) / 16;  // query tiles
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // rows [row0, row0 + n) of src into the same rows of dst with 16-byte
  // copies; zeros past row t and past column d
  auto load_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int n) {
    for (int i = tid; i < n * kPieces; i += kTcThreads) {
      const int r = row0 + i / kPieces;
      const int col = (i % kPieces) * 8;
      __nv_bfloat16* to = dst + r * kLd + col;
      if (r < t && col < d)
        cp_async16(smem_addr(to), src + base + static_cast<size_t>(r) * d + col);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // copy groups: the first round's query tiles with keys 0-63, then keys
  // 64-127, 128-191 and 192-255 (empty where KT is smaller), then V and the
  // other query tiles
  constexpr int kQFirst = kRows < kTcWarps * 16 ? kRows : kTcWarps * 16;
  load_rows(qs, q, 0, kQFirst);
#pragma unroll
  for (int kg = 0; kg < kKeyGroups; ++kg) {
    load_rows(ks, k, kg * kGroupTiles * 16, min(kGroupTiles * 16, kRows - kg * kGroupTiles * 16));
    cp_async_commit();
  }
  load_rows(vs, v, 0, kRows);
  load_rows(qs, q, kQFirst, kRows - kQFirst);
  cp_async_commit();
  // the head's bias at relative position j - i in relb[j - i + kRows - 1];
  // the first round's barrier publishes it
  [[maybe_unused]] float* relb = reinterpret_cast<float*>(vs + kRows * kLd);
  if constexpr (BIAS) {
    const float* tab = bias.table + static_cast<size_t>(blockIdx.x % bias.heads) * bias.nb;
    for (int i = tid; i < 2 * kRows; i += kTcThreads) {
      const int rel = i - (kRows - 1);
      relb[i] = (rel > -t && rel < t) ? tab[bias.buckets[rel + t - 1]] : 0.0f;
    }
  }

  const int g = lane / 4;
  const int tig = lane % 4;
  // x / sqrt(d) in f32. Where d is a power of 4, sqrt(d) is a power of 2 and
  // x * (1 / sqrt(d)) is the same number bit for bit, without the division's
  // instruction sequence (d = 64: 8).
  const float sqrt_d = sqrtf(static_cast<float>(d));
  const bool pow2_sqrt = (d & (d - 1)) == 0 && (__ffs(d) - 1) % 2 == 0;
  const float inv_sqrt_d = 1.0f / sqrt_d;

  // warp w takes query tiles w, w + kTcWarps, ...; every warp runs the first
  // round, which waits for the copies, whether it has a tile or not
  for (int tile = warp; tile < kt || tile == warp; tile += kTcWarps) {
    const bool first = tile == warp;
    const bool active = tile < kt;
    // logits, then exp(logit - row max): s[j] holds keys 8j + 2 tig + {0, 1}
    // of rows g ([0], [1]) and g + 8 ([2], [3]); l0, l1 the rows' sums
    float s[2 * KT][4];
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    float l0 = 0.0f, l1 = 0.0f;
#pragma unroll
    for (int kg = 0; kg < (KT + kGroupTiles - 1) / kGroupTiles; ++kg) {
      if (first) {  // key group kg has landed (kKeyGroups - kg groups may still fly)
        switch (kg) {
          case 0: cp_async_wait<kKeyGroups>(); break;
          case 1: cp_async_wait<kKeyGroups - 1>(); break;
          case 2: cp_async_wait<kKeyGroups - 2>(); break;
          default: cp_async_wait<kKeyGroups - 3>(); break;
        }
        __syncthreads();
      }
      if (active) {
#pragma unroll
        for (int kc = 0; kc < DK; ++kc) {
          uint32_t a[4];
          ldmatrix_x4(a, smem_addr(qs + (tile * 16 + lane % 16) * kLd + kc * 16 + (lane / 16) * 8));
#pragma unroll
          for (int j4 = 0; j4 < kGroupTiles; ++j4) {
            const int jj = kg * kGroupTiles + j4;
            if (jj < KT) {  // compile time
              // keys 16 jj .. +15 as two B operands: their rows hold the head dim
              uint32_t b[4];
              ldmatrix_x4(b, smem_addr(ks + (jj * 16 + lane % 8 + (lane / 16) * 8) * kLd +
                                       kc * 16 + ((lane / 8) % 2) * 8));
              mma_bf16(s[2 * jj], a, b[0], b[1]);
              mma_bf16(s[2 * jj + 1], a, b[2], b[3]);
            }
          }
        }
      }
    }
    if (active) {
      // one branch for the tile, none for each logit
      if (pow2_sqrt) {
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= inv_sqrt_d;
      } else {
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] /= sqrt_d;
      }
      if constexpr (BIAS) {
        // rows r and r + 8; key 8 j + 2 tig + c reads relb at
        // 8 j + 2 tig + c - row + kRows - 1 (key columns at T and beyond are
        // masked below)
        const int r = tile * 16 + g;
        const float* gate = bias.gate + static_cast<size_t>(blockIdx.x) * t;
        const float g0 = r < t ? gate[r] : 0.0f;
        const float g1 = r + 8 < t ? gate[r + 8] : 0.0f;
        const float* b0 = relb + (kRows - 1) - r + tig * 2;
        const float* b1 = b0 - 8;
#pragma unroll
        for (int j = 0; j < 2 * KT; ++j) {
          s[j][0] += g0 * b0[j * 8];
          s[j][1] += g0 * b0[j * 8 + 1];
          s[j][2] += g1 * b1[j * 8];
          s[j][3] += g1 * b1[j * 8 + 1];
        }
      }
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        if (j * 8 + 8 > min_t(KT)) {  // compile time: key columns this bucket may mask
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + tig * 2 + (e & 1) >= t) s[j][e] = -INFINITY;
        }
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      m0 = quad_max(m0);
      m1 = quad_max(m1);
#pragma unroll
      for (int j = 0; j < 2 * KT; ++j) {
        s[j][0] = expf(s[j][0] - m0);
        s[j][1] = expf(s[j][1] - m0);
        s[j][2] = expf(s[j][2] - m1);
        s[j][3] = expf(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
    }
    if (first) {  // V and the other query tiles have landed
      cp_async_wait<0>();
      __syncthreads();
    }
    if (!active) break;

    const int r_lo = tile * 16 + g;
    const int r_hi = r_lo + 8;
    // 64 output columns at a time: 32 accumulators live beside the logits
#pragma unroll
    for (int dc = 0; dc < (DK + 3) / 4; ++dc) {
      constexpr int kParts = DK < 4 ? DK : 4;  // 16-column parts in this pass
      float acc[2 * kParts][4];
#pragma unroll
      for (int n = 0; n < 2 * kParts; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < KT; ++jj) {
        // the accumulators of key tiles 2 jj and 2 jj + 1 are the A operand
        // of keys 16 jj .. +15, split into hi and lo (exp values in (0, 1])
        uint32_t ph[4], pl[4];
        split_bf16(s[2 * jj][0], s[2 * jj][1], ph[0], pl[0]);
        split_bf16(s[2 * jj][2], s[2 * jj][3], ph[1], pl[1]);
        split_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1], ph[2], pl[2]);
        split_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3], ph[3], pl[3]);
        uint32_t b[kParts][4];
#pragma unroll
        for (int dd = 0; dd < kParts; ++dd)
          ldmatrix_x4_trans(b[dd], smem_addr(vs + (jj * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                                             (dc * 4 + dd) * 16 + (lane / 16) * 8));
#pragma unroll
        for (int dd = 0; dd < kParts; ++dd) {
          mma_bf16(acc[2 * dd], ph, b[dd][0], b[dd][1]);
          mma_bf16(acc[2 * dd + 1], ph, b[dd][2], b[dd][3]);
        }
#pragma unroll
        for (int dd = 0; dd < kParts; ++dd) {
          mma_bf16(acc[2 * dd], pl, b[dd][0], b[dd][1]);
          mma_bf16(acc[2 * dd + 1], pl, b[dd][2], b[dd][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * kParts; ++n) {
        const int col = (dc * 4 + n / 2) * 16 + (n % 2) * 8 + tig * 2;
        if (col < d && r_lo < t)
          *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r_lo) * d + col) =
              as_u32(__floats2bfloat162_rn(acc[n][0] / l0, acc[n][1] / l0));
        if (col < d && r_hi < t)
          *reinterpret_cast<uint32_t*>(o + base + static_cast<size_t>(r_hi) * d + col) =
              as_u32(__floats2bfloat162_rn(acc[n][2] / l1, acc[n][3] / l1));
      }
    }
  }
}

template <int KT, int DK>
__global__ void __launch_bounds__(kTcThreads, (KT <= 13 && DK <= 4) ? 2 : 1)
    mha_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int t,
                  int d) {
  mha_tc_body<KT, DK, false>(q, k, v, o, t, d, RelBias{});
}

template <int KT, int DK>
__global__ void __launch_bounds__(kTcThreads, (KT <= 13 && DK <= 4) ? 2 : 1)
    mha_tc_bias_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int t,
                       int d, RelBias bias) {
  mha_tc_body<KT, DK, true>(q, k, v, o, t, d, bias);
}

template <int KT, int DK, bool BIAS>
int launch_tc_bucket(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
                     const RelBias& bias, cudaStream_t stream) {
  // Q, K and V of one head at the padded sizes; with the bias its 2 * 16 KT
  // relative positions in f32
  const size_t smem = static_cast<size_t>(3 * KT * 16) * (DK * 16 + kPad) * sizeof(__nv_bfloat16) +
                      (BIAS ? static_cast<size_t>(2 * KT * 16) * sizeof(float) : 0);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(o);
  cudaError_t err;
  if constexpr (BIAS) {
    err = cudaFuncSetAttribute(mha_tc_bias_kernel<KT, DK>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mha_tc_bias_kernel<KT, DK><<<bh, kTcThreads, smem, stream>>>(qb, kb, vb, ob, t, d, bias);
  } else {
    err = cudaFuncSetAttribute(mha_tc_kernel<KT, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    mha_tc_kernel<KT, DK><<<bh, kTcThreads, smem, stream>>>(qb, kb, vb, ob, t, d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int KT, bool BIAS>
int launch_tc_d(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
                const RelBias& bias, cudaStream_t stream) {
  if (d <= 16) return launch_tc_bucket<KT, 1, BIAS>(q, k, v, o, bh, t, d, bias, stream);
  if (d <= 32) return launch_tc_bucket<KT, 2, BIAS>(q, k, v, o, bh, t, d, bias, stream);
  if (d <= 64) return launch_tc_bucket<KT, 4, BIAS>(q, k, v, o, bh, t, d, bias, stream);
  return launch_tc_bucket<KT, 8, BIAS>(q, k, v, o, bh, t, d, bias, stream);
}

template <bool BIAS>
int launch_tc(const void* q, const void* k, const void* v, void* o, int bh, int t, int d,
              const RelBias& bias, cudaStream_t s) {
  if (t < min_t(8)) return launch_tc_d<4, BIAS>(q, k, v, o, bh, t, d, bias, s);
  if (t < min_t(13)) return launch_tc_d<8, BIAS>(q, k, v, o, bh, t, d, bias, s);
  if (t < min_t(16)) return launch_tc_d<13, BIAS>(q, k, v, o, bh, t, d, bias, s);
  return launch_tc_d<16, BIAS>(q, k, v, o, bh, t, d, bias, s);
}

}  // namespace

// q, k, v, o: [bh, t, d] contiguous, dtype 0 = float32, 1 = bfloat16.
// Launches mha_exact_kernel on `stream` and returns a CUDA error code
// (0 = success); cudaErrorInvalidValue for shapes outside t <= 1024, d <= 128.
extern "C" int avcer_mha_exact(const void* q, const void* k, const void* v, void* o,
                               int bh, int t, int d, int dtype, void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (t > kMaxT || d <= 0 || d > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_exact<float>(q, k, v, o, bh, t, d, s);
  if (dtype == 1) return launch_exact<__nv_bfloat16>(q, k, v, o, bh, t, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q, k, v, o: [bh, t, d] contiguous bf16, 16-byte aligned, t <= 256 and d a
// multiple of 16 up to 128. Launches mha_tc_kernel on `stream` and returns a
// CUDA error code (0 = success); cudaErrorInvalidValue for other shapes.
extern "C" int avcer_mha_tc(const void* q, const void* k, const void* v, void* o, int bh,
                            int t, int d, void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (t > kTcMaxT || d <= 0 || d > kMaxD || d % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc<false>(q, k, v, o, bh, t, d, RelBias{}, static_cast<cudaStream_t>(stream));
}

// As avcer_mha_tc, with the relative position bias: table [heads, nb] f32,
// buckets [2t - 1] int32 in [0, nb), gate [bh, t] f32, bh a multiple of
// heads. Launches mha_tc_bias_kernel.
extern "C" int avcer_mha_tc_bias(const void* q, const void* k, const void* v, void* o, int bh,
                                 int t, int d, const float* table, const int* buckets,
                                 const float* gate, int heads, int nb, void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (t > kTcMaxT || d <= 0 || d > kMaxD || d % 16 != 0 || heads <= 0 || bh % heads != 0 ||
      nb <= 0 || table == nullptr || buckets == nullptr || gate == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tc<true>(q, k, v, o, bh, t, d, RelBias{table, buckets, gate, heads, nb},
                         static_cast<cudaStream_t>(stream));
}
