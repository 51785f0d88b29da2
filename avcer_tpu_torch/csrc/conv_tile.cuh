// Shared building blocks of the fused convolution kernels (fused_resnet.cu,
// fused_ssh.cu): the rounding points of a folded conv + BatchNorm, and one
// block-wide matrix product that every 1x1 and 3x3 convolution of those
// kernels goes through.
//
// A convolution is a product  out[m, n] = sum_tap sum_k A[row(m, tap), k] *
// W[tap, k, n]  over the M pixels of a thread block's region: `row(m, tap)`
// names the pixel that output pixel m reads for that tap (the pixel itself
// for a 1x1, a neighbour for a 3x3, every second pixel for a stride-2 conv),
// or -1 where the conv reads its zero padding. The rows are gathered into
// shared memory 16 bytes at a time, so the same routine reads an NHWC input
// tensor, a strided subsample of it, or the block's scratch buffers.
//
// Tiling: a block of 256 threads computes 128 pixels x 64 output channels at
// a time over slabs of 64 (bf16) or 32 (f32) input channels held in shared
// memory. In bf16 the
// eight warps each own 32 x 32 of that tile as 2 x 2 tensor-core fragments
// (wmma m16n16k16, bf16 operands, f32 accumulators); in f32 each thread owns
// 8 x 4 outputs and multiplies on the CUDA cores, so an f32 result carries
// no TF32 rounding. Either way products are accumulated in f32, the sum goes
// through shared memory (the next slab is copied in, asynchronously, while
// the current one is multiplied), and an epilogue functor turns 16 bytes' worth of
// neighbouring output channels at a time into the stored values: round to
// the compute type, times inv, plus shift (each rounded, no FMA across
// them), activation, mask, residual. The bf16 convs of K3 and K4 go through
// block_gemm_tc instead (128 x 128 tiles on mma.sync, three cp.async stages;
// the same sums bit for bit), and a product may be shared by the blocks of
// a thread-block cluster (block_gemm's `part` of `parts`).
//
// The int8 mode (Q): the weights arrive as int8 with per-channel scales
// folded into `mult`, the activations stay in the compute type T in device
// memory (one block input feeds convs with different scales, and the
// residual, so it cannot be kept as int8). Before each conv the thread block
// quantises that conv's input rows once, with the conv's static scale (true
// f32 division, round half to even, clip to +-127), into an int8 plane of its
// scratch; the product then reads int8 rows exactly as the other modes read
// theirs. The int8 convs of K3 and K4 multiply through block_gemm_tc_q:
// 128 x 128 tiles on mma.sync m16n8k32 (s8 x s8 -> s32), both operands by
// ldmatrix from k-contiguous rows (the weights packed [taps, N, K] once, when
// folded), a three-stage cp.async ring of 128-channel slabs with swizzled
// rows. The sums are exact, and the epilogue is one f32 multiply by `mult`
// and one f32 add of `shift` (no FMA across them), rounded once to T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "mma.cuh"

namespace avcer {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // pixels per tile
constexpr int kBN = 64;   // output channels per tile
constexpr int kMaxTaps = 9;

enum Act { kLinear = 0, kRelu = 1, kLeaky = 2 };

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float to_f32(float x) { return x; }
  static __device__ __forceinline__ float from_f32(float x) { return x; }
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// bf16 arithmetic as the plain version does it: the operation in f32, then
// one rounding to bf16.
template <>
struct Num<__nv_bfloat16> {
  using B = __nv_bfloat16;
  static __device__ __forceinline__ float to_f32(B x) { return __bfloat162float(x); }
  static __device__ __forceinline__ B from_f32(float x) { return __float2bfloat16_rn(x); }
  static __device__ __forceinline__ B mul(B a, B b) {
    return __float2bfloat16_rn(__fmul_rn(__bfloat162float(a), __bfloat162float(b)));
  }
  static __device__ __forceinline__ B add(B a, B b) {
    return __float2bfloat16_rn(__fadd_rn(__bfloat162float(a), __bfloat162float(b)));
  }
};

// The conv output's rounding points: f32 sum -> T, * inv -> T, + shift -> T.
template <typename T>
__device__ __forceinline__ T fold_bn(float acc, T inv, T shift) {
  return Num<T>::add(Num<T>::mul(Num<T>::from_f32(acc), inv), shift);
}

template <typename T>
__device__ __forceinline__ T activate(T v, int act, T leaky) {
  if (act == kLinear) return v;
  const float f = Num<T>::to_f32(v);
  if (act == kRelu) return f > 0.0f ? v : Num<T>::from_f32(0.0f);
  return f >= 0.0f ? v : Num<T>::mul(v, leaky);
}

// (w, inv, shift) of one folded conv; in the int8 mode (wq int8, mult f32,
// shift f32).
struct ConvW {
  const void* w;
  const void* inv;
  const void* shift;
};

// Shared-memory layout of block_gemm for operands of type Op (float or bf16;
// the int8 product takes only its row tables, kRowBytes, from
// Tile<signed char>).
template <typename Op>
struct Tile {
  static constexpr int kVec = 16 / sizeof(Op);  // elements per 16-byte access
  static constexpr int kBK = 128 / sizeof(Op);  // input channels per slab
  static constexpr int kAS = kBK + kVec;        // padded row strides
  static constexpr int kBS = kBN + kVec;
  static constexpr int kCS = kBN + 4;
  static constexpr size_t kABytes = 2 * sizeof(Op) * kBM * kAS;  // two slabs in flight
  static constexpr size_t kBBytes = 2 * sizeof(Op) * kBK * kBS;
  static constexpr size_t kCBytes = sizeof(float) * kBM * kCS;  // f32 or int32 sums
  static constexpr size_t kRowBytes = sizeof(int) * (kMaxTaps + 1) * kBM;
  static constexpr size_t kBytes = kABytes + kBBytes + kCBytes + kRowBytes;
};

// 16 bytes from device memory to shared memory without passing through
// registers (cp.async, read through L2); zeros where `valid` is false.
__device__ __forceinline__ void copy16(void* smem_dst, const void* src, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// 16 bytes of neighbouring channels.
template <typename T>
struct alignas(16) Vec {
  T v[Tile<T>::kVec];
};

template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* p) {
  Vec<T> r;
  *reinterpret_cast<int4*>(r.v) = *reinterpret_cast<const int4*>(p);
  return r;
}

// The same through L2 only (ld.global.cg): for rows that another thread
// block of the cluster may have written, never through L1 or the read-only
// path, which may hold an older copy.
template <typename T>
__device__ __forceinline__ Vec<T> load_vec_cg(const T* p) {
  Vec<T> r;
  *reinterpret_cast<int4*>(r.v) = __ldcg(reinterpret_cast<const int4*>(p));
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& x) {
  *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(x.v);
}

// act(bn(acc)) for the channels n .. n + kVec of a conv (inv and shift
// already offset by n); `keep` false gives zeros (outside the frame).
template <typename T>
__device__ __forceinline__ Vec<T> fold_bn_vec(const float* acc, const T* inv, const T* shift,
                                              int act, T leaky, bool keep = true) {
  const Vec<T> i = load_vec(inv), s = load_vec(shift);
  Vec<T> out;
#pragma unroll
  for (int j = 0; j < Tile<T>::kVec; ++j)
    out.v[j] = keep ? activate<T>(fold_bn<T>(acc[j], i.v[j], s.v[j]), act, leaky)
                    : Num<T>::from_f32(0.0f);
  return out;
}

// layers.int8_conv's activation quantisation with a static scale.
__device__ __forceinline__ signed char quantize(float x, float sx) {
  const float q = rintf(__fdiv_rn(x, sx));  // round half to even
  return static_cast<signed char>(static_cast<int>(fminf(fmaxf(q, -127.0f), 127.0f)));
}

// The int8 mode's epilogue for the channels n .. n + kVec: the int32 sums
// (passed as the bits of `acc`) times mult plus shift in f32, rounded once to
// T, then the activation.
template <typename T>
__device__ __forceinline__ Vec<T> fold_q_vec(const float* acc, const float* mult,
                                             const float* shift, int act, T leaky, bool keep) {
  const int* sums = reinterpret_cast<const int*>(acc);
  Vec<T> out;
#pragma unroll
  for (int j = 0; j < Tile<T>::kVec; ++j) {
    const float y = __fadd_rn(__fmul_rn(__int2float_rn(sums[j]), mult[j]), shift[j]);
    out.v[j] = keep ? activate<T>(Num<T>::from_f32(y), act, leaky) : Num<T>::from_f32(0.0f);
  }
  return out;
}

// act(bn(acc)) for the channels n .. n + kVec of conv `cw`, in either mode.
template <typename T, bool Q>
__device__ __forceinline__ Vec<T> fold_vec(const float* acc, const ConvW& cw, int n, int act,
                                           T leaky, bool keep = true) {
  if constexpr (Q) {
    return fold_q_vec<T>(acc, static_cast<const float*>(cw.inv) + n,
                         static_cast<const float*>(cw.shift) + n, act, leaky, keep);
  } else {
    return fold_bn_vec<T>(acc, static_cast<const T*>(cw.inv) + n,
                          static_cast<const T*>(cw.shift) + n, act, leaky, keep);
  }
}

// The accumulators of one 128 x 64 tile, spread over the block. `Op` is the
// operand type: float or bf16.
template <typename T>
struct Acc;

template <>
struct Acc<float> {
  using L = Tile<float>;
  float v[8][4];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.0f;
  }
  __device__ __forceinline__ void step(const float* as, const float* bs) {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
    for (int kk = 0; kk < L::kBK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(bs + kk * L::kBS + tx * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float a = as[(ty * 8 + i) * L::kAS + kk];
        v[i][0] = fmaf(a, b.x, v[i][0]);
        v[i][1] = fmaf(a, b.y, v[i][1]);
        v[i][2] = fmaf(a, b.z, v[i][2]);
        v[i][3] = fmaf(a, b.w, v[i][3]);
      }
    }
  }
  __device__ __forceinline__ void store(float* cs) const {
    const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[(ty * 8 + i) * L::kCS + tx * 4 + j] = v[i][j];
  }
};

template <>
struct Acc<__nv_bfloat16> {
  using L = Tile<__nv_bfloat16>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0.0f);
  }
  __device__ __forceinline__ void step(const __nv_bfloat16* as, const __nv_bfloat16* bs) {
    namespace w = nvcuda::wmma;
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int ks = 0; ks < L::kBK; ks += 16) {
      w::fragment<w::matrix_a, 16, 16, 16, __nv_bfloat16, w::row_major> a[2];
      w::fragment<w::matrix_b, 16, 16, 16, __nv_bfloat16, w::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        w::load_matrix_sync(a[i], as + (wm * 32 + i * 16) * L::kAS + ks, L::kAS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        w::load_matrix_sync(b[j], bs + ks * L::kBS + wn * 32 + j * 16, L::kBS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) w::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void store(float* cs) {
    namespace w = nvcuda::wmma;
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        w::store_matrix_sync(cs + (wm * 32 + i * 16) * L::kCS + wn * 32 + j * 16, c[i][j],
                             L::kCS, w::mem_row_major);
  }
};

// Every thread of every block of the cluster waits here; what each wrote to
// memory before is visible to all of them after (release / acquire at
// cluster scope). Every block of a cluster must reach it equally often.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// A barrier over the `parts` blocks that share a product: the block's own
// barrier for one, the cluster's for more.
__device__ __forceinline__ void sync_parts(int parts) {
  if (parts > 1)
    cluster_sync();
  else
    __syncthreads();
}

// epi(m, n, acc, infofn(m)) for m < M and every n < N that is a multiple of
// EV, by the whole block, where acc[j] = sum_tap sum_k a[rowfn(m, tap), k] *
// w[tap, k, n + j] for j < EV: `epi` stores those EV results (EV: the compute
// type's elements per 16 bytes); `infofn(m)` is one int per pixel (a mask, a
// destination row), worked out once per pixel and not once per output
// element. `a` holds rows of `lda` elements (K of them used); it may be
// memory this block wrote before the call, so it is read through L2 and
// never through the read-only path. `w` is [taps, K, N], read-only for the
// kernel. K, N and lda are multiples of 16 bytes' worth of elements. Ends
// with a barrier: what `epi` stored is visible to the whole block on return.
// `part` of `parts`: the block computes only the (m-tile, n-tile) pairs p,
// numbered m-tile major, with p % parts == part (the blocks of a cluster share
// one product so); (0, 1) is the whole product. Which block computes an
// output does not change how it is summed.
template <typename Op, int EV, typename RowFn, typename InfoFn, typename EpiFn>
__device__ void block_gemm(const Op* a, int lda, int K, const Op* __restrict__ w, int N, int taps,
                           int M, unsigned char* smem, RowFn rowfn, InfoFn infofn, EpiFn epi,
                           int part = 0, int parts = 1) {
  using L = Tile<Op>;
  constexpr int V = L::kVec;
  constexpr int kBK = L::kBK;
  Op* as = reinterpret_cast<Op*>(smem);
  Op* bs = reinterpret_cast<Op*>(smem + L::kABytes);
  float* cs = reinterpret_cast<float*>(smem + L::kABytes + L::kBBytes);
  int* rows = reinterpret_cast<int*>(smem + L::kABytes + L::kBBytes + L::kCBytes);
  int* infos = rows + kMaxTaps * kBM;
  const int tid = threadIdx.x;
  const int ntiles = (N + kBN - 1) / kBN;

  for (int m0 = 0, mt = 0; m0 < M; m0 += kBM, ++mt) {
    // this part's first n-tile of the m-tile, if it has one
    const int nt0 = ((part - mt * ntiles) % parts + parts) % parts;
    if (nt0 >= ntiles) continue;
    for (int idx = tid; idx < taps * kBM; idx += kThreads) {
      const int tap = idx / kBM, i = idx % kBM;
      rows[idx] = m0 + i < M ? rowfn(m0 + i, tap) : -1;
    }
    for (int i = tid; i < kBM; i += kThreads) infos[i] = m0 + i < M ? infofn(m0 + i) : 0;
    __syncthreads();
    for (int nt = nt0; nt < ntiles; nt += parts) {
      const int n0 = nt * kBN;
      Acc<Op> acc;
      acc.zero();
      // two operand slabs in flight: slab s + 1 is copied (cp.async, 16 bytes
      // a thread, zero-filled where the conv reads padding) while slab s is
      // multiplied
      const int ksteps = (K + kBK - 1) / kBK;
      const int steps = taps * ksteps;
      auto fetch = [&](int step) {
        const int tap = step / ksteps, k0 = (step % ksteps) * kBK;
        Op* ad = as + (step & 1) * (kBM * L::kAS);
        Op* bd = bs + (step & 1) * (kBK * L::kBS);
        constexpr int kAChunks = kBK / V;  // 16-byte chunks per A row
        for (int c = tid; c < kBM * kAChunks; c += kThreads) {
          const int i = c / kAChunks, kc = (c % kAChunks) * V;
          const int row = rows[tap * kBM + i];
          const bool ok = row >= 0 && k0 + kc < K;
          copy16(ad + i * L::kAS + kc, ok ? a + static_cast<size_t>(row) * lda + k0 + kc : a, ok);
        }
        constexpr int kBChunks = kBN / V;
        for (int c = tid; c < kBK * kBChunks; c += kThreads) {
          const int kk = c / kBChunks, nc = (c % kBChunks) * V;
          const bool ok = k0 + kk < K && n0 + nc < N;
          copy16(bd + kk * L::kBS + nc,
                 ok ? w + (static_cast<size_t>(tap) * K + k0 + kk) * N + n0 + nc : w, ok);
        }
        copy_commit();
      };
      fetch(0);
      for (int step = 0; step < steps; ++step) {
        if (step + 1 < steps) {
          fetch(step + 1);
          copy_wait<1>();  // slab `step` has landed, slab `step + 1` may be in flight
        } else {
          copy_wait<0>();
        }
        __syncthreads();
        acc.step(as + (step & 1) * (kBM * L::kAS), bs + (step & 1) * (kBK * L::kBS));
        __syncthreads();  // before slab `step + 2` overwrites this one
      }
      acc.store(cs);
      __syncthreads();
      for (int idx = tid; idx < kBM * (kBN / EV); idx += kThreads) {
        const int i = idx / (kBN / EV), j = (idx % (kBN / EV)) * EV;
        if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, cs + i * L::kCS + j, infos[i]);
      }
      __syncthreads();
    }
  }
}

// The bf16 product of K3 and K4 (fused_resnet.cu, fused_ssh.cu) on mma.sync: the
// function of block_gemm<__nv_bfloat16>, on tiles of 128 pixels x BN output
// channels (BN 128 where N >= 128, else 64). Eight warps in 2 x 4 each own
// 64 x BN/4 of the tile as 4 x BN/32 fragments of mma.sync m16n8k16 (bf16 x
// bf16 -> f32), fed by ldmatrix (A) and ldmatrix.trans (B, stored k x n).
// Operand slabs of 64 input channels go through a ring of three cp.async
// stages with one block barrier a slab: slab s + 2 is copied while slab s is
// multiplied. The sums take the same terms in the same order as
// block_gemm's (taps, then 64-deep slabs, then 16-deep steps, ascending, each
// step one HMMA of k 16 as wmma m16n16k16 issues), so every output equals
// its result bit for bit. The f32 staging of the sums for the 16-byte
// epilogue reuses the ring, which is idle by then.
template <int BN>
struct TcTile {
  static constexpr int kBK = 64;
  static constexpr int kStages = 3;
  static constexpr int kAS = kBK + 8;  // rows padded by 16 bytes: ldmatrix
  static constexpr int kBS = BN + 8;   // phases fall in 8 bank groups
  static constexpr int kCS = BN + 8;
  static constexpr int kStage = kBM * kAS + kBK * kBS;  // elements of one stage
  static constexpr size_t kRingBytes = sizeof(__nv_bfloat16) * kStages * kStage;
  static constexpr size_t kCBytes = sizeof(float) * kBM * kCS;
  static constexpr size_t kMainBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static constexpr size_t kBytes = kMainBytes + Tile<__nv_bfloat16>::kRowBytes;
};

template <int BN, typename RowFn, typename InfoFn, typename EpiFn>
__device__ void block_gemm_tc(const __nv_bfloat16* a, int lda, int K,
                              const __nv_bfloat16* __restrict__ w, int N, int taps, int M,
                              unsigned char* smem, RowFn rowfn, InfoFn infofn, EpiFn epi,
                              int part, int parts) {
  using B16 = __nv_bfloat16;
  using L = TcTile<BN>;
  constexpr int V = 8;   // bf16 a 16-byte chunk
  constexpr int EV = 8;  // outputs an epilogue call
  constexpr int kBK = L::kBK;
  constexpr int WN = BN / 4;  // columns a warp
  constexpr int NT = WN / 8;  // n8 fragments a warp
  B16* ring = reinterpret_cast<B16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  int* rows = reinterpret_cast<int*>(smem + L::kMainBytes);
  int* infos = rows + kMaxTaps * kBM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int ntiles = (N + BN - 1) / BN;

  for (int m0 = 0, mt = 0; m0 < M; m0 += kBM, ++mt) {
    const int nt0 = ((part - mt * ntiles) % parts + parts) % parts;
    if (nt0 >= ntiles) continue;
    for (int idx = tid; idx < taps * kBM; idx += kThreads) {
      const int tap = idx / kBM, i = idx % kBM;
      rows[idx] = m0 + i < M ? rowfn(m0 + i, tap) : -1;
    }
    for (int i = tid; i < kBM; i += kThreads) infos[i] = m0 + i < M ? infofn(m0 + i) : 0;
    __syncthreads();
    for (int nt = nt0; nt < ntiles; nt += parts) {
      const int n0 = nt * BN;
      float acc[4][NT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
      const int ksteps = (K + kBK - 1) / kBK;
      const int steps = taps * ksteps;
      // slab `step` into stage step % 3; a group is committed even when there
      // is no slab left, so that wait_group counts slabs
      auto fetch = [&](int step) {
        if (step < steps) {
          const int tap = step / ksteps, k0 = (step % ksteps) * kBK;
          B16* ad = ring + (step % L::kStages) * L::kStage;
          B16* bd = ad + kBM * L::kAS;
          constexpr int kAChunks = kBK / V;
          for (int c = tid; c < kBM * kAChunks; c += kThreads) {
            const int i = c / kAChunks, kc = (c % kAChunks) * V;
            const int row = rows[tap * kBM + i];
            const bool ok = row >= 0 && k0 + kc < K;
            copy16(ad + i * L::kAS + kc, ok ? a + static_cast<size_t>(row) * lda + k0 + kc : a,
                   ok);
          }
          constexpr int kBChunks = BN / V;
          for (int c = tid; c < kBK * kBChunks; c += kThreads) {
            const int kk = c / kBChunks, nc = (c % kBChunks) * V;
            const bool ok = k0 + kk < K && n0 + nc < N;
            copy16(bd + kk * L::kBS + nc,
                   ok ? w + (static_cast<size_t>(tap) * K + k0 + kk) * N + n0 + nc : w, ok);
          }
        }
        copy_commit();
      };
      fetch(0);
      fetch(1);
      for (int step = 0; step < steps; ++step) {
        copy_wait<1>();  // slab `step` has landed (this thread's copies)
        __syncthreads();  // everyone's; and stage (step + 2) % 3 is no longer read
        fetch(step + 2);
        const B16* as = ring + (step % L::kStages) * L::kStage;
        const B16* bs = as + kBM * L::kAS;
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 16) {
          uint32_t b[NT / 2][4];
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
            ldmatrix_x4_trans(b[j], smem_addr(bs + (ks + lane % 8 + ((lane / 8) % 2) * 8) * L::kBS +
                                              wn * WN + j * 16 + (lane / 16) * 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t af[4];
            ldmatrix_x4(af, smem_addr(as + (wm * 64 + i * 16 + lane % 16) * L::kAS + ks +
                                      (lane / 16) * 8));
#pragma unroll
            for (int j = 0; j < NT / 2; ++j) {
              mma_bf16(acc[i][2 * j], af, b[j][0], b[j][1]);
              mma_bf16(acc[i][2 * j + 1], af, b[j][2], b[j][3]);
            }
          }
        }
      }
      copy_wait<0>();
      __syncthreads();  // the ring is idle: the sums may take its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = wm * 64 + i * 16 + lane / 4, c = wn * WN + j * 8 + (lane % 4) * 2;
          *reinterpret_cast<float2*>(cs + r * L::kCS + c) = make_float2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<float2*>(cs + (r + 8) * L::kCS + c) =
              make_float2(acc[i][j][2], acc[i][j][3]);
        }
      __syncthreads();
      for (int idx = tid; idx < kBM * (BN / EV); idx += kThreads) {
        const int i = idx / (BN / EV), j = (idx % (BN / EV)) * EV;
        if (m0 + i < M && n0 + j < N) epi(m0 + i, n0 + j, cs + i * L::kCS + j, infos[i]);
      }
      __syncthreads();
    }
  }
}

// The int8 product of K3 and K4 (fused_resnet.cu, fused_ssh.cu) on mma.sync:
// int8 x int8 -> exact int32 sums under block_gemm's rowfn / infofn / epi
// contract (`acc` the bits of the sums, which fold_vec reads), with the weights
// `w` stored [taps, N, K], k contiguous. Tiles of 128 pixels x BN output
// channels (BN 128 where N >= 128, else 64); eight warps in 2 x 4 each own 64 x
// BN/4 of the tile as 4 x BN/32 fragments of mma.sync m16n8k32 (s8 x s8 ->
// s32). Both operands are k-contiguous rows, so both reach their fragments
// through ldmatrix without .trans (sm_90 has no 8-bit transposing ldmatrix:
// that is why the weights are packed n-major once, when they are folded). Slabs
// of 128 input channels (128 bytes a row) go through a ring of three cp.async
// stages with one block barrier a slab; a slab of a conv with fewer channels
// left copies and multiplies only its 32-deep steps that hold some. Rows are
// not padded: the 16-byte chunk c of slab row r sits at chunk c ^ (r % 8)
// (swz), so the eight rows of an ldmatrix phase fall in eight bank groups, and
// a stage is 128 x (128 + BN) bytes: 96 KiB of ring at BN = 128, 103,424 bytes
// with the row tables, which leaves two blocks an SM (rows padded by 16 bytes
// would take 115,712, the last byte two blocks may have). Integer sums are
// exact in any order (at most 9 * 2048 * 127^2 < 2^31 at the models' widths),
// so every output is the exact sum whichever order or product takes it. The
// int32 sums are staged for the 16-byte epilogue in the ring, which is idle by
// then.
template <int BN>
struct TcQTile {
  static constexpr int kBK = 128;                  // input channels (bytes) a slab
  static constexpr int kStages = 3;
  static constexpr int kStage = (kBM + BN) * kBK;  // bytes of one stage: A rows, then B rows
  static constexpr int kCS = BN + 8;               // staged int32 sums a row
  static constexpr size_t kRingBytes = static_cast<size_t>(kStages) * kStage;
  static constexpr size_t kCBytes = sizeof(int) * kBM * kCS;
  static constexpr size_t kMainBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static constexpr size_t kBytes = kMainBytes + Tile<signed char>::kRowBytes;
};

// Byte offset of 16-byte chunk c of row r in a slab of 128-byte rows.
__device__ __forceinline__ int swz(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

template <int BN, int EV, typename RowFn, typename InfoFn, typename EpiFn>
__device__ void block_gemm_tc_q(const signed char* a, int lda, int K,
                                const signed char* __restrict__ w, int N, int taps, int M,
                                unsigned char* smem, RowFn rowfn, InfoFn infofn, EpiFn epi,
                                int part, int parts) {
  using L = TcQTile<BN>;
  constexpr int kBK = L::kBK;
  constexpr int kChunks = kBK / 16;  // 16-byte chunks a slab row
  constexpr int WN = BN / 4;         // columns a warp
  constexpr int NT = WN / 8;         // n8 fragments a warp
  unsigned char* ring = smem;
  int* cs = reinterpret_cast<int*>(smem);
  int* rows = reinterpret_cast<int*>(smem + L::kMainBytes);
  int* infos = rows + kMaxTaps * kBM;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2;
  const int ntiles = (N + BN - 1) / BN;

  for (int m0 = 0, mt = 0; m0 < M; m0 += kBM, ++mt) {
    const int nt0 = ((part - mt * ntiles) % parts + parts) % parts;
    if (nt0 >= ntiles) continue;
    for (int idx = tid; idx < taps * kBM; idx += kThreads) {
      const int tap = idx / kBM, i = idx % kBM;
      rows[idx] = m0 + i < M ? rowfn(m0 + i, tap) : -1;
    }
    for (int i = tid; i < kBM; i += kThreads) infos[i] = m0 + i < M ? infofn(m0 + i) : 0;
    __syncthreads();
    for (int nt = nt0; nt < ntiles; nt += parts) {
      const int n0 = nt * BN;
      int acc[4][NT][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
      const int ksteps = (K + kBK - 1) / kBK;
      const int steps = taps * ksteps;
      // slab `step` into stage step % 3; a group is committed even when there
      // is no slab left, so that wait_group counts slabs. Only the chunks of
      // the slab's 32-deep steps that hold channels are copied (zeros past K)
      auto fetch = [&](int step) {
        if (step < steps) {
          const int tap = step / ksteps, k0 = (step % ksteps) * kBK;
          const int kw = min(kBK, (K - k0 + 31) / 32 * 32);
          unsigned char* ad = ring + (step % L::kStages) * L::kStage;
          unsigned char* bd = ad + kBM * kBK;
          for (int c = tid; c < kBM * kChunks; c += kThreads) {
            const int i = c / kChunks, kc = (c % kChunks) * 16;
            if (kc < kw) {
              const int row = rows[tap * kBM + i];
              const bool ok = row >= 0 && k0 + kc < K;
              copy16(ad + swz(i, kc / 16), ok ? a + static_cast<size_t>(row) * lda + k0 + kc : a,
                     ok);
            }
          }
          for (int c = tid; c < BN * kChunks; c += kThreads) {
            const int n = c / kChunks, kc = (c % kChunks) * 16;
            if (kc < kw) {
              const bool ok = n0 + n < N && k0 + kc < K;
              copy16(bd + swz(n, kc / 16),
                     ok ? w + (static_cast<size_t>(tap) * N + n0 + n) * K + k0 + kc : w, ok);
            }
          }
        }
        copy_commit();
      };
      fetch(0);
      fetch(1);
      for (int step = 0; step < steps; ++step) {
        copy_wait<1>();  // slab `step` has landed (this thread's copies)
        __syncthreads();  // everyone's; and stage (step + 2) % 3 is no longer read
        fetch(step + 2);
        const unsigned char* as = ring + (step % L::kStages) * L::kStage;
        const unsigned char* bs = as + kBM * kBK;
        const int left = K - (step % ksteps) * kBK;  // channels from the slab's first on
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 32) {
          if (ks < left) {
            uint32_t b[NT / 2][4];
#pragma unroll
            for (int j = 0; j < NT / 2; ++j)
              ldmatrix_x4(b[j], smem_addr(bs + swz(wn * WN + j * 16 + (lane / 16) * 8 + lane % 8,
                                                   ks / 16 + (lane / 8) % 2)));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t af[4];
              ldmatrix_x4(af,
                          smem_addr(as + swz(wm * 64 + i * 16 + lane % 16, ks / 16 + lane / 16)));
#pragma unroll
              for (int j = 0; j < NT / 2; ++j) {
                mma_s8(acc[i][2 * j], af, b[j][0], b[j][1]);
                mma_s8(acc[i][2 * j + 1], af, b[j][2], b[j][3]);
              }
            }
          }
        }
      }
      copy_wait<0>();
      __syncthreads();  // the ring is idle: the sums may take its place
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int r = wm * 64 + i * 16 + lane / 4, c = wn * WN + j * 8 + (lane % 4) * 2;
          *reinterpret_cast<int2*>(cs + r * L::kCS + c) = make_int2(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<int2*>(cs + (r + 8) * L::kCS + c) =
              make_int2(acc[i][j][2], acc[i][j][3]);
        }
      __syncthreads();
      for (int idx = tid; idx < kBM * (BN / EV); idx += kThreads) {
        const int i = idx / (BN / EV), j = (idx % (BN / EV)) * EV;
        if (m0 + i < M && n0 + j < N)
          epi(m0 + i, n0 + j, reinterpret_cast<const float*>(cs + i * L::kCS + j), infos[i]);
      }
      __syncthreads();
    }
  }
}

// Launches `kernel` (kThreads a block, `smem` bytes of dynamic shared memory)
// on `grid` blocks in clusters of `cluster` (a cluster of one is an ordinary
// launch); with `clusters` and `blocks` non-null it launches nothing and
// reports how many such clusters the card can hold at once, and how many
// blocks an SM. Returns a CUDA error code: a cluster the card refuses
// returns the launch's own error.
template <typename P>
int launch_clusters(void (*kernel)(P), const P& p, int grid, int cluster, size_t smem,
                    cudaStream_t stream, int* clusters = nullptr, int* blocks = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters != nullptr) {
    err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
    return static_cast<int>(err);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of a kernel whose convs go through conv_gemm<T, Q, TC, TCQ>:
// the int8 mode's is block_gemm_tc_q's at its widest tile.
template <typename T, bool Q, bool TC, bool TCQ = false>
constexpr size_t conv_smem_bytes() {
  static_assert(!Q || TCQ, "the int8 mode multiplies through block_gemm_tc_q only");
  if constexpr (Q) return TcQTile<128>::kBytes;
  if constexpr (TC && std::is_same_v<T, __nv_bfloat16>)
    return TcTile<128>::kBytes > Tile<T>::kBytes ? TcTile<128>::kBytes : Tile<T>::kBytes;
  return Tile<T>::kBytes;
}

// One convolution of a fused kernel, in either mode. The conv's input is R
// rows: row r is row `gather(r)` of `a` (rows of `lda` elements, K used), or
// zeros where that is -1; output pixel m reads input row `rowfn(m, tap)`
// (-1: zero padding); `w`, N, taps, M, `infofn` and `epi` as for block_gemm.
// Exact mode: the product reads `a` through both maps. int8 mode: the block
// first quantises the R input rows with the scale `sx` into `qbuf` (R x K
// int8, K a multiple of 16), then the product reads those.
// `part` of `parts`: the blocks of a cluster share the conv (block_gemm's
// split; the quantise step splits its rows likewise), and with more than one
// part it ends with a cluster barrier, so that every part's output is visible
// to the whole cluster on return. TC: the exact bf16 mode multiplies through
// block_gemm_tc (the kernel then has conv_smem_bytes<T, Q, true>() of shared
// memory); the exact f32 mode, and TC false, through block_gemm. TCQ, which
// the int8 mode requires: it multiplies through block_gemm_tc_q, `w` then
// [taps, N, K] (the kernel has conv_smem_bytes<T, Q, TC, true>() of shared
// memory).
template <typename T, bool Q, bool TC = false, bool TCQ = false, typename GatherFn,
          typename RowFn, typename InfoFn, typename EpiFn>
__device__ void conv_gemm(const T* a, int lda, int K, int R, GatherFn gather, signed char* qbuf,
                          float sx, const void* w, int N, int taps, int M, unsigned char* smem,
                          RowFn rowfn, InfoFn infofn, EpiFn epi, int part = 0, int parts = 1) {
  constexpr int EV = 16 / sizeof(T);
  if constexpr (Q) {
    static_assert(TCQ, "the int8 mode multiplies through block_gemm_tc_q only");
    const int chunks = K / 16;
    for (int idx = part * kThreads + threadIdx.x; idx < R * chunks; idx += parts * kThreads) {
      const int r = idx / chunks, c = (idx % chunks) * 16;
      const int row = gather(r);
      union {
        int4 bits;
        signed char q[16];
      } u;
      u.bits = make_int4(0, 0, 0, 0);
      if (row >= 0) {
        const T* src = a + static_cast<size_t>(row) * lda + c;
#pragma unroll
        for (int v = 0; v < 16 / EV; ++v) {
          // rows another block of the cluster may have written: through L2
          const Vec<T> x = parts > 1 ? load_vec_cg(src + v * EV) : load_vec(src + v * EV);
#pragma unroll
          for (int j = 0; j < EV; ++j) u.q[v * EV + j] = quantize(Num<T>::to_f32(x.v[j]), sx);
        }
      }
      *reinterpret_cast<int4*>(qbuf + static_cast<size_t>(r) * K + c) = u.bits;
    }
    sync_parts(parts);
    const signed char* wq = static_cast<const signed char*>(w);
    if (N >= 128)
      block_gemm_tc_q<128, EV>(qbuf, K, K, wq, N, taps, M, smem, rowfn, infofn, epi, part, parts);
    else
      block_gemm_tc_q<64, EV>(qbuf, K, K, wq, N, taps, M, smem, rowfn, infofn, epi, part, parts);
  } else {
    auto rows = [=](int m, int tap) {
      const int r = rowfn(m, tap);
      return r < 0 ? -1 : gather(r);
    };
    if constexpr (TC && std::is_same_v<T, __nv_bfloat16>) {
      if (N >= 128)
        block_gemm_tc<128>(a, lda, K, static_cast<const T*>(w), N, taps, M, smem, rows, infofn,
                           epi, part, parts);
      else
        block_gemm_tc<64>(a, lda, K, static_cast<const T*>(w), N, taps, M, smem, rows, infofn,
                          epi, part, parts);
    } else {
      block_gemm<T, EV>(a, lda, K, static_cast<const T*>(w), N, taps, M, smem, rows, infofn, epi,
                        part, parts);
    }
  }
  if (parts > 1) cluster_sync();
}

}  // namespace avcer
