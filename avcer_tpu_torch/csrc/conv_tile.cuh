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
// them), activation, mask, residual.
//
// The int8 mode (Q): the weights arrive as int8 with per-channel scales
// folded into `mult`, the activations stay in the compute type T in device
// memory (one block input feeds convs with different scales, and the
// residual, so it cannot be kept as int8). Before each conv the thread block
// quantises that conv's input rows once, with the conv's static scale (true
// f32 division, round half to even, clip to +-127), into an int8 plane of its
// scratch; the product then reads int8 rows exactly as the other modes read
// theirs. The eight warps multiply int8 x int8 -> int32 on the tensor cores
// (wmma m16n16k16, signed char), the sums are exact, and the epilogue is one
// f32 multiply by `mult` and one f32 add of `shift` (no FMA across them),
// rounded once to T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

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

// Shared-memory layout of the product for operands of type Op (float, bf16
// or, in the int8 mode, signed char).
template <typename Op>
struct Tile {
  static constexpr bool kInt8 = sizeof(Op) == 1;
  static constexpr int kVec = 16 / sizeof(Op);  // elements per 16-byte access
  static constexpr int kBK = kInt8 ? 64 : 128 / sizeof(Op);  // input channels per slab
  static constexpr int kAS = kBK + kVec;        // padded row strides
  static constexpr int kBS = kBN + kVec;
  static constexpr int kCS = kBN + 4;
  static constexpr size_t kABytes = 2 * sizeof(Op) * kBM * kAS;  // two slabs in flight
  static constexpr size_t kBBytes = 2 * sizeof(Op) * kBK * kBS;
  static constexpr size_t kCBytes = sizeof(float) * kBM * kCS;  // f32 or int32 sums
  static constexpr size_t kRowBytes = sizeof(int) * (kMaxTaps + 1) * kBM;
  static constexpr size_t kBytes = kABytes + kBBytes + kCBytes + kRowBytes;
};

// The operand type of a kernel that computes in T.
template <typename T, bool Q>
using OpOf = std::conditional_t<Q, signed char, T>;

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
// operand type: float, bf16 or, in the int8 mode, signed char.
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

template <>
struct Acc<signed char> {
  using L = Tile<signed char>;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> c[2][2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(c[i][j], 0);
  }
  __device__ __forceinline__ void step(const signed char* as, const signed char* bs) {
    namespace w = nvcuda::wmma;
    const int warp = threadIdx.x / 32;
    const int wm = warp % 4, wn = warp / 4;
#pragma unroll
    for (int ks = 0; ks < L::kBK; ks += 16) {
      w::fragment<w::matrix_a, 16, 16, 16, signed char, w::row_major> a[2];
      w::fragment<w::matrix_b, 16, 16, 16, signed char, w::row_major> b[2];
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
    int* ci = reinterpret_cast<int*>(cs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        w::store_matrix_sync(ci + (wm * 32 + i * 16) * L::kCS + wn * 32 + j * 16, c[i][j],
                             L::kCS, w::mem_row_major);
  }
};

// epi(m, n, acc, infofn(m)) for m < M and every n < N that is a multiple of
// EV, by the whole block, where acc[j] = sum_tap sum_k a[rowfn(m, tap), k] *
// w[tap, k, n + j] for j < EV: `epi` stores those EV results (EV: the compute
// type's elements per 16 bytes); `infofn(m)` is one int per pixel (a mask, a
// destination row), worked out once per pixel and not once per output
// element. `a` holds rows of `lda` elements (K of them used); it may be
// memory this block wrote before the call, so it is read through L2 and
// never through the read-only path. `w` is [taps, K, N], read-only for the
// kernel. K, N and lda are multiples of 16 bytes' worth of elements. For int8
// operands `acc` holds the bits of int32 sums (fold_vec reads either). Ends
// with a barrier: what `epi` stored is visible to the whole block on return.
template <typename Op, int EV, typename RowFn, typename InfoFn, typename EpiFn>
__device__ void block_gemm(const Op* a, int lda, int K, const Op* __restrict__ w, int N, int taps,
                           int M, unsigned char* smem, RowFn rowfn, InfoFn infofn, EpiFn epi) {
  using L = Tile<Op>;
  constexpr int V = L::kVec;
  constexpr int kBK = L::kBK;
  Op* as = reinterpret_cast<Op*>(smem);
  Op* bs = reinterpret_cast<Op*>(smem + L::kABytes);
  float* cs = reinterpret_cast<float*>(smem + L::kABytes + L::kBBytes);
  int* rows = reinterpret_cast<int*>(smem + L::kABytes + L::kBBytes + L::kCBytes);
  int* infos = rows + kMaxTaps * kBM;
  const int tid = threadIdx.x;

  for (int m0 = 0; m0 < M; m0 += kBM) {
    for (int idx = tid; idx < taps * kBM; idx += kThreads) {
      const int tap = idx / kBM, i = idx % kBM;
      rows[idx] = m0 + i < M ? rowfn(m0 + i, tap) : -1;
    }
    for (int i = tid; i < kBM; i += kThreads) infos[i] = m0 + i < M ? infofn(m0 + i) : 0;
    __syncthreads();
    for (int n0 = 0; n0 < N; n0 += kBN) {
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

// One convolution of a fused kernel, in either mode. The conv's input is R
// rows: row r is row `gather(r)` of `a` (rows of `lda` elements, K used), or
// zeros where that is -1; output pixel m reads input row `rowfn(m, tap)`
// (-1: zero padding); `w`, N, taps, M, `infofn` and `epi` as for block_gemm.
// Exact mode: the product reads `a` through both maps. int8 mode: the block
// first quantises the R input rows with the scale `sx` into `qbuf` (R x K
// int8, K a multiple of 16), then the product reads those.
template <typename T, bool Q, typename GatherFn, typename RowFn, typename InfoFn, typename EpiFn>
__device__ void conv_gemm(const T* a, int lda, int K, int R, GatherFn gather, signed char* qbuf,
                          float sx, const void* w, int N, int taps, int M, unsigned char* smem,
                          RowFn rowfn, InfoFn infofn, EpiFn epi) {
  constexpr int EV = 16 / sizeof(T);
  if constexpr (Q) {
    const int chunks = K / 16;
    for (int idx = threadIdx.x; idx < R * chunks; idx += kThreads) {
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
          const Vec<T> x = load_vec(src + v * EV);
#pragma unroll
          for (int j = 0; j < EV; ++j) u.q[v * EV + j] = quantize(Num<T>::to_f32(x.v[j]), sx);
        }
      }
      *reinterpret_cast<int4*>(qbuf + static_cast<size_t>(r) * K + c) = u.bits;
    }
    __syncthreads();
    block_gemm<signed char, EV>(qbuf, K, K, static_cast<const signed char*>(w), N, taps, M, smem,
                                rowfn, infofn, epi);
  } else {
    block_gemm<T, EV>(
        a, lda, K, static_cast<const T*>(w), N, taps, M, smem,
        [=](int m, int tap) {
          const int r = rowfn(m, tap);
          return r < 0 ? -1 : gather(r);
        },
        infofn, epi);
  }
}

}  // namespace avcer
