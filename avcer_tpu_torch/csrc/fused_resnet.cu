// A chain of ResNet bottlenecks as one kernel launch.
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/fused_resnet_kernel.py
// (fused_chain, body _kernel; wrapper fused_layer1). Per bottleneck:
//   t1 = relu(bn(conv1x1(x))), set to 0 outside the frame,
//   t2 = relu(bn(conv3x3(t1))) with zero padding,
//   out = relu(bn(conv1x1(t2)) + res),  res = x ("id") or bn(conv1x1(x)),
// with BatchNorm folded to (inv, shift) and the rounding points of
// conv_tile.cuh. Block kinds: "id"; "ds" (projection residual); "s2ds"
// (torchvision v1.5 stride-2 entry: conv1 at input resolution, the 3x3 with
// stride 2 and padding 1, the projection 1x1 with stride 2); "s2pre" (TF v1
// entry: conv1 and the projection are 1x1 with stride 2, so the block is a
// subsample followed by a "ds" block). A projection block is the first of
// its chain.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s). Detector
// layer1, x [32, 90, 160, 64] bf16 -> 256 channels, blocks (ds, id, id):
// 213 k multiply-adds a pixel, 196 GFLOP a batch = 0.20 ms of tensor-core
// time against 295 MB read and written = 0.09 ms: bound by operations. The
// same holds for every shape of the two models (layer2 (s2ds, id, id, id)
// at [32, 90, 160, 256]: 0.31 ms against 0.11 ms; emotion layer4 (id) at
// [256, 7, 7, 2048]: 0.11 ms against 0.03 ms).
//
// Design. The TPU kernel held a band of full-width rows and all weights in
// VMEM; one such row of layer1 is 85 KB and a block here has 227 KB of
// shared memory, so this kernel tiles in both directions. One work item is
// a tile of TH x TW output pixels of G frames with a halo of one pixel per
// 3x3 conv of the chain (N = 3 and a 23 x 23 tile: 29^2 / 23^2 = 1.6 times
// the work, recomputed by neighbouring tiles). Every conv of the chain is
// computed over the whole haloed region by conv_tile.cuh's block-wide
// product; each 3x3 makes one more ring of the region meaningless and the
// tile proper is exact at the end. Weights are read from device memory
// through L2 (layer3's are 2.2 MB a block, the emotion CNN's layer4 8.7 MB:
// neither fits shared memory, both fit the 50 MB L2). Thread blocks are
// persistent (at most two an SM) and walk over the work items.
//
// Which intermediates live where, for all shapes (detector layers 1-3 at
// 90 x 160 / 45 x 80 / 23 x 40, emotion layers 1-4 at 55 / 28 / 14 / 7):
// the region's activations `cur` (c_out channels, updated in place by each
// block's residual add), t1 and t2 (planes channels) live in a scratch slab
// of device memory that belongs to the thread block, is allocated by the
// wrapper and is reused work item after work item, so it stays in L2 while
// the slabs of all resident blocks fit (0.1 to 0.7 MB a block); two operand
// slabs in flight (bf16: 128 pixels x 64 channels and 64 x 64 weights each)
// and the 128 x 64 f32 sums live in shared
// memory; accumulators in registers. No intermediate is a tensor that
// PyTorch sees, and one call is one launch. Small frames (32 x 32 and
// under) are one tile; G frames share a work item so that its pixels fill
// the 128-row product tiles.

#include "conv_tile.cuh"

namespace {

using namespace avcer;

constexpr int kMaxBlocks = 6;
enum Kind { kId = 0, kDs = 1, kS2ds = 2, kS2pre = 3 };

struct ConvW {
  const void* w;
  const void* inv;
  const void* shift;
};

struct BlockW {
  ConvW c1, c2, c3, ds;
  int kind, cin, planes;
};

struct ChainP {
  BlockW blk[kMaxBlocks];
  int nblocks;
  const void* x;
  void* out;
  void* scratch;
  long long slab;  // elements of scratch per thread block
  int B, H, W, cout;
  int Ho, Wo;      // the chain's resolution (after a stride-2 entry)
  int TH, TW, tiles_y, tiles_x, G;
  int halo, RH, RW;  // haloed region at the chain's resolution
  int RH1, RW1;      // "s2ds": conv1's region at input resolution
  int planes_max;
  int nwork;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(const ChainP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = Tile<T>::kVec;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int PR = p.RH * p.RW, PR1 = p.RH1 * p.RW1;
  const int RW = p.RW, RH = p.RH, RW1 = p.RW1;
  const int H = p.H, W = p.W, Ho = p.Ho, Wo = p.Wo, cout = p.cout;
  T* cur = static_cast<T*>(p.scratch) + static_cast<size_t>(blockIdx.x) * p.slab;
  T* t1 = cur + static_cast<size_t>(p.G) * PR * cout;
  T* t2 = t1 + static_cast<size_t>(p.G) * PR1 * p.planes_max;
  const T zero = Num<T>::from_f32(0.0f);
  const int tiles = p.tiles_y * p.tiles_x;

  for (int work = blockIdx.x; work < p.nwork; work += gridDim.x) {
    const int b0 = (work / tiles) * p.G;
    const int gc = min(p.G, p.B - b0);
    const int y0 = ((work % tiles) / p.tiles_x) * p.TH - p.halo;
    const int x0 = ((work % tiles) % p.tiles_x) * p.TW - p.halo;
    const int M = gc * PR;

    // region pixel m lies inside the frame (at the chain's resolution)
    auto inframe = [=](int m) -> bool {
      const int q = m % PR;
      const int yo = y0 + q / RW, xo = x0 + q % RW;
      return yo >= 0 && yo < Ho && xo >= 0 && xo < Wo;
    };
    // the input pixel that region pixel m reads through a 1x1 of stride s
    auto xrow = [=](int m, int s) -> int {
      const int q = m % PR;
      const int yo = y0 + q / RW, xo = x0 + q % RW;
      if (yo < 0 || yo >= Ho || xo < 0 || xo >= Wo) return -1;
      return ((b0 + m / PR) * H + yo * s) * W + xo * s;
    };

    for (int k = 0; k < p.nblocks; ++k) {
      const BlockW& bw = p.blk[k];
      const int kind = bw.kind, cin = bw.cin, pl = bw.planes;
      const bool first = k == 0, last = k == p.nblocks - 1;
      const T* w1 = static_cast<const T*>(bw.c1.w);
      const T* i1 = static_cast<const T*>(bw.c1.inv);
      const T* s1 = static_cast<const T*>(bw.c1.shift);
      const T* w2 = static_cast<const T*>(bw.c2.w);
      const T* i2 = static_cast<const T*>(bw.c2.inv);
      const T* s2 = static_cast<const T*>(bw.c2.shift);
      const T* w3 = static_cast<const T*>(bw.c3.w);
      const T* i3 = static_cast<const T*>(bw.c3.inv);
      const T* s3 = static_cast<const T*>(bw.c3.shift);
      const int s = (kind == kS2ds || kind == kS2pre) ? 2 : 1;

      if (first && kind == kId) {
        // the chain's input region into `cur`, zero outside the frame
        const int chunks = cout / V;
        for (int idx = threadIdx.x; idx < M * chunks; idx += kThreads) {
          const int m = idx / chunks, c = (idx % chunks) * V;
          const int row = xrow(m, 1);
          int4 val = make_int4(0, 0, 0, 0);
          if (row >= 0)
            val = *reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * cout + c);
          *reinterpret_cast<int4*>(cur + static_cast<size_t>(m) * cout + c) = val;
        }
        __syncthreads();
      }

      if (kind != kId) {
        // projection residual bn(conv1x1(x)) -> cur
        const T* wd = static_cast<const T*>(bw.ds.w);
        const T* id = static_cast<const T*>(bw.ds.inv);
        const T* sd = static_cast<const T*>(bw.ds.shift);
        block_gemm<T>(
            x, cin, cin, wd, cout, 1, M, smem, [=](int m, int) { return xrow(m, s); },
            [](int) { return 0; },
            [=](int m, int n, const float* acc, int) {
              store_vec(cur + static_cast<size_t>(m) * cout + n,
                        fold_bn_vec<T>(acc, id + n, sd + n, kLinear, zero));
            });
      }

      // conv1 (1x1) -> t1, zero outside the frame
      if (kind == kS2ds) {
        auto row1 = [=](int m, int) -> int {
          const int q = m % PR1;
          const int yi = 2 * y0 - 1 + q / RW1, xi = 2 * x0 - 1 + q % RW1;
          if (yi < 0 || yi >= H || xi < 0 || xi >= W) return -1;
          return ((b0 + m / PR1) * H + yi) * W + xi;
        };
        block_gemm<T>(x, cin, cin, w1, pl, 1, gc * PR1, smem, row1,
                      [=](int m) { return static_cast<int>(row1(m, 0) >= 0); },
                      [=](int m, int n, const float* acc, int ok) {
                        store_vec(t1 + static_cast<size_t>(m) * pl + n,
                                  fold_bn_vec<T>(acc, i1 + n, s1 + n, kRelu, zero, ok));
                      });
      } else {
        auto ok1 = [=](int m) { return static_cast<int>(inframe(m)); };
        auto epi1 = [=](int m, int n, const float* acc, int ok) {
          store_vec(t1 + static_cast<size_t>(m) * pl + n,
                    fold_bn_vec<T>(acc, i1 + n, s1 + n, kRelu, zero, ok));
        };
        if (kind == kId)
          block_gemm<T>(cur, cout, cin, w1, pl, 1, M, smem, [=](int m, int) { return m; }, ok1,
                        epi1);
        else
          block_gemm<T>(x, cin, cin, w1, pl, 1, M, smem,
                        [=](int m, int) { return xrow(m, s); }, ok1, epi1);
      }

      // conv2 (3x3) -> t2
      auto none = [](int) { return 0; };
      auto epi2 = [=](int m, int n, const float* acc, int) {
        store_vec(t2 + static_cast<size_t>(m) * pl + n,
                  fold_bn_vec<T>(acc, i2 + n, s2 + n, kRelu, zero));
      };
      if (kind == kS2ds) {
        block_gemm<T>(t1, pl, pl, w2, pl, 9, M, smem,
                      [=](int m, int tap) {
                        const int q = m % PR;
                        return (m / PR) * PR1 + (2 * (q / RW) + tap / 3) * RW1 + 2 * (q % RW) +
                               tap % 3;
                      },
                      none, epi2);
      } else {
        block_gemm<T>(t1, pl, pl, w2, pl, 9, M, smem,
                      [=](int m, int tap) {
                        const int q = m % PR;
                        const int r = q / RW + tap / 3 - 1, c = q % RW + tap % 3 - 1;
                        if (r < 0 || r >= RH || c < 0 || c >= RW) return -1;
                        return m + (tap / 3 - 1) * RW + tap % 3 - 1;
                      },
                      none, epi2);
      }

      // conv3 (1x1) + residual -> cur, or the tile proper -> out
      const int halo = p.halo, TH = p.TH, TW = p.TW;
      // a pixel's row of `out` if it belongs to the tile proper, else -1
      auto outrow = [=](int m) -> int {
        const int q = m % PR;
        const int r = q / RW, c = q % RW;
        if (r < halo || r >= halo + TH || c < halo || c >= halo + TW) return -1;
        const int yo = y0 + r, xo = x0 + c;
        if (yo >= Ho || xo >= Wo) return -1;
        return ((b0 + m / PR) * Ho + yo) * Wo + xo;
      };
      block_gemm<T>(t2, pl, pl, w3, cout, 1, M, smem, [=](int m, int) { return m; }, outrow,
                    [=](int m, int n, const float* acc, int orow) {
                      if (last && orow < 0) return;
                      T* res = cur + static_cast<size_t>(m) * cout + n;
                      Vec<T> v = fold_bn_vec<T>(acc, i3 + n, s3 + n, kLinear, zero);
                      const Vec<T> r = load_vec(res);
#pragma unroll
                      for (int j = 0; j < V; ++j)
                        v.v[j] = activate<T>(Num<T>::add(v.v[j], r.v[j]), kRelu, zero);
                      store_vec(last ? out + static_cast<size_t>(orow) * cout + n : res, v);
                    });
    }
  }
}

template <typename T>
int launch(const ChainP& p, int grid, cudaStream_t stream) {
  const int smem = static_cast<int>(Tile<T>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(chain_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  chain_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [B, H, W, cin] and out [B, Ho, Wo, cout] NHWC contiguous; dtype 0 =
// float32, 1 = bfloat16. wptrs: 12 pointers per block (w, inv, shift of
// conv1, conv2, conv3 and the projection; the last three null for "id"),
// w matmul-shaped [ci, co] or [3, 3, ci, co]. kinds: 0 id, 1 ds, 2 s2ds,
// 3 s2pre. TH, TW, G and grid are the caller's plan; scratch holds grid
// slabs. Launches on `stream`; returns a CUDA error code (0 = success),
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int avcer_fused_chain(const void* x, void* out, void* scratch, long long scratch_bytes,
                                 const void* const* wptrs, const int* kinds, const int* cins,
                                 const int* planes, int nblocks, int B, int H, int W, int cout,
                                 int TH, int TW, int G, int grid, int dtype, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (nblocks < 1 || nblocks > kMaxBlocks || (dtype != 0 && dtype != 1)) return bad;
  if (H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || G <= 0 || grid <= 0) return bad;
  const int vec = dtype == 0 ? 4 : 8;
  ChainP p{};
  p.nblocks = nblocks;
  p.planes_max = 0;
  for (int k = 0; k < nblocks; ++k) {
    BlockW& b = p.blk[k];
    const void* const* w = wptrs + 12 * k;
    b.c1 = {w[0], w[1], w[2]};
    b.c2 = {w[3], w[4], w[5]};
    b.c3 = {w[6], w[7], w[8]};
    b.ds = {w[9], w[10], w[11]};
    b.kind = kinds[k];
    b.cin = cins[k];
    b.planes = planes[k];
    if (b.kind < kId || b.kind > kS2pre) return bad;
    if (b.kind != kId && k > 0) return bad;  // a projection block comes first
    if (b.kind == kId && b.cin != cout) return bad;
    if (b.cin % vec || b.planes % vec) return bad;
    if (b.planes > p.planes_max) p.planes_max = b.planes;
  }
  if (cout % vec) return bad;
  const bool s2 = kinds[0] == kS2ds || kinds[0] == kS2pre;
  p.x = x;
  p.out = out;
  p.scratch = scratch;
  p.B = B, p.H = H, p.W = W, p.cout = cout;
  p.Ho = s2 ? (H + 1) / 2 : H;
  p.Wo = s2 ? (W + 1) / 2 : W;
  p.TH = TH, p.TW = TW, p.G = G;
  p.tiles_y = (p.Ho + TH - 1) / TH;
  p.tiles_x = (p.Wo + TW - 1) / TW;
  p.halo = kinds[0] == kS2ds ? nblocks - 1 : nblocks;
  p.RH = TH + 2 * p.halo;
  p.RW = TW + 2 * p.halo;
  p.RH1 = kinds[0] == kS2ds ? 2 * p.RH + 1 : p.RH;
  p.RW1 = kinds[0] == kS2ds ? 2 * p.RW + 1 : p.RW;
  const long long pr = static_cast<long long>(G) * p.RH * p.RW;
  const long long pr1 = static_cast<long long>(G) * p.RH1 * p.RW1;
  p.slab = pr * cout + pr1 * p.planes_max + pr * p.planes_max;
  p.nwork = ((B + G - 1) / G) * p.tiles_y * p.tiles_x;
  const long long need = p.slab * grid * (dtype == 0 ? 4 : 2);
  if (scratch_bytes < need) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(p, grid, s) : launch<__nv_bfloat16>(p, grid, s);
}
