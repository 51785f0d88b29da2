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
// 3x3 conv of the chain (1.2 to 2.0 times the work at the main paths'
// shapes, recomputed by neighbouring tiles). Every conv of the chain is
// computed over the whole haloed region by conv_tile.cuh's product: in
// bf16 block_gemm_tc (mma.sync on 128 x 128 tiles where the conv has 128
// output channels or more, a three-stage cp.async ring), in int8
// block_gemm_tc_q (the same tiles and ring on mma.sync m16n8k32 s8), in f32
// block_gemm; each 3x3 makes one more ring of the region meaningless and the
// tile proper is exact at the end. Weights are read from device memory
// through L2 (layer3's are 2.2 MB, the emotion CNN's layer4 8.7 MB: neither
// fits shared memory, both fit the 50 MB L2).
//
// Clusters. A work item belongs to a cluster of C thread blocks, C from the
// wrapper's plan: clamp(2 x SMs / work items, 1, 4). The deep calls have
// few work items (64 for the detector's layer3, 86 for the emotion CNN's
// layer4), which one block each would spread over half the SMs; in clusters
// of 4 and 3 they fill the card with 256 and 258 blocks. The cluster's
// blocks split every conv's (m-tile, n-tile) pairs round robin (block_gemm's
// part / parts), the region copy and the int8 quantise step split their
// rows, and each conv ends in a cluster barrier (barrier.cluster arrive
// .release / wait .acquire) that hands its output to the next. Rows another
// block wrote are read through L2 only (cp.async.cg, ld.global.cg), never
// through L1 or the read-only path. The work loop's trip count depends on
// the cluster alone, so every block of a cluster passes every barrier
// equally often. Each output is summed by the same instructions in the same
// order whichever block computes it: any C gives the result of C = 1 bit for
// bit. A call with C = 1 runs an instantiation compiled without clusters (C
// and the rank constants). Clusters are persistent (at most two blocks an
// SM) and walk over the work items.
//
// Which intermediates live where, for all shapes (detector layers 1-3 at
// 90 x 160 / 45 x 80 / 23 x 40, emotion layers 1-4 at 55 / 28 / 14 / 7):
// the region's activations `cur` (c_out channels, updated in place by each
// block's residual add), t1 and t2 (planes channels) live in a scratch slab
// of device memory that belongs to the cluster, is allocated by the wrapper
// and is reused work item after work item. At the main paths' shapes a slab
// is 0.5 to 2.6 MB (int8, with its quantised plane: 0.6 to 4.9 MB) and a
// call's slabs add up to 108 to 455 MB (int8: 144 to 862 MB), against a
// 50 MB L2: the intermediates go to device memory and come back through L2
// as the next conv gathers them. The operand ring (bf16: three stages of
// 128 pixels x 64 channels and 64 x 128 weights; int8: three stages of 128
// pixels and 128 output channels x 128 input channels; f32: two slabs) and
// the staged sums live in shared memory; accumulators in registers.
// No intermediate is a tensor that PyTorch sees, and one call is one launch.
// Small frames (32 x 32 and under) are one tile; G frames share a work item
// so that its pixels fill the 128-row product tiles.
//
// The int8 mode (avcer_fused_chain_q; the TPU kernel's act_s): every conv
// multiplies int8 weights with activations quantised by that conv's static
// scale, sums in int32 and applies one f32 multiply and add (conv_tile.cuh).
// The product is block_gemm_tc_q: mma.sync m16n8k32 s8 on tiles of 128
// pixels x 128 output channels (64 where the conv has fewer), eight warps
// each 64 x 32, both operands by ldmatrix from k-contiguous rows, so the
// weights arrive packed [taps, co, ci] (the wrapper's pack_chain_q, made
// once when the model folds them), a three-stage ring of 128-channel slabs
// with one barrier a slab. Bound by operations at twice bf16's peak (1979
// TOP/s); the int32 sums are exact in any order, so the outputs do not
// depend on the product that takes them.
// Activations stay in the compute type between convs: the out-of-frame zeros,
// the residual and both readers of a block's input (conv1 and the projection,
// each with its own scale) need them so; each conv's input is quantised once
// into an int8 plane of the thread block's scratch. The scales are consumed
// in the TPU kernel's order: conv1, conv2, conv3, then the projection, per
// block.
//
// avcer_fused_chain_flat replaces the TPU kernel fused_chain_flat (body
// _kernel_flat) of the same file: the stride-1 chains over bands of whole
// rows, each band computed flat, (th + 2n) rows of pitch W + 2n pixels (n =
// the number of blocks: halo rows and columns), with the 3x3 taps as row
// offsets into the flat band. Bound by operations as above (detector layer1
// 0.20 ms). The TPU kernel's pitch was rounded up to its 8-sublane tile and
// its caller padded, flattened, masked and unflattened the frame in device
// memory; here a row is one pixel of C contiguous channels, so the pitch is
// W + 2n, the kernel gathers the band's pixels from the NHWC input itself
// (zeros outside the frame), computes the frame mask from (row, column), and
// stores the central rows' in-frame pixels at their NHWC rows. Its convs go
// through conv_gemm as K3's do (bf16: block_gemm_tc; f32: block_gemm), the
// same terms in the same order, so it equals fused_chain bit for bit. A band
// belongs to a cluster of C blocks that split every conv as chain_kernel's
// do; the wrapper's plan chooses the band height th and C together from
// what the card holds (taller bands recompute fewer halo rows but leave
// fewer work items, which clusters then spread over more SMs).

#include "conv_tile.cuh"

namespace {

using namespace avcer;

constexpr int kMaxBlocks = 6;
enum Kind { kId = 0, kDs = 1, kS2ds = 2, kS2pre = 3 };

struct BlockW {
  ConvW c1, c2, c3, ds;
  int kind, cin, planes;
  int s0;  // int8 mode: index of conv1's scale in act_s
};

struct ChainP {
  BlockW blk[kMaxBlocks];
  int nblocks;
  const void* x;
  void* out;
  void* scratch;
  const float* act_s;  // int8 mode: one static activation scale per conv
  long long slab;   // elements of scratch per cluster
  long long qslab;  // int8 mode: bytes of the quantised plane per cluster
  int C;            // thread blocks per cluster, all on one work item
  int B, H, W, cout;
  int Ho, Wo;      // the chain's resolution (after a stride-2 entry)
  int TH, TW, tiles_y, tiles_x, G;
  int halo, RH, RW;  // haloed region at the chain's resolution
  int RH1, RW1;      // "s2ds": conv1's region at input resolution
  int planes_max;
  int nwork;
};

// kCl: launched in clusters of p.C > 1 blocks. Without it the kernel is
// compiled with C = 1 and rank 0 as constants: a call that needs no cluster
// runs the instructions of a kernel that knows none.
template <typename T, bool Q, bool kCl>
__global__ void __launch_bounds__(kThreads, 2) chain_kernel(const ChainP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = Tile<T>::kVec;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int PR = p.RH * p.RW, PR1 = p.RH1 * p.RW1;
  const int RW = p.RW, RH = p.RH, RW1 = p.RW1;
  const int H = p.H, W = p.W, Ho = p.Ho, Wo = p.Wo, cout = p.cout;
  // the cluster's blocks share its work items and its slab; `rank` is this
  // block's place in the cluster and its part of every conv
  const int C = kCl ? p.C : 1;
  const int cluster = kCl ? blockIdx.x / C : blockIdx.x, rank = kCl ? blockIdx.x % C : 0;
  const int clusters = kCl ? gridDim.x / C : gridDim.x;
  T* cur = static_cast<T*>(p.scratch) + static_cast<size_t>(cluster) * p.slab;
  T* t1 = cur + static_cast<size_t>(p.G) * PR * cout;
  T* t2 = t1 + static_cast<size_t>(p.G) * PR1 * p.planes_max;
  // the int8 planes follow the slabs of all clusters
  signed char* qbuf = reinterpret_cast<signed char*>(static_cast<T*>(p.scratch) +
                                                     static_cast<size_t>(clusters) * p.slab) +
                      static_cast<size_t>(cluster) * p.qslab;
  const T zero = Num<T>::from_f32(0.0f);
  const int tiles = p.tiles_y * p.tiles_x;
  auto same = [](int r) { return r; };
  auto same_tap = [](int m, int) { return m; };

  // the trip count depends on the cluster only: every block of a cluster
  // reaches every cluster barrier equally often
  for (int work = cluster; work < p.nwork; work += clusters) {
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
      const ConvW c1 = bw.c1, c2 = bw.c2, c3 = bw.c3, cd = bw.ds;
      const int s = (kind == kS2ds || kind == kS2pre) ? 2 : 1;
      // the static scale of the block's conv `i` (0 conv1, 1 conv2, 2 conv3,
      // 3 the projection)
      auto sx = [&](int i) -> float {
        if constexpr (Q) return __ldg(p.act_s + bw.s0 + i);
        return 0.0f;
      };

      if (first && kind == kId) {
        // the chain's input region into `cur`, zero outside the frame, its
        // rows shared out between the cluster's blocks
        const int chunks = cout / V;
        for (int idx = rank * kThreads + threadIdx.x; idx < M * chunks; idx += C * kThreads) {
          const int m = idx / chunks, c = (idx % chunks) * V;
          const int row = xrow(m, 1);
          int4 val = make_int4(0, 0, 0, 0);
          if (row >= 0)
            val = *reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * cout + c);
          *reinterpret_cast<int4*>(cur + static_cast<size_t>(m) * cout + c) = val;
        }
        sync_parts(C);
      }

      if (kind != kId) {
        // projection residual bn(conv1x1(x)) -> cur
        conv_gemm<T, Q, true, true>(
            x, cin, cin, M, [=](int r) { return xrow(r, s); }, qbuf, sx(3), cd.w, cout, 1, M, smem,
            same_tap, [](int) { return 0; },
            [=](int m, int n, const float* acc, int) {
              store_vec(cur + static_cast<size_t>(m) * cout + n,
                        fold_vec<T, Q>(acc, cd, n, kLinear, zero));
            },
            rank, C);
      }

      // conv1 (1x1) -> t1, zero outside the frame
      if (kind == kS2ds) {
        auto row1 = [=](int m) -> int {
          const int q = m % PR1;
          const int yi = 2 * y0 - 1 + q / RW1, xi = 2 * x0 - 1 + q % RW1;
          if (yi < 0 || yi >= H || xi < 0 || xi >= W) return -1;
          return ((b0 + m / PR1) * H + yi) * W + xi;
        };
        conv_gemm<T, Q, true, true>(
            x, cin, cin, gc * PR1, row1, qbuf, sx(0), c1.w, pl, 1, gc * PR1, smem, same_tap,
            [=](int m) { return static_cast<int>(row1(m) >= 0); },
            [=](int m, int n, const float* acc, int ok) {
              store_vec(t1 + static_cast<size_t>(m) * pl + n,
                        fold_vec<T, Q>(acc, c1, n, kRelu, zero, ok));
            },
            rank, C);
      } else {
        auto ok1 = [=](int m) { return static_cast<int>(inframe(m)); };
        auto epi1 = [=](int m, int n, const float* acc, int ok) {
          store_vec(t1 + static_cast<size_t>(m) * pl + n,
                    fold_vec<T, Q>(acc, c1, n, kRelu, zero, ok));
        };
        if (kind == kId)
          conv_gemm<T, Q, true, true>(cur, cout, cin, M, same, qbuf, sx(0), c1.w, pl, 1, M,
                                      smem, same_tap, ok1, epi1, rank, C);
        else
          conv_gemm<T, Q, true, true>(x, cin, cin, M, [=](int r) { return xrow(r, s); }, qbuf,
                                      sx(0), c1.w, pl, 1, M, smem, same_tap, ok1, epi1, rank, C);
      }

      // conv2 (3x3) -> t2
      auto none = [](int) { return 0; };
      auto epi2 = [=](int m, int n, const float* acc, int) {
        store_vec(t2 + static_cast<size_t>(m) * pl + n, fold_vec<T, Q>(acc, c2, n, kRelu, zero));
      };
      if (kind == kS2ds) {
        conv_gemm<T, Q, true, true>(t1, pl, pl, gc * PR1, same, qbuf, sx(1), c2.w, pl, 9, M,
                                    smem,
                                    [=](int m, int tap) {
                                      const int q = m % PR;
                                      return (m / PR) * PR1 + (2 * (q / RW) + tap / 3) * RW1 +
                                             2 * (q % RW) + tap % 3;
                                    },
                                    none, epi2, rank, C);
      } else {
        conv_gemm<T, Q, true, true>(t1, pl, pl, M, same, qbuf, sx(1), c2.w, pl, 9, M, smem,
                                    [=](int m, int tap) {
                                      const int q = m % PR;
                                      const int r = q / RW + tap / 3 - 1, c = q % RW + tap % 3 - 1;
                                      if (r < 0 || r >= RH || c < 0 || c >= RW) return -1;
                                      return m + (tap / 3 - 1) * RW + tap % 3 - 1;
                                    },
                                    none, epi2, rank, C);
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
      auto epi3 = [=](int m, int n, const float* acc, int orow) {
        if (last && orow < 0) return;
        T* res = cur + static_cast<size_t>(m) * cout + n;
        Vec<T> v = fold_vec<T, Q>(acc, c3, n, kLinear, zero);
        // another block of the cluster may have written it
        const Vec<T> r = kCl ? load_vec_cg(res) : load_vec(res);
#pragma unroll
        for (int j = 0; j < V; ++j)
          v.v[j] = activate<T>(Num<T>::add(v.v[j], r.v[j]), kRelu, zero);
        store_vec(last ? out + static_cast<size_t>(orow) * cout + n : res, v);
      };
      conv_gemm<T, Q, true, true>(t2, pl, pl, M, same, qbuf, sx(2), c3.w, cout, 1, M, smem,
                                  same_tap, outrow, epi3, rank, C);
    }
  }
}

struct FlatP {
  BlockW blk[kMaxBlocks];
  int nblocks;
  const void* x;  // [B, H, W, cin] NHWC
  void* out;      // [B, H, W, cout] NHWC
  void* scratch;
  long long slab;  // elements of scratch per cluster
  int C;           // thread blocks per cluster, all on one work item
  int B, H, W, th, nb, n, pitch, cin, cout, planes_max;
};

// One work item is one band of one frame: M = (th + 2n) * pitch flat pixels,
// flat row m the pixel (rb * th - n + m / pitch, m % pitch - n) of frame b.
// kCl: launched in clusters of p.C > 1 blocks (as chain_kernel).
template <typename T, bool kCl>
__global__ void __launch_bounds__(kThreads, 2) chain_flat_kernel(const FlatP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = Tile<T>::kVec;
  const int pitch = p.pitch, cout = p.cout, n = p.n, H = p.H, W = p.W, th = p.th;
  const int M = (th + 2 * n) * pitch;
  const T* x = static_cast<const T*>(p.x);
  T* out = static_cast<T*>(p.out);
  const int C = kCl ? p.C : 1;
  const int cluster = kCl ? blockIdx.x / C : blockIdx.x, rank = kCl ? blockIdx.x % C : 0;
  const int clusters = kCl ? gridDim.x / C : gridDim.x;
  T* cur = static_cast<T*>(p.scratch) + static_cast<size_t>(cluster) * p.slab;
  T* t1 = cur + static_cast<size_t>(M) * cout;
  T* t2 = t1 + static_cast<size_t>(M) * p.planes_max;
  const T zero = Num<T>::from_f32(0.0f);
  auto same = [](int r) { return r; };
  auto same_tap = [](int m, int) { return m; };
  auto none = [](int) { return 0; };

  // the trip count depends on the cluster only: every block of a cluster
  // reaches every cluster barrier equally often
  for (int work = cluster; work < p.B * p.nb; work += clusters) {
    const int b = work / p.nb, r0 = (work % p.nb) * th - n;
    // the NHWC row of flat row m, or -1 outside the frame (which reads zeros)
    auto pixel = [=](int m) -> int {
      const int r = r0 + m / pitch, c = m % pitch - n;
      return r >= 0 && r < H && c >= 0 && c < W ? (b * H + r) * W + c : -1;
    };
    // a conv of the exact mode over the band's M rows, shared by the cluster
    auto conv = [&](const T* a, int lda, int K, auto gather, const ConvW& cw, int N, int taps,
                    auto rowfn, auto infofn, auto epi) {
      conv_gemm<T, false, true>(a, lda, K, M, gather, nullptr, 0.0f, cw.w, N, taps, M, smem,
                                rowfn, infofn, epi, rank, C);
    };

    for (int k = 0; k < p.nblocks; ++k) {
      const BlockW& bw = p.blk[k];
      const int kind = bw.kind, cin = bw.cin, pl = bw.planes;
      const bool first = k == 0, last = k == p.nblocks - 1;
      const ConvW c1 = bw.c1, c2 = bw.c2, c3 = bw.c3, cd = bw.ds;

      if (first && kind == kId) {
        // the band's input into `cur`, zeros outside the frame
        const int chunks = cout / V;
        for (int idx = rank * kThreads + threadIdx.x; idx < M * chunks; idx += C * kThreads) {
          const int m = idx / chunks, c = (idx % chunks) * V;
          const int row = pixel(m);
          int4 val = make_int4(0, 0, 0, 0);
          if (row >= 0)
            val = *reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * cout + c);
          *reinterpret_cast<int4*>(cur + static_cast<size_t>(m) * cout + c) = val;
        }
        sync_parts(C);
      }
      if (kind == kDs)
        conv(x, p.cin, cin, pixel, cd, cout, 1, same_tap, none,
             [=](int m, int nn, const float* acc, int) {
               store_vec(cur + static_cast<size_t>(m) * cout + nn,
                         fold_vec<T, false>(acc, cd, nn, kLinear, zero));
             });
      // conv1, zero outside the frame
      auto ok1 = [=](int m) { return static_cast<int>(pixel(m) >= 0); };
      auto epi1 = [=](int m, int nn, const float* acc, int ok) {
        store_vec(t1 + static_cast<size_t>(m) * pl + nn,
                  fold_vec<T, false>(acc, c1, nn, kRelu, zero, ok));
      };
      if (kind == kDs)
        conv(x, p.cin, cin, pixel, c1, pl, 1, same_tap, ok1, epi1);
      else
        conv(cur, cout, cin, same, c1, pl, 1, same_tap, ok1, epi1);
      // conv2: tap (ky, kx) is the flat row m + (ky - 1) * pitch + (kx - 1),
      // the band extended with zeros at both ends; across a row's end it
      // reads a halo column, which conv1 zeroed
      conv(t1, pl, pl, same, c2, pl, 9,
           [=](int m, int tap) {
             const int r = m + (tap / 3 - 1) * pitch + tap % 3 - 1;
             return r >= 0 && r < M ? r : -1;
           },
           none, [=](int m, int nn, const float* acc, int) {
             store_vec(t2 + static_cast<size_t>(m) * pl + nn,
                       fold_vec<T, false>(acc, c2, nn, kRelu, zero));
           });
      // conv3 + residual -> cur, or the central th rows' in-frame pixels ->
      // their NHWC rows of out
      const int lo = n * pitch, hi = (n + th) * pitch;
      conv(t2, pl, pl, same, c3, cout, 1, same_tap,
           [=](int m) { return m >= lo && m < hi ? pixel(m) : -1; },
           [=](int m, int nn, const float* acc, int orow) {
             if (last && orow < 0) return;
             T* res = cur + static_cast<size_t>(m) * cout + nn;
             Vec<T> v = fold_vec<T, false>(acc, c3, nn, kLinear, zero);
             // another block of the cluster may have written it
             const Vec<T> r = kCl ? load_vec_cg(res) : load_vec(res);
#pragma unroll
             for (int j = 0; j < V; ++j)
               v.v[j] = activate<T>(Num<T>::add(v.v[j], r.v[j]), kRelu, zero);
             store_vec(last ? out + static_cast<size_t>(orow) * cout + nn : res, v);
           });
    }
  }
}

// chain_kernel in clusters of `cluster` blocks (launch_clusters): with
// `clusters` and `blocks` non-null it reports what the card holds instead.
template <typename T, bool Q>
int launch(const ChainP& p, int grid, int cluster, cudaStream_t stream, int* clusters = nullptr,
           int* blocks = nullptr) {
  constexpr size_t smem = conv_smem_bytes<T, Q, true, true>();
  return cluster > 1 ? launch_clusters(chain_kernel<T, Q, true>, p, grid, cluster, smem, stream,
                                       clusters, blocks)
                     : launch_clusters(chain_kernel<T, Q, false>, p, grid, cluster, smem, stream,
                                       clusters, blocks);
}

// chain_flat_kernel in clusters of `cluster` blocks; with `clusters` and
// `blocks` non-null it reports what the card holds instead (as launch).
template <typename T>
int launch_flat(const FlatP& p, int grid, int cluster, cudaStream_t stream,
                int* clusters = nullptr, int* blocks = nullptr) {
  constexpr size_t smem = conv_smem_bytes<T, false, true>();
  return cluster > 1 ? launch_clusters(chain_flat_kernel<T, true>, p, grid, cluster, smem, stream,
                                       clusters, blocks)
                     : launch_clusters(chain_flat_kernel<T, false>, p, grid, cluster, smem,
                                       stream, clusters, blocks);
}

// The blocks of a chain from the wrapper's arrays; false for what the kernels
// do not take. `align`: channel counts must be multiples of it.
bool fill_blocks(BlockW* blk, int* planes_max, const void* const* wptrs, const int* kinds,
                 const int* cins, const int* planes, int nblocks, int cout, int align,
                 int max_kind) {
  if (nblocks < 1 || nblocks > kMaxBlocks || cout % align) return false;
  *planes_max = 0;
  int s0 = 0;
  for (int k = 0; k < nblocks; ++k) {
    BlockW& b = blk[k];
    const void* const* w = wptrs + 12 * k;
    b.c1 = {w[0], w[1], w[2]};
    b.c2 = {w[3], w[4], w[5]};
    b.c3 = {w[6], w[7], w[8]};
    b.ds = {w[9], w[10], w[11]};
    b.kind = kinds[k];
    b.cin = cins[k];
    b.planes = planes[k];
    b.s0 = s0;
    s0 += b.kind == kId ? 3 : 4;
    if (b.kind < kId || b.kind > max_kind) return false;
    if (b.kind != kId && k > 0) return false;  // a projection block comes first
    if (b.kind == kId && b.cin != cout) return false;
    if (b.cin % align || b.planes % align) return false;
    if (b.planes > *planes_max) *planes_max = b.planes;
  }
  return true;
}

int chain(const void* x, void* out, void* scratch, long long scratch_bytes,
          const void* const* wptrs, const int* kinds, const int* cins, const int* planes,
          int nblocks, int B, int H, int W, int cout, int TH, int TW, int G, int grid, int cluster,
          int dtype, const float* act_s, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (dtype != 0 && dtype != 1) return bad;
  if (H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || G <= 0 || grid <= 0) return bad;
  // a portable cluster holds at most 8 blocks; the grid is whole clusters
  if (cluster < 1 || cluster > 8 || grid % cluster) return bad;
  // int8 weights are copied 16 channels at a time
  const int align = act_s != nullptr ? 16 : (dtype == 0 ? 4 : 8);
  ChainP p{};
  p.nblocks = nblocks;
  if (!fill_blocks(p.blk, &p.planes_max, wptrs, kinds, cins, planes, nblocks, cout, align,
                   kS2pre))
    return bad;
  const bool s2 = kinds[0] == kS2ds || kinds[0] == kS2pre;
  p.x = x;
  p.out = out;
  p.scratch = scratch;
  p.act_s = act_s;
  p.B = B, p.H = H, p.W = W, p.cout = cout;
  p.Ho = s2 ? (H + 1) / 2 : H;
  p.Wo = s2 ? (W + 1) / 2 : W;
  p.TH = TH, p.TW = TW, p.G = G, p.C = cluster;
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
  // the int8 plane holds the widest conv input: conv1's region by the most channels
  int qch = cins[0] > cout ? cins[0] : cout;
  if (p.planes_max > qch) qch = p.planes_max;
  p.qslab = act_s != nullptr ? pr1 * qch : 0;
  const long long need = (p.slab * (dtype == 0 ? 4 : 2) + p.qslab) * (grid / cluster);
  if (scratch_bytes < need) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_s != nullptr)
    return dtype == 0 ? launch<float, true>(p, grid, cluster, s)
                      : launch<__nv_bfloat16, true>(p, grid, cluster, s);
  return dtype == 0 ? launch<float, false>(p, grid, cluster, s)
                    : launch<__nv_bfloat16, false>(p, grid, cluster, s);
}

}  // namespace

// x [B, H, W, cin] and out [B, Ho, Wo, cout] NHWC contiguous; dtype 0 =
// float32, 1 = bfloat16. wptrs: 12 pointers per block (w, inv, shift of
// conv1, conv2, conv3 and the projection; the last three null for "id"),
// w matmul-shaped [ci, co] or [3, 3, ci, co]. kinds: 0 id, 1 ds, 2 s2ds,
// 3 s2pre. TH, TW, G, grid and cluster are the caller's plan: grid blocks in
// clusters of `cluster` (1 to 8, dividing grid), one work item a cluster at a
// time; scratch holds grid / cluster slabs. Launches on `stream`; returns a
// CUDA error code (0 = success), cudaErrorInvalidValue for what the kernel
// does not take, the launch's own error for a cluster the card refuses.
extern "C" int avcer_fused_chain(const void* x, void* out, void* scratch, long long scratch_bytes,
                                 const void* const* wptrs, const int* kinds, const int* cins,
                                 const int* planes, int nblocks, int B, int H, int W, int cout,
                                 int TH, int TW, int G, int grid, int cluster, int dtype,
                                 void* stream) {
  return chain(x, out, scratch, scratch_bytes, wptrs, kinds, cins, planes, nblocks, B, H, W, cout,
               TH, TW, G, grid, cluster, dtype, nullptr, stream);
}

// The int8 mode: as above with w int8 packed [taps, co, ci] (k contiguous:
// [co, ci] for a 1x1, [9, co, ci] for the 3x3; the wrapper's pack_chain_q),
// inv (the merged multiply) and shift float32 whatever `dtype`, and act_s [3
// or 4 per block] float32 on the device. Channel counts are multiples of 16.
extern "C" int avcer_fused_chain_q(const void* x, void* out, void* scratch,
                                   long long scratch_bytes, const void* const* wptrs,
                                   const int* kinds, const int* cins, const int* planes,
                                   int nblocks, int B, int H, int W, int cout, int TH, int TW,
                                   int G, int grid, int cluster, int dtype, const float* act_s,
                                   void* stream) {
  if (act_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return chain(x, out, scratch, scratch_bytes, wptrs, kinds, cins, planes, nblocks, B, H, W, cout,
               TH, TW, G, grid, cluster, dtype, act_s, stream);
}

// What the card reports for chain_kernel in clusters of `cluster` blocks
// (dtype as above; quant 1 for the int8 mode): the clusters it can hold at
// once (cudaOccupancyMaxActiveClusters) and the blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Launches nothing;
// returns a CUDA error code.
extern "C" int avcer_fused_chain_occupancy(int dtype, int quant, int cluster, int* clusters,
                                           int* blocks) {
  if ((dtype != 0 && dtype != 1) || cluster < 1 || cluster > 8 || clusters == nullptr ||
      blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  ChainP p{};
  if (quant)
    return dtype == 0 ? launch<float, true>(p, cluster, cluster, nullptr, clusters, blocks)
                      : launch<__nv_bfloat16, true>(p, cluster, cluster, nullptr, clusters, blocks);
  return dtype == 0 ? launch<float, false>(p, cluster, cluster, nullptr, clusters, blocks)
                    : launch<__nv_bfloat16, false>(p, cluster, cluster, nullptr, clusters, blocks);
}

// The flat kernel: x [B, H, W, cin] and out [B, H, W, cout] NHWC contiguous,
// stride-1 chains (kinds: 0 id, 1 ds). Each of nb = ceil(H / th) bands of a
// frame is th output rows and n = nblocks halo rows above and below, of
// pitch = W + 2n pixels (n halo columns a side), computed flat. grid blocks
// in clusters of `cluster` (1 to 8, dividing grid), one band a cluster at a
// time; scratch holds grid / cluster slabs of (th + 2n) * pitch * (cout + 2
// * planes_max) elements. Returns a CUDA error code as avcer_fused_chain.
extern "C" int avcer_fused_chain_flat(const void* x, void* out, void* scratch,
                                      long long scratch_bytes, const void* const* wptrs,
                                      const int* kinds, const int* cins, const int* planes,
                                      int nblocks, int B, int H, int W, int cin, int cout, int th,
                                      int grid, int cluster, int dtype, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (dtype != 0 && dtype != 1) return bad;
  if (H <= 0 || W <= 0 || th <= 0 || grid <= 0) return bad;
  if (cluster < 1 || cluster > 8 || grid % cluster) return bad;
  const int align = dtype == 0 ? 4 : 8;
  FlatP p{};
  p.nblocks = nblocks;
  if (!fill_blocks(p.blk, &p.planes_max, wptrs, kinds, cins, planes, nblocks, cout, align, kDs))
    return bad;
  if (cin != cins[0]) return bad;
  p.x = x;
  p.out = out;
  p.scratch = scratch;
  p.C = cluster;
  p.B = B, p.H = H, p.W = W, p.th = th, p.nb = (H + th - 1) / th, p.n = nblocks;
  p.pitch = W + 2 * nblocks, p.cin = cin, p.cout = cout;
  p.slab = static_cast<long long>(th + 2 * nblocks) * p.pitch * (cout + 2 * p.planes_max);
  if (scratch_bytes < p.slab * (grid / cluster) * (dtype == 0 ? 4 : 2)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_flat<float>(p, grid, cluster, s)
                    : launch_flat<__nv_bfloat16>(p, grid, cluster, s);
}

// What the card reports for chain_flat_kernel in clusters of `cluster`
// blocks, as avcer_fused_chain_occupancy (the kernel has no int8 mode: quant
// must be 0).
extern "C" int avcer_fused_chain_flat_occupancy(int dtype, int quant, int cluster, int* clusters,
                                                int* blocks) {
  if ((dtype != 0 && dtype != 1) || quant != 0 || cluster < 1 || cluster > 8 ||
      clusters == nullptr || blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  FlatP p{};
  return dtype == 0 ? launch_flat<float>(p, cluster, cluster, nullptr, clusters, blocks)
                    : launch_flat<__nv_bfloat16>(p, cluster, cluster, nullptr, clusters, blocks);
}
