// One FPN scale of the RetinaFace detector as one kernel launch: optional FPN
// lateral and merge, the SSH context module and the three 1x1 heads.
//
// Replaces the TPU kernel avcer_tpu/ops/pallas/fused_ssh_kernel.py
// (fused_ssh_heads, body _kernel). With act = ReLU (leaky == 0) or leaky
// ReLU, and every intermediate set to 0 outside the frame before the next
// 3x3 reads it:
//   f    = act(bn(conv1x1(x))) [+ up]          (with the lateral; else f = x)
//   f    = act(bn(conv3x3(f)))                 (with the merge)
//   c3   = bn(conv3x3(f))                      C/2 channels
//   c5_1 = act(bn(conv3x3(f)))                 C/4
//   c5   = bn(conv3x3(c5_1)),  c7_2 = act(bn(conv3x3(c5_1))),  c7 = bn(conv3x3(c7_2))
//   head = relu(c3) @ W[:C/2] + relu(c5) @ W[C/2:3C/4] + relu(c7) @ W[3C/4:]
// summed in f32, rounded to the compute type, plus bias; for the box (2 x 4),
// class (2 x 2) and landmark (2 x 10) heads. Optionally f itself is written
// out for the next finer scale. Rounding points as in conv_tile.cuh.
//
// What bounds it on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s), C = 256,
// 32 frames, bf16: scale 1 (x [32, 45, 80, 512], lateral, up, merge) does
// 1.28 M multiply-adds a pixel, 295 GFLOP = 0.30 ms, against 190 MB moved =
// 0.06 ms; scale 2 ([32, 23, 40, 1024]) 0.08 ms against 0.03 ms; scale 3
// ([32, 12, 20, 2048], lateral only) 0.017 ms against 0.011 ms. Operations
// bind all three.
//
// Design. A work item is a tile of TH x TW pixels of G frames with a halo of
// 3 pixels (4 with the merge conv). Each conv is conv_tile.cuh's block-wide
// product over the part of the haloed region that a later step reads, as
// the TPU kernel shrinks its bands: a 3x3 at depth d covers the region less
// d pixels on every side and reads the rectangle at depth d - 1 (with the
// merge: lateral 0, merge 1, c5_1 2, c7_2 3, c3 / c5 / c7 4, the tile
// proper; without it f 0, c5_1 1, c7_2 2, the other three 3). At scale 1
// that is 216 G multiply-adds a call against 283 over whole regions. Every
// value that a later step reads is summed as over the whole region. The
// bf16 product is block_gemm_tc (mma.sync, 128 x 128 tiles where the conv
// has 128 output channels or more, else 128 x 64, a three-stage cp.async
// ring), the int8 option's block_gemm_tc_q (mma.sync m16n8k32 s8 on the same
// tiles and ring, 128-channel slabs), f32 block_gemm. The lateral streams its
// up to 2048 input channels through shared memory in slabs of 32 to 128 and
// only the 256-channel result is kept.
//
// Clusters. A work item belongs to a cluster of C thread blocks, C from the
// wrapper's plan: the size of 1 to 4 with the fewest rounds of work items a
// block, from what the card reports it holds of each size (scale 1 of the
// r50 detector: 256 work items, C = 1; scale 2: 64, C = 3; scale 3: 32,
// C = 4). The cluster's blocks split every conv's (m-tile, n-tile) pairs
// round robin, and the region copy, the int8 quantise step, the copy of the
// emitted feature and the heads split their rows; each conv ends in a
// cluster barrier that hands its output to the next, and the work item ends
// in one before the slab is reused. Rows another block wrote are read
// through L2 only (cp.async.cg, ld.global.cg). The work loop's trip count
// depends on the cluster alone. Each output is summed by the same
// instructions in the same order whichever block computes it: any C gives
// the result of C = 1 bit for bit. A call with C = 1 runs an instantiation
// compiled without clusters.
//
// Memory. f, c5_1, c7_2 and the ReLU'd (c3 | c5 | c7) live in the cluster's
// slab of device-memory scratch (allocated by the wrapper, reused work item
// after work item): at scale 1 a slab is 1.55 MB (int8, with its quantised
// plane: 2.0 MB) and a call's slabs add up to 398 MB (int8 512 MB), against a
// 50 MB L2, so the intermediates go to device memory and come back through L2
// as the next conv gathers them. The heads are scalar f32 sums on the CUDA
// cores over `cat` and write the narrow outputs, output channel fastest, so
// a warp's stores are contiguous. The three scales are three launches in
// sequence on one stream: scale 2 reads what scale 3 emitted.
//
// The int8 option (avcer_fused_ssh_q; the TPU kernel's act_s): the lateral,
// the merge and the five SSH convs multiply int8 weights with activations
// quantised by their static scales (once per conv, the rows it reads, into
// an int8 plane of the cluster's scratch) and sum in int32 on
// block_gemm_tc_q (conv_tile.cuh), both operands by ldmatrix from
// k-contiguous rows: the weights arrive packed [taps, co, ci] (the wrapper's
// pack_chain_q, which the model makes once when it folds a scale). Bound by
// operations at twice bf16's peak (1979 TOP/s): r50 scale 1 0.15 ms. The
// int32 sums are exact in any order, so the outputs do not depend on the
// product that takes them. The leaky ReLU acts on the value already rounded
// to the compute type, and the three heads stay exact f32 sums over the
// ReLU'd segments. The scales come in the TPU kernel's order: lateral,
// merge, then the five SSH convs.

#include "conv_tile.cuh"

namespace {

using namespace avcer;

struct SshP {
  const void* x;
  const void* up;
  ConvW lat, merge, conv[5];  // conv: c3, c5_1, c5, c7_2, c7
  const void* hw[3];
  const void* hb[3];
  int hn[3];
  void* out[3];
  void* feat;
  void* scratch;
  const float* act_s;  // int8 option: lateral, merge (where present), five SSH convs
  long long slab;   // elements of scratch per cluster
  long long qslab;  // int8 option: bytes of the quantised plane per cluster
  int CL;           // thread blocks per cluster, all on one work item
  int B, H, W, Ci, C;
  int has_lat, has_merge, has_up, emit, act;
  float leaky;
  int TH, TW, tiles_y, tiles_x, G, halo, RH, RW, nwork;
};

// kCl: launched in clusters of p.CL > 1 blocks. Without it the kernel is
// compiled with a cluster of one and rank 0 as constants: a call that needs
// no cluster runs the instructions of a kernel that knows none.
template <typename T, bool Q, bool kCl>
__global__ void __launch_bounds__(kThreads, 2) ssh_kernel(const SshP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = Tile<T>::kVec;
  const T* x = static_cast<const T*>(p.x);
  const T* up = static_cast<const T*>(p.up);
  const int RH = p.RH, RW = p.RW, PR = RH * RW;
  const int H = p.H, W = p.W, C = p.C, Ci = p.Ci, C4 = p.C / 4;
  const int act = p.act;
  const T leaky = Num<T>::from_f32(p.leaky);
  // the cluster's blocks share its work items and its slab; `rank` is this
  // block's place in the cluster and its part of every conv and row loop
  const int CL = kCl ? p.CL : 1;
  const int cluster = kCl ? blockIdx.x / CL : blockIdx.x, rank = kCl ? blockIdx.x % CL : 0;
  const int clusters = kCl ? gridDim.x / CL : gridDim.x;
  const size_t region = static_cast<size_t>(p.G) * PR;
  T* f0 = static_cast<T*>(p.scratch) + static_cast<size_t>(cluster) * p.slab;
  T* f = p.has_merge ? f0 + region * C : f0;
  T* t51 = f + region * C;
  T* t72 = t51 + region * C4;
  T* cat = t72 + region * C4;  // relu(c3 | c5 | c7), C channels
  // the int8 planes follow the slabs of all clusters
  signed char* qbuf = reinterpret_cast<signed char*>(static_cast<T*>(p.scratch) +
                                                     static_cast<size_t>(clusters) * p.slab) +
                      static_cast<size_t>(cluster) * p.qslab;
  auto same = [](int r) { return r; };
  const int tiles = p.tiles_y * p.tiles_x;
  // the static scale of conv `i` in act_s order
  auto sx = [&](int i) -> float {
    if constexpr (Q) return __ldg(p.act_s + i);
    return 0.0f;
  };
  const int s_ssh = p.has_lat + p.has_merge;  // index of conv3X3's scale

  // the trip count depends on the cluster only: every block of a cluster
  // reaches every cluster barrier equally often
  for (int work = cluster; work < p.nwork; work += clusters) {
    const int b0 = (work / tiles) * p.G;
    const int gc = min(p.G, p.B - b0);
    const int y0 = ((work % tiles) / p.tiles_x) * p.TH - p.halo;
    const int x0 = ((work % tiles) % p.tiles_x) * p.TW - p.halo;
    const int M = gc * PR;

    // the frame pixel of region pixel m, or -1 outside the frame
    auto xrow = [=](int m) -> int {
      const int q = m % PR;
      const int y = y0 + q / RW, xx = x0 + q % RW;
      if (y < 0 || y >= H || xx < 0 || xx >= W) return -1;
      return ((b0 + m / PR) * H + y) * W + xx;
    };
    // the region pixel of pixel i of the rectangle at depth d: each frame's
    // region less d pixels on every side, (RH - 2d) x (RW - 2d) pixels
    auto pix = [=](int i, int d) -> int {
      const int rw = RW - 2 * d, pd = (RH - 2 * d) * rw;
      const int q = i % pd;
      return (i / pd) * PR + (d + q / rw) * RW + d + q % rw;
    };
    // a 3x3 ConvBN from `src` to `dst` (channel offset `off` of rows of `ldd`,
    // both at region pixels) over the rectangle at depth d, which reads the
    // one at depth d - 1: its input rows; `a` its activation; `mask` zeroes
    // the result outside the frame
    auto conv3x3 = [&](const T* src, int k, const ConvW& cw, float scale, int n, T* dst, int ldd,
                       int off, int a, bool mask, int d) {
      const int rh = RH - 2 * d, rw = RW - 2 * d, pd = rh * rw;
      const int rwi = rw + 2, pdi = (rh + 2) * rwi;
      conv_gemm<T, Q, true, true>(
          src, k, k, gc * pdi, [=](int r) { return pix(r, d - 1); }, qbuf, scale, cw.w, n, 9,
          gc * pd, smem,
          [=](int i, int tap) {
            const int q = i % pd;
            return (i / pd) * pdi + (q / rw + tap / 3) * rwi + q % rw + tap % 3;
          },
          [=](int i) { return static_cast<int>(!mask || xrow(pix(i, d)) >= 0); },
          [=](int i, int j, const float* acc, int ok) {
            store_vec(dst + static_cast<size_t>(pix(i, d)) * ldd + off + j,
                      fold_vec<T, Q>(acc, cw, j, a, leaky, ok));
          },
          rank, CL);
    };

    if (p.has_lat) {
      const ConvW lat = p.lat;
      const bool has_up = p.has_up;
      conv_gemm<T, Q, true, true>(
          x, Ci, Ci, M, xrow, qbuf, sx(0), lat.w, C, 1, M, smem, [](int m, int) { return m; }, xrow,
          [=](int m, int j, const float* acc, int row) {
            Vec<T> v = fold_vec<T, Q>(acc, lat, j, act, leaky, row >= 0);
            if (has_up && row >= 0) {
              const Vec<T> u = load_vec(up + static_cast<size_t>(row) * C + j);
#pragma unroll
              for (int e = 0; e < V; ++e) v.v[e] = Num<T>::add(v.v[e], u.v[e]);
            }
            store_vec(f0 + static_cast<size_t>(m) * C + j, v);
          },
          rank, CL);
    } else {
      // the input region into f0, zero outside the frame, its rows shared
      // out between the cluster's blocks
      const int chunks = C / V;
      for (int idx = rank * kThreads + threadIdx.x; idx < M * chunks; idx += CL * kThreads) {
        const int m = idx / chunks, c = (idx % chunks) * V;
        const int row = xrow(m);
        int4 val = make_int4(0, 0, 0, 0);
        if (row >= 0) val = *reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * C + c);
        *reinterpret_cast<int4*>(f0 + static_cast<size_t>(m) * C + c) = val;
      }
      sync_parts(CL);
    }
    if (p.has_merge) conv3x3(f0, C, p.merge, sx(1), C, f, C, 0, act, true, 1);

    const int halo = p.halo, TH = p.TH, TW = p.TW;
    // the tile proper: pixel i of TH x TW x gc -> region pixel, frame pixel
    auto central = [=](int i, int* m, int* row) {
      const int g = i / (TH * TW), q = i % (TH * TW);
      const int r = q / TW + halo, c = q % TW + halo;
      *m = g * PR + r * RW + c;
      const int y = y0 + r, xx = x0 + c;
      *row = (y < H && xx < W) ? ((b0 + g) * H + y) * W + xx : -1;
    };
    // f is complete here: the conv or copy that wrote it ended in the
    // cluster's barrier
    if (p.emit) {
      T* feat = static_cast<T*>(p.feat);
      const int chunks = C / V;
      for (int idx = rank * kThreads + threadIdx.x; idx < gc * TH * TW * chunks;
           idx += CL * kThreads) {
        int m, row;
        central(idx / chunks, &m, &row);
        if (row < 0) continue;
        const int c = (idx % chunks) * V;
        // rows another block of the cluster may have written: through L2
        const T* src = f + static_cast<size_t>(m) * C + c;
        store_vec(feat + static_cast<size_t>(row) * C + c, kCl ? load_vec_cg(src) : load_vec(src));
      }
    }

    // f is exact at depth d0; each conv is computed at the depth of what
    // reads it: c5_1 one deeper, c7_2 two, the three that feed the heads at
    // the tile proper (depth halo = d0 + 3)
    const int d0 = p.has_merge;
    conv3x3(f, C, p.conv[0], sx(s_ssh), C / 2, cat, C, 0, kRelu, false, halo);  // relu(c3)
    conv3x3(f, C, p.conv[1], sx(s_ssh + 1), C4, t51, C4, 0, act, true, d0 + 1);   // c5_1
    conv3x3(t51, C4, p.conv[2], sx(s_ssh + 2), C4, cat, C, C / 2, kRelu, false, halo);  // relu(c5)
    conv3x3(t51, C4, p.conv[3], sx(s_ssh + 3), C4, t72, C4, 0, act, true, d0 + 2);  // c7_2
    conv3x3(t72, C4, p.conv[4], sx(s_ssh + 4), C4, cat, C, C / 2 + C4, kRelu, false,
            halo);  // relu(c7)

    // the three heads over the tile proper, output channel fastest; each
    // output summed by one thread in k order
    const int n_out = p.hn[0] + p.hn[1] + p.hn[2];
    for (int idx = rank * kThreads + threadIdx.x; idx < gc * TH * TW * n_out;
         idx += CL * kThreads) {
      int m, row;
      central(idx / n_out, &m, &row);
      if (row < 0) continue;
      int o = idx % n_out, hd = 0;
      while (o >= p.hn[hd]) o -= p.hn[hd++];
      const int n = p.hn[hd];
      const T* w = static_cast<const T*>(p.hw[hd]);
      const T* src = cat + static_cast<size_t>(m) * C;
      float acc = 0.0f;
      for (int k = 0; k < C; k += V) {
        const Vec<T> s = kCl ? load_vec_cg(src + k) : load_vec(src + k);
#pragma unroll
        for (int e = 0; e < V; ++e)
          acc = fmaf(Num<T>::to_f32(s.v[e]), Num<T>::to_f32(w[(k + e) * n + o]), acc);
      }
      static_cast<T*>(p.out[hd])[static_cast<size_t>(row) * n + o] =
          Num<T>::add(Num<T>::from_f32(acc), static_cast<const T*>(p.hb[hd])[o]);
    }
    sync_parts(CL);  // the slab is reused by the next work item
  }
}

// ssh_kernel in clusters of `cluster` blocks (launch_clusters): with
// `clusters` and `blocks` non-null it reports what the card holds instead.
template <typename T, bool Q>
int launch(const SshP& p, int grid, int cluster, cudaStream_t stream, int* clusters = nullptr,
           int* blocks = nullptr) {
  constexpr size_t smem = conv_smem_bytes<T, Q, true, true>();
  return cluster > 1 ? launch_clusters(ssh_kernel<T, Q, true>, p, grid, cluster, smem, stream,
                                       clusters, blocks)
                     : launch_clusters(ssh_kernel<T, Q, false>, p, grid, cluster, smem, stream,
                                       clusters, blocks);
}

int ssh(const void* x, const void* up, const void* const* wptrs, const int* head_n,
        void* const* outs, void* scratch, long long scratch_bytes, int B, int H, int W, int Ci,
        int C, float leaky, int TH, int TW, int G, int grid, int cluster, int dtype,
        const float* act_s, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (dtype != 0 && dtype != 1) return bad;
  if (H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || G <= 0 || grid <= 0) return bad;
  // a portable cluster holds at most 8 blocks; the grid is whole clusters
  if (cluster < 1 || cluster > 8 || grid % cluster) return bad;
  const int vec = dtype == 0 ? 4 : 8;
  // int8 weights are copied 16 channels at a time
  const int align = act_s != nullptr ? 16 : vec;
  if (C % (4 * align) || Ci % align) return bad;
  SshP p{};
  p.x = x;
  p.up = up;
  p.lat = {wptrs[0], wptrs[1], wptrs[2]};
  p.merge = {wptrs[3], wptrs[4], wptrs[5]};
  for (int i = 0; i < 5; ++i) p.conv[i] = {wptrs[6 + 3 * i], wptrs[7 + 3 * i], wptrs[8 + 3 * i]};
  for (int i = 0; i < 3; ++i) {
    p.hw[i] = wptrs[21 + 2 * i];
    p.hb[i] = wptrs[22 + 2 * i];
    p.hn[i] = head_n[i];
    p.out[i] = outs[i];
    if (head_n[i] <= 0) return bad;
  }
  p.feat = outs[3];
  p.has_lat = p.lat.w != nullptr;
  p.has_merge = p.merge.w != nullptr;
  p.has_up = up != nullptr;
  p.emit = p.feat != nullptr;
  if (p.has_merge && !p.has_lat) return bad;
  if (!p.has_lat && (Ci != C || p.has_up)) return bad;
  p.act = leaky == 0.0f ? kRelu : kLeaky;
  p.leaky = leaky;
  p.scratch = scratch;
  p.act_s = act_s;
  p.B = B, p.H = H, p.W = W, p.Ci = Ci, p.C = C;
  p.TH = TH, p.TW = TW, p.G = G, p.CL = cluster;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles_x = (W + TW - 1) / TW;
  p.halo = p.has_merge ? 4 : 3;
  p.RH = TH + 2 * p.halo;
  p.RW = TW + 2 * p.halo;
  p.slab = static_cast<long long>(G) * p.RH * p.RW * (C * (p.has_merge ? 3 : 2) + C / 2);
  p.nwork = ((B + G - 1) / G) * p.tiles_y * p.tiles_x;
  // the int8 plane holds the widest conv input: the lateral's, or C channels
  p.qslab = act_s != nullptr ? static_cast<long long>(G) * p.RH * p.RW * (Ci > C ? Ci : C) : 0;
  if (scratch_bytes < (p.slab * (dtype == 0 ? 4 : 2) + p.qslab) * (grid / cluster)) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_s != nullptr)
    return dtype == 0 ? launch<float, true>(p, grid, cluster, s)
                      : launch<__nv_bfloat16, true>(p, grid, cluster, s);
  return dtype == 0 ? launch<float, false>(p, grid, cluster, s)
                    : launch<__nv_bfloat16, false>(p, grid, cluster, s);
}

}  // namespace

// x [B, H, W, Ci], up [B, H, W, C] or null, outs: loc, conf, landmarks
// [B, H, W, head_n[i]] and the feature [B, H, W, C] (null unless emitted); all
// NHWC contiguous, dtype 0 = float32, 1 = bfloat16. wptrs: (w, inv, shift) of
// the lateral [Ci, C], the merge [3, 3, C, C] (null triples where absent) and
// the five SSH convs, then (w [C, n], bias [n]) of the three heads: 27
// pointers. TH, TW, G, grid and cluster are the caller's plan: grid blocks
// in clusters of `cluster` (1 to 8, dividing grid), one work item a cluster
// at a time; scratch holds grid / cluster slabs. Launches on `stream`;
// returns a CUDA error code (0 = success), cudaErrorInvalidValue for what the
// kernel does not take, the launch's own error for a cluster the card
// refuses.
extern "C" int avcer_fused_ssh(const void* x, const void* up, const void* const* wptrs,
                               const int* head_n, void* const* outs, void* scratch,
                               long long scratch_bytes, int B, int H, int W, int Ci, int C,
                               float leaky, int TH, int TW, int G, int grid, int cluster,
                               int dtype, void* stream) {
  return ssh(x, up, wptrs, head_n, outs, scratch, scratch_bytes, B, H, W, Ci, C, leaky, TH, TW, G,
             grid, cluster, dtype, nullptr, stream);
}

// The int8 option: as above with the conv weights int8 and packed [taps, co,
// ci] (the lateral [1, C, Ci], the merge [9, C, C], the SSH convs [9, co,
// ci], tap 3 ky + kx), their inv (the merged multiply) and shift float32
// whatever `dtype`, the heads in `dtype`, and act_s [5 + the number of FPN
// convs] float32 on the device. C is a multiple of 64.
extern "C" int avcer_fused_ssh_q(const void* x, const void* up, const void* const* wptrs,
                                 const int* head_n, void* const* outs, void* scratch,
                                 long long scratch_bytes, int B, int H, int W, int Ci, int C,
                                 float leaky, int TH, int TW, int G, int grid, int cluster,
                                 int dtype, const float* act_s, void* stream) {
  if (act_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return ssh(x, up, wptrs, head_n, outs, scratch, scratch_bytes, B, H, W, Ci, C, leaky, TH, TW, G,
             grid, cluster, dtype, act_s, stream);
}

// What the card reports for ssh_kernel in clusters of `cluster` blocks
// (dtype as above; quant 1 for the int8 option, whose shared memory is
// block_gemm_tc_q's): the clusters it can hold at once
// (cudaOccupancyMaxActiveClusters) and the blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor). Launches nothing;
// returns a CUDA error code.
extern "C" int avcer_fused_ssh_occupancy(int dtype, int quant, int cluster, int* clusters,
                                         int* blocks) {
  if ((dtype != 0 && dtype != 1) || cluster < 1 || cluster > 8 || clusters == nullptr ||
      blocks == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  SshP p{};
  if (quant)
    return dtype == 0 ? launch<float, true>(p, cluster, cluster, nullptr, clusters, blocks)
                      : launch<__nv_bfloat16, true>(p, cluster, cluster, nullptr, clusters, blocks);
  return dtype == 0 ? launch<float, false>(p, cluster, cluster, nullptr, clusters, blocks)
                    : launch<__nv_bfloat16, false>(p, cluster, cluster, nullptr, clusters, blocks);
}
