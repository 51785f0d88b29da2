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
// Design: as fused_resnet.cu. A work item is a tile of the frame with a halo
// of 3 pixels (4 with the merge conv); each conv is conv_tile.cuh's
// block-wide product over the whole haloed region, so the lateral streams
// its up to 2048 input channels through shared memory in slabs of 32 and
// only the 256-channel result is kept. f, c5_1, c7_2 and the ReLU'd
// (c3 | c5 | c7) live in the thread block's slab of device-memory scratch
// (allocated by the wrapper, reused work item after work item, L2-resident);
// the heads read that slab and write the narrow outputs, output channel
// fastest, so a warp's stores are contiguous. The three scales are three
// launches in sequence on one stream: scale 2 reads what scale 3 emitted.
//
// The int8 option (avcer_fused_ssh_q; the TPU kernel's act_s): the lateral,
// the merge and the five SSH convs multiply int8 weights with activations
// quantised by their static scales (once per conv, into an int8 plane of the
// thread block's scratch) and sum in int32 (conv_tile.cuh), the
// leaky ReLU acts on the value already rounded to the compute type, and the
// three heads stay exact f32 sums over the ReLU'd segments. The scales come
// in the TPU kernel's order: lateral, merge, then the five SSH convs.

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
  long long slab;
  long long qslab;  // int8 option: bytes of the quantised plane per thread block
  int B, H, W, Ci, C;
  int has_lat, has_merge, has_up, emit, act;
  float leaky;
  int TH, TW, tiles_y, tiles_x, G, halo, RH, RW, nwork;
};

template <typename T, bool Q>
__global__ void __launch_bounds__(kThreads, 2) ssh_kernel(const SshP p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int V = Tile<T>::kVec;
  const T* x = static_cast<const T*>(p.x);
  const T* up = static_cast<const T*>(p.up);
  const int RH = p.RH, RW = p.RW, PR = RH * RW;
  const int H = p.H, W = p.W, C = p.C, Ci = p.Ci, C4 = p.C / 4;
  const int act = p.act;
  const T leaky = Num<T>::from_f32(p.leaky);
  const T zero = Num<T>::from_f32(0.0f);
  const size_t region = static_cast<size_t>(p.G) * PR;
  T* f0 = static_cast<T*>(p.scratch) + static_cast<size_t>(blockIdx.x) * p.slab;
  T* f = p.has_merge ? f0 + region * C : f0;
  T* t51 = f + region * C;
  T* t72 = t51 + region * C4;
  T* cat = t72 + region * C4;  // relu(c3 | c5 | c7), C channels
  // the int8 planes follow the slabs of all thread blocks
  signed char* qbuf = reinterpret_cast<signed char*>(static_cast<T*>(p.scratch) +
                                                     static_cast<size_t>(gridDim.x) * p.slab) +
                      static_cast<size_t>(blockIdx.x) * p.qslab;
  auto same = [](int r) { return r; };
  const int tiles = p.tiles_y * p.tiles_x;
  // the static scale of conv `i` in act_s order
  auto sx = [&](int i) -> float {
    if constexpr (Q) return __ldg(p.act_s + i);
    return 0.0f;
  };
  const int s_ssh = p.has_lat + p.has_merge;  // index of conv3X3's scale

  for (int work = blockIdx.x; work < p.nwork; work += gridDim.x) {
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
    auto tap3 = [=](int m, int tap) -> int {
      const int q = m % PR;
      const int r = q / RW + tap / 3 - 1, c = q % RW + tap % 3 - 1;
      if (r < 0 || r >= RH || c < 0 || c >= RW) return -1;
      return m + (tap / 3 - 1) * RW + tap % 3 - 1;
    };
    // a 3x3 ConvBN from `src` to `dst` (channel offset `off` of rows of `ldd`);
    // `a` its activation; `mask` zeroes the result outside the frame
    auto conv3x3 = [&](const T* src, int k, const ConvW& cw, float scale, int n, T* dst, int ldd,
                       int off, int a, bool mask) {
      conv_gemm<T, Q>(
          src, k, k, M, same, qbuf, scale, cw.w, n, 9, M, smem, tap3,
          [=](int m) { return static_cast<int>(!mask || xrow(m) >= 0); },
          [=](int m, int j, const float* acc, int ok) {
            store_vec(dst + static_cast<size_t>(m) * ldd + off + j,
                      fold_vec<T, Q>(acc, cw, j, a, leaky, ok));
          });
    };

    if (p.has_lat) {
      const ConvW lat = p.lat;
      const bool has_up = p.has_up;
      conv_gemm<T, Q>(
          x, Ci, Ci, M, xrow, qbuf, sx(0), lat.w, C, 1, M, smem, [](int m, int) { return m; }, xrow,
          [=](int m, int j, const float* acc, int row) {
            Vec<T> v = fold_vec<T, Q>(acc, lat, j, act, leaky, row >= 0);
            if (has_up && row >= 0) {
              const Vec<T> u = load_vec(up + static_cast<size_t>(row) * C + j);
#pragma unroll
              for (int e = 0; e < V; ++e) v.v[e] = Num<T>::add(v.v[e], u.v[e]);
            }
            store_vec(f0 + static_cast<size_t>(m) * C + j, v);
          });
    } else {
      const int chunks = C / V;
      for (int idx = threadIdx.x; idx < M * chunks; idx += kThreads) {
        const int m = idx / chunks, c = (idx % chunks) * V;
        const int row = xrow(m);
        int4 val = make_int4(0, 0, 0, 0);
        if (row >= 0) val = *reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * C + c);
        *reinterpret_cast<int4*>(f0 + static_cast<size_t>(m) * C + c) = val;
      }
      __syncthreads();
    }
    if (p.has_merge) conv3x3(f0, C, p.merge, sx(1), C, f, C, 0, act, true);

    const int halo = p.halo, TH = p.TH, TW = p.TW;
    // the tile proper: pixel i of TH x TW x gc -> region pixel, frame pixel
    auto central = [=](int i, int* m, int* row) {
      const int g = i / (TH * TW), q = i % (TH * TW);
      const int r = q / TW + halo, c = q % TW + halo;
      *m = g * PR + r * RW + c;
      const int y = y0 + r, xx = x0 + c;
      *row = (y < H && xx < W) ? ((b0 + g) * H + y) * W + xx : -1;
    };
    if (p.emit) {
      T* feat = static_cast<T*>(p.feat);
      const int chunks = C / V;
      for (int idx = threadIdx.x; idx < gc * TH * TW * chunks; idx += kThreads) {
        int m, row;
        central(idx / chunks, &m, &row);
        if (row < 0) continue;
        const int c = (idx % chunks) * V;
        *reinterpret_cast<int4*>(feat + static_cast<size_t>(row) * C + c) =
            *reinterpret_cast<const int4*>(f + static_cast<size_t>(m) * C + c);
      }
    }

    conv3x3(f, C, p.conv[0], sx(s_ssh), C / 2, cat, C, 0, kRelu, false);             // relu(c3)
    conv3x3(f, C, p.conv[1], sx(s_ssh + 1), C4, t51, C4, 0, act, true);              // c5_1
    conv3x3(t51, C4, p.conv[2], sx(s_ssh + 2), C4, cat, C, C / 2, kRelu, false);     // relu(c5)
    conv3x3(t51, C4, p.conv[3], sx(s_ssh + 3), C4, t72, C4, 0, act, true);           // c7_2
    conv3x3(t72, C4, p.conv[4], sx(s_ssh + 4), C4, cat, C, C / 2 + C4, kRelu, false);  // relu(c7)

    // the three heads over the tile proper, output channel fastest
    const int n_out = p.hn[0] + p.hn[1] + p.hn[2];
    for (int idx = threadIdx.x; idx < gc * TH * TW * n_out; idx += kThreads) {
      int m, row;
      central(idx / n_out, &m, &row);
      if (row < 0) continue;
      int o = idx % n_out, hd = 0;
      while (o >= p.hn[hd]) o -= p.hn[hd++];
      const int n = p.hn[hd];
      const T* w = static_cast<const T*>(p.hw[hd]);
      const T* src = cat + static_cast<size_t>(m) * C;
      float acc = 0.0f;
      for (int k = 0; k < C; ++k)
        acc = fmaf(Num<T>::to_f32(src[k]), Num<T>::to_f32(w[k * n + o]), acc);
      static_cast<T*>(p.out[hd])[static_cast<size_t>(row) * n + o] =
          Num<T>::add(Num<T>::from_f32(acc), static_cast<const T*>(p.hb[hd])[o]);
    }
    __syncthreads();  // the slab is reused by the next work item
  }
}

template <typename T, bool Q>
int launch(const SshP& p, int grid, cudaStream_t stream) {
  const int smem = static_cast<int>(Tile<OpOf<T, Q>>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(ssh_kernel<T, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssh_kernel<T, Q><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int ssh(const void* x, const void* up, const void* const* wptrs, const int* head_n,
        void* const* outs, void* scratch, long long scratch_bytes, int B, int H, int W, int Ci,
        int C, float leaky, int TH, int TW, int G, int grid, int dtype, const float* act_s,
        void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  if (dtype != 0 && dtype != 1) return bad;
  if (H <= 0 || W <= 0 || TH <= 0 || TW <= 0 || G <= 0 || grid <= 0) return bad;
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
  p.TH = TH, p.TW = TW, p.G = G;
  p.tiles_y = (H + TH - 1) / TH;
  p.tiles_x = (W + TW - 1) / TW;
  p.halo = p.has_merge ? 4 : 3;
  p.RH = TH + 2 * p.halo;
  p.RW = TW + 2 * p.halo;
  p.slab = static_cast<long long>(G) * p.RH * p.RW * (C * (p.has_merge ? 3 : 2) + C / 2);
  p.nwork = ((B + G - 1) / G) * p.tiles_y * p.tiles_x;
  // the int8 plane holds the widest conv input: the lateral's, or C channels
  p.qslab = act_s != nullptr ? static_cast<long long>(G) * p.RH * p.RW * (Ci > C ? Ci : C) : 0;
  if (scratch_bytes < (p.slab * (dtype == 0 ? 4 : 2) + p.qslab) * grid) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act_s != nullptr)
    return dtype == 0 ? launch<float, true>(p, grid, s) : launch<__nv_bfloat16, true>(p, grid, s);
  return dtype == 0 ? launch<float, false>(p, grid, s) : launch<__nv_bfloat16, false>(p, grid, s);
}

}  // namespace

// x [B, H, W, Ci], up [B, H, W, C] or null, outs: loc, conf, landmarks
// [B, H, W, head_n[i]] and the feature [B, H, W, C] (null unless emitted); all
// NHWC contiguous, dtype 0 = float32, 1 = bfloat16. wptrs: (w, inv, shift) of
// the lateral [Ci, C], the merge [3, 3, C, C] (null triples where absent) and
// the five SSH convs, then (w [C, n], bias [n]) of the three heads: 27
// pointers. TH, TW, G and grid are the caller's plan; scratch holds grid
// slabs. Launches on `stream`; returns a CUDA error code (0 = success).
extern "C" int avcer_fused_ssh(const void* x, const void* up, const void* const* wptrs,
                               const int* head_n, void* const* outs, void* scratch,
                               long long scratch_bytes, int B, int H, int W, int Ci, int C,
                               float leaky, int TH, int TW, int G, int grid, int dtype,
                               void* stream) {
  return ssh(x, up, wptrs, head_n, outs, scratch, scratch_bytes, B, H, W, Ci, C, leaky, TH, TW, G,
             grid, dtype, nullptr, stream);
}

// The int8 option: as above with the conv weights int8, their inv (the merged
// multiply) and shift float32 whatever `dtype`, the heads in `dtype`, and
// act_s [5 + the number of FPN convs] float32 on the device. C is a multiple
// of 64.
extern "C" int avcer_fused_ssh_q(const void* x, const void* up, const void* const* wptrs,
                                 const int* head_n, void* const* outs, void* scratch,
                                 long long scratch_bytes, int B, int H, int W, int Ci, int C,
                                 float leaky, int TH, int TW, int G, int grid, int dtype,
                                 const float* act_s, void* stream) {
  if (act_s == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return ssh(x, up, wptrs, head_n, outs, scratch, scratch_bytes, B, H, W, Ci, C, leaky, TH, TW, G,
             grid, dtype, act_s, stream);
}
