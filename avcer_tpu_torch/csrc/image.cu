// I420 -> BGR rebuild of the detect stage's wire format.
//
// Replaces no Pallas kernel: the JAX package computes this function in XLA
// inside its detect program (avcer_tpu/ops/image.py i420_to_bgr_device). The
// port's dispatch rule sends a CUDA tensor to a kernel, and the plain
// PyTorch version (avcer_tpu_torch/ops/image.py i420_to_bgr_plain) would cost
// a dozen launches over f32 temporaries of 30-90 MB a batch.
//
// The function: per pixel, yb = 1.164 (y - 16); with the quad's chroma
// u' = u - 128 and v' = v - 128, b = yb + 2.018 u', g = yb - 0.391 u' -
// 0.813 v', r = yb + 1.596 v'; each rounded half to even, clamped to
// [0, 255] and stored as uint8, pixel-interleaved BGR. The chroma planes are
// packed flat after the Y plane (U, then V, each (H/2)(W/2) bytes), so U can
// end in the middle of a row: they are indexed flat.
//
// What bounds it on the H100: bytes. It reads 1.5 bytes a pixel and writes
// 3, some ten f32 operations a pixel: at [32, 360, 640] 33 MB, 9.9 us at
// 3.35 TB/s, against 0.07 us of the f32 rate.
//
// Design: one thread a 2 x 2 luma quad, which shares one (U, V) pair: two
// 2-byte loads of Y (one a row), one byte each of U and V, 12 bytes written
// as six 2-byte stores. Neighbouring threads take neighbouring quads, so a
// warp's loads and stores are contiguous runs of each row.
//
// The result must equal the plain version bit for bit: every operation is
// one f32 rounding in the plain version's order, rintf rounds half to even,
// and the file is compiled with --fmad=false (avcer_tpu_torch/_build.py) so
// that no multiply and add contract into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t to_u8(float x) {
  return static_cast<uint8_t>(fminf(fmaxf(rintf(x), 0.0f), 255.0f));
}

__device__ __forceinline__ void pixel(float y, float u, float v, uint8_t* bgr) {
  const float yb = 1.164f * (y - 16.0f);
  bgr[0] = to_u8(yb + 2.018f * u);
  bgr[1] = to_u8((yb - 0.391f * u) - 0.813f * v);
  bgr[2] = to_u8(yb + 1.596f * v);
}

__global__ void __launch_bounds__(kThreads) i420_to_bgr_kernel(
    const uint8_t* __restrict__ wire, uint8_t* __restrict__ out, int b, int h, int w) {
  const int qw = w / 2;
  const long long quads = static_cast<long long>(h / 2) * qw;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= quads * b) return;
  const long long n = t / quads;
  const long long q = t - n * quads;
  const int qy = static_cast<int>(q / qw);
  const int qx = static_cast<int>(q - static_cast<long long>(qy) * qw);
  const uint8_t* frame = wire + n * (static_cast<long long>(h) * 3 / 2) * w;
  const uint8_t* chroma = frame + static_cast<long long>(h) * w;
  const float u = static_cast<float>(chroma[q]) - 128.0f;
  const float v = static_cast<float>(chroma[quads + q]) - 128.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const long long row = 2 * qy + dy;
    const uchar2 y = *reinterpret_cast<const uchar2*>(frame + row * w + 2 * qx);
    uint8_t px[6];
    pixel(static_cast<float>(y.x), u, v, px);
    pixel(static_cast<float>(y.y), u, v, px + 3);
    // 6 bytes at a multiple of 6: 2-byte aligned
    uchar2* dst = reinterpret_cast<uchar2*>(out + ((n * h + row) * w + 2 * qx) * 3);
    dst[0] = make_uchar2(px[0], px[1]);
    dst[1] = make_uchar2(px[2], px[3]);
    dst[2] = make_uchar2(px[4], px[5]);
  }
}

}  // namespace

// wire: [b, h * 3 / 2, w] uint8 I420; out: [b, h, w, 3] uint8 BGR; h and w
// even. Returns the CUDA error of the launch (0 on success).
extern "C" int avcer_i420_to_bgr(const void* wire, void* out, int b, int h, int w,
                                 void* stream) {
  const long long threads = static_cast<long long>(b) * (h / 2) * (w / 2);
  if (threads == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  i420_to_bgr_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wire), static_cast<uint8_t*>(out), b, h, w);
  return static_cast<int>(cudaGetLastError());
}
