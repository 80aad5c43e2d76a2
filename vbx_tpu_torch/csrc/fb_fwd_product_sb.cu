// Forward-only block-operator walk (K2) for the frame-sharded VB-HMM smoother.
//
// Replaces vbx_tpu/ops/fb_pallas.py:_fwd_product_kernel_sb, the Pallas TPU
// kernel that parallel/fb_blockwise.py launches for each shard's block
// transition operator. The shard's Tb frames are split into R segments of
// Ts = Tb / R frames. For each segment r, recording b and row i (a "lane"),
// the walk starts from the lane's own initial message finit[r, b, i, :]:
//
//   first frame of the segment:  a = w_0 * finit
//   every later frame t:         a = w_t * (lp * prev + col_b)
//   c = sum_s a;   if c > 1e-37: prev = a * (1 / c),  ls += log c
//                  else (an all-zero w frame): prev and ls stay unchanged
//
// and writes the final normalized message fhat[r, b, i, :] = prev and
// ls[r, b, i]. With finit's rows the rows of the identity (or of the
// incoming transition lp * I + col), row i of fhat is row i of the
// segment's operator product, up to the scale exp(ls).
//
// Arithmetic is float32 whatever the stream type (bfloat16 loads upcast),
// as in the TPU kernel; no fast math (the 1e-37 floor sits just above
// float32's normal range).
//
// Layout: w is [B, Tb, S] row-major, the E-step product's native layout,
// so segment r of lane b is Ts * S contiguous values. col is [B, S]; finit
// and fhat are [R, B, S, S] and ls is [R, B, S], all float32. The TPU kernel
// read an S-fold lane-replicated copy of w ([Ts, S, R*B*S]) to fill its
// 128-lane tiles; here the S rows of one (r, b) share each frame instead.
//
// Design. A row is a group of G = min(32, next power of two >= S) threads
// of one warp; each thread holds P = ceil(S / G) <= 4 speakers (s = lane,
// lane + G, ...) in registers, and c is a butterfly of G-wide warp shuffles
// (every thread of the group gets the same total). A block holds up to 256
// threads: one (r, b) and ceil(256 / G) of its rows; grid.y covers the
// rest of the rows. Blocks share nothing, so segments and recordings run in
// parallel, one walk per row.
//
// Bound: the walk must read w once (B * Tb * S values: 1.05 MB in float32
// at B=4, Tb=8192, S=8, ~0.3 us at 3.35 TB/s) and does ~5 float32
// operations per (lane, frame, speaker), below that. But each row is Ts
// dependent steps (a shuffle reduction, a reciprocal and a log per step),
// so the kernel is latency-bound far above the bytes bound. The design
// hides the load latency only: each step issues the load of the next
// frame's w before computing the current frame; R segments cut the chain
// to Ts steps. S <= 128 (vbx_tpu's cap).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpeakers = 128;
constexpr int kBlockThreads = 256;
constexpr float kTiny = 1e-37f;  // just above the float32 normal range

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over an aligned group of G lanes (G a power of two <= 32); every lane
// of the group gets the same total. All 32 lanes of the warp take part.
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename IO, int P>
__device__ __forceinline__ void load_frame(const IO* __restrict__ frame,
                                           int lane, int G, int S,
                                           float (&out)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int s = lane + G * k;
    out[k] = s < S ? to_f32(frame[s]) : 0.f;
  }
}

template <typename IO, int P>
__global__ void __launch_bounds__(kBlockThreads)
    fwd_product_kernel(const IO* __restrict__ w, const float* __restrict__ col,
                       const float* __restrict__ finit, float lp, int B,
                       int Tb, int Ts, int S, int G, int rows_per_block,
                       float* __restrict__ fhat, float* __restrict__ ls) {
  const int rb = blockIdx.x;  // r * B + b
  const int r = rb / B;
  const int b = rb - r * B;
  const int g = threadIdx.x / G;     // row group within the block
  const int lane = threadIdx.x - g * G;
  const int i = blockIdx.y * rows_per_block + g;  // row
  // threads past the last row still run the shuffles, on zeros
  const bool row_ok = g < rows_per_block && i < S;

  const IO* wl = w + (static_cast<size_t>(b) * Tb +
                      static_cast<size_t>(r) * Ts) * S;
  const size_t row_off = (static_cast<size_t>(rb) * S + (row_ok ? i : 0)) * S;

  float colr[P], carry[P], wcur[P], wnxt[P];
  load_frame<float, P>(col + static_cast<size_t>(b) * S, lane, G, S, colr);
  load_frame<float, P>(finit + row_off, lane, G, row_ok ? S : 0, carry);
  float lsum = 0.f;

  load_frame<IO, P>(wl, lane, G, S, wcur);
  for (int t = 0; t < Ts; ++t) {
    if (t + 1 < Ts)
      load_frame<IO, P>(wl + static_cast<size_t>(t + 1) * S, lane, G, S, wnxt);
    float a[P];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      a[k] = t == 0 ? wcur[k] * carry[k] : wcur[k] * (lp * carry[k] + colr[k]);
      part += a[k];
    }
    const float c = group_sum(part, G);
    if (c > kTiny) {
      const float rc = 1.f / c;
#pragma unroll
      for (int k = 0; k < P; ++k) carry[k] = a[k] * rc;
      lsum += logf(c);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) wcur[k] = wnxt[k];
  }

  if (row_ok) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int s = lane + G * k;
      if (s < S) fhat[row_off + s] = carry[k];
    }
    if (lane == 0) ls[static_cast<size_t>(rb) * S + i] = lsum;
  }
}

template <typename IO>
void launch(const void* w, const void* col, const void* finit, float lp,
            int R, int B, int Tb, int S, void* fhat, void* ls,
            cudaStream_t stream) {
  int G = 1;
  while (G < S && G < 32) G <<= 1;
  const int P = (S + G - 1) / G;
  const int rows_per_block = S < kBlockThreads / G ? S : kBlockThreads / G;
  const int threads = (rows_per_block * G + 31) / 32 * 32;
  const dim3 grid(R * B, (S + rows_per_block - 1) / rows_per_block);
  const auto* wp = static_cast<const IO*>(w);
  const auto* cp = static_cast<const float*>(col);
  const auto* fp = static_cast<const float*>(finit);
  auto* fo = static_cast<float*>(fhat);
  auto* lo = static_cast<float*>(ls);
  const int Ts = Tb / R;
  if (P == 1)
    fwd_product_kernel<IO, 1><<<grid, threads, 0, stream>>>(
        wp, cp, fp, lp, B, Tb, Ts, S, G, rows_per_block, fo, lo);
  else if (P == 2)
    fwd_product_kernel<IO, 2><<<grid, threads, 0, stream>>>(
        wp, cp, fp, lp, B, Tb, Ts, S, G, rows_per_block, fo, lo);
  else
    fwd_product_kernel<IO, 4><<<grid, threads, 0, stream>>>(
        wp, cp, fp, lp, B, Tb, Ts, S, G, rows_per_block, fo, lo);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronize, allocates nothing; returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int fb_fwd_product_sb_launch(const void* w, const void* col,
                                        const void* finit, float lp, int R,
                                        int B, int Tb, int S, int io_bf16,
                                        void* fhat, void* ls, void* stream) {
  if (R < 1 || B < 1 || Tb < 1 || S < 1 || S > kMaxSpeakers || Tb % R != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    launch<__nv_bfloat16>(w, col, finit, lp, R, B, Tb, S, fhat, ls, st);
  else
    launch<float>(w, col, finit, lp, R, B, Tb, S, fhat, ls, st);
  return static_cast<int>(cudaGetLastError());
}
