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
// as in the TPU kernel.
//
// Layout: w is [B, Tb, S] row-major, the E-step product's native layout,
// so segment r of lane b is Ts * S contiguous values. col is [B, S]; finit
// and fhat are [R, B, S, S] and ls is [R, B, S], all float32. The TPU kernel
// read an S-fold lane-replicated copy of w ([Ts, S, R*B*S]) to fill its
// 128-lane tiles; here the S rows of one (r, b) share each frame instead.
//
// Bound. The walk must read w once (B * Tb * S values: 1.05 MB in float32
// at B=4, Tb=8192, S=8, ~0.3 us at 3.35 TB/s) and does ~5 float32
// operations per (lane, frame, speaker), below that. But each row is Ts
// dependent steps and all rows run at once, so the time is Ts x the latency
// of one step. A first design (groups of min(32, S) threads, next frame's w
// loaded into registers one step ahead, IEEE reciprocal and logf on every
// step) took 800-935 cycles a step on an H100 at 1980 MHz; this design
// takes ~175 (scripts/torch_fb_fused_tuning.py times it and its variants):
//
// - A block is one (r, b) and up to 256 / G of its rows; a row is a group
//   of G threads x P speakers sized to S (fb_step.cuh: pick_group, S=8: two
//   threads of four speakers, one shuffle round). Rows past the last run
//   the shuffles on zeros.
// - The segment's frames reach the step through a shared-memory ring,
//   staged once per block, one asynchronous bulk copy a chunk, two chunks
//   ahead (fb_step.cuh: Stager, block-wide: all rows read the same frames,
//   so a chunk is entered behind one __syncthreads).
// - The reciprocal is the hardware approximation (c > 1e-37 is a normal
//   number; fb_step.cuh: norm_recip), and the step has no branch: a skipped
//   frame is a select, the first frame's rule a loop-carried prior.
// - The logarithm is off the step: c is split into exponent and mantissa
//   (two integer operations), the exponents add up as an integer, the
//   mantissas (in [1, 2)) multiply up, and logf runs at the end of a chunk
//   once kLogEvery frames have gone by, on a product below 2^96. Those logs
//   add up in float64 (one addition per kLogEvery frames), because
//   exponents * ln 2 and the mantissas' logs nearly cancel where c is just
//   below 1: ls = float32(exponents * ln 2 + the sum of the logs).
//
// S <= 128 (vbx_tpu's cap).

#include "fb_step.cuh"

namespace {

using namespace fb_step;

constexpr int kMaxSpeakers = 128;
constexpr int kBlockThreads = 256;
constexpr int kLogEvery = 32;  // least frames per logf of the mantissa product
constexpr int kMaxLogChunk = 6;  // at most 64 frames a staged chunk

template <typename IO, int G, int P>
__global__ void __launch_bounds__(kBlockThreads)
    fwd_product_kernel(const IO* __restrict__ w, const float* __restrict__ col,
                       const float* __restrict__ finit, float lp, int B,
                       int Tb, int Ts, int S, int rows_per_block, int log_f,
                       int ring_stride, float* __restrict__ fhat,
                       float* __restrict__ ls) {
  extern __shared__ __align__(16) char smem[];
  const int rb = blockIdx.x;  // r * B + b
  const int r = rb / B;
  const int b = rb - r * B;
  const int grp = threadIdx.x / G;  // row within the block
  const int g = threadIdx.x % G;    // thread within the row's group
  const int i = blockIdx.y * rows_per_block + grp;  // row
  // threads past the last row still run the shuffles, on zeros
  const bool row_ok = grp < rows_per_block && i < S;

  const size_t row_off = (static_cast<size_t>(rb) * S + (row_ok ? i : 0)) * S;

  // x is the prior of the frame to come: finit before the segment's first
  // frame, lp * prev + col after it
  float colr[P], carry[P], x[P], wcur[P], wnxt[P];
  read_frame<float, G, P>(col + static_cast<size_t>(b) * S, g, S, colr);
  read_frame<float, G, P>(finit + row_off, g, row_ok ? S : 0, carry);
#pragma unroll
  for (int k = 0; k < P; ++k) x[k] = carry[k];

  Stager<IO, true> st;
  st.init(w, static_cast<size_t>(B) * Tb * S,
          w + (static_cast<size_t>(b) * Tb + static_cast<size_t>(r) * Ts) * S,
          Ts, S, log_f, true, smem, ring_stride, smem + kStages * ring_stride,
          threadIdx.x, blockDim.x);
  st.begin();

  int esum = 0;        // sum of the biased exponents of the frames' c
  float mprod = 1.f;   // product of their mantissas since the last logf
  double mlog = 0.0;   // sum of the logs of the earlier products
  int since = 0;       // frames since the last logf

  for (int q = 0; q < st.n_chunks; ++q) {
    st.enter(q);
    const int n = st.chunk_hi(q) - st.chunk_lo(q);
    const IO* wp = st.chunk_data(q);
    read_frame<IO, G, P>(wp, g, S, wcur);
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      wp += S;  // past the chunk's end it reads the ring's padding, unused
      read_frame<IO, G, P>(wp, g, S, wnxt);
      float a[P];
#pragma unroll
      for (int k = 0; k < P; ++k) a[k] = wcur[k] * x[k];
      const float c = group_sum<G>(tree_sum<P>(a));
      const bool live = c > kTiny;
      const float rc = norm_recip(c, false);
      // c = m * 2^(e - 127) with m in [1, 2)
      const int bits = __float_as_int(c);
      esum += live ? bits >> 23 : 127;
      mprod *= live ? __int_as_float((bits & 0x007fffff) | 0x3f800000) : 1.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        carry[k] = live ? a[k] * rc : carry[k];
        x[k] = fmaf(lp, carry[k], colr[k]);
        wcur[k] = wnxt[k];
      }
    }
    since += n;
    if (since >= kLogEvery) {
      mlog += logf(mprod);
      mprod = 1.f;
      since = 0;
    }
  }

  if (row_ok) {
    write_frame<float, G, P>(fhat + row_off, g, S, carry);
    if (g == 0)
      ls[static_cast<size_t>(rb) * S + i] = static_cast<float>(
          (esum - 127 * Ts) * 0.693147180559945309 + mlog + logf(mprod));
  }
}

template <typename IO, int G, int P>
int launch_group(const void* w, const void* col, const void* finit, float lp,
                 int R, int B, int Tb, int S, void* fhat, void* ls,
                 cudaStream_t stream) {
  const int rows_per_block = S < kBlockThreads / G ? S : kBlockThreads / G;
  const int threads = (rows_per_block * G + 31) / 32 * 32;
  const dim3 grid(R * B, (S + rows_per_block - 1) / rows_per_block);
  const int frame_bytes = S * static_cast<int>(sizeof(IO));
  // at most kMaxLogChunk: the mantissa product spans kLogEvery - 1 frames
  // and one chunk between two logs
  const int picked = pick_log_chunk(frame_bytes);
  const int log_f = picked < kMaxLogChunk ? picked : kMaxLogChunk;
  const int stride = ring_stride_bytes(frame_bytes << log_f, frame_bytes, 32);
  fwd_product_kernel<IO, G, P>
      <<<grid, threads, kStages * (stride + 8), stream>>>(
      static_cast<const IO*>(w), static_cast<const float*>(col),
      static_cast<const float*>(finit), lp, B, Tb, Tb / R, S, rows_per_block,
      log_f, stride, static_cast<float*>(fhat), static_cast<float*>(ls));
  return static_cast<int>(cudaGetLastError());
}

template <typename IO>
int launch(const void* w, const void* col, const void* finit, float lp,
           int R, int B, int Tb, int S, void* fhat, void* ls,
           cudaStream_t stream) {
  int G, P;
  pick_group(S, &G, &P);
#define FB_GROUP(GG, PP)                                                     \
  if (G == GG && P == PP)                                                    \
    return launch_group<IO, GG, PP>(w, col, finit, lp, R, B, Tb, S, fhat,    \
                                    ls, stream);
  FB_GROUP(1, 4)
  FB_GROUP(2, 4)
  FB_GROUP(4, 4)
  FB_GROUP(8, 4)
  FB_GROUP(16, 4)
  FB_GROUP(32, 4)
#undef FB_GROUP
  return static_cast<int>(cudaErrorInvalidValue);
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
    return launch<__nv_bfloat16>(w, col, finit, lp, R, B, Tb, S, fhat, ls, st);
  return launch<float>(w, col, finit, lp, R, B, Tb, S, fhat, ls, st);
}
