// Scaled forward-backward recursions in the time-major [T, B, S] layout:
// the fused bidirectional walk and the two-pass forward and backward walks.
//
// Replaces three Pallas TPU kernels of vbx_tpu/ops/fb_pallas.py, all reached
// through fb_scan_pallas, the general [T, B, S] API:
//   fb_scan_fused_kernel  <- _fused_kernel  (both recursions in one launch)
//   fb_scan_fwd_kernel    <- _fwd_kernel    (forward pass: ahat and c_t)
//   fb_scan_bwd_kernel    <- _bwd_kernel    (backward pass: bhat)
// For each recording lane b, in float32:
//
//   forward:  a_t = w_t * (lp * ahat_{t-1} + col),  a_0 = w_0 * pinit
//             c_t = max(sum_s a_t, 1e-37),          ahat_t = a_t / c_t
//   backward: u   = w_{t+1} * bhat_{t+1}
//             b_t = lp * u + sum_s(col * u)
//             bhat_t = b_t / max(sum_s b_t, 1e-37), bhat_{T-1} = 1 / S
//
// The fused kernel writes ahat and bhat only (its wrapper rebuilds c_t from
// ahat in one elementwise pass, as the TPU wrapper does); the forward kernel
// also writes c_t as cfw [T, B].
//
// Layout: w, ahat and bhat are [T, B, S] row-major: one frame of one lane is
// S contiguous floats, and consecutive frames of a lane are B * S floats
// apart. col and pinit are [B, S]. The TPU kernels padded S to 128 lanes and
// B to 8/16/32 sublanes, cut T into chunks with the carry in scratch memory,
// read a one-frame-shifted copy of w in the backward pass and wrote c_t
// broadcast over 128 lanes; none of that is work the function needs, and none
// of it is here: the backward chain reads w[t+1] directly, S and B are not
// padded, and c_t is one float per (frame, lane). bhat therefore differs
// from the TPU kernels' by a per-frame scale only, which every consumer
// divides out.
//
// Bound: bytes. The fused walk reads w once and writes ahat and bhat once
// (at T=1025, B=256, S=31 about 98 MB, ~29 us at 3.35 TB/s); but it is T
// dependent steps per lane, every lane's chain runs at once, and so its time
// is T x the latency of one step, far above that bound.
//
// K3, K4 and K5 (fb_scan_fused_kernel, fb_scan_fwd_kernel,
// fb_scan_bwd_kernel) are built like K1's narrow form (fb_fused_sb.cu,
// fb_step.cuh), which does the same walks in the [B, T, S] layout, and K4
// is K3's forward chain with one more store:
//
// - A lane's S speakers are held by a group of G threads, P speakers each
//   (fb_step.cuh: pick_group, from S alone, so a lane's result does not
//   depend on its batch); a warp holds 32 / G consecutive lanes b0 ..
//   b0 + 32/G - 1, whose frame t is one row of (32/G) * S contiguous floats
//   at (t * B + b0) * S. Lanes past the batch's end repeat its last lane
//   and store nothing. Blocks are one warp; in K3 blockIdx.y 0 runs the
//   forward chains and 1 the backward chains, K4 runs forward chains only.
// - w reaches the step through a ring of kStages chunks of rows in shared
//   memory, one bulk copy a row, counted by the buffer's mbarrier
//   (fb_step.cuh: RowStager). The rows of a chunk land one fixed stride
//   apart (congruent to the frame stride modulo 16, so no per-row offset is
//   kept), and the step reads the next frame one stride ahead through a
//   moving pointer; past a chunk's end it reads the buffer's padding.
// - The step has no branch but the reciprocal's rare one: the forward
//   chain carries its prior x (pinit before frame 0) and the chunk loop
//   around the frame loop replaces any test of t.
// - One butterfly a backward step: sum_s b_t = lp * sum(u) + S * sum(col u)
//   (every one of the S speakers, absent ones too, adds sum(col u)), so the
//   two sums ride the same shuffles.
// - The normalizing reciprocal is the hardware approximation, the IEEE
//   division only for sums at the floor and above 1e30
//   (fb_step.cuh: norm_recip).
// - K4's c_t is the floored sum max(sum_s a_t, 1e-37), stored by the first
//   thread of each group whose lane belongs to the batch, through a pointer
//   that moves B floats a frame: a predicated store, no branch. A warp's
//   lanes are consecutive, so its stores of one frame are one contiguous
//   run of 32 / G floats. K3 and K4 run the same forward body, so their
//   ahat agree bit for bit.
//
// On an H100 at 1980 MHz (T=1025, B=256, S=31) K3 and K5 take ~320 cycles a
// step and K4 ~330 (its cfw store ~20) where K1 takes 261; the difference
// is issuing the rows' bulk copies, ~50 cycles a row (one thread issuing
// a chunk's rows, or one mbarrier arrival a chunk in place of one a row,
// is no better).
// scripts/torch_fb_scan_tuning.py times the three kernels and their
// variants.

#include "fb_step.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpeakers = 128;  // the [T, B, S] API's cap

namespace rows {

using namespace fb_step;

// Where a thread of a one-warp block stands: the lane it computes (b), its
// place in the lane's group (g), its lane's offset in the staged row (rd,
// floats) and how many speakers it may store (S, or 0 past the batch).
struct Lane {
  int b, g, rd, s_store;
};

// Sets up the warp's ring over rows of w and says where this thread stands.
template <int G>
__device__ __forceinline__ Lane setup(RowStager<float>& st,
                                      const float* __restrict__ w, int T,
                                      int B, int S, int log_f, int stride,
                                      int buf_bytes, bool forward,
                                      char* smem) {
  constexpr int kLanes = 32 / G;
  const int grp = threadIdx.x / G;
  const int b0 = blockIdx.x * kLanes;
  const int nl = min(kLanes, B - b0);  // lanes of the batch in this warp
  const int i = min(grp, nl - 1);      // lanes past B repeat lane B - 1
  st.init(w, static_cast<size_t>(T) * B * S, w + static_cast<size_t>(b0) * S,
          static_cast<size_t>(B) * S, nl * S, T, log_f, forward, smem, stride,
          buf_bytes, smem + kStages * buf_bytes, threadIdx.x);
  return Lane{b0 + i, static_cast<int>(threadIdx.x) % G, i * S,
              grp < nl ? S : 0};
}

// Forward chain of lane l.b: frames 0 .. T-1. x is the prior of the frame
// to come, lp * ahat_{t-1} + col, and pinit before frame 0. WITH_C (K4)
// also stores c_t = max(sum_s a_t, 1e-37) to cfw[t * B + l.b]; without it
// cfw is not read.
template <int G, int P, bool WITH_C>
__device__ __forceinline__ void forward_rows(RowStager<float>& st,
                                             const float* __restrict__ col,
                                             const float* __restrict__ pinit,
                                             float lp, int B, int S,
                                             const Lane& l,
                                             float* __restrict__ ahat,
                                             float* __restrict__ cfw) {
  const size_t step = static_cast<size_t>(B) * S;  // floats between frames
  const int cs = st.stride / 4;                    // floats between rows
  // one thread a lane of the batch stores its c_t
  const bool c_store = WITH_C && l.g == 0 && l.s_store != 0;
  float colr[P], x[P], wcur[P], wnxt[P];
  read_frame<float, G, P>(col + static_cast<size_t>(l.b) * S, l.g, S, colr);
  read_frame<float, G, P>(pinit + static_cast<size_t>(l.b) * S, l.g, S, x);
  st.begin();
  for (int q = 0; q < st.n_chunks; ++q) {
    st.enter(q);
    const int t0 = st.chunk_lo(q), t1 = st.chunk_hi(q);
    const float* wp = st.chunk_data(q) + l.rd;
    float* ap = ahat + static_cast<size_t>(t0) * step +
                static_cast<size_t>(l.b) * S;
    float* cp = WITH_C ? cfw + static_cast<size_t>(t0) * B + l.b : nullptr;
    read_frame<float, G, P>(wp, l.g, S, wcur);
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      wp += cs;  // past the chunk's last row: the buffer's padding, unused
      read_frame<float, G, P>(wp, l.g, S, wnxt);
      float a[P], carry[P];
#pragma unroll
      for (int k = 0; k < P; ++k) a[k] = wcur[k] * x[k];
      const float c_raw = group_sum<G>(tree_sum<P>(a));
      const float r = norm_recip(c_raw, true);
#pragma unroll
      for (int k = 0; k < P; ++k) carry[k] = a[k] * r;
      write_frame<float, G, P>(ap, l.g, l.s_store, carry);
      if (c_store) *cp = fmaxf(c_raw, kTiny);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        x[k] = fmaf(lp, carry[k], colr[k]);
        wcur[k] = wnxt[k];
      }
      ap += step;
      if (WITH_C) cp += B;
    }
  }
}

// Backward chain of lane l.b: writes bhat at frames T-1 .. 0; step f reads
// w_f (the w_{t+1} of output frame f - 1).
template <int G, int P>
__device__ __forceinline__ void backward_rows(RowStager<float>& st,
                                              const float* __restrict__ col,
                                              float lp, int T, int B, int S,
                                              const Lane& l,
                                              float* __restrict__ bhat) {
  const size_t step = static_cast<size_t>(B) * S;
  const int cs = st.stride / 4;
  const float s_f = static_cast<float>(S);
  float colr[P], carry[P], wcur[P], wnxt[P];
  read_frame<float, G, P>(col + static_cast<size_t>(l.b) * S, l.g, S, colr);
  const float uniform = 1.f / s_f;
#pragma unroll
  for (int k = 0; k < P; ++k) carry[k] = l.g + G * k < S ? uniform : 0.f;
  write_frame<float, G, P>(bhat + static_cast<size_t>(T - 1) * step +
                               static_cast<size_t>(l.b) * S,
                           l.g, l.s_store, carry);
  if (T < 2) return;
  st.begin();
  for (int q = 0; q < st.n_chunks; ++q) {
    st.enter(q);
    const int lo = st.chunk_lo(q), f0 = max(lo, 1), f1 = st.chunk_hi(q) - 1;
    const float* wp = st.chunk_data(q) + (f1 - lo) * cs + l.rd;
    float* bp = bhat + static_cast<size_t>(f1 - 1) * step +
                static_cast<size_t>(l.b) * S;
    read_frame<float, G, P>(wp, l.g, S, wcur);
#pragma unroll 4
    for (int f = f1; f >= f0; --f) {
      wp -= cs;  // before the chunk's first row: the buffer's padding, unused
      read_frame<float, G, P>(wp, l.g, S, wnxt);
      float u[P], cu_part[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        u[k] = wcur[k] * carry[k];
        cu_part[k] = colr[k] * u[k];
      }
      float su = tree_sum<P>(u);
      float cu = tree_sum<P>(cu_part);
      group_sum2<G>(su, cu);
      // sum_s (lp * u_s + cu) over the lane's S speakers
      const float r = norm_recip(fmaf(lp, su, s_f * cu), true);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        carry[k] = fmaf(lp, u[k], cu) * r;
        wcur[k] = wnxt[k];
      }
      write_frame<float, G, P>(bp, l.g, l.s_store, carry);
      bp -= step;
    }
  }
}

template <int G, int P>
__global__ void __launch_bounds__(32)
    fb_scan_fused_kernel(const float* __restrict__ w,
                         const float* __restrict__ col,
                         const float* __restrict__ pinit, float lp, int T,
                         int B, int S, int log_f, int stride, int buf_bytes,
                         float* __restrict__ ahat, float* __restrict__ bhat) {
  extern __shared__ __align__(16) char smem[];
  RowStager<float> st;
  const bool forward = blockIdx.y == 0;
  const Lane l =
      setup<G>(st, w, T, B, S, log_f, stride, buf_bytes, forward, smem);
  if (forward)
    forward_rows<G, P, false>(st, col, pinit, lp, B, S, l, ahat, nullptr);
  else
    backward_rows<G, P>(st, col, lp, T, B, S, l, bhat);
}

template <int G, int P>
__global__ void __launch_bounds__(32)
    fb_scan_fwd_kernel(const float* __restrict__ w,
                       const float* __restrict__ col,
                       const float* __restrict__ pinit, float lp, int T,
                       int B, int S, int log_f, int stride, int buf_bytes,
                       float* __restrict__ ahat, float* __restrict__ cfw) {
  extern __shared__ __align__(16) char smem[];
  RowStager<float> st;
  const Lane l = setup<G>(st, w, T, B, S, log_f, stride, buf_bytes, true,
                          smem);
  forward_rows<G, P, true>(st, col, pinit, lp, B, S, l, ahat, cfw);
}

template <int G, int P>
__global__ void __launch_bounds__(32)
    fb_scan_bwd_kernel(const float* __restrict__ w,
                       const float* __restrict__ col, float lp, int T, int B,
                       int S, int log_f, int stride, int buf_bytes,
                       float* __restrict__ bhat) {
  extern __shared__ __align__(16) char smem[];
  RowStager<float> st;
  const Lane l = setup<G>(st, w, T, B, S, log_f, stride, buf_bytes, false,
                          smem);
  backward_rows<G, P>(st, col, lp, T, B, S, l, bhat);
}

// K4 (cfw given), K3 (ahat and bhat given) or K5 (ahat null) for one
// group shape: the ring's geometry from the row of a warp's lanes,
// one-warp blocks, and in K3 a second row of blocks for the backward
// chains.
template <int G, int P>
int launch(const float* w, const float* col, const float* pinit, float lp,
           int T, int B, int S, float* ahat, float* bhat, float* cfw,
           cudaStream_t stream) {
  constexpr int kLanes = 32 / G;
  const int row_bytes = kLanes * S * static_cast<int>(sizeof(float));
  const int log_f = pick_log_chunk(row_bytes);
  const int stride = row_stride_bytes(
      row_bytes, static_cast<long long>(B) * S * sizeof(float));
  const int buf = row_ring_bytes(stride, log_f);
  // buffers and mbarriers: a row is at most 32 * P * 4 = 512 bytes, so
  // this stays under 35 KB, inside the default 48 KB of a block
  const int smem = kStages * (buf + 8);
  const int n_blocks = (B + kLanes - 1) / kLanes;
  if (cfw != nullptr)
    fb_scan_fwd_kernel<G, P><<<n_blocks, 32, smem, stream>>>(
        w, col, pinit, lp, T, B, S, log_f, stride, buf, ahat, cfw);
  else if (ahat != nullptr)
    fb_scan_fused_kernel<G, P><<<dim3(n_blocks, 2), 32, smem, stream>>>(
        w, col, pinit, lp, T, B, S, log_f, stride, buf, ahat, bhat);
  else
    fb_scan_bwd_kernel<G, P><<<n_blocks, 32, smem, stream>>>(
        w, col, lp, T, B, S, log_f, stride, buf, bhat);
  return static_cast<int>(cudaGetLastError());
}

int launch_any(const float* w, const float* col, const float* pinit,
               float lp, int T, int B, int S, float* ahat, float* bhat,
               float* cfw, cudaStream_t stream) {
  int G, P;
  pick_group(S, &G, &P);
#define FB_SCAN_GROUP(GG, PP)                                           \
  if (G == GG && P == PP)                                               \
    return launch<GG, PP>(w, col, pinit, lp, T, B, S, ahat, bhat, cfw,  \
                          stream);
  FB_SCAN_GROUP(1, 4)
  FB_SCAN_GROUP(2, 4)
  FB_SCAN_GROUP(4, 4)
  FB_SCAN_GROUP(8, 4)
  FB_SCAN_GROUP(16, 4)
  FB_SCAN_GROUP(32, 4)
#undef FB_SCAN_GROUP
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace rows

bool bad_shape(int T, int B, int S) {
  return T < 1 || B < 1 || S < 1 || S > kMaxSpeakers;
}

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`, does
// not synchronize, allocates nothing, and returns cudaGetLastError() after
// the launch (0 = cudaSuccess). Each picks its group shape from S.

extern "C" int fb_scan_fused_launch(const void* w, const void* col,
                                    const void* pinit, float lp, int T, int B,
                                    int S, void* ahat, void* bhat,
                                    void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  return rows::launch_any(
      static_cast<const float*>(w), static_cast<const float*>(col),
      static_cast<const float*>(pinit), lp, T, B, S, static_cast<float*>(ahat),
      static_cast<float*>(bhat), nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" int fb_scan_fwd_launch(const void* w, const void* col,
                                  const void* pinit, float lp, int T, int B,
                                  int S, void* ahat, void* cfw, void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  return rows::launch_any(
      static_cast<const float*>(w), static_cast<const float*>(col),
      static_cast<const float*>(pinit), lp, T, B, S, static_cast<float*>(ahat),
      nullptr, static_cast<float*>(cfw), static_cast<cudaStream_t>(stream));
}

extern "C" int fb_scan_bwd_launch(const void* w, const void* col, float lp,
                                  int T, int B, int S, void* bhat,
                                  void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  return rows::launch_any(static_cast<const float*>(w),
                          static_cast<const float*>(col), nullptr, lp, T, B,
                          S, nullptr, static_cast<float*>(bhat), nullptr,
                          static_cast<cudaStream_t>(stream));
}
