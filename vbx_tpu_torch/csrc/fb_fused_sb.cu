// Fused bidirectional scaled forward-backward walk for the VB-HMM E-step.
//
// Replaces vbx_tpu/ops/fb_pallas.py:_fused_kernel_sb, the Pallas TPU kernel
// on the main diarization path. For each recording lane b it computes
//
//   forward:  a_t = w_t * (lp * ahat_{t-1} + col),  a_0 = w_0 * pinit
//             c_t = max(sum_s a_t, 1e-37),          ahat_t = a_t / c_t
//   backward: u   = w_{t+1} * bhat_{t+1}
//             b_t = lp * u + sum_s(col * u),        bhat_t = b_t / sum_s b_t
//             bhat_{T-1} = binit
//
// with float32 arithmetic whatever the stream type (loads upcast, stores
// round to nearest even), as the TPU kernel does. RECIP normalizes by
// multiplying with the reciprocal; SKIP_DEAD makes an all-zero w frame an
// exact no-op in both directions (carry kept, c = 1).
//
// Layout: w, ahat and bhat are [B, T, S] row-major, so one frame of one
// lane is S contiguous values; col/pinit/binit are [B, S] float32 and cfw is
// [B, T] float32. S is not padded: speakers s >= S do not exist here, where
// the TPU kernel carried them as zero rows (bhat therefore differs from the
// TPU kernel's by a per-frame scale only, which every consumer divides out).
//
// Design. The TPU kernel walks T in sequential grid steps and carries its
// state between them in VMEM scratch; CUDA blocks run in parallel and share
// nothing, so here the whole walk of one lane lives in one block: the first
// half of the block runs the forward chain and the second half the backward
// chain (the two are independent). A chain is nw warps; each thread holds
// speakers ct, ct + 32 nw, ... (at most 8) in registers, and the per-frame
// sums are warp-shuffle butterflies. S <= 256 runs one warp per chain (the
// main path's case, no barrier at all); wider S runs nw = ceil(S / 256) <= 16
// warps per chain, whose warp partials meet in shared memory behind one
// named barrier per sum (double-buffered, so one barrier per sum suffices).
// Every thread of a chain adds the partials in the same order, so all see
// the same total. S <= 4096.
//
// Bound: one pass reads w once and writes ahat, bhat and cfw once — at
// B=256, T=1025, S=31 in float32 about 98 MB, ~29 us at 3.35 TB/s. The walk
// is T dependent steps, each a shuffle reduction (two in the backward
// chain) plus a global load, so the kernel is latency-bound far above the
// bytes bound. The design only hides the load latency: each step issues
// the load of the next frame's w before computing the current frame. Closing
// the gap (several lanes per warp, more frames in flight) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPerThread = 8;      // speakers per thread
constexpr int kMaxChainWarps = 16; // two chains of 16 warps: 1024 threads
constexpr int kNarrowSpeakers = 32 * kPerThread;                    // 256
constexpr int kMaxSpeakers = kNarrowSpeakers * kMaxChainWarps;      // 4096
constexpr float kTiny = 1e-37f;    // just above the float32 normal range

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over one chain's threads; every thread of the chain gets the total.
// WIDE chains (nw > 1 warps) exchange warp partials through `red`
// ([2][kMaxChainWarps], alternating halves) behind named barrier `bar`.
// A half is rewritten two sums later, after the next barrier, by which
// time every thread of the chain has read it.
template <bool WIDE>
struct ChainSum {
  float* red;
  int nw, warp, lane, bar, half;

  __device__ __forceinline__ float operator()(float v) {
    v = warp_sum(v);
    if (!WIDE) return v;
    float* slot = red + half * kMaxChainWarps;
    if (lane == 0) slot[warp] = v;
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * nw) : "memory");
    float total = 0.f;
    for (int i = 0; i < nw; ++i) total += slot[i];
    half ^= 1;
    return total;
  }
};

// Loads one frame's speakers of this thread; absent speakers read as 0.
template <typename IO>
__device__ __forceinline__ void load_frame(const IO* __restrict__ frame,
                                           int ct, int stride, int S,
                                           float (&out)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = ct + stride * k;
    out[k] = s < S ? to_f32(frame[s]) : 0.f;
  }
}

template <typename IO>
__device__ __forceinline__ void store_frame(IO* __restrict__ frame, int ct,
                                            int stride, int S,
                                            const float (&v)[kPerThread]) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = ct + stride * k;
    if (s < S) store(frame + s, v[k]);
  }
}

template <typename IO, bool RECIP, bool SKIP_DEAD, bool WIDE>
__global__ void __launch_bounds__(WIDE ? 64 * kMaxChainWarps : 64)
    fb_fused_sb_kernel(const IO* __restrict__ w, const float* __restrict__ col,
                       const float* __restrict__ pinit,
                       const float* __restrict__ binit, float lp, int T, int S,
                       IO* __restrict__ ahat, IO* __restrict__ bhat,
                       float* __restrict__ cfw) {
  __shared__ float red[2][2 * kMaxChainWarps];
  const int b = blockIdx.x;
  const int nw = WIDE ? blockDim.x / 64 : 1;    // warps per chain
  const int stride = 32 * nw;                   // threads per chain
  const int chain = threadIdx.x / stride;       // 0 forward, 1 backward
  const int ct = threadIdx.x - chain * stride;  // thread within its chain
  ChainSum<WIDE> sum{red[chain], nw, ct / 32, ct & 31, 1 + chain, 0};
  const size_t lane_off = static_cast<size_t>(b) * T * S;
  const IO* wl = w + lane_off;

  float colr[kPerThread], carry[kPerThread];
  float wcur[kPerThread], wnxt[kPerThread];
  load_frame(col + static_cast<size_t>(b) * S, ct, stride, S, colr);

  if (chain == 0) {
    // ---- forward chain: frames 0 .. T-1 ----
    IO* al = ahat + lane_off;
    float* cl = cfw + static_cast<size_t>(b) * T;
    float pin[kPerThread];
    load_frame(pinit + static_cast<size_t>(b) * S, ct, stride, S, pin);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) carry[k] = 0.f;
    load_frame(wl, ct, stride, S, wcur);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T)
        load_frame(wl + static_cast<size_t>(t + 1) * S, ct, stride, S, wnxt);
      float a[kPerThread];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        a[k] = t == 0 ? wcur[k] * pin[k] : wcur[k] * (lp * carry[k] + colr[k]);
        part += a[k];
      }
      const float c_raw = sum(part);
      const float c = fmaxf(c_raw, kTiny);
      const float r = RECIP ? 1.f / c : 0.f;
      const bool live = !SKIP_DEAD || c_raw > kTiny;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float an = RECIP ? a[k] * r : a[k] / c;
        carry[k] = live ? an : carry[k];
      }
      store_frame(al + static_cast<size_t>(t) * S, ct, stride, S, carry);
      if (ct == 0) cl[t] = live ? c : 1.f;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) wcur[k] = wnxt[k];
    }
  } else {
    // ---- backward chain: frames T-1 .. 0 ----
    IO* bl = bhat + lane_off;
    load_frame(binit + static_cast<size_t>(b) * S, ct, stride, S, carry);
    store_frame(bl + static_cast<size_t>(T - 1) * S, ct, stride, S, carry);
    load_frame(wl + static_cast<size_t>(T - 1) * S, ct, stride, S, wcur);
    for (int j = T - 2; j >= 0; --j) {
      // wnxt: frame j, the w_{t+1} of the following step
      load_frame(wl + static_cast<size_t>(j) * S, ct, stride, S, wnxt);
      float u[kPerThread];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        u[k] = wcur[k] * carry[k];
        part += colr[k] * u[k];
      }
      const float cu = sum(part);
      float bb[kPerThread];
      part = 0.f;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        bb[k] = ct + stride * k < S ? lp * u[k] + cu : 0.f;
        part += bb[k];
      }
      const float cb_raw = sum(part);
      const float cb = fmaxf(cb_raw, kTiny);
      const float r = RECIP ? 1.f / cb : 0.f;
      const bool live = !SKIP_DEAD || cb_raw > kTiny;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const float bn = RECIP ? bb[k] * r : bb[k] / cb;
        carry[k] = live ? bn : carry[k];
      }
      store_frame(bl + static_cast<size_t>(j) * S, ct, stride, S, carry);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) wcur[k] = wnxt[k];
    }
  }
}

template <typename IO, bool RECIP, bool SKIP_DEAD>
void launch(const void* w, const void* col, const void* pinit,
            const void* binit, float lp, int B, int T, int S, void* ahat,
            void* bhat, void* cfw, cudaStream_t stream) {
  const auto* wp = static_cast<const IO*>(w);
  const auto* cp = static_cast<const float*>(col);
  const auto* pp = static_cast<const float*>(pinit);
  const auto* bp = static_cast<const float*>(binit);
  auto* ap = static_cast<IO*>(ahat);
  auto* bhp = static_cast<IO*>(bhat);
  auto* cf = static_cast<float*>(cfw);
  if (S <= kNarrowSpeakers) {
    fb_fused_sb_kernel<IO, RECIP, SKIP_DEAD, false><<<B, 64, 0, stream>>>(
        wp, cp, pp, bp, lp, T, S, ap, bhp, cf);
  } else {
    const int nw = (S + kNarrowSpeakers - 1) / kNarrowSpeakers;
    fb_fused_sb_kernel<IO, RECIP, SKIP_DEAD, true><<<B, 64 * nw, 0, stream>>>(
        wp, cp, pp, bp, lp, T, S, ap, bhp, cf);
  }
}

template <typename IO>
void dispatch(int recip, int skip_dead, const void* w, const void* col,
              const void* pinit, const void* binit, float lp, int B, int T,
              int S, void* ahat, void* bhat, void* cfw, cudaStream_t stream) {
  if (recip) {
    if (skip_dead)
      launch<IO, true, true>(w, col, pinit, binit, lp, B, T, S, ahat, bhat,
                             cfw, stream);
    else
      launch<IO, true, false>(w, col, pinit, binit, lp, B, T, S, ahat, bhat,
                              cfw, stream);
  } else {
    if (skip_dead)
      launch<IO, false, true>(w, col, pinit, binit, lp, B, T, S, ahat, bhat,
                              cfw, stream);
    else
      launch<IO, false, false>(w, col, pinit, binit, lp, B, T, S, ahat, bhat,
                               cfw, stream);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Launches on `stream`, does not
// synchronize, allocates nothing; returns cudaGetLastError() after the
// launch (0 = cudaSuccess).
extern "C" int fb_fused_sb_launch(const void* w, const void* col,
                                  const void* pinit, const void* binit,
                                  float lp, int B, int T, int S, int io_bf16,
                                  int recip, int skip_dead, void* ahat,
                                  void* bhat, void* cfw, void* stream) {
  if (B < 1 || T < 1 || S < 1 || S > kMaxSpeakers)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_bf16)
    dispatch<__nv_bfloat16>(recip, skip_dead, w, col, pinit, binit, lp, B, T,
                            S, ahat, bhat, cfw, st);
  else
    dispatch<float>(recip, skip_dead, w, col, pinit, binit, lp, B, T, S, ahat,
                    bhat, cfw, st);
  return static_cast<int>(cudaGetLastError());
}
