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
// Design. One warp walks one chain of one lane, its carry in registers; a
// thread holds speakers lane, lane + 32, ... (at most 4: S <= 128, the API's
// cap) and the per-frame sums are warp-shuffle butterflies, so a walk needs no
// barrier. A block holds kLanesPerBlock lanes; in the fused kernel its first
// half of warps run the forward chains and its second half the backward
// chains of the same lanes (the two are independent). The 1e-37 floor sits
// just above float32's normal range: IEEE division, no fast math.
//
// Bound: bytes. The fused walk reads w once and writes ahat and bhat once
// (at T=1025, B=256, S=31 about 98 MB, ~29 us at 3.35 TB/s); it is T
// dependent steps, each one or two shuffle reductions and a division, so the
// kernel is latency-bound far above that. A step's frame is a fresh line
// B * S floats after the last one, and its latency from device memory is
// longer than the rest of the step. Each chain therefore keeps kAhead frames
// of w in flight as asynchronous copies (cp.async) into a ring of staging
// frames in shared memory, 32 * KPT floats per frame per warp: the copy of
// frame t + kAhead starts while frame t is computed, and a thread reads back
// only the slots it copied itself, so waiting for its own copy groups is the
// only synchronization. A first version held the ring in registers (plain
// loads issued kAhead steps early): on an H100 that hid nothing (1, 4 and 8
// frames in flight took the same time, 1207 cycles per forward step at
// 1980 MHz, 655 of them the load), while the staged copies take the load off
// the step (scripts/torch_fb_scan_tuning.py). What remains is the IEEE
// division, about half of a forward step, and the shuffle sums.

#include <cuda_runtime.h>

namespace {

constexpr int kLanesPerBlock = 4;  // recording lanes (warps per chain kind)
constexpr int kAhead = 4;          // frames of w in flight per chain
constexpr int kMaxSpeakers = 128;  // 4 speakers per thread
constexpr float kTiny = 1e-37f;    // just above the float32 normal range

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Asynchronous 4-byte copy from device memory into shared memory. It does
// not occupy a register while in flight, and it completes by groups: a
// thread commits a group per frame and waits until at most N groups pend.
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Starts the copy of this thread's speakers of one frame of w into its own
// slots of a staging frame (32 * KPT floats), as one group. A thread only
// ever reads back the slots it copied itself, so its own wait is all the
// synchronization a staging frame needs.
template <int KPT>
__device__ __forceinline__ void stage_frame(const float* __restrict__ frame,
                                            int lane, int S, float* slot) {
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = lane + 32 * k;
    if (s < S) cp_async4(slot + s, frame + s);
  }
  cp_async_commit();
}

// Reads this thread's speakers of a staged frame; absent speakers read as 0.
template <int KPT>
__device__ __forceinline__ void read_staged(const float* slot, int lane,
                                            int S, float (&out)[KPT]) {
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = lane + 32 * k;
    out[k] = s < S ? slot[s] : 0.f;
  }
}

// Loads this thread's speakers of one frame; absent speakers read as 0.
template <int KPT>
__device__ __forceinline__ void load_frame(const float* __restrict__ frame,
                                           int lane, int S,
                                           float (&out)[KPT]) {
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = lane + 32 * k;
    out[k] = s < S ? frame[s] : 0.f;
  }
}

template <int KPT>
__device__ __forceinline__ void store_frame(float* __restrict__ frame,
                                            int lane, int S,
                                            const float (&v)[KPT]) {
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int s = lane + 32 * k;
    if (s < S) frame[s] = v[k];
  }
}

// Forward chain of lane b: frames 0 .. T-1. WITH_C also writes c_t.
template <int KPT, bool WITH_C>
__device__ __forceinline__ void forward_chain(
    const float* __restrict__ w, const float* __restrict__ col,
    const float* __restrict__ pinit, float lp, int T, int B, int S, int b,
    int lane, float* stage, float* __restrict__ ahat,
    float* __restrict__ cfw) {
  const size_t step = static_cast<size_t>(B) * S;  // floats between frames
  const float* wl = w + static_cast<size_t>(b) * S;
  float* al = ahat + static_cast<size_t>(b) * S;
  float colr[KPT], pin[KPT], carry[KPT];
  load_frame<KPT>(col + static_cast<size_t>(b) * S, lane, S, colr);
  load_frame<KPT>(pinit + static_cast<size_t>(b) * S, lane, S, pin);
  // one group per staging frame, empty past the end, so that "at most
  // kAhead - 1 groups pending" always means "this step's frame has landed"
#pragma unroll
  for (int i = 0; i < kAhead; ++i)
    stage_frame<KPT>(wl + i * step, lane, i < T ? S : 0,
                     stage + i * 32 * KPT);
#pragma unroll
  for (int k = 0; k < KPT; ++k) carry[k] = 0.f;
  for (int t0 = 0; t0 < T; t0 += kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = t0 + i;
      if (t < T) {
        float* slot = stage + i * 32 * KPT;
        float wt[KPT], a[KPT];
        float part = 0.f;
        cp_async_wait<kAhead - 1>();
        read_staged<KPT>(slot, lane, S, wt);
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          a[k] = t == 0 ? wt[k] * pin[k] : wt[k] * (lp * carry[k] + colr[k]);
          part += a[k];
        }
        stage_frame<KPT>(wl + (t + kAhead) * step, lane,
                         t + kAhead < T ? S : 0, slot);
        const float c = fmaxf(warp_sum(part), kTiny);
#pragma unroll
        for (int k = 0; k < KPT; ++k) carry[k] = a[k] / c;
        store_frame<KPT>(al + t * step, lane, S, carry);
        if (WITH_C && lane == 0) cfw[static_cast<size_t>(t) * B + b] = c;
      }
    }
  }
}

// Backward chain of lane b: writes bhat at frames T-1 .. 0. Step f reads
// w[f] (the w_{t+1} of output frame f - 1).
template <int KPT>
__device__ __forceinline__ void backward_chain(
    const float* __restrict__ w, const float* __restrict__ col, float lp,
    int T, int B, int S, int b, int lane, float* stage,
    float* __restrict__ bhat) {
  const size_t step = static_cast<size_t>(B) * S;
  const float* wl = w + static_cast<size_t>(b) * S;
  float* bl = bhat + static_cast<size_t>(b) * S;
  float colr[KPT], carry[KPT];
  load_frame<KPT>(col + static_cast<size_t>(b) * S, lane, S, colr);
  const float uniform = 1.f / static_cast<float>(S);
#pragma unroll
  for (int k = 0; k < KPT; ++k) carry[k] = lane + 32 * k < S ? uniform : 0.f;
  store_frame<KPT>(bl + static_cast<size_t>(T - 1) * step, lane, S, carry);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int f = T - 1 - i;
    stage_frame<KPT>(wl + (f >= 1 ? f : 0) * step, lane, f >= 1 ? S : 0,
                     stage + i * 32 * KPT);
  }
  for (int f0 = T - 1; f0 >= 1; f0 -= kAhead) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int f = f0 - i;
      if (f >= 1) {
        float* slot = stage + i * 32 * KPT;
        float u[KPT];
        float part = 0.f;
        cp_async_wait<kAhead - 1>();
        read_staged<KPT>(slot, lane, S, u);
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          u[k] *= carry[k];
          part += colr[k] * u[k];
        }
        stage_frame<KPT>(wl + (f - kAhead >= 1 ? f - kAhead : 0) * step,
                         lane, f - kAhead >= 1 ? S : 0, slot);
        const float cu = warp_sum(part);
        float bb[KPT];
        part = 0.f;
#pragma unroll
        for (int k = 0; k < KPT; ++k) {
          bb[k] = lane + 32 * k < S ? lp * u[k] + cu : 0.f;
          part += bb[k];
        }
        const float cb = fmaxf(warp_sum(part), kTiny);
#pragma unroll
        for (int k = 0; k < KPT; ++k) carry[k] = bb[k] / cb;
        store_frame<KPT>(bl + (f - 1) * step, lane, S, carry);
      }
    }
  }
}

template <int KPT>
__global__ void __launch_bounds__(64 * kLanesPerBlock)
    fb_scan_fused_kernel(const float* __restrict__ w,
                         const float* __restrict__ col,
                         const float* __restrict__ pinit, float lp, int T,
                         int B, int S, float* __restrict__ ahat,
                         float* __restrict__ bhat) {
  __shared__ float stage[2 * kLanesPerBlock][kAhead * 32 * KPT];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLanesPerBlock + warp % kLanesPerBlock;
  if (b >= B) return;
  if (warp < kLanesPerBlock)
    forward_chain<KPT, false>(w, col, pinit, lp, T, B, S, b, lane,
                              stage[warp], ahat, nullptr);
  else
    backward_chain<KPT>(w, col, lp, T, B, S, b, lane, stage[warp], bhat);
}

template <int KPT>
__global__ void __launch_bounds__(32 * kLanesPerBlock)
    fb_scan_fwd_kernel(const float* __restrict__ w,
                       const float* __restrict__ col,
                       const float* __restrict__ pinit, float lp, int T, int B,
                       int S, float* __restrict__ ahat,
                       float* __restrict__ cfw) {
  __shared__ float stage[kLanesPerBlock][kAhead * 32 * KPT];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kLanesPerBlock + warp;
  if (b >= B) return;
  forward_chain<KPT, true>(w, col, pinit, lp, T, B, S, b, threadIdx.x & 31,
                           stage[warp], ahat, cfw);
}

template <int KPT>
__global__ void __launch_bounds__(32 * kLanesPerBlock)
    fb_scan_bwd_kernel(const float* __restrict__ w,
                       const float* __restrict__ col, float lp, int T, int B,
                       int S, float* __restrict__ bhat) {
  __shared__ float stage[kLanesPerBlock][kAhead * 32 * KPT];
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kLanesPerBlock + warp;
  if (b >= B) return;
  backward_chain<KPT>(w, col, lp, T, B, S, b, threadIdx.x & 31, stage[warp],
                      bhat);
}

bool bad_shape(int T, int B, int S) {
  return T < 1 || B < 1 || S < 1 || S > kMaxSpeakers;
}

int blocks(int B) { return (B + kLanesPerBlock - 1) / kLanesPerBlock; }

}  // namespace

// Plain C entry points (loaded with ctypes). Each launches on `stream`, does
// not synchronize, allocates nothing, and returns cudaGetLastError() after
// the launch (0 = cudaSuccess). The instance holds 1, 2 or 4 speakers per
// thread by S.

extern "C" int fb_scan_fused_launch(const void* w, const void* col,
                                    const void* pinit, float lp, int T, int B,
                                    int S, void* ahat, void* bhat,
                                    void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wp = static_cast<const float*>(w);
  const auto* cp = static_cast<const float*>(col);
  const auto* pp = static_cast<const float*>(pinit);
  auto* ap = static_cast<float*>(ahat);
  auto* bp = static_cast<float*>(bhat);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 64 * kLanesPerBlock;
  if (S <= 32)
    fb_scan_fused_kernel<1><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T,
                                                           B, S, ap, bp);
  else if (S <= 64)
    fb_scan_fused_kernel<2><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T,
                                                           B, S, ap, bp);
  else
    fb_scan_fused_kernel<4><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T,
                                                           B, S, ap, bp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fb_scan_fwd_launch(const void* w, const void* col,
                                  const void* pinit, float lp, int T, int B,
                                  int S, void* ahat, void* cfw, void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wp = static_cast<const float*>(w);
  const auto* cp = static_cast<const float*>(col);
  const auto* pp = static_cast<const float*>(pinit);
  auto* ap = static_cast<float*>(ahat);
  auto* cf = static_cast<float*>(cfw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * kLanesPerBlock;
  if (S <= 32)
    fb_scan_fwd_kernel<1><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T, B,
                                                         S, ap, cf);
  else if (S <= 64)
    fb_scan_fwd_kernel<2><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T, B,
                                                         S, ap, cf);
  else
    fb_scan_fwd_kernel<4><<<blocks(B), threads, 0, st>>>(wp, cp, pp, lp, T, B,
                                                         S, ap, cf);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fb_scan_bwd_launch(const void* w, const void* col, float lp,
                                  int T, int B, int S, void* bhat,
                                  void* stream) {
  if (bad_shape(T, B, S)) return static_cast<int>(cudaErrorInvalidValue);
  const auto* wp = static_cast<const float*>(w);
  const auto* cp = static_cast<const float*>(col);
  auto* bp = static_cast<float*>(bhat);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 32 * kLanesPerBlock;
  if (S <= 32)
    fb_scan_bwd_kernel<1><<<blocks(B), threads, 0, st>>>(wp, cp, lp, T, B, S,
                                                         bp);
  else if (S <= 64)
    fb_scan_bwd_kernel<2><<<blocks(B), threads, 0, st>>>(wp, cp, lp, T, B, S,
                                                         bp);
  else
    fb_scan_bwd_kernel<4><<<blocks(B), threads, 0, st>>>(wp, cp, lp, T, B, S,
                                                         bp);
  return static_cast<int>(cudaGetLastError());
}
