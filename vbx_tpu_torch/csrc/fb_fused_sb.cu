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
// multiplying with the reciprocal; skip_dead makes an all-zero w frame an
// exact no-op in both directions (carry kept, c = 1).
//
// Layout: w, ahat and bhat are [B, T, S] row-major, so one frame of one
// lane is S contiguous values and a lane's frames are one contiguous run;
// col/pinit/binit are [B, S] float32 and cfw is [B, T] float32. S is not
// padded: speakers s >= S do not exist here, where the TPU kernel carried
// them as zero rows (bhat therefore differs from the TPU kernel's by a
// per-frame scale only, which every consumer divides out).
//
// Bound. One pass reads w once and writes ahat, bhat and cfw once: at
// B=256, T=1025, S=31 in float32 about 98 MB, ~29 us at 3.35 TB/s. But the
// walk is T dependent steps and every lane's chain runs at once (a few
// hundred warps on 132 SMs), so the time is T x the latency of one step and
// nothing else. A first design (one warp per chain, eight speakers per
// thread slot, next frame's w loaded into registers one step ahead, IEEE
// reciprocal) took 840-950 cycles a step in float32 and 1,170-1,340 in
// bfloat16 on an H100 at 1980 MHz. This design takes ~260 cycles a step at
// S=31 and 170-180 at S=8 in either type (scripts/torch_fb_fused_tuning.py
// times it and its variants): the dependent arithmetic of one frame
// (multiply, sums, reciprocal, multiply, multiply-add) and the in-order
// issue of the step's ~60 machine operations by a warp that has its
// scheduler to itself. What took the rest off the step:
//
// - w is off the step. A chain's frames are one contiguous run, staged
//   through a shared-memory ring of kStages chunks, one asynchronous bulk
//   copy a chunk, two chunks ahead (fb_step.cuh: Stager); the step reads
//   shared memory, one frame ahead into registers, through a pointer that
//   moves by S.
// - The step has no branch (skipped frames and the first frame are selects
//   or loop-carried values; only the chunk loop, the frame loop and the
//   reciprocal's rare branch remain): a branch cost ~25-30 cycles a step.
// - The group that holds a lane is sized to S (fb_step.cuh: pick_group): G
//   threads x P speakers, so S=31 sums in three shuffle rounds and S=8 in
//   one, and 32 / G lanes share a warp. G and P depend on S only and a
//   group never reads a neighbour's values, so a lane's result does not
//   depend on the batch it is launched in. Lanes past the batch's end repeat
//   its last lane and store nothing.
// - One butterfly per backward step: with u = w_{t+1} * bhat_{t+1}, the
//   normalizer sum_s b_t is lp * sum(u) + S * sum(col * u) exactly (every
//   one of the S speakers adds the same sum(col * u)), so sum(u) and
//   sum(col * u) ride the same shuffles and the second, dependent butterfly
//   is gone. The rounding differs from a sum over b_t in the last bits.
// - The reciprocal is the hardware approximation unless the sum is at the
//   floor or absurdly large (fb_step.cuh: norm_recip); the RECIP = false form
//   keeps its IEEE division.
// - The forward and the backward chain of a lane are separate blocks
//   (blockIdx.y), one warp each.
//
// S > 256 keeps the several-warp form: each chain is ceil(S / 256) <= 16
// warps of one block, eight speakers per thread, whose warp partials meet
// in shared memory behind one named barrier per step (double-buffered), w
// loaded into registers one frame ahead. It has the merged backward sum and
// the reciprocal above; up to 1024 speakers (four warps a chain) it is an
// instance with a register budget of its own, which does not spill.
// S <= 4096.

#include "fb_step.cuh"

namespace {

using namespace fb_step;

constexpr int kNarrowSpeakers = 256;  // one group of <= 32 threads per lane
constexpr int kWidePerThread = 8;     // speakers per thread, wide form
constexpr int kMaxChainWarps = 16;    // two chains of 16 warps: 1024 threads
constexpr int kMaxSpeakers = 32 * kWidePerThread * kMaxChainWarps;  // 4096

// Normalizes one step's unnormalized message `a` (whose sum is c_raw) into
// the carry; returns the c_t to record. With skip_dead a frame at the floor
// leaves the carry alone and records 1 (by selects: no branch).
template <int P, bool RECIP>
__device__ __forceinline__ float normalize(const float (&a)[P], float c_raw,
                                           bool skip_dead,
                                           float (&carry)[P]) {
  const bool dead = skip_dead && !(c_raw > kTiny);
  const float c = fmaxf(c_raw, kTiny);
  if (RECIP) {
    const float r = norm_recip(c_raw, !skip_dead);
#pragma unroll
    for (int k = 0; k < P; ++k) carry[k] = dead ? carry[k] : a[k] * r;
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) carry[k] = dead ? carry[k] : a[k] / c;
  }
  return dead ? 1.f : c;
}

// ---- S <= 256: a group of G threads per lane, 32 / G lanes per warp ------

template <typename IO, int G, int P, bool RECIP>
__global__ void __launch_bounds__(32)
    fb_fused_narrow_kernel(const IO* __restrict__ w,
                           const float* __restrict__ col,
                           const float* __restrict__ pinit,
                           const float* __restrict__ binit, float lp, int B,
                           int T, int S, int log_f, int ring_stride,
                           int skip_dead, IO* __restrict__ ahat,
                           IO* __restrict__ bhat, float* __restrict__ cfw) {
  extern __shared__ __align__(16) char smem[];
  const int grp = threadIdx.x / G;  // lane within the warp
  const int g = threadIdx.x % G;    // thread within the lane's group
  const int b_raw = blockIdx.x * (32 / G) + grp;
  const bool lane_ok = b_raw < B;
  const int b = lane_ok ? b_raw : B - 1;
  const bool forward = blockIdx.y == 0;
  const bool skip = skip_dead != 0;
  const size_t lane_off = static_cast<size_t>(b) * T * S;
  const int s_store = lane_ok ? S : 0;  // speakers this thread may store

  float colr[P], carry[P], wcur[P], wnxt[P];
  read_frame<float, G, P>(col + static_cast<size_t>(b) * S, g, S, colr);

  Stager<IO, false> st;
  st.init(w, static_cast<size_t>(B) * T * S, w + lane_off, T, S, log_f,
          forward, smem + static_cast<size_t>(grp) * kStages * ring_stride,
          ring_stride,
          smem + static_cast<size_t>(32 / G) * kStages * ring_stride +
              grp * kStages * 8,
          g, G);

  if (forward) {
    // ---- forward chain: frames 0 .. T-1. x is the prior of the frame to
    // come, lp * ahat_{t-1} + col, and pinit before frame 0 ----
    float x[P];
    read_frame<float, G, P>(pinit + static_cast<size_t>(b) * S, g, S, x);
#pragma unroll
    for (int k = 0; k < P; ++k) carry[k] = 0.f;
    st.begin();
    for (int q = 0; q < st.n_chunks; ++q) {
      st.enter(q);
      const int t0 = st.chunk_lo(q), t1 = st.chunk_hi(q);
      const IO* wp = st.chunk_data(q);
      IO* ap = ahat + lane_off + static_cast<size_t>(t0) * S;
      float* cp = cfw + static_cast<size_t>(b) * T + t0;
      read_frame<IO, G, P>(wp, g, S, wcur);
#pragma unroll 4
      for (int t = t0; t < t1; ++t) {
        wp += S;  // past the chunk's end it reads the ring's padding, unused
        read_frame<IO, G, P>(wp, g, S, wnxt);
        float a[P];
#pragma unroll
        for (int k = 0; k < P; ++k) a[k] = wcur[k] * x[k];
        const float c_raw = group_sum<G>(tree_sum<P>(a));
        const float c = normalize<P, RECIP>(a, c_raw, skip, carry);
        write_frame<IO, G, P>(ap, g, s_store, carry);
        if (g == 0 && lane_ok) *cp = c;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          x[k] = fmaf(lp, carry[k], colr[k]);
          wcur[k] = wnxt[k];
        }
        ap += S;
        ++cp;
      }
    }
  } else {
    // ---- backward chain: step f reads w_f and writes bhat_{f-1} ----
    const float s_f = static_cast<float>(S);
    read_frame<float, G, P>(binit + static_cast<size_t>(b) * S, g, S, carry);
    write_frame<IO, G, P>(bhat + lane_off + static_cast<size_t>(T - 1) * S, g,
                          s_store, carry);
    if (T < 2) return;
    st.begin();
    for (int q = 0; q < st.n_chunks; ++q) {
      st.enter(q);
      const int f0 = max(st.chunk_lo(q), 1), f1 = st.chunk_hi(q) - 1;
      const IO* wp = st.chunk_data(q) +
                     static_cast<size_t>(f1 - st.chunk_lo(q)) * S;
      IO* bp = bhat + lane_off + static_cast<size_t>(f1 - 1) * S;
      read_frame<IO, G, P>(wp, g, S, wcur);
#pragma unroll 4
      for (int f = f1; f >= f0; --f) {
        wp -= S;  // before the chunk's start: the ring's padding, unused
        read_frame<IO, G, P>(wp, g, S, wnxt);
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
        const float cb_raw = fmaf(lp, su, s_f * cu);
        float bb[P];
#pragma unroll
        for (int k = 0; k < P; ++k) bb[k] = fmaf(lp, u[k], cu);
        normalize<P, RECIP>(bb, cb_raw, skip, carry);
        write_frame<IO, G, P>(bp, g, s_store, carry);
#pragma unroll
        for (int k = 0; k < P; ++k) wcur[k] = wnxt[k];
        bp -= S;
      }
    }
  }
}

template <typename IO, int G, int P, bool RECIP>
int launch_narrow(const void* w, const void* col, const void* pinit,
                  const void* binit, float lp, int B, int T, int S,
                  int skip_dead, void* ahat, void* bhat, void* cfw,
                  cudaStream_t stream) {
  auto* kernel = fb_fused_narrow_kernel<IO, G, P, RECIP>;
  const int lanes = 32 / G;
  const int frame_bytes = S * static_cast<int>(sizeof(IO));
  const int log_f = pick_log_chunk(frame_bytes);
  const int stride = ring_stride_bytes(frame_bytes << log_f, frame_bytes, G);
  const int smem = lanes * kStages * (stride + 8);  // rings and mbarriers
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + lanes - 1) / lanes, 2);
  kernel<<<grid, 32, smem, stream>>>(
      static_cast<const IO*>(w), static_cast<const float*>(col),
      static_cast<const float*>(pinit), static_cast<const float*>(binit), lp,
      B, T, S, log_f, stride, skip_dead, static_cast<IO*>(ahat),
      static_cast<IO*>(bhat), static_cast<float*>(cfw));
  return static_cast<int>(cudaGetLastError());
}

// ---- S > 256: several warps per chain, both chains in one block ----------

// Sums over one chain's nw warps; every thread of the chain gets the
// totals. Warp partials meet in `red` ([2 halves][2 sums][kMaxChainWarps],
// alternating halves) behind named barrier `bar`. A half is rewritten two
// steps later, after the next barrier, by which time every thread of the
// chain has read it; every thread adds the partials in the same order.
struct WideSum {
  float* red;
  int nw, warp, lane, bar, half;

  __device__ __forceinline__ float* meet(float a, float b, bool two) {
    float* slot = red + half * 2 * kMaxChainWarps;
    if (lane == 0) {
      slot[warp] = a;
      if (two) slot[kMaxChainWarps + warp] = b;
    }
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 * nw) : "memory");
    half ^= 1;
    return slot;
  }

  __device__ __forceinline__ float one(float a) {
    const float* slot = meet(group_sum<32>(a), 0.f, false);
    float total = 0.f;
    for (int i = 0; i < nw; ++i) total += slot[i];
    return total;
  }

  // two sums behind one barrier
  __device__ __forceinline__ void two(float& a, float& b) {
    group_sum2<32>(a, b);
    const float* slot = meet(a, b, true);
    a = 0.f;
    b = 0.f;
    for (int i = 0; i < nw; ++i) {
      a += slot[i];
      b += slot[kMaxChainWarps + i];
    }
  }
};

// MAXW: the most warps per chain this instance is launched with (its
// register budget follows from it).
template <typename IO, bool RECIP, int MAXW>
__global__ void __launch_bounds__(64 * MAXW)
    fb_fused_wide_kernel(const IO* __restrict__ w,
                         const float* __restrict__ col,
                         const float* __restrict__ pinit,
                         const float* __restrict__ binit, float lp, int T,
                         int S, int skip_dead, IO* __restrict__ ahat,
                         IO* __restrict__ bhat, float* __restrict__ cfw) {
  constexpr int P = kWidePerThread;
  __shared__ float red[2][4 * kMaxChainWarps];
  const int b = blockIdx.x;
  const int nw = blockDim.x / 64;               // warps per chain
  const int stride = 32 * nw;                   // threads per chain
  const int chain = threadIdx.x / stride;       // 0 forward, 1 backward
  const int ct = threadIdx.x - chain * stride;  // thread within its chain
  const bool skip = skip_dead != 0;
  WideSum sum{red[chain], nw, ct / 32, ct & 31, 1 + chain, 0};
  const size_t lane_off = static_cast<size_t>(b) * T * S;
  const IO* wl = w + lane_off;

  // thread ct holds speakers ct, ct + stride, ...
  auto load = [&](const auto* frame, float(&out)[P]) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int s = ct + stride * k;
      out[k] = s < S ? to_f32(frame[s]) : 0.f;
    }
  };
  auto store = [&](IO* frame, const float(&v)[P]) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int s = ct + stride * k;
      if (s < S) store_io(frame + s, v[k]);
    }
  };

  float colr[P], carry[P], wcur[P], wnxt[P];
  load(col + static_cast<size_t>(b) * S, colr);

  if (chain == 0) {
    IO* al = ahat + lane_off;
    float* cl = cfw + static_cast<size_t>(b) * T;
    float pin[P];
    load(pinit + static_cast<size_t>(b) * S, pin);
#pragma unroll
    for (int k = 0; k < P; ++k) carry[k] = 0.f;
    load(wl, wcur);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) load(wl + static_cast<size_t>(t + 1) * S, wnxt);
      float a[P];
#pragma unroll
      for (int k = 0; k < P; ++k)
        a[k] = t == 0 ? wcur[k] * pin[k]
                      : wcur[k] * fmaf(lp, carry[k], colr[k]);
      const float c_raw = sum.one(tree_sum<P>(a));
      const float c = normalize<P, RECIP>(a, c_raw, skip, carry);
      store(al + static_cast<size_t>(t) * S, carry);
      if (ct == 0) cl[t] = c;
#pragma unroll
      for (int k = 0; k < P; ++k) wcur[k] = wnxt[k];
    }
  } else {
    IO* bl = bhat + lane_off;
    const float s_f = static_cast<float>(S);
    load(binit + static_cast<size_t>(b) * S, carry);
    store(bl + static_cast<size_t>(T - 1) * S, carry);
    load(wl + static_cast<size_t>(T - 1) * S, wcur);
    for (int f = T - 1; f >= 1; --f) {
      // wnxt: frame f - 1, the w_{t+1} of the following step
      load(wl + static_cast<size_t>(f - 1) * S, wnxt);
      float u[P], cu_part[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        u[k] = wcur[k] * carry[k];
        cu_part[k] = colr[k] * u[k];
      }
      float su = tree_sum<P>(u);
      float cu = tree_sum<P>(cu_part);
      sum.two(su, cu);
      const float cb_raw = fmaf(lp, su, s_f * cu);
      float bb[P];
#pragma unroll
      for (int k = 0; k < P; ++k) bb[k] = fmaf(lp, u[k], cu);
      normalize<P, RECIP>(bb, cb_raw, skip, carry);
      store(bl + static_cast<size_t>(f - 1) * S, carry);
#pragma unroll
      for (int k = 0; k < P; ++k) wcur[k] = wnxt[k];
    }
  }
}

template <typename IO, bool RECIP>
int launch(const void* w, const void* col, const void* pinit,
           const void* binit, float lp, int B, int T, int S, int skip_dead,
           void* ahat, void* bhat, void* cfw, cudaStream_t stream) {
  if (S > kNarrowSpeakers) {
    const int nw = (S + 32 * kWidePerThread - 1) / (32 * kWidePerThread);
    auto* kernel = nw <= 4 ? fb_fused_wide_kernel<IO, RECIP, 4>
                           : fb_fused_wide_kernel<IO, RECIP, kMaxChainWarps>;
    kernel<<<B, 64 * nw, 0, stream>>>(
        static_cast<const IO*>(w), static_cast<const float*>(col),
        static_cast<const float*>(pinit), static_cast<const float*>(binit),
        lp, T, S, skip_dead, static_cast<IO*>(ahat), static_cast<IO*>(bhat),
        static_cast<float*>(cfw));
    return static_cast<int>(cudaGetLastError());
  }
  int G, P;
  pick_group(S, &G, &P);
#define FB_NARROW(GG, PP)                                                    \
  if (G == GG && P == PP)                                                    \
    return launch_narrow<IO, GG, PP, RECIP>(w, col, pinit, binit, lp, B, T,  \
                                            S, skip_dead, ahat, bhat, cfw,   \
                                            stream);
  FB_NARROW(1, 4)
  FB_NARROW(2, 4)
  FB_NARROW(4, 4)
  FB_NARROW(8, 4)
  FB_NARROW(16, 4)
  FB_NARROW(32, 4)
  FB_NARROW(32, 8)
#undef FB_NARROW
  return static_cast<int>(cudaErrorInvalidValue);
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
  if (io_bf16) {
    if (recip)
      return launch<__nv_bfloat16, true>(w, col, pinit, binit, lp, B, T, S,
                                         skip_dead, ahat, bhat, cfw, st);
    return launch<__nv_bfloat16, false>(w, col, pinit, binit, lp, B, T, S,
                                        skip_dead, ahat, bhat, cfw, st);
  }
  if (recip)
    return launch<float, true>(w, col, pinit, binit, lp, B, T, S, skip_dead,
                               ahat, bhat, cfw, st);
  return launch<float, false>(w, col, pinit, binit, lp, B, T, S, skip_dead,
                              ahat, bhat, cfw, st);
}
