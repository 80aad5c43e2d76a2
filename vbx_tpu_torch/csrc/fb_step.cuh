// What the [B, T, S] walks share (fb_fused_sb.cu, fb_fwd_product_sb.cu): the
// step's group sums, its reciprocal, the stream-type conversions, and the
// staging of w through shared memory.
//
// Both walks are T dependent steps per lane, so their time is steps x the
// latency of one step, and everything here serves to shorten that latency:
//
// - A lane's S speakers are held by a group of G threads of one warp (G a
//   power of two chosen from S alone, see pick_group), P speakers each
//   (s = g + G k), so a per-frame sum is P - 1 adds in a tree and log2(G)
//   shuffle rounds instead of five; 32 / G lanes share a warp and never
//   exchange values.
// - The normalizing reciprocal is the hardware approximation (1 ulp), the
//   IEEE division only at the floor and for absurd sums (norm_recip).
// - The step has no branch: a branch cost the walk ~25-30 cycles a step
//   each (one warp per scheduler, nothing to overlap it with), so skipped
//   frames and the first frame are selects, and the only branches are the
//   loops and the reciprocal's rare one.
// - w reaches the step through a ring of kStages chunks of frames in shared
//   memory, each filled by one asynchronous bulk copy (the copy engine of
//   sm_90, completion counted by an mbarrier) that runs kStages - 1 chunks
//   ahead of the walk (Stager): a load from device memory issued into
//   registers one step ahead was measured at ~260-360 cycles of a step, and
//   per-thread 16-byte cp.async copies at ~25-40.
//
// The [T, B, S] walks of fb_scan_tbs.cu (K3, K5) use the same group sums
// and reciprocal; their w is staged row by row (RowStager: a warp's lanes
// at one frame are one row of the time-major tensor, and consecutive
// frames' rows are B * S values apart).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fb_step {

constexpr float kTiny = 1e-37f;  // the normalizer's floor, a normal float32
constexpr float kHuge = 1e30f;   // above it 1 / c nears the subnormal range
constexpr int kStages = 3;       // chunks of w in the shared-memory ring
constexpr int kChunkBytes = 8192;     // a chunk's target size
constexpr int kMaxChunkFrames = 128;  // and its bounds in frames
constexpr int kMinChunkFrames = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_io(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_io(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- which threads hold a lane ------------------------------------------

// Group width G and speakers per thread P for S speakers (S <= 256): a
// function of S alone, never of the batch, so that a lane's sums run in the
// same order whatever lanes share its launch.
inline void pick_group(int S, int* G, int* P) {
  *P = S <= 128 ? 4 : 8;
  int g = 1;
  while (g * *P < S) g <<= 1;
  *G = g;
}

// log2 of the frames per staged chunk, from the bytes of one frame.
inline int pick_log_chunk(int frame_bytes) {
  int log_f = 0;
  while ((2 << log_f) * frame_bytes <= kChunkBytes) ++log_f;
  int lo = 0, hi = 0;
  while ((1 << lo) < kMinChunkFrames) ++lo;
  while ((1 << hi) < kMaxChunkFrames) ++hi;
  return log_f < lo ? lo : (log_f > hi ? hi : log_f);
}

// Bytes in front of and behind a chunk in its ring buffer: room for one
// frame, so that the step's read of the frame to come needs no test for the
// chunk's end (what it reads there is never used).
__host__ __device__ inline int ring_pad_bytes(int frame_bytes) {
  return (frame_bytes + 15) / 16 * 16;
}

// Bytes of one ring buffer for chunks of `chunk_bytes`: the 16-byte-aligned
// run that covers a chunk starting anywhere, a frame's room on either side,
// padded so that the buffers of the 32 / G lanes of a warp start in
// different shared-memory banks.
inline int ring_stride_bytes(int chunk_bytes, int frame_bytes, int G) {
  int words = ((chunk_bytes + 15) / 16 * 16 + 16 +
               2 * ring_pad_bytes(frame_bytes)) / 4;
  const int want = (G < 4 ? 4 : G) % 32;
  while (words % 32 != want) words += 4;
  return words * 4;
}

// Bytes between consecutive rows in a RowStager buffer, for rows of at most
// `row_bytes` (a multiple of 4) that lie `frame_stride_bytes` apart in the
// tensor: the least stride >= row_bytes + 12 that is congruent to the frame
// stride modulo 16. A bulk copy keeps an address's offset modulo 16, so
// with this stride the rows of a chunk land exactly one stride apart
// whatever their offsets, and the walk moves its read pointer by a
// constant. The copies of two neighbouring rows never overlap: with o and
// o' their offsets from a 16-byte boundary, row r's aligned run ends
// ceil16(o + row_bytes) - o bytes after its first byte lands and row
// r + 1's begins stride - o' bytes after it; ceil16(o + row_bytes) - o + o'
// is at most row_bytes + 27 and congruent to the frame stride modulo 16
// (o' = o + frame stride, modulo 16), so it is at most the stride. The rows
// of a buffer are read one at a time by the whole warp, so they need no
// padding against bank conflicts.
inline int row_stride_bytes(int row_bytes, long long frame_stride_bytes) {
  int stride = row_bytes + 12;
  while ((stride - frame_stride_bytes) % 16 != 0) stride += 4;
  return stride;
}

// Bytes of one RowStager buffer for chunks of 2^log_f rows: one stride in
// front (the backward walk reads one row before a chunk), the rows, one
// stride behind (the forward walk reads one row past it) and 16 bytes for
// the first row's offset, in multiples of 16.
inline int row_ring_bytes(int stride, int log_f) {
  return ((stride + 15) / 16 * 16 + ((1 << log_f) + 1) * stride + 16 + 15) /
         16 * 16;
}

// ---- sums ---------------------------------------------------------------

template <int P>
__device__ __forceinline__ float tree_sum(const float (&v)[P]) {
  static_assert(P == 1 || P == 2 || P == 4 || P == 8, "P is a power of two");
  float t[P];
#pragma unroll
  for (int k = 0; k < P; ++k) t[k] = v[k];
#pragma unroll
  for (int h = P / 2; h > 0; h /= 2)
#pragma unroll
    for (int k = 0; k < h; ++k) t[k] += t[k + h];
  return t[0];
}

// Sum over an aligned group of G threads of a warp; every thread of the
// group gets the same total. All 32 threads of the warp take part.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Two sums side by side in one butterfly (the shuffles of a round overlap).
template <int G>
__device__ __forceinline__ void group_sum2(float& a, float& b) {
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    const float ta = __shfl_xor_sync(0xffffffffu, a, o);
    const float tb = __shfl_xor_sync(0xffffffffu, b, o);
    a += ta;
    b += tb;
  }
}

// ---- the normalizing reciprocal -----------------------------------------

// 1 / max(c_raw, kTiny): the hardware approximation (1 ulp) of the floored
// sum, a normal number whose reciprocal is normal too, so the
// approximation's flush-to-zero touches neither. Two frames get the IEEE
// division instead, behind a branch that is almost never taken: one whose
// sum is at the floor (its messages have underflowed towards the subnormal
// range; `floor_exact` false leaves it out, for a caller that skips such
// frames anyway) and one whose sum is absurdly large (the reciprocal would
// near the subnormal range). The approximation is issued first, so the
// branch resolves while it is in flight.
__device__ __forceinline__ float norm_recip(float c_raw, bool floor_exact) {
  const float c = fmaxf(c_raw, kTiny);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(c));
  if ((floor_exact && !(c_raw > kTiny)) || c_raw >= kHuge) r = 1.f / c;
  return r;
}

// ---- staging w through shared memory ------------------------------------

// An mbarrier (8 bytes of shared memory) counts the bytes of one bulk copy:
// the thread that starts the copy arrives on it with the byte count, the
// copy engine completes it when the bytes have landed, and every thread
// that waits for that phase then sees them.
__device__ __forceinline__ unsigned smem_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(void* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(
                   smem_address(mbar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// an mbarrier whose phase completes after `count` arrivals (and their bytes)
__device__ __forceinline__ void mbar_init_count(void* mbar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_address(mbar)),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
// waits until the barrier has completed its phase number `use` (0, 1, ...)
__device__ __forceinline__ void mbar_wait(void* mbar, int use) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_address(mbar)), "r"(use & 1)
        : "memory");
  } while (!done);
}
// One asynchronous bulk copy of n bytes (a multiple of 16, source and
// destination 16-byte aligned) that completes a phase of `mbar`; with
// n == 0 the phase completes at once.
__device__ __forceinline__ void bulk_copy(void* smem, uintptr_t gmem,
                                          unsigned n, void* mbar) {
  const unsigned bar = smem_address(mbar);
  if (n == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(n)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_address(smem)),
      "l"(gmem), "r"(n), "r"(bar)
      : "memory");
}

// Copies the bytes [s, e) of a tensor that occupies [lo, hi) into `buf`
// (16-byte aligned) so that the byte at address a lands at
// buf + (a - (s & ~15)), completing one phase of `mbar`; `tid` is this
// thread's number among the `nthreads` that call it together. A bulk copy
// needs source and destination 16-byte aligned and a size that is a
// multiple of 16, and a chunk of frames starts wherever
// b * T * S * sizeof(IO) puts it, so what thread 0 copies is the aligned run
// [v0, v1) that covers the chunk; it may take in bytes of the neighbouring
// frames but never bytes outside the tensor: where the aligned run would
// cross lo or hi (the first chunk of the first lane, the last of the last)
// it is cut by 16 bytes and the few elements between are loaded one by one
// (ordinary loads and stores: the barrier that follows the wait publishes
// them).
template <typename IO>
__device__ __forceinline__ void stage_bytes(uintptr_t lo, uintptr_t hi,
                                            uintptr_t s, uintptr_t e,
                                            char* buf, void* mbar, int tid,
                                            int nthreads) {
  const uintptr_t r0 = s & ~static_cast<uintptr_t>(15);
  const uintptr_t r1 = (e + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t v0 = r0 < lo ? r0 + 16 : r0;
  const uintptr_t v1 = r1 > hi ? r1 - 16 : r1;
  if (tid == 0)
    bulk_copy(buf + (v0 - r0), v0,
              v1 > v0 ? static_cast<unsigned>(v1 - v0) : 0u, mbar);
  if (r0 < lo) {
    const uintptr_t x1 = v0 < e ? v0 : e;
    for (uintptr_t a = s + sizeof(IO) * tid; a < x1;
         a += sizeof(IO) * nthreads)
      *reinterpret_cast<IO*>(buf + (a - r0)) =
          *reinterpret_cast<const IO*>(a);
  }
  if (r1 > hi) {
    const uintptr_t x0 = v1 > s ? v1 : s;
    for (uintptr_t a = x0 + sizeof(IO) * tid; a < e;
         a += sizeof(IO) * nthreads)
      *reinterpret_cast<IO*>(buf + (a - r0)) =
          *reinterpret_cast<const IO*>(a);
  }
}

// The ring of one walk: `n_frames` frames of S values, contiguous from
// address `first`, cut into chunks of 1 << log_f frames (the last may be
// short) and walked forward (chunk 0 first) or backward (last chunk first).
// Chunk number q of the walk lives in buffer q % kStages, a frame's room
// (ring_pad_bytes) after its start, and completes the (q / kStages)-th
// phase of that buffer's mbarrier. `tid` of `nthreads` threads own the
// ring together and all read every frame: the G threads of a lane's group
// (BLOCK false: they share a warp, and the barrier is __syncwarp) or the
// whole block (BLOCK true: __syncthreads).
//
// begin() sets up the mbarriers and starts the first kStages - 1 chunks.
// enter(q), called by every thread when the walk comes to chunk q (0
// included) and holds no unread frame of chunk q - 1 outside its
// registers, waits for chunk q, meets the other threads (after which chunk
// q - 1's buffer is free) and starts chunk q + kStages - 1 into that
// buffer. Every started chunk is entered, so nothing is in flight at the
// end.
template <typename IO, bool BLOCK>
struct Stager {
  uintptr_t lo, hi, first;
  char* ring;
  unsigned long long* mbars;
  int stride, front, n_frames, S, log_f, n_chunks, tid, nthreads;
  bool forward;

  // mbar_base: kStages mbarriers (8 bytes each, 8-byte aligned)
  __device__ __forceinline__ void init(const IO* tensor, size_t n_elements,
                                       const IO* first_frame, int frames,
                                       int speakers, int log_frames,
                                       bool fwd, char* ring_base,
                                       int stride_bytes, char* mbar_base,
                                       int thread, int threads) {
    lo = reinterpret_cast<uintptr_t>(tensor);
    hi = lo + n_elements * sizeof(IO);
    first = reinterpret_cast<uintptr_t>(first_frame);
    ring = ring_base;
    mbars = reinterpret_cast<unsigned long long*>(mbar_base);
    stride = stride_bytes;
    front = ring_pad_bytes(speakers * static_cast<int>(sizeof(IO)));
    n_frames = frames;
    S = speakers;
    log_f = log_frames;
    n_chunks = (frames + (1 << log_frames) - 1) >> log_frames;
    forward = fwd;
    tid = thread;
    nthreads = threads;
  }

  __device__ __forceinline__ void barrier() const {
    if (BLOCK)
      __syncthreads();
    else
      __syncwarp();
  }

  // address of the first byte of chunk c of the tensor
  __device__ __forceinline__ uintptr_t chunk_start(int c) const {
    return first + (static_cast<size_t>(c) << log_f) * S * sizeof(IO);
  }

  // whether the walk's chunk q is copied at all
  __device__ __forceinline__ bool staged(int q) const { return q < n_chunks; }

  __device__ __forceinline__ void start(int q) {
    if (staged(q))
      stage_bytes<IO>(lo, hi, chunk_start(chunk_of(q)),
                      first + static_cast<size_t>(chunk_hi(q)) * S * sizeof(IO),
                      ring + (q % kStages) * stride + front,
                      mbars + q % kStages, tid, nthreads);
  }

  __device__ __forceinline__ void enter(int q) {
    if (staged(q)) mbar_wait(mbars + q % kStages, q / kStages);
    barrier();
    start(q + kStages - 1);
  }

  __device__ __forceinline__ void begin() {
    if (tid == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) mbar_init(mbars + i);
    }
    barrier();
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) start(q);
  }

  // number in the tensor of the walk's chunk q, and its frames [lo, hi)
  __device__ __forceinline__ int chunk_of(int q) const {
    return forward ? q : n_chunks - 1 - q;
  }
  __device__ __forceinline__ int chunk_lo(int q) const {
    return chunk_of(q) << log_f;
  }
  __device__ __forceinline__ int chunk_hi(int q) const {
    return min((chunk_of(q) + 1) << log_f, n_frames);
  }

  // frame chunk_lo(q) in the ring (chunk q must have been entered); the
  // chunk's later frames follow it, S values each
  __device__ __forceinline__ const IO* chunk_data(int q) const {
    return reinterpret_cast<const IO*>(
        ring + (q % kStages) * stride + front +
        (chunk_start(chunk_of(q)) & 15));
  }
};

// The ring of one warp's walk over a time-major [T, B, S] tensor, whose
// 32 / G lanes at frame t are one row of `row_elements` values starting at
// `first_row` + t * `frame_elements`. Frames are cut into chunks of
// 1 << log_f rows (the last may be short), walked forward or backward as
// in Stager; the walk's chunk q lives in buffer q % kStages and completes
// the (q / kStages)-th phase of that buffer's mbarrier. Each row is one
// bulk copy of its 16-byte-aligned run, issued by thread r % 32 for row r
// of a chunk through stage_bytes (cut where the run would leave the
// tensor, the few elements there loaded singly by the same thread). The
// mbarrier counts one arrival per row of a full chunk; rows past a short
// chunk's end arrive with no copy, so a phase completes when every row has
// landed. Row r of chunk q lands at chunk_data(q) + r * stride bytes
// (row_stride_bytes). The warp owns the ring: begin() and enter() as in
// Stager, meeting at __syncwarp.
template <typename IO>
struct RowStager {
  uintptr_t lo, hi, first;
  size_t frame_stride;
  char* ring;
  unsigned long long* mbars;
  int stride, buf_bytes, front, row_bytes, n_frames, log_f, n_chunks, lane;
  bool forward;

  // mbar_base: kStages mbarriers (8 bytes each, 8-byte aligned); ring_base
  // and buffer_bytes multiples of 16
  __device__ __forceinline__ void init(const IO* tensor, size_t n_elements,
                                       const IO* first_row,
                                       size_t frame_elements,
                                       int row_elements, int frames,
                                       int log_frames, bool fwd,
                                       char* ring_base, int stride_bytes,
                                       int buffer_bytes, char* mbar_base,
                                       int thread) {
    lo = reinterpret_cast<uintptr_t>(tensor);
    hi = lo + n_elements * sizeof(IO);
    first = reinterpret_cast<uintptr_t>(first_row);
    frame_stride = frame_elements * sizeof(IO);
    ring = ring_base;
    mbars = reinterpret_cast<unsigned long long*>(mbar_base);
    stride = stride_bytes;
    buf_bytes = buffer_bytes;
    front = (stride_bytes + 15) / 16 * 16;
    row_bytes = row_elements * static_cast<int>(sizeof(IO));
    n_frames = frames;
    log_f = log_frames;
    n_chunks = (frames + (1 << log_frames) - 1) >> log_frames;
    forward = fwd;
    lane = thread;
  }

  // address of the first byte of frame t's row
  __device__ __forceinline__ uintptr_t row_start(int t) const {
    return first + static_cast<size_t>(t) * frame_stride;
  }

  // whether the walk's chunk q is copied at all
  __device__ __forceinline__ bool staged(int q) const { return n_chunks > q; }

  __device__ __forceinline__ int chunk_of(int q) const {
    return forward ? q : n_chunks - 1 - q;
  }
  __device__ __forceinline__ int chunk_lo(int q) const {
    return chunk_of(q) << log_f;
  }
  __device__ __forceinline__ int chunk_hi(int q) const {
    return min((chunk_of(q) + 1) << log_f, n_frames);
  }

  // where the first byte of chunk q's first row lands
  __device__ __forceinline__ char* chunk_slot(int q) const {
    return ring + (q % kStages) * buf_bytes + front +
           (row_start(chunk_lo(q)) & 15);
  }

  __device__ __forceinline__ void start(int q) {
    if (!staged(q)) return;
    const int t0 = chunk_lo(q), n = chunk_hi(q) - t0;
    char* slot = chunk_slot(q);
    void* mbar = mbars + q % kStages;
    for (int r = lane; r < (1 << log_f); r += 32) {
      if (r < n) {
        const uintptr_t s = row_start(t0 + r);
        // 16-byte aligned: stride = frame_stride (mod 16)
        stage_bytes<IO>(lo, hi, s, s + row_bytes,
                        slot + r * stride - (s & 15), mbar, 0, 1);
      } else {
        bulk_copy(slot, 0, 0u, mbar);  // no such row: arrive alone
      }
    }
  }

  __device__ __forceinline__ void enter(int q) {
    if (staged(q)) mbar_wait(mbars + q % kStages, q / kStages);
    __syncwarp();
    start(q + kStages - 1);
  }

  __device__ __forceinline__ void begin() {
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kStages; ++i)
        mbar_init_count(mbars + i, 1 << log_f);
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) start(q);
  }

  // chunk q's first row in the ring (chunk q must have been entered); row
  // r of the chunk follows it at r * stride bytes
  __device__ __forceinline__ const IO* chunk_data(int q) const {
    return reinterpret_cast<const IO*>(chunk_slot(q));
  }
};

// Reads this thread's speakers (s = g + G k) of one frame; absent speakers
// read as 0.
template <typename IO, int G, int P>
__device__ __forceinline__ void read_frame(const IO* frame, int g, int S,
                                           float (&out)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int s = g + G * k;
    out[k] = s < S ? to_f32(frame[s]) : 0.f;
  }
}

template <typename IO, int G, int P>
__device__ __forceinline__ void write_frame(IO* frame, int g, int S,
                                            const float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int s = g + G * k;
    if (s < S) store_io(frame + s, v[k]);
  }
}

}  // namespace fb_step
