// NN-chain average-linkage walk over the cluster-sums identity, all lanes
// to their end in one cooperative launch.
//
// Replaces vbx_tpu/clustering/device.py:_nn_chain_batched_jit, the XLA
// lax.while_loop that walks Muellner's nearest-neighbour chain on the
// accelerator (no Pallas kernel: vbx_tpu left the loop to XLA). With
// average linkage over d(i, j) = -(x_i . x_j), the distance of two
// clusters is -(S_a . S_x) / (n_a n_x), where S is a cluster's row sum and
// n its size, so every nearest-neighbour scan of the chain's tip is one
// [N, D] matrix-vector product over the cluster sums, and a merge is
// S_b += S_a, n_b += n_a.
//
// One step of a lane (a recording), as in vbx_tpu's lane body:
//   a = chain tip; scan d(a, x) over every active x != a (lowest index on
//   ties); the chain's predecessor p wins ties (d(a, p) <= dmin)
//   and then a and p merge (S_p += S_a, a deactivated, both popped, the
//   triple (a, p, d) recorded); otherwise the nearest x is pushed. An empty
//   chain is seeded with the lowest active index. The walk ends when a lane
//   has recorded N - 1 merges. A lane whose tip is an inactive cluster
//   (rounding broke reducibility: clustering/device.py) sets `bad` and
//   stops; so does a lane still walking after 4 N + 4 steps, which no
//   correct walk takes.
//
// Precision. The sums, sizes and distances are float64, the host chain's
// precision (vbx_tpu walks in float32, which its TPU is limited to). In
// float32, two candidate merges whose distances differ by less than ~1e-7
// are a coin toss: on 16384 synthetic x-vectors in 8 clusters (D = 128) a
// float32 walk on this card chose the other of two merges 1.5e-9 apart,
// and one cluster of the dendrogram (1,348 rows against the host's 1,345)
// and a merge distance (9.5e-6) came out differently. The H100 has float64
// at half the float32 rate, and the walk is bound by its step latency, not
// by arithmetic, so it takes the host's precision.
//
// Design. A step is two phases separated by grid barriers
// (cooperative_groups::this_grid().sync()), so the loop needs no host round
// trip and ends when a count of live lanes, read after a barrier, is 0:
// - Phase A, scan. Rows are cut into chunks of kChunkRows; block g scans
//   chunks g, g + gridDim, ... of every live lane, with the tip's sum row in
//   shared memory; a warp takes one row at a time (32 lanes stride the D
//   columns, then a shuffle butterfly), and each chunk leaves one (dmin,
//   argmin) partial. The block that meets the predecessor's row stores its
//   distance, so the tie rule compares the very value the scan saw.
// - Phase B, update. Block m owns lane m (m + gridDim, ... past the grid):
//   it reduces the lane's partials, applies the predecessor rule, does the
//   merge (D threads add S_a into S_b) or the push, seeds an empty chain,
//   checks the new tip, and adds the lane to the next step's live count.
// The minimum is taken as the least (distance, index) pair, an order-free
// reduction, and a row's dot is summed in a fixed order that depends on D
// alone: a lane's merges and distances are bit-equal whether it runs alone,
// among other lanes, or at another grid size.
//
// Bound. A step of a lane with k merges made reads the rows and sizes of
// its n - k live clusters (the tip's row too), (n - k) (D + 1) 8 bytes, and
// its n active flags, 4 n bytes; the kernel sums n - k over the lane's
// steps (`rows`) so that a bound counts what the walk read. The sums, at
// most N * D * 8 bytes (10.2 MB at N = 10000, D = 128), stay in the 50 MB
// L2 through the walk, so those bytes over the HBM rate (3.35 TB/s)
// overstate the time reading them needs. The floor is not that either:
// each step pays two grid barriers and a few dependent L2 round trips of
// the lane's bookkeeping in phase B (the chain tip, the sizes, the
// partials), several microseconds whatever N is. The design keeps each
// step to those two barriers, spreads a step's rows over every SM (a chunk
// of 32 rows a block), and keeps the bookkeeping to one thread of one
// block a lane; the grid is capped at a few blocks an SM because a
// barrier's cost grows with the number of blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 32;  // rows a (lane, chunk) partial covers
constexpr int kRowsPerWarp = kChunkRows / kWarps;
constexpr int kMaxD = 4096;     // the tip's row in dynamic shared memory
constexpr double kInf = __builtin_huge_val();

// Lane state, int32 [M, kStateInts]; the header phase A reads, int32
// [M, kHdrInts]: live, tip a, predecessor (-1: none); |a| is in size_a.
enum { kClen, kK, kMerges, kBad, kSteps, kFirst, kN, kStateInts = 8 };
enum { kLive, kTip, kPrev, kHdrInts = 4 };

struct Walk {
  double* sums;    // [M, Np, D] cluster row sums (updated in place)
  double* sizes;   // [M, Np] cluster sizes
  int* active;     // [M, Np]
  int* chain;      // [M, Np + 2]
  int* state;      // [M, kStateInts]
  int* hdr;        // [M, kHdrInts]
  double* size_a;  // [M] the tip's size
  int* ma;         // [M, Np - 1] merge triples, in chain order
  int* mb;
  double* md;
  double* part_d;  // [M, nch] (dmin, argmin) partials
  int* part_i;
  double* dprev;   // [M] distance of the tip to its predecessor
  int* live;       // [2] live lanes, alternating between steps
  long long* rows; // [M] live clusters summed over the lane's scans
  int M, Np, D, nch;
};

__device__ __forceinline__ bool less_pair(double d, int i, double bd,
                                          int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void warp_min_pair(double& d, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const double od = __shfl_xor_sync(0xffffffffu, d, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (less_pair(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// Every lane of the warp gets the same bits: the butterfly adds the same
// two operands on both partners of each exchange.
__device__ __forceinline__ double row_dot(const double* row, const double* sa,
                                          int D, int lane) {
  double acc = 0.0;
  for (int j = lane; j < D; j += 32) acc = fma(__ldcg(row + j), sa[j], acc);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// Least (d, i) over the block; the result is valid in thread 0.
__device__ __forceinline__ void block_min_pair(double& d, int& i, double* sd,
                                               int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_min_pair(d, i);
  if (lane == 0) {
    sd[warp] = d;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    d = lane < kWarps ? sd[lane] : kInf;
    i = lane < kWarps ? si[lane] : INT_MAX;
    warp_min_pair(d, i);
  }
  __syncthreads();
}

__device__ void scan_phase(const Walk& w, double* sa, double* sd, int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = 0; m < w.M; ++m) {
    const int4 h = __ldcg(reinterpret_cast<const int4*>(w.hdr) + m);
    if (!h.x) continue;
    const int n = __ldcg(w.state + m * kStateInts + kN);
    const int nch = (n + kChunkRows - 1) / kChunkRows;
    if (static_cast<int>(blockIdx.x) >= nch) continue;
    const int a = h.y, prev = h.z;
    const double na = __ldcg(w.size_a + m);
    const double* lane_sums = w.sums + static_cast<size_t>(m) * w.Np * w.D;
    const double* lane_sizes = w.sizes + static_cast<size_t>(m) * w.Np;
    const int* lane_active = w.active + static_cast<size_t>(m) * w.Np;
    for (int j = threadIdx.x; j < w.D; j += kThreads)
      sa[j] = __ldcg(lane_sums + static_cast<size_t>(a) * w.D + j);
    __syncthreads();
    for (int c = blockIdx.x; c < nch; c += gridDim.x) {
      double bd = kInf;
      int bi = INT_MAX;
      const int x0 = c * kChunkRows + warp * kRowsPerWarp;
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int x = x0 + r;
        if (x >= n) break;
        // a merged-away row is not read (x is the same in the whole warp)
        const bool valid = __ldcg(lane_active + x) != 0 && x != a;
        const double d =
            valid ? -row_dot(lane_sums + static_cast<size_t>(x) * w.D, sa,
                             w.D, lane) /
                        (__ldcg(lane_sizes + x) * na)
                  : kInf;
        if (x == prev && lane == 0) w.dprev[m] = d;
        if (less_pair(d, x, bd, bi)) {
          bd = d;
          bi = x;
        }
      }
      block_min_pair(bd, bi, sd, si);
      if (threadIdx.x == 0) {
        w.part_d[static_cast<size_t>(m) * w.nch + c] = bd;
        w.part_i[static_cast<size_t>(m) * w.nch + c] = bi;
      }
    }
    __syncthreads();  // sa is rewritten for the next lane
  }
}

__device__ void update_phase(const Walk& w, int next, double* sd, int* si,
                             int* sh) {
  for (int m = blockIdx.x; m < w.M; m += gridDim.x) {
    int* hdr = w.hdr + m * kHdrInts;
    if (!__ldcg(hdr + kLive)) continue;
    int* st = w.state + m * kStateInts;
    const int n = __ldcg(st + kN);
    const int nch = (n + kChunkRows - 1) / kChunkRows;
    double bd = kInf;
    int bi = INT_MAX;
    for (int c = threadIdx.x; c < nch; c += kThreads) {
      const double d = __ldcg(w.part_d + static_cast<size_t>(m) * w.nch + c);
      const int i = __ldcg(w.part_i + static_cast<size_t>(m) * w.nch + c);
      if (less_pair(d, i, bd, bi)) {
        bd = d;
        bi = i;
      }
    }
    block_min_pair(bd, bi, sd, si);
    double* lane_sums = w.sums + static_cast<size_t>(m) * w.Np * w.D;
    double* sizes = w.sizes + static_cast<size_t>(m) * w.Np;
    int* active = w.active + static_cast<size_t>(m) * w.Np;
    int* chain = w.chain + static_cast<size_t>(m) * (w.Np + 2);
    int clen = 0, k = 0;  // thread 0's
    if (threadIdx.x == 0) {
      const int a = __ldcg(hdr + kTip), prev = __ldcg(hdr + kPrev);
      const double dprev = prev >= 0 ? __ldcg(w.dprev + m) : kInf;
      const bool merge = prev >= 0 && dprev <= bd;
      const int b = merge ? prev : bi;
      sh[0] = merge;
      sh[1] = a;
      sh[2] = b;
      clen = __ldcg(st + kClen);
      k = __ldcg(st + kK);
      // this step's scan read the n - k live clusters' rows (the tip's too)
      w.rows[m] = __ldcg(w.rows + m) + (n - k);
      if (merge) {
        const size_t o = static_cast<size_t>(m) * (w.Np - 1) + k;
        w.ma[o] = a;
        w.mb[o] = b;
        w.md[o] = dprev;
        ++k;
        sizes[b] = __ldcg(sizes + b) + __ldcg(sizes + a);
        active[a] = 0;
        clen -= 2;
      } else {
        chain[clen++] = b;
      }
    }
    __syncthreads();
    if (sh[0]) {
      const double* ra = lane_sums + static_cast<size_t>(sh[1]) * w.D;
      double* rb = lane_sums + static_cast<size_t>(sh[2]) * w.D;
      for (int j = threadIdx.x; j < w.D; j += kThreads)
        rb[j] = __ldcg(rb + j) + __ldcg(ra + j);
    }
    if (threadIdx.x == 0) {
      const int nm = __ldcg(st + kMerges);
      const int steps = __ldcg(st + kSteps) + 1;
      int bad = 0;
      int tip = -1, prev = -1;
      if (k < nm) {
        if (clen == 0) {  // seed: the lowest active index, which only grows
          int first = __ldcg(st + kFirst);
          while (first < n - 1 && !__ldcg(active + first)) ++first;
          st[kFirst] = first;
          chain[0] = first;
          clen = 1;
        }
        tip = __ldcg(chain + clen - 1);
        prev = clen >= 2 ? __ldcg(chain + clen - 2) : -1;
        bad = !__ldcg(active + tip) || steps >= 4 * n + 4;
      }
      st[kK] = k;
      st[kClen] = clen;
      st[kSteps] = steps;
      st[kBad] = bad;
      const int live = k < nm && !bad;
      hdr[kLive] = live;
      hdr[kTip] = tip;
      hdr[kPrev] = prev;
      if (live) w.size_a[m] = __ldcg(sizes + tip);
      if (live) atomicAdd(w.live + next, 1);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) nn_chain_kernel(Walk w) {
  extern __shared__ double sa[];
  __shared__ double sd[kWarps];
  __shared__ int si[kWarps];
  __shared__ int sh[3];
  cg::grid_group grid = cg::this_grid();
  for (int s = 0;; ++s) {
    grid.sync();
    if (__ldcg(w.live + (s & 1)) == 0) break;
    // the other count was last read at the top of the previous step
    if (blockIdx.x == 0 && threadIdx.x == 0) w.live[(s + 1) & 1] = 0;
    scan_phase(w, sa, sd, si);
    grid.sync();
    update_phase(w, (s + 1) & 1, sd, si, sh);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). The caller has set every lane's
// state, header, sums, sizes, active flags, zeroed rows and the first live
// count (see vbx_tpu_torch/clustering/device.py). Launches cooperatively on
// `stream` with blocks_per_sm blocks an SM (0: as many as fit, at most 2),
// does not synchronize, allocates nothing; writes the grid size to
// *grid_out and returns a CUDA error code (0 = cudaSuccess).
extern "C" int nn_chain_walk_launch(void* sums, void* sizes, void* active,
                                    void* chain, void* state, void* hdr,
                                    void* size_a, void* ma, void* mb,
                                    void* md, void* part_d, void* part_i,
                                    void* dprev, void* live, void* rows,
                                    int M, int Np, int D, int nch,
                                    int blocks_per_sm, void* stream,
                                    int* grid_out) {
  if (M < 1 || Np < 2 || D < 1 || D > kMaxD || nch < 1 ||
      static_cast<long long>(nch) * kChunkRows < Np)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = static_cast<size_t>(D) * sizeof(double);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nn_chain_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int want = blocks_per_sm > 0 ? blocks_per_sm : 2;
  if (per_sm < 1 || want > per_sm)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Walk w{static_cast<double*>(sums),  static_cast<double*>(sizes),
         static_cast<int*>(active),    static_cast<int*>(chain),
         static_cast<int*>(state),     static_cast<int*>(hdr),
         static_cast<double*>(size_a), static_cast<int*>(ma),
         static_cast<int*>(mb),        static_cast<double*>(md),
         static_cast<double*>(part_d), static_cast<int*>(part_i),
         static_cast<double*>(dprev),  static_cast<int*>(live),
         static_cast<long long*>(rows), M, Np, D, nch};
  const int grid = want * sms;
  *grid_out = grid;
  void* args[] = {&w};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&nn_chain_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
