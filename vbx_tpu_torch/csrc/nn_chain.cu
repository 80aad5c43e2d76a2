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
// Design. The walk is bound by the latency of a step, not by its bytes,
// so a step is built around one exchange between the blocks and nothing
// else that waits on another block (no grid barrier):
// - Rows belong to blocks by a fixed map: block g owns rows [g R, g R + R)
//   of a lane of n rows, R = ceil(n / gridDim). The owner alone scans its
//   rows and alone writes them; it keeps the first Rc of them, and their
//   sizes, in shared memory (as many as fit beside the lanes' replicas).
// - Every block keeps a replica of each lane's bookkeeping in shared
//   memory: tip, predecessor, chain length, merges made, the lowest index
//   that may still be active, steps, rows scanned, `bad`, and the active
//   set as a bitmap (N / 8 bytes). Every block reduces the same partials
//   with the same order-free rule and applies the same predecessor rule,
//   so the replicas never differ and no block waits on another's update.
// - Every block stages the tip's row S_a and the predecessor's row S_p of
//   each live lane in shared memory, with their sizes, and forms a merge's
//   new row S_p + S_a itself (the same bits as the owner writes).
// - d(a, p), which the predecessor rule compares with the scan's minimum,
//   is not computed again: it is the minimum of the step that pushed a
//   (the scan's d(p, a)), kept with the chain entry (chain_d). A row in
//   the chain and its size are unchanged since its push, and the dot and
//   the size product are symmetric to the bit (fma(x, y, z) = fma(y, x,
//   z)), so it is the value a scan of row p would give now.
// - A step: scan the block's rows of every live lane, with no barrier
//   between lanes (four lanes of a warp share a row, so a warp has 8 rows
//   in flight); reduce them to one (dmin, argmin) partial a lane; publish
//   the partials tagged with the step number (release); acquire every
//   block's tag of the step (thread j spins on block j's), then every
//   block's records; decide; stage the next step's rows. The owner of the
//   merged row b writes S_b = S_p + S_a and n_b; one block (block 0)
//   writes the chain entries, their distances and the merge triples; one
//   of the last threads of each block updates the replica (its loads are
//   in flight while the others stage the rows).
// The cooperative launch is what lets a block spin on another: it
// guarantees that every block of the grid is resident.
//
// What each cross-block read sees. Exchange s is the publication of the
// step-s partials. A block writes global memory only between its acquire
// of exchange s and its publication of exchange s + 1 (the merge's row and
// size, the chain entry and its distance, the triple); the publication is
// a release (the block's threads meet at __syncthreads, then one thread
// stores the tag with st.release.gpu: the order a grid barrier's arrival
// gives), so whatever a block wrote in step s is visible to every block
// that has acquired exchange s + 1. The reads:
// - the partials of exchange s: the tag's ld.acquire.gpu, __syncthreads,
//   then the records (__ldcg, past the SM's L1);
// - the next tip's and predecessor's rows and sizes, read at the end of
//   step s, after the acquire of exchange s. Step s writes one row, b, the
//   merged one; every other row was last written in a step s' <= s - 1 and
//   published by exchange s' + 1 <= s. A tip or predecessor equal to b is
//   not read at all: it is S_p + S_a (and n_p + n_a), formed from the
//   staged rows. That is the seeding case: a merge that empties the chain
//   seeds it with the lowest active index, which may be b itself. (b is
//   the only row a step writes, and a row in the chain is unchanged since
//   its push: b is always the predecessor, popped in the step that writes
//   it.)
// - the chain entries (and distances) the next step may pop, the two
//   below its tip, read at the end of step s: the tip was pushed in a step
//   <= s, so these were pushed in steps <= s - 2, written by block 0 then
//   and published by exchange s - 1 at the latest.
// - the owner's own rows and sizes: written and read by the same block,
//   between __syncthreads (plain loads: no other block writes them).
// Two slots of records, by step parity, are enough: a block writes the
// slot of step s + 2 only after it has acquired every block's tag of step
// s + 1, and a block publishes step s + 1 only after it has read the
// records of step s, so no block can run two exchanges ahead of another.
// The tags count up through the whole launch, so a tag never repeats.
//
// Batch invariance. The minimum is the least (distance, index) pair, an
// order-free reduction; a row's dot is summed in a fixed order that
// depends on D alone (row_part, row_sum); a merge is one add an element.
// A lane's merges, distances, steps and rows are bit-equal whether it runs
// alone, among other lanes, in another order, or at another grid size.
// Lanes are walked in groups of as many as the shared memory holds (Mg),
// every lane of a group to its end, in one launch.
//
// Bound. A step of a lane with k merges made reads the rows and sizes of
// its n - k live clusters (the tip's row too), (n - k) (D + 1) 8 bytes;
// the kernel sums n - k over the lane's steps (`rows`), so that a bound
// counts what the walk read. The sums, at most N * D * 8 bytes (10.2 MB at
// N = 10000, D = 128), stay in shared memory and the 50 MB L2 through the
// walk, so those bytes over the HBM rate (3.35 TB/s) overstate the time
// reading them needs (scripts/torch_nn_chain_tuning.py measures the L2
// rate too). The floor of a step is its round trips to L2: the
// publication's release, the tag, the records, the next tip's row.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesAtOnce = 4;   // lanes whose records a thread loads at once
constexpr int kRowLanes = 4;      // the lanes of a warp that share a row
constexpr int kMaxD = 4096;       // kept in step with clustering/device.py
constexpr int kMaxGroup = 32;     // lanes walked together, at most
constexpr int kDefaultBlocksPerSm = 1;
// the owner keeps the first of its rows of each lane in shared memory, as
// many as fit beside the lanes' replicas (the others are read through L2)
constexpr bool kOwnRowsInShared = true;
constexpr double kInf = __builtin_huge_val();
// polls of one tag before the kernel gives up (tens of seconds; a step
// waits about a microsecond)
constexpr long long kSpinLimit = 1LL << 25;

struct Rec {  // one block's partial of one lane
  double d;
  int i;
  int pad;
};

// A lane's replicated bookkeeping (each block's shared memory, two copies:
// step e reads copy e % 2 and its lane's thread writes copy (e + 1) % 2).
struct Lane {
  double na, np;    // sizes of the tip and the predecessor
  double dprev;     // d(a, p): the scan's minimum when a was pushed
  double dc3;       // d(chain[clen - 3], chain[clen - 4]), the same
  long long rows;   // live clusters summed over the lane's scans
  int n, a, p, clen, k, first, steps, bad, live;
  int lo, hi;       // the rows this block owns
  int c3, c4;       // chain[clen - 3], chain[clen - 4] (-1: none)
};

struct Walk {
  double* sums;      // [M, Np, D] cluster row sums (updated in place)
  double* sizes;     // [M, Np] cluster sizes (updated in place)
  const int* ns;     // [M]
  int* chain;        // [M, Np + 2]
  double* chain_d;   // [M, Np + 2] d(chain[k], chain[k - 1]) at its push
  int* ma;           // [M, Np - 1] merge triples, in chain order
  int* mb;
  double* md;
  int* bad;          // [M]
  int* steps;        // [M]
  long long* rows;   // [M]
  Rec* recs;         // [2, cap, Mg] the exchange's records
  int* tags;         // [2, cap] the step each block's records belong to
  int M, Np, D, Mg, W, Rc, cap;
};

// The stride of the owner's rows in shared memory: DS = 4 (mod 16), so
// that the 4 rows x 4 columns a half-warp reads at once lie in distinct
// banks.
__host__ __device__ __forceinline__ int own_stride(int D) {
  return D + (20 - D % 16) % 16;
}

// Shared memory of a block, in bytes from its start (the host sizes the
// launch with the same function): per lane, the staged tip and
// predecessor rows, Rc of the owner's rows and their sizes, the warps'
// partials of the scan (wd, wi) and of the exchange (xd, xi), the two
// copies of the replica and its bitmap.
struct Layout {
  size_t ra, rp, own, osz, wd, xd, lanes, wi, xi, bits, total;
  __host__ __device__ Layout(int Mg, int D, int Rc, int W) {
    size_t o = 0;
    ra = o;    o += sizeof(double) * Mg * D;
    rp = o;    o += sizeof(double) * Mg * D;
    own = o;
    o += sizeof(double) * static_cast<size_t>(Mg) * Rc * own_stride(D);
    osz = o;   o += sizeof(double) * Mg * Rc;
    wd = o;    o += sizeof(double) * Mg * kWarps;
    xd = o;    o += sizeof(double) * Mg * kWarps;
    lanes = o; o += sizeof(Lane) * 2 * Mg;
    wi = o;    o += sizeof(int) * Mg * kWarps;
    xi = o;    o += sizeof(int) * Mg * kWarps;
    bits = o;  o += sizeof(unsigned) * Mg * W;
    total = o;
  }
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

__device__ __forceinline__ bool active(const unsigned* bits, int x) {
  return (bits[x >> 5] >> (x & 31)) & 1u;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// a short sleep between polls of a tag: fewer polls reach L2 while the
// other blocks publish (5% off a step on the H100,
// scripts/torch_nn_chain_tuning.py)
__device__ __forceinline__ void spin_pause() { __nanosleep(32); }

// The dot of a row with the tip's row by the kRowLanes lanes that share
// it (lane q = 0 .. kRowLanes - 1 of them): lane q sums the columns
// j = q + kRowLanes c (mod 4 kRowLanes) in four chains c = 0..3, each in
// order, and adds them pairwise (row_part); then the lanes add their sums
// pairwise, lane bit 0, then bit 1, ... (row_sum). The order is set by D
// alone, and every lane of the row gets the same bits.
__device__ __forceinline__ double row_part(const double* row,
                                           const double* sa, int D, int q) {
  constexpr int S = kRowLanes;
  double c[4] = {0.0, 0.0, 0.0, 0.0};
  int j = q;
#pragma unroll 2
  for (; j + 3 * S < D; j += 4 * S)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c[k] = fma(row[j + S * k], sa[j + S * k], c[k]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (j + S * k < D) c[k] = fma(row[j + S * k], sa[j + S * k], c[k]);
  return (c[0] + c[1]) + (c[2] + c[3]);
}

__device__ __forceinline__ double row_sum(double v) {
#pragma unroll
  for (int o = 1; o < kRowLanes; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's rows of every live lane against the lane's staged tip row:
// kRowLanes lanes take one row at a time, so a warp has 32 / kRowLanes
// rows in flight; each
// warp's least (d, x) a lane goes into wd / wi. The owner's first Rc rows
// of a lane and their sizes are in shared memory (own_stride); the others
// are read with plain loads, since no other block writes them.
__device__ __forceinline__ void scan_lanes(const Walk& w, int g0, int mg,
                                           const double* ra,
                                           const double* own,
                                           const double* osz, Lane* lanes,
                                           const unsigned* bits, double* wd,
                                           int* wi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kRows = 32 / kRowLanes;  // rows a warp scans at once
  const int D = w.D, DS = own_stride(D), Rc = w.Rc, q = lane % kRowLanes;
  for (int l = 0; l < mg; ++l) {
    Lane& L = lanes[l];
    if (!L.live) continue;
    const double* sa = ra + static_cast<size_t>(l) * D;
    const unsigned* lb = bits + static_cast<size_t>(l) * w.W;
    const double* lane_sums =
        w.sums + static_cast<size_t>(g0 + l) * w.Np * D;
    const double* lane_own = own + static_cast<size_t>(l) * Rc * DS;
    const double* lane_osz = osz + static_cast<size_t>(l) * Rc;
    const double* lane_sizes = w.sizes + static_cast<size_t>(g0 + l) * w.Np;
    const double na = L.na;
    const int a = L.a, lo = L.lo, hi = L.hi;
    double bd = kInf;
    int bi = INT_MAX;
    for (int x0 = lo + warp * kRows; x0 < hi; x0 += kWarps * kRows) {
      const int x = x0 + lane / kRowLanes, r = x - lo;
      // a merged-away row is not read
      const bool ok = x < hi && x != a && active(lb, x);
      const bool in_shared = r < Rc;
      const double sz = !ok ? 1.0 : in_shared ? lane_osz[r] : lane_sizes[x];
      // two calls, so that each reads one kind of memory
      const double part =
          !ok ? 0.0
          : in_shared ? row_part(lane_own + static_cast<size_t>(r) * DS, sa,
                                 D, q)
                      : row_part(lane_sums + static_cast<size_t>(x) * D, sa,
                                 D, q);
      const double dot = row_sum(part);  // every lane takes part
      if (ok) {
        const double d = -dot / (sz * na);
        if (less_pair(d, x, bd, bi)) {
          bd = d;
          bi = x;
        }
      }
    }
    warp_min_pair(bd, bi);
    if (lane == 0) {
      wd[l * kWarps + warp] = bd;
      wi[l * kWarps + warp] = bi;
    }
  }
}

// What a step decides for a lane, from the exchange's partials (xd, xi)
// and the replica: every thread that needs it computes it, with the same
// result in every thread of every block.
struct Next {
  int merge, b, tip, prev, k, clen, first, bad, live;
  double d;      // the step's minimum: d(a, p) of a merge, d(a, b) of a push
  double dprev;  // d(tip, prev) of the next step
};

__device__ __forceinline__ bool active_now(const unsigned* bits, int x) {
  // the lane's thread may clear a's bit meanwhile: every reader treats a
  // as inactive already (decide)
  return (*reinterpret_cast<const volatile unsigned*>(bits + (x >> 5)) >>
          (x & 31)) & 1u;
}

__device__ __forceinline__ Next decide(const Lane& L, const double* xd,
                                       const int* xi, const unsigned* lb,
                                       int l) {
  double bd = kInf;
  int bi = INT_MAX;
  for (int v = 0; v < kWarps; ++v)
    if (less_pair(xd[l * kWarps + v], xi[l * kWarps + v], bd, bi)) {
      bd = xd[l * kWarps + v];
      bi = xi[l * kWarps + v];
    }
  Next x;
  const int n = L.n;
  x.merge = L.p >= 0 && L.dprev <= bd;
  x.d = x.merge ? L.dprev : bd;
  x.b = x.merge ? L.p : bi;
  x.k = L.k + x.merge;
  x.clen = x.merge ? L.clen - 2 : L.clen + 1;
  x.tip = x.merge ? L.c3 : x.b;
  x.prev = x.merge ? (x.clen >= 2 ? L.c4 : -1) : L.a;
  x.dprev = x.merge ? (x.clen >= 2 ? L.dc3 : kInf) : bd;
  x.first = L.first;
  x.bad = 0;
  // a is inactive after a merge, whatever its bit reads
  const int gone = x.merge ? L.a : -1;
  if (x.k < n - 1) {
    if (x.clen == 0) {  // seed: the lowest active index, which only grows
      int f = L.first;
      while (f < n - 1 && (f == gone || !active_now(lb, f))) ++f;
      x.first = f;
      x.clen = 1;
      x.tip = f;
      x.prev = -1;
      x.dprev = kInf;
    }
    x.bad = x.tip < 0 || x.tip >= n || x.tip == gone ||
            !active_now(lb, x.tip) || L.steps + 1 >= 4 * n + 4;
  }
  x.live = x.k < n - 1 && !x.bad;
  return x;
}

// two blocks an SM must fit: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2) nn_chain_kernel(Walk w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(w.Mg, w.D, w.Rc, w.W);
  double* ra = reinterpret_cast<double*>(smem + lay.ra);
  double* rp = reinterpret_cast<double*>(smem + lay.rp);
  double* own = reinterpret_cast<double*>(smem + lay.own);
  double* osz = reinterpret_cast<double*>(smem + lay.osz);
  double* wd = reinterpret_cast<double*>(smem + lay.wd);
  double* xd = reinterpret_cast<double*>(smem + lay.xd);
  Lane* lanes2 = reinterpret_cast<Lane*>(smem + lay.lanes);
  int* wi = reinterpret_cast<int*>(smem + lay.wi);
  int* xi = reinterpret_cast<int*>(smem + lay.xi);
  unsigned* bits = reinterpret_cast<unsigned*>(smem + lay.bits);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, D = w.D, W = w.W, Rc = w.Rc;
  const bool block0 = blockIdx.x == 0;
  int e = 0;  // the exchange (step) number, the same in every block

  for (int g0 = 0; g0 < w.M; g0 += w.Mg) {
    const int mg = min(w.Mg, w.M - g0);
    __syncthreads();  // the last group's replicas have been read
    Lane* lanes = lanes2 + (e & 1) * w.Mg;
    if (tid < mg) {
      Lane& L = lanes[tid];
      const int n = w.ns[g0 + tid];
      const int R = (n + G - 1) / G;
      L.n = n;
      L.lo = min(n, static_cast<int>(blockIdx.x) * R);
      L.hi = min(n, L.lo + R);
      L.a = 0;
      L.p = -1;
      L.clen = 1;  // the chain [0] (clustering/device.py zeroes it)
      L.k = L.first = L.steps = L.bad = 0;
      L.live = n >= 2;
      L.rows = 0;
      L.na = 1.0;
      L.np = 0.0;
      L.dprev = L.dc3 = kInf;
      L.c3 = L.c4 = -1;
    }
    for (int i = tid; i < mg * W; i += kThreads) {
      const int n = w.ns[g0 + i / W], x0 = (i % W) * 32;
      bits[i] = n >= x0 + 32 ? 0xffffffffu
              : n > x0       ? (1u << (n - x0)) - 1u : 0u;
    }
    __syncthreads();
    // the first tips (row 0) and the owner's first Rc rows of each lane
    for (int i = tid; i < mg * D; i += kThreads) {
      const int l = i / D, j = i % D;
      ra[i] = __ldcg(w.sums + static_cast<size_t>(g0 + l) * w.Np * D + j);
      rp[i] = 0.0;
    }
    for (int l = 0; l < mg; ++l) {
      const Lane& L = lanes[l];
      const size_t o = static_cast<size_t>(g0 + l) * w.Np + L.lo;
      const int rows = min(L.hi - L.lo, Rc);
      double* dst = own + static_cast<size_t>(l) * Rc * own_stride(D);
      for (int i = tid; i < rows * D; i += kThreads)
        dst[i / D * own_stride(D) + i % D] = __ldcg(w.sums + o * D + i);
      for (int r = tid; r < rows; r += kThreads)
        osz[static_cast<size_t>(l) * Rc + r] = __ldcg(w.sizes + o + r);
    }
    __syncthreads();

    for (;; ++e) {
      Lane* cur = lanes2 + (e & 1) * w.Mg;
      Lane* nxt = lanes2 + ((e + 1) & 1) * w.Mg;
      bool any = false;
      for (int l = 0; l < mg; ++l) any |= cur[l].live != 0;
      if (!any) break;
      const int slot = e & 1;
      scan_lanes(w, g0, mg, ra, own, osz, cur, bits, wd, wi);
      __syncthreads();

      // publish: the block's partial of every live lane, then the tag
      if (tid == 0) {
        Rec* rec = w.recs + (static_cast<size_t>(slot) * w.cap + blockIdx.x)
                                * w.Mg;
        for (int l = 0; l < mg; ++l) {
          if (!cur[l].live) continue;
          double bd = kInf;
          int bi = INT_MAX;
          for (int v = 0; v < kWarps; ++v)
            if (less_pair(wd[l * kWarps + v], wi[l * kWarps + v], bd, bi)) {
              bd = wd[l * kWarps + v];
              bi = wi[l * kWarps + v];
            }
          rec[l].d = bd;
          rec[l].i = bi;
        }
        // a release: with the __syncthreads above, it publishes every write
        // of this block's threads since its last acquire (the order a grid
        // barrier's arrival gives)
        st_release(w.tags + slot * w.cap + blockIdx.x, e);
      }
      // acquire: thread j polls block j's tag; after the barrier thread j
      // reads block j's records, and a warp reduces them a lane into xd / xi
      for (int j = tid; j < G; j += kThreads)
        for (long long t = 0; ld_acquire(w.tags + slot * w.cap + j) != e;
             ++t) {
          spin_pause();
          if (t > kSpinLimit) __trap();  // a lost block: fail, do not hang
        }
      __syncthreads();
      for (int l0 = 0; l0 < mg; l0 += kLanesAtOnce) {
        double bd[kLanesAtOnce];
        int bi[kLanesAtOnce];
#pragma unroll
        for (int u = 0; u < kLanesAtOnce; ++u) {
          bd[u] = kInf;
          bi[u] = INT_MAX;
        }
        for (int j = tid; j < G; j += kThreads) {
          const Rec* rec =
              w.recs + (static_cast<size_t>(slot) * w.cap + j) * w.Mg;
#pragma unroll
          for (int u = 0; u < kLanesAtOnce; ++u) {
            const int l = l0 + u;
            if (l >= mg || !cur[l].live) continue;
            const double d = __ldcg(&rec[l].d);
            const int i = __ldcg(&rec[l].i);
            if (less_pair(d, i, bd[u], bi[u])) {
              bd[u] = d;
              bi[u] = i;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kLanesAtOnce; ++u) {
          if (l0 + u >= mg) break;
          warp_min_pair(bd[u], bi[u]);
          if (lane == 0) {
            xd[(l0 + u) * kWarps + warp] = bd[u];
            xi[(l0 + u) * kWarps + warp] = bi[u];
          }
        }
      }
      __syncthreads();

      // the step's decision and the next step's staging, with no barrier
      // between: every thread decides for the lanes of its elements.
      // First the lane's thread: the next copy of the replica (a copy of
      // this one for a lane that has ended), the bitmap, the sizes, the
      // chain entries the next step may pop (two below its tip: pushed in
      // steps <= e - 2, published by exchange e - 1 at the latest), and
      // (block 0) the chain, the triples and the outputs. The lane's thread
      // is one of the last (lt = kThreads - 1 - tid), which stage few or no
      // rows, and its loads are in flight while the rows are staged.
      const int lt = kThreads - 1 - tid;
      Lane N;
      double sz_tip = 0.0, sz_prev = 0.0, merged_sz = 0.0;
      double chd_hi = kInf;
      int ch_hi = -1, ch_lo = -1, tip_is = 0, prev_is = 0;
      if (lt < mg) {
        const Lane& L = cur[lt];
        N = L;
        if (L.live) {
          const int m = g0 + lt;
          unsigned* lb = bits + static_cast<size_t>(lt) * W;
          const Next y = decide(L, xd, xi, lb, lt);
          N.rows += L.n - L.k;  // this scan read the n - k live clusters
          N.steps = L.steps + 1;
          N.k = y.k;
          N.clen = y.clen;
          N.first = y.first;
          N.bad = y.bad;
          N.live = y.live;
          N.a = y.tip;
          N.p = y.prev;
          N.dprev = y.dprev;
          const size_t co = static_cast<size_t>(m) * (w.Np + 2);
          int* chain = w.chain + co;
          double* chain_d = w.chain_d + co;
          if (y.merge) {
            atomicAnd(lb + (L.a >> 5), ~(1u << (L.a & 31)));
            if (block0) {
              const size_t o = static_cast<size_t>(m) * (w.Np - 1) + L.k;
              w.ma[o] = L.a;
              w.mb[o] = y.b;
              w.md[o] = y.d;
            }
            if (block0 && L.clen == 2 && y.k < L.n - 1) chain[0] = y.first;
          } else if (block0) {
            chain[L.clen] = y.b;
            chain_d[L.clen] = y.d;
          }
          if (!y.live && block0) {
            w.bad[m] = y.bad;
            w.steps[m] = N.steps;
            w.rows[m] = N.rows;
          }
          double* lane_sizes = w.sizes + static_cast<size_t>(m) * w.Np;
          const double merged = L.np + L.na;
          const int bm = y.merge ? y.b : -1;
          if (y.merge && y.b >= L.lo && y.b < L.hi) {
            lane_sizes[y.b] = merged;
            if (y.b - L.lo < Rc)
              osz[static_cast<size_t>(lt) * Rc + y.b - L.lo] = merged;
          }
          if (y.live) {
            // loads issued now, their values used after the rows' loads
            const int c = max(y.clen - 4, 0);
            sz_tip = __ldcg(lane_sizes + max(y.tip, 0));
            sz_prev = __ldcg(lane_sizes + max(y.prev, 0));
            ch_hi = __ldcg(chain + c + 1);
            ch_lo = __ldcg(chain + c);
            chd_hi = __ldcg(chain_d + c + 1);
            tip_is = y.tip == bm ? 1 : y.tip == L.a ? 2 : 0;
            prev_is = y.prev < 0 ? 3 : y.prev == bm ? 1 : y.prev == L.a ? 2
                                                                       : 0;
            merged_sz = merged;
          }
        }
      }
      // the rows: the new tip's and predecessor's read through L2; the
      // owner of the merged row b writes it; a row equal to b's is formed
      // here, never read (the note)
      int lc = -1;
      Next x;
      for (int i = tid; i < mg * D; i += kThreads) {
        const int l = i / D, j = i % D;
        const Lane& L = cur[l];
        if (!L.live) continue;
        if (l != lc) {
          x = decide(L, xd, xi, bits + static_cast<size_t>(l) * W, l);
          lc = l;
        }
        double* lane_sums = w.sums + static_cast<size_t>(g0 + l) * w.Np * D;
        const double a_row = ra[i], p_row = rp[i];
        const double sum = p_row + a_row;  // S_p + S_a: one add an element
        const int bm = x.merge ? x.b : -1;
        if (x.merge && x.b >= L.lo && x.b < L.hi) {
          lane_sums[static_cast<size_t>(x.b) * D + j] = sum;
          if (x.b - L.lo < Rc)
            own[(static_cast<size_t>(l) * Rc + (x.b - L.lo)) * own_stride(D) +
                j] = sum;
        }
        if (!x.live) continue;
        ra[i] = x.tip == bm ? sum : x.tip == L.a ? a_row
              : __ldcg(lane_sums + static_cast<size_t>(x.tip) * D + j);
        rp[i] = x.prev < 0 ? 0.0 : x.prev == bm ? sum : x.prev == L.a ? a_row
              : __ldcg(lane_sums + static_cast<size_t>(x.prev) * D + j);
      }
      if (lt < mg) {
        if (N.live) {
          const double na = cur[lt].na;
          N.na = tip_is == 1 ? merged_sz : tip_is == 2 ? na : sz_tip;
          N.np = prev_is == 3 ? 0.0 : prev_is == 1 ? merged_sz
               : prev_is == 2 ? na : sz_prev;
          // chain[clen - 3] and chain[clen - 4] (clen >= 4: ch_hi, ch_lo;
          // clen == 3: chain[0], loaded as ch_lo)
          N.c3 = N.clen >= 4 ? ch_hi : N.clen == 3 ? ch_lo : -1;
          N.c4 = N.clen >= 4 ? ch_lo : -1;
          N.dc3 = chd_hi;
        }
        nxt[lt] = N;
      }
      __syncthreads();
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). The caller gives every lane's
// sums (rows past ns[m] unused), sizes set to 1, the chain zeroed, the
// outputs bad / steps / rows zeroed, and exchange scratch for `cap` blocks:
// recs [2, cap, kMaxGroup] of 16 bytes and tags [2, cap] set to -1 (see
// vbx_tpu_torch/clustering/device.py). Launches cooperatively on `stream`
// with blocks_per_sm blocks an SM (0: kDefaultBlocksPerSm), as many lanes
// at once as shared memory holds (at most kMaxGroup), and as many of the
// owners' rows in shared memory as fit beside them; does not synchronize,
// allocates nothing; writes the grid size to *grid_out and the lanes
// walked at once to *group_out, and returns a CUDA error code (0 =
// cudaSuccess).
extern "C" int nn_chain_walk_launch(void* sums, void* sizes, void* ns,
                                    void* chain, void* chain_d, void* ma,
                                    void* mb,
                                    void* md, void* bad, void* steps,
                                    void* rows, void* recs, void* tags,
                                    int M, int Np, int D, int cap,
                                    int blocks_per_sm, void* stream,
                                    int* grid_out, int* group_out) {
  if (M < 1 || Np < 2 || D < 1 || D > kMaxD || cap < 1 || blocks_per_sm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, coop = 0, sms = 0, optin = 0, per_sm_bytes = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int want = blocks_per_sm > 0 ? blocks_per_sm : kDefaultBlocksPerSm;
  const int grid = want * sms;
  if (grid > cap) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (Np + 31) / 32;
  // a block's share of the SM's shared memory at `want` blocks an SM: as
  // many lanes as fit, then as many of the owners' rows
  const long long budget =
      std::min<long long>(optin, per_sm_bytes / want - reserved);
  int Mg = M < kMaxGroup ? M : kMaxGroup;
  while (Mg > 1 && static_cast<long long>(Layout(Mg, D, 0, W).total) > budget)
    --Mg;
  const long long base = static_cast<long long>(Layout(Mg, D, 0, W).total);
  if (base > budget)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int Rc = 0;
  if (kOwnRowsInShared) {
    const long long fit = (budget - base) / (8LL * Mg * (own_stride(D) + 1));
    const int rmax = (Np + grid - 1) / grid;
    Rc = static_cast<int>(fit < rmax ? fit : rmax);
  }
  const size_t smem = Layout(Mg, D, Rc, W).total;
  int per_sm = 0;
  err = cudaFuncSetAttribute(nn_chain_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nn_chain_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < want)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Walk w{static_cast<double*>(sums),  static_cast<double*>(sizes),
         static_cast<const int*>(ns), static_cast<int*>(chain),
         static_cast<double*>(chain_d),
         static_cast<int*>(ma),        static_cast<int*>(mb),
         static_cast<double*>(md),     static_cast<int*>(bad),
         static_cast<int*>(steps),     static_cast<long long*>(rows),
         static_cast<Rec*>(recs),      static_cast<int*>(tags),
         M, Np, D, Mg, W, Rc, cap};
  *grid_out = grid;
  *group_out = Mg;
  void* args[] = {&w};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&nn_chain_kernel), dim3(grid),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
