// First-party nearest-neighbor-chain agglomerative linkage.
//
// Copy of vbx_tpu/clustering/native/linkage.cpp: the replacement for the
// fastcluster C++ dependency the reference diarization CLI uses for AHC
// initialization (reference: vbhmm.py:33,140-141 calls
// fastcluster.linkage(condensed, method='average')). This host-side step turns the condensed distance matrix into a SciPy-
// compatible linkage matrix Z[(n-1) x 4] = (id_a, id_b, dist, size) with the
// standard sorted-by-distance cluster numbering, so scipy.cluster.hierarchy.
// fcluster consumes it directly.
//
// Algorithm: Muellner's NN-chain (O(n^2) time, works in-place on the
// condensed matrix) + stable sort by merge distance + union-find relabeling.
// Exact for single/complete/average/weighted linkage (all reducible
// Lance-Williams updates).
//
// Build: see build.py (g++ -O3 -fopenmp -shared -fPIC). Called via ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

enum Method : int32_t {
  kSingle = 0,
  kComplete = 1,
  kAverage = 2,
  kWeighted = 3,
};

// Condensed index of pair (i, j), i < j, for n points.
inline int64_t condensed_index(int64_t n, int64_t i, int64_t j) {
  return n * i - i * (i + 1) / 2 + (j - i - 1);
}

inline int64_t pair_index(int64_t n, int64_t a, int64_t b) {
  return a < b ? condensed_index(n, a, b) : condensed_index(n, b, a);
}

struct Merge {
  int32_t a;
  int32_t b;
  double dist;
};

class UnionFind {
 public:
  explicit UnionFind(int64_t n)
      : parent_(2 * n - 1, -1), size_(2 * n - 1, 1), next_label_(n) {}

  int64_t find(int64_t x) {
    int64_t root = x;
    while (parent_[root] != -1) root = parent_[root];
    while (parent_[x] != -1) {  // path compression
      int64_t up = parent_[x];
      parent_[x] = root;
      x = up;
    }
    return root;
  }

  // Merge the sets containing labels x and y; the merged set gets the next
  // internal-node label. Returns the new size.
  int64_t merge(int64_t x, int64_t y) {
    int64_t label = next_label_++;
    parent_[x] = label;
    parent_[y] = label;
    int64_t s = size_[x] + size_[y];
    size_[label] = s;
    return s;
  }

  int64_t size_of(int64_t label) const { return size_[label]; }

 private:
  std::vector<int64_t> parent_;
  std::vector<int64_t> size_;
  int64_t next_label_;
};

// Parallelism thresholds: at ~2 ns/element scans, an OpenMP region only
// pays for itself above a few thousand active clusters (4-core host).
constexpr int64_t kParThresh = 8192;
constexpr int kMaxThreads = 8;

// Shared tail: stable-sort merges by distance (keeps NN-chain order on
// ties — a valid merge order by reducibility) and relabel to the SciPy
// convention with union-find.
void finalize_linkage(std::vector<Merge>& merges, int64_t n, double* out_z) {
  std::stable_sort(
      merges.begin(), merges.end(),
      [](const Merge& l, const Merge& r) { return l.dist < r.dist; });
  UnionFind uf(n);
  for (int64_t k = 0; k < n - 1; ++k) {
    int64_t la = uf.find(merges[k].a);
    int64_t lb = uf.find(merges[k].b);
    if (la > lb) std::swap(la, lb);
    int64_t s = uf.merge(la, lb);
    out_z[4 * k + 0] = static_cast<double>(la);
    out_z[4 * k + 1] = static_cast<double>(lb);
    out_z[4 * k + 2] = merges[k].dist;
    out_z[4 * k + 3] = static_cast<double>(s);
  }
}

template <typename T>
int nn_chain_linkage_impl(T* dist, int64_t n, int32_t method, double* out_z) {
  if (n < 1) return 1;
  if (n == 1) return 0;

  std::vector<int64_t> cluster_size(n, 1);
  // Sorted compact list of active clusters: scans touch only live entries
  // (vs. branch-testing all n flags every merge).
  std::vector<int32_t> act(n);
  std::iota(act.begin(), act.end(), 0);
  std::vector<int32_t> chain;
  chain.reserve(n);

  std::vector<Merge> merges;
  merges.reserve(n - 1);

  for (int64_t k = 0; k < n - 1; ++k) {
    if (chain.empty()) chain.push_back(act.front());

    int32_t a, b;
    for (;;) {
      a = chain.back();
      // Prefer the chain predecessor on ties so reciprocity is detected.
      int32_t best = -1;
      double best_d = 0;
      if (chain.size() >= 2) {
        best = chain[chain.size() - 2];
        best_d = static_cast<double>(dist[pair_index(n, a, best)]);
      }
      const int64_t m = static_cast<int64_t>(act.size());
#ifdef _OPENMP
      if (m >= kParThresh) {
        // Per-thread scans over ascending contiguous ranges combined in
        // thread order with strict '<' reproduce the sequential
        // lowest-index-on-tie result exactly (determinism matters: the
        // merge order feeds the AHC cut).
        int nt = std::min(omp_get_max_threads(), kMaxThreads);
        int32_t tb[kMaxThreads];
        double td[kMaxThreads];
        for (int t = 0; t < kMaxThreads; ++t) tb[t] = -1;
#pragma omp parallel num_threads(nt)
        {
          const int tid = omp_get_thread_num();
          const int nth = omp_get_num_threads();
          const int64_t chunk = (m + nth - 1) / nth;
          const int64_t s = tid * chunk;
          const int64_t e = std::min<int64_t>(m, s + chunk);
          int32_t lb = -1;
          double ld = 0;
          for (int64_t i = s; i < e; ++i) {
            const int32_t x = act[i];
            if (x == a) continue;
            const double d = static_cast<double>(dist[pair_index(n, a, x)]);
            if (lb < 0 || d < ld) {
              lb = x;
              ld = d;
            }
          }
          tb[tid] = lb;
          td[tid] = ld;
        }
        for (int t = 0; t < kMaxThreads; ++t) {
          if (tb[t] >= 0 && (best < 0 || td[t] < best_d)) {
            best = tb[t];
            best_d = td[t];
          }
        }
      } else
#endif
      {
        for (int64_t i = 0; i < m; ++i) {
          const int32_t x = act[i];
          if (x == a) continue;
          const double d = static_cast<double>(dist[pair_index(n, a, x)]);
          if (best < 0 || d < best_d) {
            best = x;
            best_d = d;
          }
        }
      }
      b = best;
      if (chain.size() >= 2 && b == chain[chain.size() - 2]) break;
      chain.push_back(b);
    }
    // a and b are reciprocal nearest neighbors -> merge.
    chain.pop_back();
    chain.pop_back();

    double d_ab = static_cast<double>(dist[pair_index(n, a, b)]);
    merges.push_back(Merge{a, b, d_ab});

    int64_t sa = cluster_size[a], sb = cluster_size[b];
    // Keep the merged cluster in slot b (arbitrary; relabeling fixes ids).
    act.erase(std::lower_bound(act.begin(), act.end(), a));
    cluster_size[b] = sa + sb;

    const int64_t m = static_cast<int64_t>(act.size());
    const double dsa = static_cast<double>(sa), dsb = static_cast<double>(sb);
    const double dsab = static_cast<double>(sa + sb);
    // Each iteration writes the distinct entry pair(x, b); reads pair(x, a)
    // are never another iteration's write (a is no longer active) -> safe
    // to parallelize with identical results. The average update keeps the
    // exact division (a reciprocal-multiply differs at 1 ulp, which can
    // flip a near-tie merge and change the AHC cut).
#ifdef _OPENMP
#pragma omp parallel for schedule(static) if (m >= kParThresh)
#endif
    for (int64_t i = 0; i < m; ++i) {
      const int32_t x = act[i];
      if (x == b) continue;
      const double d_xa = static_cast<double>(dist[pair_index(n, x, a)]);
      const double d_xb = static_cast<double>(dist[pair_index(n, x, b)]);
      double nd;
      switch (method) {
        case kSingle:
          nd = std::min(d_xa, d_xb);
          break;
        case kComplete:
          nd = std::max(d_xa, d_xb);
          break;
        case kAverage:
          nd = (dsa * d_xa + dsb * d_xb) / dsab;
          break;
        default:  // kWeighted (method validated by the caller)
          nd = 0.5 * (d_xa + d_xb);
          break;
      }
      dist[pair_index(n, x, b)] = static_cast<T>(nd);
    }
  }

  finalize_linkage(merges, n, out_z);
  return 0;
}

// Distance-on-demand average linkage over the inner-product metric
// d(i, j) = -(x_i . x_j) — the AHC chain's actual distance (negated cosine
// of l2-normalized vectors, reference vbhmm.py:135,139-141). Key identity:
// average linkage's mean pairwise distance is EXACTLY computable from
// per-cluster vector sums,
//     D(A, B) = mean_{i in A, j in B} -(x_i . x_j) = -(S_A . S_B)/(|A||B|),
// so no condensed matrix is ever materialized (O(N^2) f64 = 10 GB at
// N = 50k was the long-recording memory wall, BENCHMARKS.md) and the
// per-merge Lance-Williams update pass disappears entirely: a merge is
// just S_b += S_a. Memory: O(N.D). The scans stream contiguous rows
// (BLAS-like, bandwidth-bound) instead of gathering condensed entries
// (latency-bound), so this is also FASTER at large N.
//
// Merge order matches the condensed implementation up to floating-point
// rounding: the sums identity and the iterated Lance-Williams recursion
// compute the same real number along different f64 paths (~1e-15
// relative), which can only flip a merge whose two candidate distances
// are closer than that — vanishingly rare on continuous data and
// irrelevant to the AHC cut scale (~1e-4). Scan order, predecessor
// tie-preference, and the deterministic thread-order reduction mirror
// nn_chain_linkage_impl exactly.
int nn_chain_dot_avg_impl(const double* xn, int64_t n, int64_t d,
                          double* out_z) {
  if (n < 1 || d < 1) return 1;
  if (n == 1) return 0;

  std::vector<double> sums(xn, xn + n * d);  // S_c, row c = cluster c's sum
  std::vector<int64_t> cluster_size(n, 1);
  std::vector<int32_t> act(n);
  std::iota(act.begin(), act.end(), 0);
  std::vector<int32_t> chain;
  chain.reserve(n);
  std::vector<Merge> merges;
  merges.reserve(n - 1);

  // The dots use `omp simd` reductions: without it -O3 keeps the strict
  // serial FP order and the loop runs latency-bound on the FMA chain
  // (~4x slower). The simd order is fixed per build and identical for
  // every call and thread count, so determinism is preserved.
  auto row_dot = [d](const double* sp, const double* sq) {
    double dot = 0;
#pragma omp simd reduction(+ : dot)
    for (int64_t t = 0; t < d; ++t) dot += sp[t] * sq[t];
    return dot;
  };
  auto pair_dist = [&](int32_t p, int32_t q) {
    const double* sp = sums.data() + static_cast<int64_t>(p) * d;
    const double* sq = sums.data() + static_cast<int64_t>(q) * d;
    return -row_dot(sp, sq) /
           static_cast<double>(cluster_size[p] * cluster_size[q]);
  };

  for (int64_t k = 0; k < n - 1; ++k) {
    if (chain.empty()) chain.push_back(act.front());

    int32_t a, b;
    for (;;) {
      a = chain.back();
      int32_t best = -1;
      double best_d = 0;
      if (chain.size() >= 2) {
        best = chain[chain.size() - 2];
        best_d = pair_dist(a, best);
      }
      const int64_t m = static_cast<int64_t>(act.size());
      const double* sa = sums.data() + static_cast<int64_t>(a) * d;
      const double na = static_cast<double>(cluster_size[a]);
#ifdef _OPENMP
      if (m * d >= kParThresh * 16) {
        int nt = std::min(omp_get_max_threads(), kMaxThreads);
        int32_t tb[kMaxThreads];
        double td[kMaxThreads];
        for (int t = 0; t < kMaxThreads; ++t) tb[t] = -1;
#pragma omp parallel num_threads(nt)
        {
          const int tid = omp_get_thread_num();
          const int nth = omp_get_num_threads();
          const int64_t chunk = (m + nth - 1) / nth;
          const int64_t s = tid * chunk;
          const int64_t e = std::min<int64_t>(m, s + chunk);
          int32_t lb = -1;
          double ld = 0;
          for (int64_t i = s; i < e; ++i) {
            const int32_t x = act[i];
            if (x == a) continue;
            const double* sx = sums.data() + static_cast<int64_t>(x) * d;
            const double dist = -row_dot(sa, sx) /
                                (na * static_cast<double>(cluster_size[x]));
            if (lb < 0 || dist < ld) {
              lb = x;
              ld = dist;
            }
          }
          tb[tid] = lb;
          td[tid] = ld;
        }
        for (int t = 0; t < kMaxThreads; ++t) {
          if (tb[t] >= 0 && (best < 0 || td[t] < best_d)) {
            best = tb[t];
            best_d = td[t];
          }
        }
      } else
#endif
      {
        for (int64_t i = 0; i < m; ++i) {
          const int32_t x = act[i];
          if (x == a) continue;
          const double* sx = sums.data() + static_cast<int64_t>(x) * d;
          const double dist = -row_dot(sa, sx) /
                              (na * static_cast<double>(cluster_size[x]));
          if (best < 0 || dist < best_d) {
            best = x;
            best_d = dist;
          }
        }
      }
      b = best;
      if (chain.size() >= 2 && b == chain[chain.size() - 2]) {
        merges.push_back(Merge{a, b, best_d});
        break;
      }
      chain.push_back(b);
    }
    chain.pop_back();
    chain.pop_back();

    // Merge a into b: the sums identity makes this the WHOLE update.
    double* sb = sums.data() + static_cast<int64_t>(b) * d;
    const double* sa = sums.data() + static_cast<int64_t>(a) * d;
    for (int64_t t = 0; t < d; ++t) sb[t] += sa[t];
    cluster_size[b] += cluster_size[a];
    act.erase(std::lower_bound(act.begin(), act.end(), a));
  }

  finalize_linkage(merges, n, out_z);
  return 0;
}

}  // namespace

extern "C" {

int nn_chain_linkage_f64(double* dist, int64_t n, int32_t method,
                         double* out_z) {
  return nn_chain_linkage_impl<double>(dist, n, method, out_z);
}

// Distance-on-demand average linkage over d(i,j) = -(x_i . x_j); xn is
// row-major [n x d] (l2-normalized rows make this negated-cosine AHC).
// O(N.D) memory — no condensed matrix (see nn_chain_dot_avg_impl).
int nn_chain_linkage_dot_avg_f64(const double* xn, int64_t n, int64_t d,
                                 double* out_z) {
  return nn_chain_dot_avg_impl(xn, n, d, out_z);
}

// Cap the OpenMP team size for the linkage loops (process-global). The
// corpus pipeline sets 1 while its per-recording init thread pool is
// active (pool workers x OMP teams would oversubscribe the host), and
// restores the core count for single-recording latency afterwards.
void linkage_set_threads(int n) {
#ifdef _OPENMP
  omp_set_num_threads(n < 1 ? 1 : n);
#else
  (void)n;
#endif
}

// Single-pass histogram moments: per-bin count, sum, sum-of-squares of s.
// Feeds the binned 2-GMM calibration EM (ops/calibration.py) without the
// three separate numpy bincount passes. Accumulates into the caller's
// arrays (callers stream blocks through).
int hist_moments_f64(const double* s, int64_t n, double lo, double scale,
                     int64_t n_bins, double* cnt, double* sum,
                     double* sumsq) {
  for (int64_t i = 0; i < n; ++i) {
    const double v = s[i];
    int64_t idx = static_cast<int64_t>((v - lo) * scale);
    if (idx < 0) idx = 0;
    if (idx >= n_bins) idx = n_bins - 1;
    cnt[idx] += 1.0;
    sum[idx] += v;
    sumsq[idx] += v * v;
  }
  return 0;
}

int nn_chain_linkage_f32(float* dist, int64_t n, int32_t method,
                         double* out_z) {
  return nn_chain_linkage_impl<float>(dist, n, method, out_z);
}

// Shared-variance 2-GMM EM over weighted score atoms (count, sum,
// sum-of-squares, mean score per atom); returns the equal-LLR threshold.
// Native form of ops/calibration._weighted_em_threshold — same init, same
// update order, same degenerate-score fallbacks (the numpy path remains
// the reference; a parity test pins agreement). Runs GIL-free via ctypes:
// the EM is the serving init chain's hottest pure-Python stage (20
// iterations of sigmoid over every bin), so releasing the GIL here lets
// the service's init pool actually parallelize. OpenMP honors
// linkage_set_threads' process-global cap.
//
// DETERMINISM: the E-step reduction uses fixed-size chunks whose partial
// sums are accumulated in index order, so the threshold is bit-identical
// for any thread count (a bare `omp reduction(+)` would combine partials
// in thread order and drift ~1e-12 run-to-run; the threshold feeds the
// linkage cut and hence the cluster count, so it must be reproducible).
//
// SERIAL ON PURPOSE: every caller passes <= 2^18 atoms (bigger score sets
// are binned to <= 2^16 moments first — ops/calibration.adaptive_bins),
// and at that size OpenMP measured NO speedup quiet (21.4 vs 21.1 ms at
// n=152k, 20 iters) and up to ~10x SLOWER under concurrent host load
// (libgomp barrier spin-wait thrash, 20 parallel regions per call — the
// same small-problem pathology utils/hostblas.py pins for BLAS). Serial
// is also the right shape under the serving init pool, which already
// parallelizes ACROSS requests through this GIL-free call.

double two_gmm_weighted_em(const double* cnt, const double* ssum,
                           const double* s2sum, const double* sc, int64_t n,
                           int32_t niters) {
  double total = 0, sum_s = 0, sum_s2 = 0;
  for (int64_t i = 0; i < n; ++i) {
    total += cnt[i];
    sum_s += ssum[i];
    sum_s2 += s2sum[i];
  }
  const double mean = sum_s / total;
  double var = sum_s2 / total - mean * mean;
  const double var_floor = 1e-12 * std::max(1.0, mean * mean);
  if (!(var > var_floor)) return mean;  // degenerate scores: any threshold
  double w0 = 0.5, w1 = 0.5;
  double m0 = mean - std::sqrt(var), m1 = mean + std::sqrt(var);
  constexpr int64_t kEmChunk = 4096;
  const int64_t nchunks = (n + kEmChunk - 1) / kEmChunk;
  std::vector<double> pc(nchunks), p1(nchunks), p2(nchunks);
  for (int32_t it = 0; it < niters; ++it) {
    if (!(var > var_floor)) return mean;  // components merged mid-EM
    const double d = (m1 - m0) / var;
    const double c =
        std::log(w1) - std::log(w0) - 0.5 * (m1 * m1 - m0 * m0) / var;
    for (int64_t k = 0; k < nchunks; ++k) {
      const int64_t lo = k * kEmChunk;
      const int64_t hi = std::min(n, lo + kEmChunk);
      double a = 0, b = 0, q = 0;
      for (int64_t i = lo; i < hi; ++i) {
        const double z = sc[i] * d + c;
        const double ez = std::exp(-std::abs(z));  // in (0,1]: no overflow
        const double g1 = z >= 0 ? 1.0 / (1.0 + ez) : ez / (1.0 + ez);
        a += g1 * cnt[i];
        b += g1 * ssum[i];
        q += g1 * s2sum[i];
      }
      pc[k] = a;
      p1[k] = b;
      p2[k] = q;
    }
    double cnt1 = 0, s1 = 0, s2 = 0;
    for (int64_t k = 0; k < nchunks; ++k) {  // index order: deterministic
      cnt1 += pc[k];
      s1 += p1[k];
      s2 += p2[k];
    }
    const double cnt0 = total - cnt1, s0 = sum_s - s1, q0 = sum_s2 - s2;
    w0 = cnt0 / total;
    w1 = cnt1 / total;
    m0 = s0 / cnt0;
    m1 = s1 / cnt1;
    var = (q0 / cnt0 - m0 * m0) * w0 + (s2 / cnt1 - m1 * m1) * w1;
  }
  const double thr =
      -0.5 *
      ((std::log(w0 * w0 / var) - m0 * m0 / var) -
       (std::log(w1 * w1 / var) - m1 * m1 / var)) /
      (m0 / var - m1 / var);
  return std::isfinite(thr) ? thr : mean;  // final-iteration collapse
}

// Square symmetric matrix -> condensed upper-triangle vector, optionally
// negated (the AHC chain clusters on -similarity, vbhmm.py:139). One
// OpenMP-parallel pass; replaces a Python per-row loop that held the GIL
// through N small numpy copies in the serving init chain.
void squareform_condensed_f64(const double* sq, int64_t n, int negate,
                              double* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n - 1; ++i) {
    // row i's strict-upper span starts at the condensed offset
    int64_t o = n * i - i * (i + 1) / 2;
    const double* row = sq + i * n + i + 1;
    const int64_t m = n - i - 1;
    if (negate) {
      for (int64_t j = 0; j < m; ++j) out[o + j] = -row[j];
    } else {
      std::memcpy(out + o, row, static_cast<size_t>(m) * sizeof(double));
    }
  }
}

// Flat cut of a linkage matrix at threshold t (inclusive), 'distance'
// criterion: clusters are the connected components formed by all merges with
// dist <= t. Labels are assigned 0-based in order of first appearance by
// leaf index (matching scipy.cluster.hierarchy.fcluster(criterion='distance')
// numbering minus 1, i.e. the reference's `fcluster(...) - 1` at
// vbhmm.py:145-146).
int fcluster_distance(const double* z, int64_t n, double threshold,
                      int32_t* out_labels) {
  std::vector<int64_t> parent(2 * n - 1);
  std::iota(parent.begin(), parent.end(), 0);
  auto find = [&parent](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t k = 0; k < n - 1; ++k) {
    if (z[4 * k + 2] <= threshold) {
      int64_t a = find(static_cast<int64_t>(z[4 * k + 0]));
      int64_t b = find(static_cast<int64_t>(z[4 * k + 1]));
      int64_t root = n + k;
      parent[a] = root;
      parent[b] = root;
    }
  }
  std::vector<int32_t> label_of_root(2 * n - 1, -1);
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = find(i);
    if (label_of_root[r] < 0) label_of_root[r] = next++;
    out_labels[i] = label_of_root[r];
  }
  return 0;
}

}  // extern "C"
