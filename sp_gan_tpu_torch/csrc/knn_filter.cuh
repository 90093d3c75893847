// The exact self-kNN selection engine of kernels A and G (knn.cu), B
// (knn_edge.cu) and, above 4 channels, F (knn_edge_window.cu, on a band):
// one running list a query over a chunk of keys, walked from the block's
// own tile; above 4 channels a TF32 tensor-core filter in front of the
// exact f32 fold decides which keys get folded. Every pick and every
// distance is the fold's (knn_common.cuh): the result is bit-equal to the
// plain versions (ops/pairwise.py, ops/kernels/knn.py,
// ops/kernels/knn_edge.py, ops/approx_knn.band_select) in both selection
// orders:
//
//   exact  - (distance, index) ascending, the order of k rounds of argmin
//            with ties to the lower index (TopK<K, false>);
//   packed - the int32 key (bits(max(d, 0)) & ~low) | j ascending, low =
//            2^ceil(log2 N) - 1, j the column (pack_key, TopK<K, true>).
//
// What a call does with the lists is the sink's (`Out`): ListOut writes
// idx and dist (A, G), EdgeOut writes idx and the edge rows (B; F with
// BAND, below).
//
// The band (kernel F, Out::kBand). Query i's candidates are the rows i + o
// mod N, 0 < |o| <= W, with 2 W < N, and its column is the band position p
// = o + W, not the index; the packed key's low mask is the caller's (F's:
// the JAX kernel's, 2^b - 1 >= 2 W). A block of queries q0 .. q0 + nq - 1
// works in key coordinates r, the positions of its circular slice, rows
// q0 - W + r mod N (r < nq + 2 W): query t's band is r = t .. t + 2 W,
// itself at r = t + W, and p = r - t. The slice takes the chunks' place
// (key_split on band_keys), and the walk starts at the tile holding r = W,
// the block's first query.
//
// Two selection kernels, chosen by the width C:
//
//   * C <= kFilterAbove (4): knn_exact_kernel, the CUDA cores fold every
//     pair: 2 C + 3 f32 operations a pair, 9 at EdgeConv1's C = 3, where a
//     filter would spend as much on a pair before any exact fold.
//   * C > 4: knn_filter_kernel, the tensor-core filter (below), after
//     knn_norms_kernel has folded every point's |x|^2 once. It takes C at
//     run time, so every width above 4 goes through one kernel.
//
// Split. A block holds kSelQ = 128 queries of one cloud. The keys (N, or a
// band's slice of up to 128 + 2 W) are cut into S chunks only as far as
// filling the card needs: S = ceil(fill / (B * ceil(N / 128))), at least 1
// and at most ceil(keys / 64), each chunk a multiple of 64 keys; fill =
// 1024 blocks for the exact kernel (small shared memory, many blocks an
// SM) and 256 for the filter (two blocks an SM). At P2 ([16, 16384, C]),
// the serving request [64, 2048, C], the training step [24, 2048, C] and
// P1's band ([4, 8192, C], 256 blocks) that is S = 1; at B = 1 and N =
// 2048, S = 32 (C <= 4) or 16. Splitting the serving request's keys in
// two, or the training step's in six, read slower on the H100: each
// chunk's first tile costs exact folds, and each split a merge.
// With S = 1 the selection kernel of A and G writes idx and dist itself;
// otherwise, and always for B, it writes each query's k entries of each
// chunk to scratch and knn_merge_kernel pushes the S * k partial entries
// through the same list, then hands it to the sink, which writes the edge
// rows from a kernel that keeps many blocks an SM in flight (the filter
// keeps two or three). k <= 10 keeps a list of 10, 11 <= k <= 32 one of
// 32, 33 <= k <= 64 (--nk <= 128) one of 64: KM, the list's compile-time
// width (in exact order the filter keeps a list of 64's indices in shared
// memory, FilterList below). A block walks its chunk in tiles (64 keys;
// the filter's 64 or 32, kFewBlocksPerSm below, and 32 at KM = 64)
// starting at the tile that holds its own first query, wrapping around:
// on a cloud stored in spatial order (the sphere template, and the
// features computed from it) the first tiles hold near neighbours, so the
// list's k-th entry falls
// early and few later keys get past it. A list keeps the k smallest of
// what it is given in any order, so the walk's order changes no result.
//
// The filter. Warp w owns queries 32w .. 32w + 31 of the block, lane r
// the list of query 32w + r. Key tiles land as f32 rows by cp.async in two
// buffers (the next while this one is used); channels are zero-padded to
// Cp, a multiple of 16 (a zero term is exact in every sum below). The
// block splits each tile once into tf32 pairs in fragment order: x = hi +
// lo exactly, hi = tf32(x), lo = x - hi, each operand rounded to tf32 to
// nearest, ties away (cvt.rna's rounding, in integer instructions). Each
// warp computes c~ ~ q.k for its 32 x FT pairs with mma.sync m16n8k8
// TF32 in three products, hi.hi + hi.lo + lo.hi, into
// one f32 accumulator. With qn and kn the exact-fold norms and tau the
// list's threshold (below), key j is dropped only if
//
//   c~ < h - w,  h = (qn - rb) / 2,  rb = mu qn + (tau + nu),
//                w = (mu kn - kn) / 2,
//
// rb and w rounded up at each step, h and h - w down: then in real numbers
// qn - 2 c~ > rb + (mu kn - kn) >= tau + nu + mu (qn + kn) - kn. It is
// written !(c~ >= h - w): a NaN is kept. The query itself is always
// kept, and every key is kept where tau is not finite (while the list is
// short) or qn or kn is not below 2^125 (inf and NaN included). The
// candidates of the tile (a 64-bit mask per query, ORed across the lanes
// of the mma fragment by shuffles, then handed to the owner lane) get the
// exact fold from the staged f32 rows and are pushed into the owner's
// list; tau is read again for the next tile. The first tile of a chunk
// meets an empty list; its threshold comes from the tile's own estimates
// instead (first_bound): an upper bound tau0 on the distances of at least
// k of its keys, so that the list is full after it. Where the estimates
// bound fewer than k keys, tau0 is +inf and the tile takes every key, so
// a degenerate cloud turns into the exact pass and stays right. At KM =
// 64 (k > 32) tau0 is +inf outright (wide lists, below).
//
// tau, by order. Exact: the fold's distance of the list's k-th entry.
// Packed: tau_q = int_as_float(K | low), K the list's k-th key, the
// largest float whose bits share K's high bits (tau_q >= max(d_K, 0); a
// negative K, which the fold never makes, keeps every key, as does a K
// whose exponent bits are all ones, +inf and NaN, since tau_q is then
// NaN). tau_q is a float, so it enters T unrounded, and every later step
// rounds up as above.
//
// Why the result is exact. Both orders are total (j sits in the packed
// key's low bits, and low >= N - 1), and a list keeps the k smallest of
// the keys pushed into it. So if every key of the chunk's top-k is
// pushed, the list ends as that top-k, in its order and with the fold's
// distances, whatever else was pushed. The k-th entry only falls, and is
// always the k-th of the keys pushed so far, so the final top-k's keys
// come before it whenever a tile is filtered. It is enough, then, that a
// dropped key j comes after the current k-th entry, and for that that d_j
// > tau:
//
//   exact:  d_j > tau = d_K, so (d_j, j) follows (d_K, K);
//   packed: d_j > tau_q >= 0, so max(d_j, 0) = d_j and bits(d_j) >=
//           (K | low) + 1 = (K & ~low) + low + 1 as integers (non-negative
//           floats order as their bits), and pack(d_j) = bits(d_j) & ~low
//           | j >= (K & ~low) + 2^b > K. Comparing with tau alone (d_K)
//           would not do: a key with d_K < d_j <= tau_q shares K's
//           quantum and, with a lower column, comes before K. A negative
//           d_j is clamped to 0 and can come before K, but d_j > tau_q
//           >= 0 rules it out; a NaN d_j is packed as it is, and the
//           filter keeps it (e is NaN). The fold never gives -0: (qn - 2
//           acc) + kn with qn, kn >= +0 rounds to -0 only from -0 + -0.
//
// tau0 is such a threshold too: at least k keys have d <= tau0, so the
// list's final k-th entry (exact) or key (packed, whose high bits are
// those of a distance <= tau0) comes no later than theirs.
//
// Wide lists (KM = 64, 33 <= k <= 64). The filter's tiles hold FT = 32
// keys there, so a fragment row's 4 lanes see 32 columns in all, the
// query itself among them in its own tile: fewer than k, and no bound
// over one tile covers k keys. So the first tile of a chunk is not
// filtered: rrb is +inf and every key of it (a band's candidates in it,
// for F) gets the exact fold. While the list holds fewer than k entries
// its k-th slot is the sentinel (INT_MAX, INT_MAX), so tau is NaN (exact)
// or tau_q is NaN (packed, INT_MAX | low = INT_MAX), rb is +inf and the
// next tiles take every key too, until k candidates have been pushed. No
// key is dropped before the list is full, and from then on tau is the
// k-th entry of the keys pushed so far, as above: the argument needs no
// bound on the first tile. At k <= 32 nothing changes: M = ceil(KM / 4)
// <= 8 columns of a lane's FT / 4 >= 8 (first_bound).
//
// On the band each step holds as it stands, with p for j and the band for
// the chunk's keys. The band mask acts before any push (keys outside a
// query's band are never pushed) and in first_bound (their estimates are
// +inf), so the list, tau, tau_q and tau0 see candidates only, and tau0
// bounds at least k of them. A query's band holds 2 W + 1 distinct slice
// positions, hence distinct p and, as 2 W < N, distinct rows: no candidate
// is pushed twice, and both orders stay total over the band. In packed
// mode p <= 2 W <= low, so p sits in the key's low bits as j does and the
// argument for tau_q is unchanged under F's mask. The filter's per-pair
// bound below does not depend on which keys are compared, so the margin
// stays FILTER_MU, FILTER_NU. The query itself is kept and pushed at +inf,
// as the plain version (band_sqdist) ranks it.
//
// Where the filter can drop j at all, tau is finite and qn, kn < 2^125,
// so 2 |acc| and 2 |c~| stay below 2^127 and no step overflows; a dropped
// key has qn - 2 c~ + kn > tau + nu + mu (qn + kn) in real numbers (the
// rounding directions above), so it is enough that d_j >= qn - 2 c~ + kn -
// mu (qn + kn) - nu: then d_j > tau. With u = 2^-24, S = sum_c |q_c k_c|
// and acc the fold of q.k:
//
//   d  >= qn - 2 acc + kn - 4u (qn + kn)(1 + 1e-4)
//         (two roundings of the outer sub and add, |qn - 2 acc| <= 2 qn +
//         kn + 3 gamma (qn + kn));
//   |acc - q.k| <= gamma S, gamma = (Cp + 2) u / (1 - (Cp + 2) u) (Cp
//         products and adds; the norms carry the same factor);
//   |c~ - q.k| <= (3 t^2 + 2 t^3 + t^4) S     the dropped term lo.lo, with
//         hi and lo off by up to t = 2^-10 of their input even if the
//         cores truncated rather than rounded to tf32,
//       + 3 Cp 2^-22 (1 + 2^-7) S  the sums: each m16n8k8 step adds its 8
//         exact products to the accumulator with an error of at most
//         16 * 2^-23 of the magnitudes it adds (twice the bound of 8 f32
//         additions in any order, truncating), 3 Cp / 8 steps over terms
//         of at most (1 + 2^-7) S in all. The PTX ISA leaves the order,
//         the rounding and the subnormal handling of mma's f32 sums
//         unspecified; Fasi, Higham, Mikaitis and Pranesh, "Numerical
//         behavior of NVIDIA tensor cores", PeerJ Comput. Sci. 7:e330
//         (2021), measured exact products, alignment to the largest
//         exponent and truncation (round toward zero) in the sums on the
//         V100, T4 and A100 (TF32 included), one such error a step. The
//         model allows twice that. No public measurement of Hopper's
//         TF32 sums is cited here: chip_smoke.py and the card tests check
//         the margin on the H100 (a sweep of mu on the hard inputs, and
//         mu = 0 on a cloud far from the origin, which must differ);
//   2 S <= |q|^2 + |k|^2 <= (qn + kn) / (1 - gamma).
//
// Every term bounds an absolute error, so the bound below holds for |qn
// - 2 c~ + kn - d|, and first_bound's U = qn - 2 c~ + kn + mu (qn + kn) +
// nu (rounded up) is at least d.
//
// Together qn - 2 c~ + kn - d <= (gamma + 3.003 t^2 + 3 Cp 2^-22 (1 +
// 2^-7) + 4.001 u) (qn + kn) / (1 - gamma): 1.031e-4 (qn + kn) at Cp =
// 128, 5.317e-5 (qn + kn) at Cp = 64. Below 2^-126 the cores may flush
// operands, products and sums to zero: a flushed operand of magnitude a <
// 2^-126 loses at most 2 * 3 a |k_c| <= (mu / 16) k_c^2 + 144 a^2 / mu a
// channel (and the same with q and k swapped), at most (mu / 16)(qn + kn)
// + 2^-220 in all; flushed products and sums lose at most 2 * 1024 *
// 2^-126 = 2^-115, and the fold's gradual underflow less. So mu (15/16)
// >= 1.100e-4 and nu >= 2^-114 suffice, in either order. The wrappers
// pass FILTER_MU = 2^-12 = 2.441e-4 and FILTER_NU = 2^-100
// (ops/kernels/knn.py, the one definition), a factor of safety of 2.22
// at Cp = 128 (4.30 at Cp = 64) on a model of the cores' sums that is
// itself twice the bound of f32 additions, and 2^14 times the absolute
// terms. On an H100 (80GB HBM3, 700 W) the hard inputs of chip_smoke.py's
// sweep at C = 64, N = 16384 stayed bit-equal to the exact fold down to
// mu = 2^-18 and broke at 2^-20 (randn + 1000 first), and with mu = nu =
// 0 on four of five inputs. TF32 only decides which keys get the exact
// fold: every pick and every distance returned is the fold's.
#pragma once

#include "knn_common.cuh"

namespace spgan {
namespace {  // each source that includes this instantiates its own copy

constexpr int kSelQ = kQueries;    // queries per selection block
constexpr int kT = kTileKeys;      // keys per tile of the exact kernel
// The filter's key tiles hold 64 keys (two blocks an SM fit in shared
// memory) or 32 (three blocks an SM, at more cost a key): 32 where the
// grid fits one wave at three blocks an SM, which 64 would spread over two
// waves, the second part empty (the training step's 384 blocks on 132
// SMs); 64 otherwise (the serving request's 1024 blocks, P2's 2048).
// Wide lists (KM = 64) always take tiles of 32 at two blocks an SM: the
// list's 64 registers of keys (FilterList) beside a 64-key tile's 64 of
// accumulators would not fit the 255 a thread may have (245-252 at tiles
// of 32, no spill).
constexpr int kFewBlocksPerSm = 3;
constexpr int kWideK = 64;         // the widest list (k <= 64)

// The list the filter keeps: TopK, or for the wide exact lists TopKSplit,
// its indices in a shared table of KM * kSelQ ints (32 KB), so that the
// list takes 64 registers, as a packed one does: with TopK's 128 beside
// the accumulators the filter spilled 1.3 KB a thread (G at P2's 64
// channels 41.0-41.4 ms a call, split 35.1 on the H100). The CUDA-core
// pass and the merge keep TopK: they hold no accumulators, and at the
// CUDA-core pass's many pushes the shared indices cost more than they
// save (A at [64, 2048, 3] 4.58-4.80 ms in registers, 6.34 split).
template <int KM, bool PACKED>
struct FilterList {
  using type = TopK<KM, PACKED>;
  static constexpr int kSharedInts = 0;
};

template <>
struct FilterList<kWideK, false> {
  using type = TopKSplit<kWideK>;
  static constexpr int kSharedInts = kWideK * kSelQ;
};

template <int K, bool P>
__device__ __forceinline__ void init_list(TopK<K, P>& top, int*) {
  top.init();
}

template <int K>
__device__ __forceinline__ void init_list(TopKSplit<K>& top, int* column) {
  top.init(column);
}
// blocks the split aims at: the exact kernel keeps many blocks an SM in
// flight, the filter two (its shared memory)
constexpr int kFillExact = 1024;
constexpr int kFillFilter = 256;
constexpr int kFilterAbove = 4;    // C above which the filter runs
constexpr float kInf = __builtin_huge_valf();
// qn or kn from here up (or NaN) keeps the pair outright: below it no step
// of the fold or of the filter can overflow
constexpr float kHuge = 0x1p125f;

struct Split {
  int S, chunk;
};

// The split of a block's `keys` (N, or the band's slice, band_keys) into
// S chunks.
Split key_split(int B, int N, int C, int keys) {
  const long long fill = C > kFilterAbove ? kFillFilter : kFillExact;
  const long long qblocks = (long long)B * ((N + kSelQ - 1) / kSelQ);
  long long S = (fill + qblocks - 1) / qblocks;
  S = S < 1 ? 1 : S;
  const long long most = (keys + kT - 1) / kT;
  S = S > most ? most : S;
  int chunk = (int)((keys + S - 1) / S);
  chunk = (chunk + kT - 1) / kT * kT;
  return {(keys + chunk - 1) / chunk, chunk};
}

// Keys of a block of queries: the cloud's N rows, or with a band of
// half-width W > 0 (kernel F) the most a block's circular slice holds,
// min(kSelQ, N) + 2 W.
__host__ __device__ __forceinline__ int band_keys(int N, int W) {
  return W > 0 ? (N < kSelQ ? N : kSelQ) + 2 * W : N;
}

// Whether a selection ends in knn_merge_kernel: with S > 1 key chunks,
// and always for a sink that writes edges, so that the edge rows are
// written by a kernel that keeps many blocks an SM in flight, not by the
// filter's two.
template <class Out>
bool merges(const Split& sp) {
  return sp.S > 1 || Out::kEdges;
}

// int32 words of scratch a selection needs: the norms of the filter (B *
// N, C > 4) and, where it merges, the partial lists (2 * B * N * S * k);
// W the band's half-width (kernel F) or 0.
template <class Out>
long long select_scratch_words(int B, int N, int C, int k, int W = 0) {
  if (B <= 0 || N <= 0 || k <= 0) return 0;
  const Split sp = key_split(B, N, C, band_keys(N, W));
  const long long rows = (long long)B * N;
  return (C > kFilterAbove ? rows : 0) +
         (merges<Out>(sp) ? 2 * rows * sp.S * k : 0);
}

// The sink of kernels A and G: idx and dist [B, N, k].
struct ListOut {
  static constexpr bool kPacked = false;
  static constexpr bool kEdges = false;
  static constexpr bool kBand = false;
  int32_t* idx;
  float* dist;
  int k;

  // Called by every thread of the block with its query's list.
  template <int KM, class List>
  __device__ __forceinline__ void finish(const List& top, int b, int N,
                                         int q0, bool valid, float*) const {
    if (!valid) return;
    const size_t o = ((size_t)b * N + q0 + threadIdx.x) * k;
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      if (t < k) {
        idx[o + t] = top.idx[t];
        dist[o + t] = unorderable(top.key[t]);
      }
    }
  }
};

// The sink of kernels B and F: idx [B, N, k] and the edge rows of the
// block's queries (write_edges), written by consecutive threads once the
// block's lists sit in shared memory (`smem`, kSelQ * k ints). Only the
// merge kernel calls it. BAND (kernel F): the lists hold band positions p,
// and the query's neighbour is row qi - W + p, mod N.
template <bool PACKED, bool BAND = false>
struct EdgeOut {
  static constexpr bool kPacked = PACKED;
  static constexpr bool kEdges = true;
  static constexpr bool kBand = BAND;
  const float* x;
  void* ee;
  int32_t* idx;
  int C, k, low_mask;
  bool diff_only, out_bf16;
  int W;  // the band's half-width (BAND)

  template <int KM, class List>
  __device__ __forceinline__ void finish(const List& top, int b, int N,
                                         int q0, bool valid,
                                         float* smem) const {
    int* snbr = reinterpret_cast<int*>(smem);
    __syncthreads();  // every thread is done with the shared memory
    if (valid) {
      const size_t o = ((size_t)b * N + q0 + threadIdx.x) * k;
#pragma unroll
      for (int t = 0; t < KM; ++t) {
        if (t < k) {
          int j = PACKED ? (top.key[t] & low_mask) : top.idx[t];
          if constexpr (BAND) {
            j = q0 + threadIdx.x - W + min(max(j, 0), 2 * W);
            j = j < 0 ? j + N : (j >= N ? j - N : j);
          } else {
            j = min(max(j, 0), N - 1);  // memory safety on NaN input only
          }
          snbr[threadIdx.x * k + t] = j;
          idx[o + t] = j;
        }
      }
    }
    __syncthreads();
    write_edges(x + (size_t)b * N * C, ee, snbr, b, N, C, k, q0,
                min(kSelQ, N - q0), diff_only, out_bf16);
  }
};

// Shared floats a sink needs after the selection.
template <class Out, int KM>
__host__ __device__ constexpr int sink_floats() {
  return Out::kEdges ? kSelQ * KM : 0;
}

// The tile (of `tile` keys) of the chunk [key0, key1) a block of queries
// from q0 walks first: the one holding q0, or the chunk's first.
__device__ __forceinline__ int first_tile(int q0, int key0, int key1,
                                          int tile) {
  return (q0 >= key0 && q0 < key1) ? (q0 - key0) / tile : 0;
}

// The list's k-th entry as the filter's threshold tau (above): exact, its
// distance; packed, tau_q. NaN or +-inf where every key must be kept.
template <int KM, bool PACKED, class List>
__device__ __forceinline__ float list_tau(const List& top, int k,
                                          int low_mask) {
  int kth = INT_MAX;
#pragma unroll
  for (int t = 0; t < KM; ++t)
    if (t == k - 1) kth = top.key[t];
  if (!PACKED) return unorderable(kth);  // NaN while short
  return kth < 0 ? __int_as_float(0x7fffffff) : __int_as_float(kth | low_mask);
}

// The selection key of distance d to column j.
template <bool PACKED>
__device__ __forceinline__ int select_key(float d, int low_mask, int j) {
  return PACKED ? pack_key(d, low_mask, j) : orderable(d);
}

// The end of a selection block: the lists to the sink (S = 1, no edges),
// or to the partial lists of chunk s.
template <int KM, class Out, class List>
__device__ __forceinline__ void end_block(const Out& out, const List& top,
                                          int b, int N, int q0, bool valid,
                                          int s, int S, int k,
                                          int32_t* part_key,
                                          int32_t* part_idx) {
  if (S == 1 && !Out::kEdges) {
    out.template finish<KM>(top, b, N, q0, valid, nullptr);
    return;
  }
  if (!valid) return;
  const size_t o = (((size_t)b * N + q0 + threadIdx.x) * S + s) * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      part_key[o + t] = top.key[t];
      if (!Out::kPacked) part_idx[o + t] = top.idx[t];
    }
  }
}

// C <= 4: every pair of the chunk folded on the CUDA cores (load_query,
// stage_keys and key_dist), eight keys' distances at a time. A key that
// would land after the list's last entry is not pushed: the push would
// drop it.
template <int KM, class Out>
__global__ void __launch_bounds__(kSelQ)
    knn_exact_kernel(const float* __restrict__ x, Out out,
                     int32_t* __restrict__ part_key,
                     int32_t* __restrict__ part_idx,
                     unsigned long long* __restrict__ refined, int N, int C,
                     int k, int S, int chunk, int low_mask) {
  constexpr int CM = kFilterAbove;
  constexpr bool P = Out::kPacked;
  __shared__ __align__(16) float sk[kT * CM];
  __shared__ float skn[kT];
  const int b = blockIdx.z, s = blockIdx.y, q0 = blockIdx.x * kSelQ;
  const int qi = q0 + threadIdx.x;
  const bool valid = qi < N;
  const int key0 = s * chunk, key1 = min(N, key0 + chunk);
  const int tiles = (key1 - key0 + kT - 1) / kT;
  const int first = first_tile(q0, key0, key1, kT);
  const float* xb = x + (size_t)b * N * C;
  float q[CM];
  const float qn = load_query<CM>(xb, C, qi, valid, q);
  TopK<KM, P> top;
  top.init();
  float last = unorderable(top.key[KM - 1]);  // exact order: NaN, take all
  for (int it = 0; it < tiles; ++it) {
    const int ti = first + it < tiles ? first + it : first + it - tiles;
    const int tile0 = key0 + ti * kT, nt = min(kT, key1 - tile0);
    stage_keys<CM>(xb, C, tile0, nt, RowsAsIs{}, sk, skn);
    if (!valid) continue;
    // eight distances, then one test of all eight against the list's
    // last entry, and the pushes only where one of them gets past it
    // (about 2% of the keys at the serving request): the folds do not wait
    // on the list, and the rare push costs one branch in eight keys (rows
    // past nt are zeros, their distances unused)
    for (int t0 = 0; t0 < nt; t0 += 8) {
      float d8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float d = key_dist<CM>(q, qn, sk + (t0 + u) * CM, skn[t0 + u]);
        d8[u] = tile0 + t0 + u == qi ? kInf : d;  // self at +inf
      }
      bool hit = false;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        hit |= t0 + u < nt &&
               (P ? pack_key(d8[u], low_mask, tile0 + t0 + u) <
                        top.key[KM - 1]
                  : !(d8[u] > last));  // NaN too
      if (!hit) continue;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = tile0 + t0 + u;
        if (t0 + u >= nt) continue;
        if (P) {
          const int key = pack_key(d8[u], low_mask, j);
          if (key < top.key[KM - 1]) top.push(key, j);
        } else if (!(d8[u] > last)) {
          top.push(orderable(d8[u]), j);
          last = unorderable(top.key[KM - 1]);
        }
      }
    }
  }
  if (refined != nullptr && threadIdx.x == 0)
    atomicAdd(refined, (unsigned long long)min(kSelQ, N - q0) *
                           (unsigned long long)(key1 - key0));
  end_block<KM>(out, top, b, N, q0, valid, s, S, k, part_key, part_idx);
}

// |x|^2 of every point in the fold order of load_query and stage_keys.
__global__ void knn_norms_kernel(const float* __restrict__ x,
                                 float* __restrict__ norms, long long rows,
                                 int C) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* xr = x + r * C;
  float s = 0.f;
  for (int c = 0; c < C; ++c) s = __fadd_rn(s, __fmul_rn(xr[c], xr[c]));
  norms[r] = s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` (4 or 16) from src, or zeros when `full` is false
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         bool full) {
  const int n = full ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the group committed last are in
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows row_of(r0 + r), r < n, of the cloud xb [N, C] into dst [rows, ld],
// channels zero-padded to Cp and rows past n zero; 16 bytes a copy where
// `vec` (C % 4 == 0 and x 16-byte aligned)
template <class RowOf>
__device__ __forceinline__ void stage_rows(float* dst, const float* xb,
                                           int r0, int n, int rows, int C,
                                           int Cp, int ld, bool vec,
                                           const RowOf& row_of) {
  if (vec) {
    const int per = Cp / 4;
    for (int e = threadIdx.x; e < rows * per; e += kSelQ) {
      const int r = e / per, c = (e % per) * 4;
      const bool full = r < n && c < C;
      cp_async(dst + r * ld + c,
               full ? xb + (size_t)row_of(r0 + r) * C + c : xb, 16, full);
    }
  } else {
    for (int e = threadIdx.x; e < rows * Cp; e += kSelQ) {
      const int r = e / Cp, c = e % Cp;
      const bool full = r < n && c < C;
      cp_async(dst + r * ld + c,
               full ? xb + (size_t)row_of(r0 + r) * C + c : xb, 4, full);
    }
  }
}

// The bits j of [lo, hi) within a 64-key tile
__device__ __forceinline__ unsigned long long range_bits(int lo, int hi) {
  lo = max(lo, 0);
  hi = min(hi, 64);
  if (hi <= lo) return 0ull;
  const unsigned long long upto = hi == 64 ? ~0ull : (1ull << hi) - 1ull;
  return upto & ~((1ull << lo) - 1ull);
}

// v rounded to tf32 to nearest, ties away from zero, as cvt.rna does,
// in two integer instructions on the full-rate pipes: half of the dropped
// 13 bits added to the magnitude, then masked (a NaN may turn into another
// NaN or a zero; a NaN's row or key is kept whatever its estimate)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + (v - hi), hi = tf32(v); lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// d += a (16 x 8, row-major fragment) b (8 x 8, column-major fragment)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__host__ __device__ constexpr int filter_cp(int C) {
  return (C + 15) / 16 * 16;
}

// Shared bytes of a filter block with tiles of FT keys, ld = Cp + 4
// (conflict-free fragment loads): the query rows [kSelQ, ld], two key
// tiles [FT, ld], their norms [2, FT], the current tile's tf32 pairs in
// fragment order [2, FT * Cp], its keys' terms mu kn - kn and kn + mu
// kn, rounded up [2, FT], and `list_ints` of the lists' indices
// (FilterList; 167 KB at C = 128 with a wide exact list, of the 227 KB a
// block may have).
int filter_smem_bytes(int C, int FT, int list_ints) {
  const int Cp = filter_cp(C), ld = Cp + 4;
  return (kSelQ * ld + 2 * FT * ld + 2 * FT + 2 * FT * Cp + 2 * FT +
          list_ints) *
         (int)sizeof(float);
}

// The threshold of a chunk's first tile, which meets an empty list, at
// KM <= 32 (at KM = 64 it is +inf: wide lists, above): from the tile's
// own estimates. U_j = (qn - 2 c~) + (kn + mu kn) + (mu qn +
// nu), each step rounded up, bounds d_j from above (the bound of the
// header holds both ways). Each of the 4 lanes holding a fragment row
// takes the M-th smallest U of its FT / 4 columns, M = ceil(KM / 4) (self and
// columns past the tile's keys at +inf); the largest of the 4 bounds the
// distances of at least 4 M >= k keys, so the chunk's k-th entry never
// exceeds it: tau0 serves as tau (exact) and, packed, gives tau_q as the
// k-th key does, since those keys' packed keys are at most bits(max(tau0,
// 0)) | low. rrb gets mu qn + (tau + nu) of each row, rounded up, or +inf
// where a row keeps every key. BAND: only the columns within W of a row's
// own (its band) count, so the keys bounded are candidates.
template <int FT, int KM, bool PACKED, bool BAND>
__device__ __forceinline__ void first_bound(const float (&acc)[2][FT / 8][4],
                                            const float (&rqn)[2][2],
                                            const float* su, int wq0,
                                            int tile0, int t4, int g, int k,
                                            int low_mask, float mu, float nu,
                                            int W, float (&rrb)[2][2]) {
  constexpr int M = (KM + 3) / 4;
  const unsigned all = 0xffffffffu;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int self = wq0 + m * 16 + h * 8 + g - tile0;
      float low[M];  // the M smallest U of this lane's columns, ascending
#pragma unroll
      for (int i = 0; i < M; ++i) low[i] = kInf;
#pragma unroll
      for (int n = 0; n < FT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 8 + 2 * t4 + e;
          float u = __fadd_ru(__fmaf_ru(-2.f, acc[m][n][h * 2 + e],
                                        rqn[m][h]),
                              su[col]);
          const bool out = col == self || (BAND && abs(col - self) > W);
          u = (out || !(u < kInf)) ? kInf : u;  // NaN too
#pragma unroll
          for (int i = 0; i < M; ++i) {  // insert u, keep the M smallest
            const float lo = fminf(low[i], u);
            u = fmaxf(low[i], u);
            low[i] = lo;
          }
        }
      }
      float b = low[M - 1];
      b = fmaxf(b, __shfl_xor_sync(all, b, 1));
      b = fmaxf(b, __shfl_xor_sync(all, b, 2));
      const float qn = rqn[m][h];
      float tau = __fadd_ru(b, __fmaf_ru(mu, qn, nu));
      if (PACKED) tau = __int_as_float(__float_as_int(fmaxf(tau, 0.f)) |
                                       low_mask);
      rrb[m][h] = (tau < kInf && qn < kHuge)
                      ? __fmaf_ru(mu, qn, __fadd_ru(tau, nu))
                      : kInf;
    }
  }
}

template <int FT, int KM, class Out>
__global__ void __launch_bounds__(kSelQ, FT == 32 && KM < kWideK ? 3 : 2)
    knn_filter_kernel(const float* __restrict__ x,
                      const float* __restrict__ norms, Out out,
                      int32_t* __restrict__ part_key,
                      int32_t* __restrict__ part_idx,
                      unsigned long long* __restrict__ refined, int N, int C,
                      int k, int S, int chunk, int low_mask, float mu,
                      float nu, int vec) {
  constexpr bool P = Out::kPacked;
  using List = FilterList<KM, P>;
  constexpr int NT = FT / 8;  // n-tiles of 8 keys
  extern __shared__ __align__(16) float smem[];
  const int Cp = filter_cp(C), ld = Cp + 4, NP = Cp / 16;
  float* sq = smem;                // [kSelQ, ld] the block's query rows
  float* sk = sq + kSelQ * ld;     // [2, FT, ld] key tiles
  float* skn = sk + 2 * FT * ld;  // [2, FT] their norms
  float* sb = skn + 2 * FT;       // [2 (hi, lo), NT, NP, 32, 4] tf32 pairs
  float* sw = sb + 2 * FT * Cp;   // [FT] (mu kn - kn) / 2, rounded up
  float* su = sw + FT;            // [FT] kn + mu kn, rounded up
  // [KM, kSelQ] the lists' indices (FilterList), if they live here
  int* sidx = reinterpret_cast<int*>(su + FT);
  const int b = blockIdx.z, s = blockIdx.y, q0 = blockIdx.x * kSelQ;
  // Keys in key coordinates: the cloud's rows, or (kernel F) the positions
  // r of the block's circular slice, rows q0 - W + r mod N, where query t's
  // band is r = t .. t + 2 W and its column p = r - t. qk0 is the block's
  // first query in key coordinates.
  int W = 0;
  if constexpr (Out::kBand) W = out.W;
  const int keys = Out::kBand ? min(kSelQ, N - q0) + 2 * W : N;
  const int qk0 = Out::kBand ? W : q0;
  const int key0 = s * chunk, key1 = min(keys, key0 + chunk);
  const int tiles = key1 > key0 ? (key1 - key0 + FT - 1) / FT : 0;
  const int first = first_tile(qk0, key0, key1, FT);
  const float* xb = x + (size_t)b * N * C;
  const float* nb = norms + (size_t)b * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned all = 0xffffffffu;
  const RowsCircular slice{q0 - W, N};
  auto row_of = [&](int r) { return Out::kBand ? slice(r) : r; };

  auto tile_of = [&](int it) {
    const int ti = first + it < tiles ? first + it : first + it - tiles;
    return key0 + ti * FT;
  };
  auto stage_tile = [&](int it) {
    const int tile0 = tile_of(it), buf = it & 1;
    const int n = min(FT, key1 - tile0);
    stage_rows(sk + buf * FT * ld, xb, tile0, n, FT, C, Cp, ld, vec, row_of);
    if (threadIdx.x < FT)
      cp_async(skn + buf * FT + threadIdx.x,
               (int)threadIdx.x < n ? nb + row_of(tile0 + threadIdx.x) : nb,
               4, (int)threadIdx.x < n);
  };
  stage_rows(sq, xb, q0, min(kSelQ, N - q0), kSelQ, C, Cp, ld, vec,
             RowsAsIs{});
  stage_tile(0);
  cp_async_commit();

  // this lane's query; row m * 16 + h * 8 + g of the warp's fragments is
  // lane m * 16 + h * 8 + g's query
  const int qi = q0 + threadIdx.x;
  const bool valid = qi < N;
  const float qn = valid ? nb[qi] : 0.f;
  float rqn[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rqn[m][h] = __shfl_sync(all, qn, m * 16 + h * 8 + g);
  // mu qn + (tau + nu), rounded up; +inf (every key kept) while the list is
  // short, tau is not finite or qn is not below kHuge
  float rb = kInf;
  typename List::type top;
  init_list(top, sidx + threadIdx.x);
  unsigned long long count = 0;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, tile0 = tile_of(it);
    const int nt = min(FT, key1 - tile0);
    if (it + 1 < tiles) stage_tile(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile `it` (and the queries) in shared memory

    const float* K = sk + buf * FT * ld;
    // the tile's tf32 pairs: key n * 8 + gg, channel 16 p + tt + 4 j at
    // [lo][n][p][gg * 4 + tt][j], the b0 and b1 of k-steps 2 p and 2 p + 1
    // in one 16-byte word
    for (int e = threadIdx.x; e < FT * 4 * NP; e += kSelQ) {
      const int r = (e & (FT * 4 - 1)) >> 2, tt = e & 3, p = e / (FT * 4);
      const float* src = K + r * ld + p * 16 + tt;
      uint4 hi, lo;
      split_tf32(src[0], hi.x, lo.x);
      split_tf32(src[4], hi.y, lo.y);
      split_tf32(src[8], hi.z, lo.z);
      split_tf32(src[12], hi.w, lo.w);
      const int o = ((r >> 3) * NP + p) * 32 + (r & 7) * 4 + tt;
      reinterpret_cast<uint4*>(sb)[o] = hi;
      reinterpret_cast<uint4*>(sb + FT * Cp)[o] = lo;
    }
    if (threadIdx.x < FT) {
      const float kn = skn[buf * FT + threadIdx.x];
      const bool ok = kn < kHuge && (int)threadIdx.x < nt;  // NaN too
      sw[threadIdx.x] =
          kn < kHuge ? __fmul_ru(0.5f, __fsub_ru(__fmul_ru(mu, kn), kn))
                     : kInf;
      su[threadIdx.x] = ok ? __fmaf_ru(mu, kn, kn) : kInf;
    }
    __syncthreads();

    float acc[2][NT][4];  // [m-tile][n-tile][fragment]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[m][n][f] = 0.f;
    const float* Q = sq + warp * 32 * ld;
    const float4* bh = reinterpret_cast<const float4*>(sb);
    const float4* bl = reinterpret_cast<const float4*>(sb + FT * Cp);
    // the band: a warp whose queries' bands miss the tile (positions 32
    // warp .. 32 warp + 31 + 2 W) has no candidate in it, and skips it
    const bool near = !Out::kBand ||
                      (tile0 <= warp * 32 + 31 + 2 * W &&
                       tile0 + FT > warp * 32);
    for (int p = 0; near && p < NP; ++p) {
      uint32_t qh[2][2][4], ql[2][2][4];  // [k-step of the pair][m-tile]
#pragma unroll
      for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* r0 = Q + (m * 16 + g) * ld + p * 16 + sub * 8 + t4;
          const float* r8 = r0 + 8 * ld;
          split_tf32(r0[0], qh[sub][m][0], ql[sub][m][0]);
          split_tf32(r8[0], qh[sub][m][1], ql[sub][m][1]);
          split_tf32(r0[4], qh[sub][m][2], ql[sub][m][2]);
          split_tf32(r8[4], qh[sub][m][3], ql[sub][m][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 h4 = bh[(n * NP + p) * 32 + lane];
        const float4 l4 = bl[(n * NP + p) * 32 + lane];
        const uint32_t kh[2][2] = {
            {__float_as_uint(h4.x), __float_as_uint(h4.y)},
            {__float_as_uint(h4.z), __float_as_uint(h4.w)}};
        const uint32_t kl[2][2] = {
            {__float_as_uint(l4.x), __float_as_uint(l4.y)},
            {__float_as_uint(l4.z), __float_as_uint(l4.w)}};
#pragma unroll
        for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_tf32(acc[m][n], qh[sub][m], kh[sub][0], kh[sub][1]);
            mma_tf32(acc[m][n], qh[sub][m], kl[sub][0], kl[sub][1]);
            mma_tf32(acc[m][n], ql[sub][m], kh[sub][0], kh[sub][1]);
          }
        }
      }
    }

    // the filter: bit j of part[m][h] keeps key tile0 + j for row
    // m * 16 + h * 8 + g; this lane holds columns 2 t4 and 2 t4 + 1 of
    // each n-tile
    float rrb[2][2];
    if (it == 0) {
      if constexpr (KM >= kWideK) {  // every key of the first tile kept
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) rrb[m][h] = kInf;
      } else {
        first_bound<FT, KM, P, Out::kBand>(acc, rqn, su, qk0 + warp * 32,
                                           tile0, t4, g, k, low_mask, mu, nu,
                                           W, rrb);
      }
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          rrb[m][h] = __shfl_sync(all, rb, m * 16 + h * 8 + g);
    }
    float hrow[2][2];  // (qn - rb) / 2, rounded down
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hrow[m][h] = __fmul_rd(0.5f, __fsub_rd(rqn[m][h], rrb[m][h]));
    unsigned long long part[2][2] = {{0ull, 0ull}, {0ull, 0ull}};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float2 w2 = reinterpret_cast<const float2*>(sw)[n * 4 + t4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int h = f >> 1, e = f & 1;
        const float w = e ? w2.y : w2.x;
        const unsigned long long bit = 1ull << (n * 8 + 2 * t4 + e);
#pragma unroll
        for (int m = 0; m < 2; ++m)
          if (!(acc[m][n][f] < __fsub_rd(hrow[m][h], w))) part[m][h] |= bit;
      }
    }
    unsigned long long mine = 0;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned long long v = part[m][h];
        v |= __shfl_xor_sync(all, v, 1);
        v |= __shfl_xor_sync(all, v, 2);
        v = __shfl_sync(all, v, (lane & 7) * 4);
        if (m == (lane >> 4) && h == ((lane >> 3) & 1)) mine = v;
      }
    }
    if (nt < 64) mine &= (1ull << nt) - 1ull;
    if constexpr (Out::kBand)  // the query's band, positions t .. t + 2 W
      mine &= range_bits(threadIdx.x - tile0, threadIdx.x + 2 * W + 1 - tile0);
    const int sj = qk0 + threadIdx.x - tile0;
    if (sj >= 0 && sj < nt) mine |= 1ull << sj;  // self
    // the list's column of key tile0 + j: its index, or its band position
    const int col0 = tile0 - (Out::kBand ? (int)threadIdx.x : 0);

    // the exact fold of the candidates, in ascending key order
    if (valid) {
      count += __popcll(mine);
      const float4* q4 =
          reinterpret_cast<const float4*>(sq + threadIdx.x * ld);
      while (mine != 0ull) {
        const int j = __ffsll((long long)mine) - 1;
        mine &= mine - 1ull;
        const float4* k4 = reinterpret_cast<const float4*>(K + j * ld);
        float a = 0.f;
        for (int c4 = 0; c4 < Cp / 4; ++c4) {
          const float4 qv = q4[c4], kv = k4[c4];
          a = __fadd_rn(a, __fmul_rn(qv.x, kv.x));
          a = __fadd_rn(a, __fmul_rn(qv.y, kv.y));
          a = __fadd_rn(a, __fmul_rn(qv.z, kv.z));
          a = __fadd_rn(a, __fmul_rn(qv.w, kv.w));
        }
        float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, a)),
                            skn[buf * FT + j]);
        if (j == sj) d = kInf;  // self
        top.push(select_key<P>(d, low_mask, col0 + j), col0 + j);
      }
      const float tau = list_tau<KM, P>(top, k, low_mask);
      rb = (fabsf(tau) < kInf && qn < kHuge)
               ? __fmaf_ru(mu, qn, __fadd_ru(tau, nu))
               : kInf;
    }
    __syncthreads();  // tile `it` consumed before its buffers are refilled
  }

  if (refined != nullptr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) count += __shfl_xor_sync(all, count, o);
    if (lane == 0) atomicAdd(refined, count);
  }
  end_block<KM>(out, top, b, N, q0, valid, s, S, k, part_key, part_idx);
}

// The S * k partial entries of each query of a block of kSelQ, through one
// list, to the sink.
template <int KM, class Out>
__global__ void __launch_bounds__(kSelQ)
    knn_merge_kernel(const int32_t* __restrict__ part_key,
                     const int32_t* __restrict__ part_idx, Out out, int N,
                     int k, int S) {
  constexpr int kSmem = sink_floats<Out, KM>() > 0 ? sink_floats<Out, KM>()
                                                   : 1;
  __shared__ __align__(16) float smem[kSmem];
  const int b = blockIdx.y, q0 = blockIdx.x * kSelQ;
  const bool valid = q0 + (int)threadIdx.x < N;
  TopK<KM, Out::kPacked> top;
  top.init();
  if (valid) {
    const size_t base = ((size_t)b * N + q0 + threadIdx.x) * S * k;
    for (int e = 0; e < S * k; ++e)
      top.push(part_key[base + e], Out::kPacked ? 0 : part_idx[base + e]);
  }
  out.template finish<KM>(top, b, N, q0, valid, smem);
}

// One selection: norms (C > 4), the selection kernel over S chunks, and
// the merge (merges<Out>), all on `stream`. `scratch` holds
// select_scratch_words<Out>(B, N, C, k) int32. Returns the first nonzero
// cudaError_t.
template <class Out>
struct Select {
  Out out;
  const float* x;
  int32_t* scratch;
  unsigned long long* refined;
  int B, N, C, k, low_mask;
  float mu, nu;
  cudaStream_t stream;
  int W;  // the band's half-width (kernel F), else 0

  Split split() const { return key_split(B, N, C, band_keys(N, W)); }

  template <int FT, int KM>
  int filter(dim3 grid, const float* norms, int32_t* part_key,
             int32_t* part_idx) const {
    const Split sp = split();
    const int bytes =
        filter_smem_bytes(C, FT, FilterList<KM, Out::kPacked>::kSharedInts);
    const cudaError_t e = cudaFuncSetAttribute(
        knn_filter_kernel<FT, KM, Out>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    const int vec = C % 4 == 0 && (uintptr_t)x % 16 == 0;
    knn_filter_kernel<FT, KM, Out><<<grid, kSelQ, bytes, stream>>>(
        x, norms, out, part_key, part_idx, refined, N, C, k, sp.S, sp.chunk,
        low_mask, mu, nu, vec);
    return 0;
  }

  template <int KM>
  int run() const {
    const Split sp = split();
    const long long rows = (long long)B * N;
    float* norms = reinterpret_cast<float*>(scratch);
    int32_t* part_key = scratch + (C > kFilterAbove ? rows : 0);
    int32_t* part_idx = part_key + rows * sp.S * k;
    const dim3 grid((N + kSelQ - 1) / kSelQ, sp.S, B);
    if (C <= kFilterAbove) {
      // kernel F takes its CUDA-core pass (select_band) at these widths
      if constexpr (Out::kBand) return (int)cudaErrorInvalidValue;
      else
        knn_exact_kernel<KM, Out><<<grid, kSelQ, 0, stream>>>(
            x, out, part_key, part_idx, refined, N, C, k, sp.S, sp.chunk,
            low_mask);
    } else {
      knn_norms_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
          x, norms, rows, C);
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      const cudaError_t e =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e != cudaSuccess) return (int)e;
      int r;
      if constexpr (KM >= kWideK) {  // tiles of 32 whatever the grid
        r = filter<32, KM>(grid, norms, part_key, part_idx);
      } else {
        const long long blocks = (long long)grid.x * grid.y * grid.z;
        // the band's grid takes tiles of 32 only where tiles of 64 (two
        // blocks an SM) would spread it over two waves: P1's 256 blocks
        // fit one wave of 64 and read faster so on an H100
        const bool few = blocks <= (long long)kFewBlocksPerSm * sms &&
                         (!Out::kBand || blocks > 2LL * sms);
        r = few ? filter<32, KM>(grid, norms, part_key, part_idx)
                : filter<64, KM>(grid, norms, part_key, part_idx);
      }
      if (r != 0) return r;
    }
    if (merges<Out>(sp) && cudaPeekAtLastError() == cudaSuccess)
      knn_merge_kernel<KM, Out>
          <<<dim3((N + kSelQ - 1) / kSelQ, B), kSelQ, 0, stream>>>(
              part_key, part_idx, out, N, k, sp.S);
    return (int)cudaGetLastError();
  }

  int operator()() const {
    return k <= 10 ? run<10>() : (k <= 32 ? run<32>() : run<kWideK>());
  }
};

}  // namespace
}  // namespace spgan
