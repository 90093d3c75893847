// Kernel G: exact self-kNN above 8192 points, idx [B, N, k] int32 and
// dist [B, N, k] f32, bit-equal to kernel A (knn.cu) and to knn_plain.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/knn.py::knn_pallas_blocked
// (_knn_blocked_kernel), which knn_pallas switches to for N > 8192. The
// function is kernel A's: d = (|q|^2 - 2 q.k) + |k|^2 with the cross term
// and the norms folded over the channels left to right, each product and
// each sum rounded to f32, no FMA (knn_common.cuh); the k smallest of each
// query's N - 1 keys (self at +inf) in (distance, index) order.
//
// Two kernels, chosen by the width C:
//
//   * C <= kFilterAbove (4): knn_exact_kernel, the CUDA cores fold every
//     pair, as kernel A does: 2 C + 3 f32 operations a pair, 9 at
//     EdgeConv1's C = 3, where a filter would spend as much on a pair
//     before any exact fold. One instantiation, for the width P2 runs.
//   * C > 4: knn_filter_kernel, a tensor-core filter in front of the exact
//     f32 selection (below), after knn_norms_kernel has folded every
//     point's |x|^2 once. It takes C at run time, so every width above 4
//     (P2's EdgeConv2 runs 64) goes through one kernel.
//
// Split. Both keep one running list per query over a chunk of keys. A
// block holds kQ = 128 queries of one cloud. The keys are cut into S
// chunks only as far as filling the card needs: S = ceil(kFillBlocks /
// (B * ceil(N / 128))), at least 1 and at most ceil(N / 64), each chunk a
// multiple of 64 keys; kFillBlocks = 2048 (about 16 blocks an SM). At P2
// ([16, 16384, C]) that is 2,048 query blocks and S = 1; at B = 1 and
// N = 16384, S = 16. With S > 1 a merge pass pushes each query's S * k
// partial entries, (orderable distance, index), through the same top-k.
// k <= 10 (P2's k) keeps a list of 10, 11 <= k <= 32 one of 32. A block
// walks its chunk in tiles of 64 keys starting at the tile that holds its
// own first query, wrapping around: on a cloud stored in spatial order
// (the sphere template, and the features computed from it) the first
// tiles hold near neighbours, so the list's k-th distance falls early and
// few later keys get past it. A list keeps the k smallest of what it is
// given in any order, so the walk's order changes no result.
//
// The filter. Warp w owns queries 32w .. 32w + 31 of the block, lane r
// the list of query 32w + r. Key tiles land as f32 rows by cp.async in two
// buffers (the next while this one is used); channels are zero-padded to
// Cp, a multiple of 16 (a zero term is exact in every sum below). The
// block splits each tile once into tf32 pairs in fragment order: x = hi +
// lo exactly, hi = tf32(x), lo = x - hi, each operand rounded to tf32
// (cvt.rna). Each warp computes c~ ~ q.k for its 32 x 64 pairs with
// mma.sync m16n8k8 TF32 in three products, hi.hi + hi.lo + lo.hi, into
// one f32 accumulator. With qn and kn the exact-fold norms and tau the
// exact distance of the query's k-th entry, key j is dropped only if
//
//   e > T,  e = qn - 2 c~                            rounded down,
//           T = (mu qn + (tau + nu)) + (mu kn - kn)  each step rounded up,
//
// written !(e > T): a NaN is kept. The query itself is always kept, and
// every key is kept where tau is not finite (while the list is short) or
// qn or kn is not below 2^125 (inf and NaN included). The candidates of
// the tile (a 64-bit mask per query, ORed across the lanes of the mma
// fragment by shuffles, then handed to the owner lane) get the exact fold
// from the staged f32 rows and are pushed into the owner's list in
// ascending key order; tau is read again for the next tile. The first
// tile meets tau = +inf and takes every key, so a degenerate cloud turns
// into the exact pass and stays right.
//
// Why the result is exact. (distance, index) is a total order, and a list
// keeps the k smallest of the keys pushed into it. So if every key of the
// chunk's exact top-k is pushed, the list ends as that top-k, in its order
// and with the fold's distances, whatever else was pushed. tau only falls
// and is always the k-th of the keys pushed so far, so a key j of the
// final top-k has d_j <= tau whenever its tile is filtered. Where the
// filter can drop j at all, tau is finite and qn, kn < 2^125, so 2 |acc|
// and 2 |c~| stay below 2^127 and no step overflows; a dropped key has
// qn - 2 c~ + kn > tau + nu + mu (qn + kn) in real numbers (e rounds
// down, T up), so it is enough that d_j >= qn - 2 c~ + kn - mu (qn + kn)
// - nu: then d_j > tau. With u = 2^-24, S = sum_c |q_c k_c| and acc the
// fold of q.k:
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
//         TF32 sums is cited here: chip_smoke.py and the card test check
//         the margin on the H100 (a sweep of mu on the hard inputs, and
//         mu = 0 on a cloud far from the origin, which must differ);
//   2 S <= |q|^2 + |k|^2 <= (qn + kn) / (1 - gamma).
//
// Together qn - 2 c~ + kn - d <= (gamma + 3.003 t^2 + 3 Cp 2^-22 (1 +
// 2^-7) + 4.001 u) (qn + kn) / (1 - gamma): 1.031e-4 (qn + kn) at Cp =
// 128, 5.317e-5 (qn + kn) at Cp = 64. Below 2^-126 the cores may flush
// operands, products and sums to zero: a flushed operand of magnitude a <
// 2^-126 loses at most 2 * 3 a |k_c| <= (mu / 16) k_c^2 + 144 a^2 / mu a
// channel (and the same with q and k swapped), at most (mu / 16)(qn + kn)
// + 2^-220 in all; flushed products and sums lose at most 2 * 1024 *
// 2^-126 = 2^-115, and the fold's gradual underflow less. So mu (15/16)
// >= 1.100e-4 and nu >= 2^-114 suffice. The wrapper
// (ops/kernels/knn_blocked.py) passes mu = 2^-12 = 2.441e-4, a factor of
// safety of 2.22 at Cp = 128 (4.30 at Cp = 64) on a model of the cores'
// sums that is itself twice the bound of f32 additions, and nu = 2^-100,
// 2^14 times the absolute terms. On an H100 (80GB HBM3, 700 W) the hard
// inputs of chip_smoke.py's sweep at C = 64 stayed bit-equal to kernel A
// down to mu = 2^-18 and broke at 2^-20 (randn + 1000 first), and with
// mu = nu = 0 on four of five inputs. TF32 only decides which keys get
// the exact fold: every pick and every distance returned is the fold's.
//
// What bounds it on an H100: at P2's EdgeConv2 call [16, 16384, 64], k =
// 10 the three TF32 products are 3 * 2 * 16 * 16384^2 * 64 = 1.65 TFLOP,
// 3.3 ms at 495 TFLOP/s; the exact folds of the candidates (about a
// hundred a query) and the bytes (67 MB in, 21 MB out) are far below
// that. At EdgeConv1's [16, 16384, 3] every pair is folded: 9 f32
// operations a pair, 1.16 ms at 33.5 Tops/s. chip_smoke.py counts the
// pairs each call folds exactly and computes the bound from that count.
#include "knn_common.cuh"

namespace {

constexpr int kQ = spgan::kQueries;  // queries per block, one per thread
constexpr int kT = 64;               // keys per tile (= spgan::kTileKeys)
constexpr int kFillBlocks = 2048;    // blocks the split aims at
constexpr int kFilterAbove = 4;      // C above which the filter runs
constexpr int kMergeThreads = 128;
constexpr float kInf = __builtin_huge_valf();
// qn or kn from here up (or NaN) keeps the pair outright: below it no step
// of the fold or of the filter can overflow
constexpr float kHuge = 0x1p125f;
static_assert(kT == spgan::kTileKeys, "both kernels walk the same tiles");

struct Split {
  int S, chunk;
};

Split key_split(int B, int N) {
  const long long qblocks = (long long)B * ((N + kQ - 1) / kQ);
  long long S = (kFillBlocks + qblocks - 1) / qblocks;
  S = S < 1 ? 1 : S;
  const long long most = (N + kT - 1) / kT;
  S = S > most ? most : S;
  int chunk = (int)((N + S - 1) / S);
  chunk = (chunk + kT - 1) / kT * kT;
  return {(N + chunk - 1) / chunk, chunk};
}

// The tile of the chunk [key0, key1) a block of queries from q0 walks
// first: the one holding q0, or the chunk's first.
__device__ __forceinline__ int first_tile(int q0, int key0, int key1) {
  return (q0 >= key0 && q0 < key1) ? (q0 - key0) / kT : 0;
}

// The first k entries of `top` for the query row `row` of chunk `s`: to
// idx and dist when there is one chunk, else to the partial lists.
template <int KM>
__device__ __forceinline__ void store_list(const spgan::TopK<KM, false>& top,
                                           size_t row, int s, int S, int k,
                                           int32_t* part_key,
                                           int32_t* part_idx, int32_t* idx,
                                           float* dist) {
  if (S == 1) {
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      if (t < k) {
        idx[row * k + t] = top.idx[t];
        dist[row * k + t] = spgan::unorderable(top.key[t]);
      }
    }
    return;
  }
  const size_t o = (row * S + s) * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      part_key[o + t] = top.key[t];
      part_idx[o + t] = top.idx[t];
    }
  }
}

// C <= 4: every pair of the chunk folded on the CUDA cores (kernel A's
// load_query, stage_keys and key_dist). A key whose distance exceeds the
// list's last entry's is not pushed: the push would drop it.
template <int CM, int KM>
__global__ void __launch_bounds__(kQ)
    knn_exact_kernel(const float* __restrict__ x, int32_t* __restrict__ part_key,
                     int32_t* __restrict__ part_idx, int32_t* __restrict__ idx,
                     float* __restrict__ dist,
                     unsigned long long* __restrict__ refined, int N, int C,
                     int k, int S, int chunk) {
  __shared__ __align__(16) float sk[kT * CM];
  __shared__ float skn[kT];
  const int b = blockIdx.z, s = blockIdx.y, q0 = blockIdx.x * kQ;
  const int qi = q0 + threadIdx.x;
  const bool valid = qi < N;
  const int key0 = s * chunk, key1 = min(N, key0 + chunk);
  const int tiles = (key1 - key0 + kT - 1) / kT;
  const int first = first_tile(q0, key0, key1);
  const float* xb = x + (size_t)b * N * C;
  float q[CM];
  const float qn = spgan::load_query<CM>(xb, C, qi, valid, q);
  spgan::TopK<KM, false> top;
  top.init();
  float last = spgan::unorderable(top.key[KM - 1]);  // NaN: take all
  for (int it = 0; it < tiles; ++it) {
    const int ti = first + it < tiles ? first + it : first + it - tiles;
    const int tile0 = key0 + ti * kT, nt = min(kT, key1 - tile0);
    spgan::stage_keys<CM>(xb, C, tile0, nt, spgan::RowsAsIs{}, sk, skn);
    if (!valid) continue;
    for (int t = 0; t < nt; ++t) {
      float d = spgan::key_dist<CM>(q, qn, sk + t * CM, skn[t]);
      if (tile0 + t == qi) d = kInf;  // self
      if (!(d > last)) {
        top.push(spgan::orderable(d), tile0 + t);
        last = spgan::unorderable(top.key[KM - 1]);
      }
    }
  }
  if (refined != nullptr && threadIdx.x == 0)
    atomicAdd(refined, (unsigned long long)min(kQ, N - q0) *
                           (unsigned long long)(key1 - key0));
  if (valid)
    store_list<KM>(top, (size_t)b * N + qi, s, S, k, part_key, part_idx, idx,
                   dist);
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

// rows [r0, r0 + n) of the cloud xb [N, C] into dst [rows, ld], channels
// zero-padded to Cp and rows past n zero; 16 bytes a copy where `vec`
// (C % 4 == 0 and x 16-byte aligned)
__device__ __forceinline__ void stage_rows(float* dst, const float* xb,
                                           int r0, int n, int rows, int C,
                                           int Cp, int ld, bool vec) {
  if (vec) {
    const int per = Cp / 4;
    for (int e = threadIdx.x; e < rows * per; e += kQ) {
      const int r = e / per, c = (e % per) * 4;
      const bool full = r < n && c < C;
      cp_async(dst + r * ld + c, full ? xb + (size_t)(r0 + r) * C + c : xb,
               16, full);
    }
  } else {
    for (int e = threadIdx.x; e < rows * Cp; e += kQ) {
      const int r = e / Cp, c = e % Cp;
      const bool full = r < n && c < C;
      cp_async(dst + r * ld + c, full ? xb + (size_t)(r0 + r) * C + c : xb, 4,
               full);
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
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

__host__ __device__ constexpr int filter_cp(int C) { return (C + 15) / 16 * 16; }

// Shared floats of a filter block, ld = Cp + 4 (conflict-free fragment
// loads): the query rows [kQ, ld], two key tiles [kT, ld], their norms
// [2, kT], the current tile's tf32 pairs in fragment order [2, kT * Cp]
// and its keys' thresholds mu kn - kn [kT].
int filter_smem_bytes(int C) {
  const int Cp = filter_cp(C), ld = Cp + 4;
  return (kQ * ld + 2 * kT * ld + 2 * kT + 2 * kT * Cp + kT) *
         (int)sizeof(float);
}

template <int KM>
__global__ void __launch_bounds__(kQ)
    knn_filter_kernel(const float* __restrict__ x,
                      const float* __restrict__ norms,
                      int32_t* __restrict__ part_key,
                      int32_t* __restrict__ part_idx,
                      int32_t* __restrict__ idx, float* __restrict__ dist,
                      unsigned long long* __restrict__ refined, int N, int C,
                      int k, int S, int chunk, float mu, float nu, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int Cp = filter_cp(C), ld = Cp + 4, P = Cp / 16;
  float* sq = smem;                // [kQ, ld] the block's query rows
  float* sk = sq + kQ * ld;        // [2, kT, ld] key tiles
  float* skn = sk + 2 * kT * ld;   // [2, kT] their norms
  float* sb = skn + 2 * kT;        // [2 (hi, lo), 8, P, 32, 4] tf32 pairs
  float* sw = sb + 2 * kT * Cp;    // [kT] mu kn - kn, rounded up
  const int b = blockIdx.z, s = blockIdx.y, q0 = blockIdx.x * kQ;
  const int key0 = s * chunk, key1 = min(N, key0 + chunk);
  const int tiles = (key1 - key0 + kT - 1) / kT;
  const int first = first_tile(q0, key0, key1);
  const float* xb = x + (size_t)b * N * C;
  const float* nb = norms + (size_t)b * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned all = 0xffffffffu;

  auto tile_of = [&](int it) {
    const int ti = first + it < tiles ? first + it : first + it - tiles;
    return key0 + ti * kT;
  };
  auto stage_tile = [&](int it) {
    const int tile0 = tile_of(it), buf = it & 1;
    const int n = min(kT, key1 - tile0);
    stage_rows(sk + buf * kT * ld, xb, tile0, n, kT, C, Cp, ld, vec);
    if (threadIdx.x < kT)
      cp_async(skn + buf * kT + threadIdx.x,
               (int)threadIdx.x < n ? nb + tile0 + threadIdx.x : nb, 4,
               (int)threadIdx.x < n);
  };
  stage_rows(sq, xb, q0, min(kQ, N - q0), kQ, C, Cp, ld, vec);
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
  spgan::TopK<KM, false> top;
  top.init();
  unsigned long long count = 0;

  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, tile0 = tile_of(it);
    const int nt = min(kT, key1 - tile0);
    if (it + 1 < tiles) stage_tile(it + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile `it` (and the queries) in shared memory

    const float* K = sk + buf * kT * ld;
    // the tile's tf32 pairs: key n * 8 + gg, channel 16 p + tt + 4 j at
    // [lo][n][p][gg * 4 + tt][j], the b0 and b1 of k-steps 2 p and 2 p + 1
    // in one 16-byte word
    for (int e = threadIdx.x; e < kT * 4 * P; e += kQ) {
      const int r = (e & (kT * 4 - 1)) >> 2, tt = e & 3, p = e / (kT * 4);
      const float* src = K + r * ld + p * 16 + tt;
      uint4 hi, lo;
      split_tf32(src[0], hi.x, lo.x);
      split_tf32(src[4], hi.y, lo.y);
      split_tf32(src[8], hi.z, lo.z);
      split_tf32(src[12], hi.w, lo.w);
      const int o = ((r >> 3) * P + p) * 32 + (r & 7) * 4 + tt;
      reinterpret_cast<uint4*>(sb)[o] = hi;
      reinterpret_cast<uint4*>(sb + kT * Cp)[o] = lo;
    }
    if (threadIdx.x < kT) {
      const float kn = skn[buf * kT + threadIdx.x];
      sw[threadIdx.x] =
          kn < kHuge ? __fsub_ru(__fmul_ru(mu, kn), kn) : kInf;  // NaN too
    }
    __syncthreads();

    float acc[2][8][4];  // [m-tile][n-tile][fragment]
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[m][n][f] = 0.f;
    const float* Q = sq + warp * 32 * ld;
    const float4* bh = reinterpret_cast<const float4*>(sb);
    const float4* bl = reinterpret_cast<const float4*>(sb + kT * Cp);
    for (int p = 0; p < P; ++p) {
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
      for (int n = 0; n < 8; ++n) {
        const float4 h4 = bh[(n * P + p) * 32 + lane];
        const float4 l4 = bl[(n * P + p) * 32 + lane];
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
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        rrb[m][h] = __shfl_sync(all, rb, m * 16 + h * 8 + g);
    unsigned long long part[2][2] = {{0ull, 0ull}, {0ull, 0ull}};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 w2 = reinterpret_cast<const float2*>(sw)[n * 4 + t4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int h = f >> 1, e = f & 1;
        const float w = e ? w2.y : w2.x;
        const unsigned long long bit = 1ull << (n * 8 + 2 * t4 + e);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float ev = __fmaf_rd(-2.f, acc[m][n][f], rqn[m][h]);
          if (!(ev > __fadd_ru(rrb[m][h], w))) part[m][h] |= bit;
        }
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
    if (nt < kT) mine &= (1ull << nt) - 1ull;
    const int sj = qi - tile0;
    if (sj >= 0 && sj < nt) mine |= 1ull << sj;  // self

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
                            skn[buf * kT + j]);
        if (j == sj) d = kInf;  // self
        top.push(spgan::orderable(d), tile0 + j);
      }
      int kth = INT_MAX;
#pragma unroll
      for (int t = 0; t < KM; ++t)
        if (t == k - 1) kth = top.key[t];
      const float tau = spgan::unorderable(kth);  // NaN while short
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
  if (valid)
    store_list<KM>(top, (size_t)b * N + qi, s, S, k, part_key, part_idx, idx,
                   dist);
}

template <int KM>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const int32_t* __restrict__ part_key,
                     const int32_t* __restrict__ part_idx,
                     int32_t* __restrict__ idx, float* __restrict__ dist,
                     int64_t rows, int k, int S) {
  const int64_t row = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= rows) return;
  spgan::TopK<KM, false> top;
  top.init();
  const size_t base = (size_t)row * S * k;
  for (int e = 0; e < S * k; ++e)
    top.push(part_key[base + e], part_idx[base + e]);
  const size_t o = (size_t)row * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      idx[o + t] = top.idx[t];
      dist[o + t] = spgan::unorderable(top.key[t]);
    }
  }
}

struct KnnBlockedLaunch {
  const float* x;
  float* norms;
  int32_t *part_key, *part_idx, *idx;
  float* dist;
  unsigned long long* refined;
  int B, N, C, k;
  float mu, nu;
  Split sp;
  int vec;
  cudaStream_t stream;

  template <int KM>
  int operator()() const {
    const dim3 grid((N + kQ - 1) / kQ, sp.S, B);
    if (C <= kFilterAbove) {
      knn_exact_kernel<kFilterAbove, KM><<<grid, kQ, 0, stream>>>(
          x, part_key, part_idx, idx, dist, refined, N, C, k, sp.S, sp.chunk);
    } else {
      const long long rows = (long long)B * N;
      knn_norms_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, stream>>>(
          x, norms, rows, C);
      const int bytes = filter_smem_bytes(C);
      const cudaError_t e = cudaFuncSetAttribute(
          knn_filter_kernel<KM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (e != cudaSuccess) return (int)e;
      knn_filter_kernel<KM><<<grid, kQ, bytes, stream>>>(
          x, norms, part_key, part_idx, idx, dist, refined, N, C, k, sp.S,
          sp.chunk, mu, nu, vec);
    }
    if (sp.S > 1 && cudaPeekAtLastError() == cudaSuccess) {
      const int64_t rows = (int64_t)B * N;
      knn_merge_kernel<KM>
          <<<(unsigned)((rows + kMergeThreads - 1) / kMergeThreads),
             kMergeThreads, 0, stream>>>(part_key, part_idx, idx, dist, rows,
                                         k, sp.S);
    }
    return (int)cudaGetLastError();
  }
};

}  // namespace

// int32 words of scratch a call needs: the norms of the filter (B * N,
// C > 4) and, with S > 1 key chunks, the partial lists (2 * B * N * S * k).
extern "C" long long spgan_knn_blocked_scratch(int B, int N, int C, int k) {
  if (B <= 0 || N <= 0 || k <= 0) return 0;
  const Split sp = key_split(B, N);
  const long long rows = (long long)B * N;
  return (C > kFilterAbove ? rows : 0) +
         (sp.S > 1 ? 2 * rows * sp.S * k : 0);
}

// x [B, N, C] f32 contiguous on the device; idx, dist [B, N, k]; scratch
// of spgan_knn_blocked_scratch(B, N, C, k) int32, needing no
// initialisation; refined null or one unsigned 64-bit counter, to which
// the call adds the (query, key) pairs it folds exactly. mu and nu: the
// filter's margin (above). Launches on `stream` and returns the first
// nonzero cudaError_t (0 on success). Takes C <= 128,
// 1 <= k <= min(32, N - 1) and B <= 65535.
extern "C" int spgan_knn_blocked(const void* x, void* scratch, void* idx,
                                 void* dist, void* refined, int B, int N,
                                 int C, int k, float mu, float nu,
                                 void* stream) {
  if (B <= 0 || B > 65535 || N <= 1 || C <= 0 || C > 128 || k <= 0 ||
      k >= N || k > 32)
    return (int)cudaErrorInvalidValue;
  const Split sp = key_split(B, N);
  const long long rows = (long long)B * N;
  int32_t* words = static_cast<int32_t*>(scratch);
  int32_t* part = words + (C > kFilterAbove ? rows : 0);
  const KnnBlockedLaunch f{static_cast<const float*>(x),
                           reinterpret_cast<float*>(words),
                           part,
                           part + rows * sp.S * k,
                           static_cast<int32_t*>(idx),
                           static_cast<float*>(dist),
                           static_cast<unsigned long long*>(refined),
                           B,
                           N,
                           C,
                           k,
                           mu,
                           nu,
                           sp,
                           C % 4 == 0 && (uintptr_t)x % 16 == 0,
                           static_cast<cudaStream_t>(stream)};
  return k <= 10 ? f.operator()<10>() : f.operator()<32>();
}
