// Kernels D, H and M: deterministic scatter-adds by target through a CSR
// inversion of the index lists, with no float atomics.
//
// Kernel M (spgan_edge_scatter_bwd): backward of the concat-form edge op
// (kernel B without diff_only), ee = [central, nbr - central].
// d_ee [B, N, k, 2C] in f32 or bf16 and idx [B, N, k] int32 ->
//   d_x[b, p, :] = sum_{(q, j): idx[b, q, j] = p} d_ee[b, q, j, C:]
//                  + sum_j (d_ee[b, p, j, :C] - d_ee[b, p, j, C:])
// in f32, accumulated in f32 for bf16 d_ee too. Replaces the TPU kernel
// sp_gan_tpu/ops/pallas/scatter.py::edge_scatter_bwd_pallas
// (_edge_bwd_kernel), which the JAX package runs under SPGAN_EDGE_BWD=pallas
// (sp_gan_tpu/ops/edge.py:147-155): there an O(N^2 k C) one-hot matmul over
// the neighbor half, f32 made exact by a hi/mid/lo bf16 split, the central
// sum added where the target tile is the source tile. Here it is the four
// passes below on the neighbor half (sources at a row stride of 2C), then
// the central sum (j ascending, each term a - b in f32) added last. What
// bounds it on an H100: at the --fused_train step's EdgeConv2 (d_ee
// [24, 2048, 10, 128] bf16) the function moves 125.8 MB of d_ee, 2.0 MB of
// idx and 12.6 MB of d_x (140.4 MB, 42 us at 3.35 TB/s) for 94 MFLOP of
// adds: bytes.
//
// Kernel H (spgan_scatter_add): g [B, S, F] in f32 or bf16 and idx [B, S]
// int32 -> out[b, p, :] = sum_{s: idx[b, s] = p} g[b, s, :], [B, n, F] f32.
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/scatter.py::
// scatter_add_pallas (_scatter_kernel), the backward of the neighbor gather
// once its one-hot would pass 1 GiB (sp_gan_tpu/ops/edge.py:64-72): the
// transpose of gather_neighbors on the unfused large-N path. It runs the
// four passes below with n targets and S sources per cloud and no central
// term. What bounds it on an H100: at P3's shape (g [2, 163840, 64] bf16,
// N=16384, k=10) the function moves 41.9 MB of g, 1.3 MB of idx and
// 8.4 MB of out (51.6 MB, 15 us at 3.35 TB/s) for 21 MFLOP of adds, so
// bytes bound it.
//
// Kernel D (spgan_scatter_diff_bwd): backward of the diff-only edge op
// (kernel B or F with diff_only), and of the neighbor half of the concat
// edges (EdgeConcat hands it d_ee[..., C:] in place, rows at a stride of
// 2C).
// d_diff [B, N, k, C] (rows at any stride >= C) in f32 or bf16 and idx
// [B, N, k] int32 ->
//   d_x[b, p, :] = sum_{(q, j): idx[b, q, j] = p} d_diff[b, q, j, :]
//                  - sum_j d_diff[b, p, j, :]
// in f32, accumulated in f32. Replaces the TPU kernel
// sp_gan_tpu/ops/pallas/scatter.py::scatter_diff_bwd_pallas
// (_diff_bwd_kernel), an O(N^2 k C) one-hot matmul on the MXU with a
// hi/mid/lo bf16 split to make f32 exact. Kernel D is kernel H on the
// sources s = q * k + j (n = N, S = N k) plus the central term. At the
// training shape d_diff [24, 2048, 10, 64] bf16 the function moves 62.9 MB
// of d_diff, 2.0 MB of idx and 12.6 MB of d_x (77.5 MB, 23 us at 3.35
// TB/s) for 66 MFLOP of adds: bytes. At D's calls (the default step and
// F1: 24 clouds of 2048 targets and 20480 sources; P1: 4 of 8192 and
// 81920) the four passes take 0.132 ms of device time at the default call
// and 0.097 at P1, the sum pass 0.111 and 0.079 of it, each row read
// twice (as an in-edge, as an own row) at about 1.1 TB/s (H100 80GB HBM3,
// 700 W). Four designs written for these shapes were measured on that
// card (PERF.md), and none was faster at both calls: a block per 128
// targets that scans its cloud's idx and groups its in-edges in shared
// memory in one launch (0.124-0.130 and 0.099-0.117 ms), the same on the
// bucket lists of passes 1 and 2 (0.139 and 0.089), blocks of 32 targets
// (0.127 and 0.099), and the central sums streamed first by a kernel of
// their own (0.149 and 0.121). D keeps the four passes; its rows may lie
// at any stride, so F1's neighbor half is read in place, with no copy.
//
// The work is O(S C) per cloud: a stable counting sort of the sources by
// target (two digits, most significant first) gives each target its
// sources in ascending order by construction, and each target row sums
// them in that order.
//
//   1. hist:  a block per tile of 2048 sources counts them by bucket, the
//             target's high digit (p / TB, TB = 128 targets a bucket up to
//             n = 131072);
//   2. place: a block per tile scans the histograms of its cloud (the
//             buckets' starts, and the counts of its bucket in earlier
//             tiles) and writes each source, with its target, to its
//             bucket's next slot: warp w takes the tile's w-th run of 256
//             sources in rounds of 32, and a source's slot is its
//             bucket's base for the warp plus its rank among the lanes of
//             the round with the same bucket (__match_any_sync). Sources
//             stay in ascending order within each bucket;
//   3. sort:  a block per bucket orders its entries by the low digit
//             (p mod TB) the same stable way, in shared-memory counts, so
//             that each target's sources are contiguous and ascending, and
//             writes each target's first row of the sorted list;
//   4. sum:   a warp per target row (the card full of warps, so that their
//             loads hide each other's latency) loads 32 of its source
//             indices at once, hands each row's index to the warp by a
//             shuffle, and keeps 8-32 rows in flight (a 64-channel bf16
//             row is one 128-byte load of 32 words of two bf16); each
//             channel adds the rows in ascending source order (__fadd_rn),
//             then the central term of the row's own central_k sources, j
//             ascending, last, as the TPU kernel does (scatter.py:167-169).
//             A hub's row takes its warp in-degree / 32 load latencies.
//
// Deterministic: the sort is stable and integer, and the sums run in a
// fixed order, so two launches give bit-identical output, and the order is
// the plain version's index_add_ on the CPU (ascending source). No float
// atomics, no hub-dependent sort cost (a hub's sources are one contiguous
// run of the sorted list). Entries of idx outside [0, n) are dropped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kTile = 2048;        // sources of a tile in passes 1 and 2
constexpr int kPlaceThreads = 256;  // passes 1 and 2: 8 warps, 8 rounds each
constexpr int kSortThreads = 256;   // pass 3
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSumThreads = 256;    // pass 4: a warp per target
constexpr int kMaxBuckets = 1024;
constexpr int kMinTargetsPerBucket = 128;
constexpr int kMaxTargetsPerBucket = 512;
constexpr int kMaxC = 128;

// A lane's V values of a row, kept as raw 32-bit words from the load until
// they are added: f32 one word a value, bf16 two values a word
template <typename T, int V>
struct Raw {
  static constexpr int kWords = sizeof(T) == 4 ? V : (V + 1) / 2;
  uint32_t w[kWords];
};

// loads the V values at p (V * sizeof(T)-byte aligned), or zeros if !ok
template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, bool ok, Raw<T, V>& r) {
#pragma unroll
  for (int i = 0; i < Raw<T, V>::kWords; ++i) r.w[i] = 0u;
  if (!ok) return;
  if constexpr (sizeof(T) == 4 && V == 1) {
    r.w[0] = __float_as_uint(__ldg(reinterpret_cast<const float*>(p)));
  } else if constexpr (sizeof(T) == 4 && V == 2) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
  } else if constexpr (sizeof(T) == 4) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
    r.w[2] = x.z;
    r.w[3] = x.w;
  } else if constexpr (V == 1) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else if constexpr (V == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = x.x;
    r.w[1] = x.y;
  }
}

// value v of the V as f32 (bf16 widens exactly: its bits are the top half)
template <typename T, int V>
__device__ __forceinline__ float value(const Raw<T, V>& r, int v) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(r.w[v]);
  } else {
    const uint32_t x = r.w[v / 2];
    return __uint_as_float((v & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// Exclusive prefix sum of a[0, len) in place over a block of kT threads,
// each thread a contiguous run; returns the total to every thread.
template <int kT>
__device__ int32_t block_exclusive_scan(int32_t* a, int len,
                                        int32_t* warp_tot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (len + kT - 1) / kT;
  const int lo = min(t * per, len), hi = min(lo + per, len);
  int32_t local = 0;
  for (int i = lo; i < hi; ++i) local += a[i];
  int32_t inc = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t x = lane < kT / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += v;
    }
    if (lane < kT / 32) warp_tot[lane] = x;  // inclusive over warps
  }
  __syncthreads();
  int32_t run = inc - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int32_t v = a[i];
    a[i] = run;
    run += v;
  }
  const int32_t total = warp_tot[kT / 32 - 1];
  __syncthreads();
  return total;
}

// Pass 1: hist[b][tile][q] = sources of the tile whose target is in
// bucket q (targets in [0, n) only).
__global__ void __launch_bounds__(kPlaceThreads)
    hist_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ hist,
                int n, int S, int nq, int shift) {
  extern __shared__ int32_t h[];  // [nq]
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  for (int q = threadIdx.x; q < nq; q += kPlaceThreads) h[q] = 0;
  __syncthreads();
  const int32_t* ix = idx + (int64_t)b * S;
  const int lo = tile * kTile, hi = min(lo + kTile, S);
  for (int s = lo + threadIdx.x; s < hi; s += kPlaceThreads) {
    const int p = ix[s];
    if ((unsigned)p < (unsigned)n) atomicAdd(&h[p >> shift], 1);
  }
  __syncthreads();
  int32_t* out = hist + ((int64_t)b * tiles + tile) * nq;
  for (int q = threadIdx.x; q < nq; q += kPlaceThreads) out[q] = h[q];
}

// Pass 2: each source of the tile (index s, target p) to
// part[b][bucket base + rank] = (s, p), stable; the tile-0 block of each
// cloud also writes the buckets' starts bstart[b][0, nq].
__global__ void __launch_bounds__(kPlaceThreads)
    place_kernel(const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ hist, int2* __restrict__ part,
                 int32_t* __restrict__ bstart, int n, int S, int nq,
                 int shift) {
  extern __shared__ int32_t sm[];
  int32_t* base = sm;            // [nq]: the tile's first slot of bucket q
  int32_t* whist = sm + nq;      // [8][nq]: per warp, counts then bases
  __shared__ int32_t warp_tot[kPlaceThreads / 32];
  constexpr int kWarps = kPlaceThreads / 32;
  constexpr int kRounds = kTile / kPlaceThreads;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int32_t* hb = hist + (int64_t)b * tiles * nq;

  // the bucket totals and this tile's share of earlier tiles
  for (int q = t; q < nq; q += kPlaceThreads) {
    int32_t total = 0, pre = 0;
#pragma unroll 8
    for (int tt = 0; tt < tiles; ++tt) {
      const int32_t v = hb[(int64_t)tt * nq + q];
      total += v;
      pre += tt < tile ? v : 0;
    }
    base[q] = total;
    whist[q] = pre;  // borrowed until the scan is done
  }
  for (int i = t + nq; i < kWarps * nq; i += kPlaceThreads) whist[i] = 0;
  __syncthreads();
  const int32_t all = block_exclusive_scan<kPlaceThreads>(base, nq, warp_tot);
  if (tile == 0) {
    int32_t* bs = bstart + (int64_t)b * (nq + 1);
    for (int q = t; q < nq; q += kPlaceThreads) bs[q] = base[q];
    if (t == 0) bs[nq] = all;
  }
  for (int q = t; q < nq; q += kPlaceThreads) {
    base[q] += whist[q];
    whist[q] = 0;
  }
  __syncthreads();

  // this warp's sources, by bucket
  const int32_t* ix = idx + (int64_t)b * S;
  const int s0 = tile * kTile + warp * (kTile / kWarps);
  int key[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int s = s0 + r * 32 + lane;
    const int p = s < S ? ix[s] : -1;
    key[r] = (unsigned)p < (unsigned)n ? p : -1;
    if (key[r] >= 0) atomicAdd(&whist[warp * nq + (key[r] >> shift)], 1);
  }
  __syncthreads();
  // per bucket: each warp's first slot, warps in order
  for (int q = t; q < nq; q += kPlaceThreads) {
    int32_t run = base[q];
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = whist[w * nq + q];
      whist[w * nq + q] = run;
      run += c;
    }
  }
  __syncthreads();
  int2* pb = part + (int64_t)b * S;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int q = key[r] >= 0 ? key[r] >> shift : -1;
    const unsigned same = __match_any_sync(0xffffffffu, q);
    if (q >= 0) {
      pb[whist[warp * nq + q] + __popc(same & below)] =
          make_int2(s0 + r * 32 + lane, key[r]);
    }
    __syncwarp();
    if (q >= 0 && (same & below) == 0)
      whist[warp * nq + q] += __popc(same);
    __syncwarp();
  }
}

// What a target row adds after its in-edges: nothing (kernel H), minus the
// sum of its own central_k source rows (kernel D), or plus the sum of
// a - b over its own rows, a the C values before each source row (kernel M)
enum Central { kNoCentral = 0, kSubtractOwn = 1, kAddConcat = 2 };


// Pass 3: a block per bucket q of cloud b. Its entries part[b][bstart[q],
// bstart[q + 1]) go to sorted[b] of the same range by the low digit,
// stable: warp w takes the w-th run of them in rounds of 32, each entry's
// slot its target's base for the warp plus its rank among the lanes of
// the round with the same target. Writes each target's first row,
// tstart[b][p] (and tstart[b][n], the cloud's rows, from the last bucket).
__global__ void __launch_bounds__(kSortThreads)
    sort_kernel(const int2* __restrict__ part,
                const int32_t* __restrict__ bstart,
                int32_t* __restrict__ sorted, int32_t* __restrict__ tstart,
                int n, int S, int nq, int TB) {
  extern __shared__ int32_t sm[];
  int32_t* first = sm;               // [TB]: the targets' first rows
  int32_t* whist = sm + TB;          // [kSortWarps][TB]
  __shared__ int32_t warp_tot[kSortWarps];
  const int b = blockIdx.y, q = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int32_t lo = bstart[(int64_t)b * (nq + 1) + q];
  const int E = bstart[(int64_t)b * (nq + 1) + q + 1] - lo;
  const int2* pe = part + (int64_t)b * S + lo;
  int32_t* srt = sorted + (int64_t)b * S + lo;

  for (int i = t; i < kSortWarps * TB; i += kSortThreads) whist[i] = 0;
  __syncthreads();
  const int run = (E + kSortWarps - 1) / kSortWarps;
  const int e0 = min(warp * run, E), e1 = min(e0 + run, E);
  for (int e = e0 + lane; e < e1; e += 32)
    atomicAdd(&whist[warp * TB + (pe[e].y & (TB - 1))], 1);
  __syncthreads();
  for (int p = t; p < TB; p += kSortThreads) {
    int32_t c = 0;
    for (int w = 0; w < kSortWarps; ++w) c += whist[w * TB + p];
    first[p] = c;
  }
  __syncthreads();
  block_exclusive_scan<kSortThreads>(first, TB, warp_tot);
  const int nvalid = min(TB, n - q * TB);
  int32_t* ts = tstart + (int64_t)b * (n + 1) + q * TB;
  for (int p = t; p < TB; p += kSortThreads) {
    int32_t r = first[p];
    if (p < nvalid) ts[p] = lo + r;
    for (int w = 0; w < kSortWarps; ++w) {
      const int32_t c = whist[w * TB + p];
      whist[w * TB + p] = r;
      r += c;
    }
  }
  if (q == nq - 1 && t == 0) ts[nvalid] = lo + E;
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
  for (int e = e0; e < e1; e += 32) {
    const bool ok = e + lane < e1;
    const int2 x = ok ? pe[e + lane] : make_int2(0, -1);
    const int lt = ok ? (x.y & (TB - 1)) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, lt);
    if (ok) srt[whist[warp * TB + lt] + __popc(same & below)] = x.x;
    __syncwarp();
    if (ok && (same & below) == 0) whist[warp * TB + lt] += __popc(same);
    __syncwarp();
  }
}

// Pass 4: a warp per target row p of cloud b: its in-edge rows (the
// sources sorted[b][tstart[b][p], tstart[b][p + 1])) added in order, then
// the central term of kMode over row p's own central_k sources, j
// ascending. Lane l holds the channels (l + 32 t) * V + v, t < kSlotsC,
// v < V; source s is the row of C values at g + s * stride.
template <typename T, int V, int kSlotsC, int kMode>
__global__ void __launch_bounds__(kSumThreads)
    sum_kernel(const T* __restrict__ g, const int32_t* __restrict__ sorted,
               const int32_t* __restrict__ tstart, float* __restrict__ out,
               int B, int n, int S, int C, int64_t stride, int central_k) {
  using R = Raw<T, V>;
  // rows in flight: 32 words a lane (a hub's row takes in-degree / kRif
  // load latencies)
  constexpr int kRif = 32 / (kSlotsC * R::kWords) > 4
                           ? 32 / (kSlotsC * R::kWords) : 4;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kSumThreads / 32) +
                      (threadIdx.x >> 5);
  if (row >= (int64_t)B * n) return;
  const int b = (int)(row / n), p = (int)(row - (int64_t)b * n);
  const int32_t* ts = tstart + (int64_t)b * (n + 1);
  const int beg = ts[p], end = ts[p + 1];
  const int32_t* srt = sorted + (int64_t)b * S;
  const T* gb = g + (int64_t)b * S * stride;
  float acc[kSlotsC][V];
#pragma unroll
  for (int sl = 0; sl < kSlotsC; ++sl)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[sl][v] = 0.0f;

  for (int r0 = beg; r0 < end; r0 += 32) {
    const int nr = min(32, end - r0);
    const int mine = lane < nr ? srt[r0 + lane] : 0;
    for (int i0 = 0; i0 < nr; i0 += kRif) {
      R x[kRif][kSlotsC];
#pragma unroll
      for (int i = 0; i < kRif; ++i) {
        const int src = __shfl_sync(0xffffffffu, mine, (i0 + i) & 31);
        const T* gr = gb + (int64_t)src * stride;
#pragma unroll
        for (int sl = 0; sl < kSlotsC; ++sl) {
          const int c = (sl * 32 + lane) * V;
          load_raw<T, V>(gr + c, i0 + i < nr && c < C, x[i][sl]);
        }
      }
#pragma unroll
      for (int i = 0; i < kRif; ++i) {
        if (i0 + i < nr) {
#pragma unroll
          for (int sl = 0; sl < kSlotsC; ++sl)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[sl][v] = __fadd_rn(acc[sl][v], value<T, V>(x[i][sl], v));
        }
      }
    }
  }

  float cs[kSlotsC][V];
#pragma unroll
  for (int sl = 0; sl < kSlotsC; ++sl)
#pragma unroll
    for (int v = 0; v < V; ++v) cs[sl][v] = 0.0f;
  if constexpr (kMode != kNoCentral) {
    // the own rows p * central_k + j; kernel M's terms are a - b, a the C
    // values before each source row
    constexpr int kOwn = kMode == kAddConcat ? kRif / 2 : kRif;
    const T* own = gb + (int64_t)p * central_k * stride;
    for (int j0 = 0; j0 < central_k; j0 += kOwn) {
      R x[kOwn][kSlotsC], a[kMode == kAddConcat ? kOwn : 1][kSlotsC];
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        const T* gr = own + (int64_t)(j0 + j) * stride;
#pragma unroll
        for (int sl = 0; sl < kSlotsC; ++sl) {
          const int c = (sl * 32 + lane) * V;
          const bool ok = j0 + j < central_k && c < C;
          load_raw<T, V>(gr + c, ok, x[j][sl]);
          if constexpr (kMode == kAddConcat)
            load_raw<T, V>(gr + c - C, ok, a[j][sl]);
        }
      }
#pragma unroll
      for (int j = 0; j < kOwn; ++j) {
        if (j0 + j < central_k) {
#pragma unroll
          for (int sl = 0; sl < kSlotsC; ++sl)
#pragma unroll
            for (int v = 0; v < V; ++v) {
              const float y = value<T, V>(x[j][sl], v);
              if constexpr (kMode == kSubtractOwn)
                cs[sl][v] = __fadd_rn(cs[sl][v], y);
              else
                cs[sl][v] = __fadd_rn(
                    cs[sl][v],
                    __fsub_rn(value<T, V>(a[j][sl], v), y));
            }
        }
      }
    }
  }

  float* o = out + row * C;
#pragma unroll
  for (int sl = 0; sl < kSlotsC; ++sl) {
    const int c = (sl * 32 + lane) * V;
    if (c >= C) continue;
    float res[V];
#pragma unroll
    for (int v = 0; v < V; ++v)
      res[v] = kMode == kNoCentral     ? acc[sl][v]
               : kMode == kSubtractOwn ? __fsub_rn(acc[sl][v], cs[sl][v])
                                       : __fadd_rn(acc[sl][v], cs[sl][v]);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(o + c) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(o + c) = make_float2(res[0], res[1]);
    } else {
      o[c] = res[0];
    }
  }
}

// targets a bucket: 128 up to n = 131072, then doubled so that the buckets
// stay at most kMaxBuckets; 0 if n needs more than kMaxTargetsPerBucket
int targets_per_bucket(int n) {
  int tb = kMinTargetsPerBucket;
  while ((int64_t)tb * kMaxBuckets < n) tb *= 2;
  return tb <= kMaxTargetsPerBucket ? tb : 0;
}

int64_t scratch_ints(int B, int n, int64_t S) {
  const int tb = targets_per_bucket(n);
  const int64_t nq = (n + tb - 1) / tb;
  const int64_t tiles = (S + kTile - 1) / kTile;
  // hist, bucket starts, target starts, part (int2, 8-byte aligned),
  // sorted
  return B * (tiles * nq + nq + 1 + n + 1) + 1 + 3 * B * S;
}

template <typename T, int V, int kSlotsC, int kMode>
cudaError_t launch_sum(const T* g, const int32_t* sorted,
                       const int32_t* tstart, float* out, int B, int n,
                       int S, int C, int64_t stride, int central_k,
                       cudaStream_t st) {
  const int64_t rows = (int64_t)B * n;
  const unsigned blocks =
      (unsigned)((rows + kSumThreads / 32 - 1) / (kSumThreads / 32));
  sum_kernel<T, V, kSlotsC, kMode><<<blocks, kSumThreads, 0, st>>>(
      g, sorted, tstart, out, B, n, S, C, stride, central_k);
  return cudaGetLastError();
}

template <typename T, int V, int kSlotsC>
cudaError_t launch_sum_mode(const T* g, const int32_t* sorted,
                            const int32_t* tstart, float* out, int B, int n,
                            int S, int C, int64_t stride, int central_k,
                            int mode, cudaStream_t st) {
  if (mode == kSubtractOwn)
    return launch_sum<T, V, kSlotsC, kSubtractOwn>(
        g, sorted, tstart, out, B, n, S, C, stride, central_k, st);
  if (mode == kAddConcat)
    return launch_sum<T, V, kSlotsC, kAddConcat>(
        g, sorted, tstart, out, B, n, S, C, stride, central_k, st);
  return launch_sum<T, V, kSlotsC, kNoCentral>(g, sorted, tstart, out, B, n,
                                               S, C, stride, central_k, st);
}

// V channels a lane loads at once: the fewest (1, 2 or 4) that cover C
// with 32 lanes, where C, the stride and g's address allow it
template <typename T>
cudaError_t launch_sum_vec(const T* g, const int32_t* sorted,
                           const int32_t* tstart, float* out, int B, int n,
                           int S, int C, int64_t stride, int central_k,
                           int mode, cudaStream_t st) {
  auto fits = [&](int v) {
    return C <= 32 * v && C % v == 0 && stride % v == 0 &&
           reinterpret_cast<uintptr_t>(g) % (v * sizeof(T)) == 0;
  };
  if (C <= 32)
    return launch_sum_mode<T, 1, 1>(g, sorted, tstart, out, B, n, S, C,
                                    stride, central_k, mode, st);
  if (fits(2))
    return launch_sum_mode<T, 2, 1>(g, sorted, tstart, out, B, n, S, C,
                                    stride, central_k, mode, st);
  if (fits(4))
    return launch_sum_mode<T, 4, 1>(g, sorted, tstart, out, B, n, S, C,
                                    stride, central_k, mode, st);
  return launch_sum_mode<T, 1, kMaxC / 32>(g, sorted, tstart, out, B, n, S,
                                           C, stride, central_k, mode, st);
}

// The four passes on the caller's stream: n targets and S sources a cloud,
// the sources' C values at g + offset + s * stride (s over [B, S]), idx
// [B, S], out [B, n, C]; `scratch` holds scratch_ints(B, n, S) int32 and
// needs no initialising. Returns the first nonzero cudaError_t.
int csr_scatter(const void* g, const void* idx, void* out, void* scratch,
                int B, int n, int64_t S, int C, int64_t offset,
                int64_t stride, bool g_bf16, int central_k, int mode,
                cudaStream_t st) {
  const int TB = targets_per_bucket(n);
  if (TB == 0 || S >= INT_MAX) return (int)cudaErrorInvalidValue;
  int shift = 0;
  while ((1 << shift) < TB) ++shift;
  const int nq = (n + TB - 1) / TB;
  const int tiles = (int)((S + kTile - 1) / kTile);
  int32_t* hist = static_cast<int32_t*>(scratch);
  int32_t* bstart = hist + (int64_t)B * tiles * nq;
  int32_t* tstart = bstart + (int64_t)B * (nq + 1);
  int32_t* tail = tstart + (int64_t)B * (n + 1);
  int2* part = reinterpret_cast<int2*>(
      tail + (reinterpret_cast<uintptr_t>(tail) % 8 ? 1 : 0));
  int32_t* sorted = reinterpret_cast<int32_t*>(part + (int64_t)B * S);
  const int32_t* ix = static_cast<const int32_t*>(idx);
  const dim3 grid(tiles, B);
  hist_kernel<<<grid, kPlaceThreads, sizeof(int32_t) * nq, st>>>(
      ix, hist, n, (int)S, nq, shift);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  place_kernel<<<grid, kPlaceThreads, sizeof(int32_t) * 9 * nq, st>>>(
      ix, hist, part, bstart, n, (int)S, nq, shift);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sort_kernel<<<dim3(nq, B), kSortThreads,
                sizeof(int32_t) * (1 + kSortWarps) * TB, st>>>(
      part, bstart, sorted, tstart, n, (int)S, nq, TB);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  float* o = static_cast<float*>(out);
  if (g_bf16)
    err = launch_sum_vec<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(g) + offset, sorted, tstart, o, B,
        n, (int)S, C, stride, central_k, mode, st);
  else
    err = launch_sum_vec<float>(static_cast<const float*>(g) + offset, sorted,
                                tstart, o, B, n, (int)S, C, stride, central_k,
                                mode, st);
  return (int)err;
}

}  // namespace

// int32 of scratch the functions below need for B clouds of S sources and
// n targets (histograms, bucket and target starts, sources placed by
// bucket, sources sorted by target); -1 if n is beyond what they take
// (n <= 2^19).
extern "C" long long spgan_csr_scratch(int B, int n, long long S) {
  if (B <= 0 || n <= 0 || S <= 0 || targets_per_bucket(n) == 0) return -1;
  return scratch_ints(B, n, S);
}

// The C values of source row s (s = (b N + q) k + j) at d_diff + s * stride
// (stride >= C elements), f32 or bf16 (dd_bf16); idx [B, N, k] int32
// contiguous; d_x [B, N, C] f32; all on the device. `scratch` holds
// spgan_csr_scratch(B, N, N k) int32; nothing in it needs initialising.
// Entries of idx outside [0, N) are ignored. Launches on `stream` and
// returns the first nonzero cudaError_t (0 on success). Takes C <= 128.
extern "C" int spgan_scatter_diff_bwd(const void* d_diff, const void* idx,
                                      void* d_x, void* scratch, int B, int N,
                                      int k, int C, int stride, int dd_bf16,
                                      void* stream) {
  if (B <= 0 || N <= 0 || k <= 0 || C <= 0 || C > kMaxC || stride < C ||
      (int64_t)N * k >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(d_diff, idx, d_x, scratch, B, N, (int64_t)N * k, C, 0,
                     stride, dd_bf16 != 0, k, kSubtractOwn,
                     static_cast<cudaStream_t>(stream));
}

// Kernel H. g [B, S, F] f32 or bf16 (g_bf16) and idx [B, S] int32,
// contiguous on the device; out [B, n, F] f32. `scratch` holds
// spgan_csr_scratch(B, n, S) int32; nothing in it needs initialising.
// Entries of idx outside [0, n) are ignored; a target with no source gets
// zeros. Launches on `stream` and returns the first nonzero cudaError_t
// (0 on success). Takes F <= 128.
extern "C" int spgan_scatter_add(const void* g, const void* idx, void* out,
                                 void* scratch, int B, int S, int n, int F,
                                 int g_bf16, void* stream) {
  if (B <= 0 || S <= 0 || n <= 0 || F <= 0 || F > kMaxC)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(g, idx, out, scratch, B, n, S, F, 0, F, g_bf16 != 0, 0,
                     kNoCentral, static_cast<cudaStream_t>(stream));
}

// Kernel M. d_ee [B, N, k, 2C] f32 or bf16 (ee_bf16) and idx [B, N, k]
// int32, contiguous on the device; d_x [B, N, C] f32. `scratch` holds
// spgan_csr_scratch(B, N, N k) int32, as kernel D's; nothing in it needs
// initialising. Entries of idx outside [0, N) are ignored. Launches on
// `stream` and returns the first nonzero cudaError_t (0 on success). Takes
// C <= 128.
extern "C" int spgan_edge_scatter_bwd(const void* d_ee, const void* idx,
                                      void* d_x, void* scratch, int B, int N,
                                      int k, int C, int ee_bf16,
                                      void* stream) {
  if (B <= 0 || N <= 0 || k <= 0 || C <= 0 || C > kMaxC ||
      (int64_t)N * k >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(d_ee, idx, d_x, scratch, B, N, (int64_t)N * k, C, C,
                     2 * (int64_t)C, ee_bf16 != 0, k, kAddConcat,
                     static_cast<cudaStream_t>(stream));
}
