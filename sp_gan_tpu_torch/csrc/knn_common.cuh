// Shared pieces of the kNN kernels (knn.cu: A and G, knn_edge.cu: B, both
// through the selection engine of knn_filter.cuh; knn_edge_window.cu: F,
// through that engine above 4 channels and select_band at or below;
// chamfer.cu: N): the f32 distance fold, the running top-k kept in
// registers (TopK; TopKSplit keeps the indices in shared memory) and the
// edge-row writer.
//
// Layout: one thread owns one query point; a block holds kQueries queries
// of one cloud and walks its keys (a chunk of them, or a circular band) in
// tiles of kTileKeys rows staged in shared memory. Every thread of a warp
// reads the same key row at the same time, so the shared-memory reads are
// broadcasts (the filter of knn_filter.cuh has its own layout).
//
// Arithmetic: the distance is (|q|^2 - 2 q.k) + |k|^2 with the dot products
// folded over the channels left to right, each product and each partial sum
// rounded to f32 (__fmul_rn/__fadd_rn: no contraction into FMA, no tensor
// cores, no TF32). The plain PyTorch twins (sp_gan_tpu_torch/ops/pairwise.py)
// run the same sequence, so kernel and twin select identical neighbors.
// Channels are zero-padded up to the compile-time width CM; a padded term
// adds an exact zero and changes no result.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spgan {

constexpr int kQueries = 128;   // queries per block, one per thread
constexpr int kTileKeys = 64;   // key rows per shared-memory tile

// int32 image of a float that orders like the float (-inf < ... < -0 < +0
// < ... < +inf < NaN for positive NaN). It is its own inverse.
__device__ __forceinline__ int orderable(float d) {
  int b = __float_as_int(d);
  return b ^ ((b >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unorderable(int key) {
  return __int_as_float(key ^ ((key >> 31) & 0x7fffffff));
}

// The K smallest entries seen so far, ascending. PACKED: `key` alone orders
// (the column index sits in its low bits). Otherwise (key, idx) orders
// lexicographically, which is the order that K rounds of argmin with ties
// to the lower index produce. Entries start at the sentinel (INT_MAX,
// INT_MAX), which every real candidate precedes.
template <int K, bool PACKED>
struct TopK {
  int key[K];
  int idx[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < K; ++t) {
      key[t] = INT_MAX;
      idx[t] = INT_MAX;
    }
  }

  __device__ __forceinline__ static bool before(int ka, int ia, int kb,
                                                int ib) {
    return PACKED ? ka < kb : (ka < kb || (ka == kb && ia < ib));
  }

  // Insert by swapping the candidate down the list: every entry after the
  // insertion point moves one slot right and the last one drops out.
  __device__ __forceinline__ void push(int k, int i) {
    if (!before(k, i, key[K - 1], idx[K - 1])) return;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      if (before(k, i, key[t], idx[t])) {
        const int tk = key[t];
        key[t] = k;
        k = tk;
        if (!PACKED) {
          const int ti = idx[t];
          idx[t] = i;
          i = ti;
        }
      }
    }
  }
};

// Slot t of one thread's column of a block's shared int table, at
// p[t * kQueries]: a warp's threads touch consecutive words, one bank each.
struct SmemColumn {
  int* p;
  __device__ __forceinline__ int& operator[](int t) const {
    return p[t * kQueries];
  }
};

// TopK<K, false> with the keys in registers and the indices in the
// thread's column of a shared table: the wide exact lists (K = 64), whose
// 2 K registers beside a filter tile's accumulators spill. Its entries,
// order and pushes are TopK's; only where the indices live differs.
template <int K>
struct TopKSplit {
  int key[K];
  SmemColumn idx;

  __device__ __forceinline__ void init(int* column) {
    idx.p = column;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      key[t] = INT_MAX;
      idx[t] = INT_MAX;
    }
  }

  __device__ __forceinline__ void push(int k, int i) {
    if (!TopK<K, false>::before(k, i, key[K - 1], idx[K - 1])) return;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      if (TopK<K, false>::before(k, i, key[t], idx[t])) {
        const int tk = key[t];
        key[t] = k;
        k = tk;
        const int ti = idx[t];
        idx[t] = i;
        i = ti;
      }
    }
  }
};

// Key-row maps for `stage_keys`: the rows of a tile as they are, or taken
// circularly from `base` (base + r mod N, for base + r in (-N, 2N)).
struct RowsAsIs {
  __device__ __forceinline__ int operator()(int r) const { return r; }
};

struct RowsCircular {
  int base, n;
  __device__ __forceinline__ int operator()(int r) const {
    const int g = base + r;
    return g < 0 ? g + n : (g >= n ? g - n : g);
  }
};

// The query row `qi` of `xb` [N, C], zero-padded to CM channels (all zero
// for a padding thread), and its squared norm in the fold order below.
template <int CM>
__device__ __forceinline__ float load_query(const float* __restrict__ xb,
                                            int C, int qi, bool valid,
                                            float (&q)[CM]) {
#pragma unroll
  for (int c = 0; c < CM; ++c)
    q[c] = (valid && c < C) ? xb[(size_t)qi * C + c] : 0.f;
  float qn = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) qn = __fadd_rn(qn, __fmul_rn(q[c], q[c]));
  return qn;
}

// Stages the key rows row_of(r0 + t), t < nt <= kTileKeys, of `xb` in the
// shared tile `sk` [kTileKeys, CM] and their squared norms in `skn`. Every
// thread of the block must call it (it synchronizes before and after).
template <int CM, typename RowOf>
__device__ __forceinline__ void stage_keys(const float* __restrict__ xb,
                                           int C, int r0, int nt,
                                           const RowOf& row_of, float* sk,
                                           float* skn) {
  __syncthreads();  // the previous tile is consumed
  for (int e = threadIdx.x; e < kTileKeys * CM; e += blockDim.x) {
    const int t = e / CM, c = e % CM;
    sk[e] = (t < nt && c < C) ? xb[(size_t)row_of(r0 + t) * C + c] : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < nt) {
    const float* kr = sk + threadIdx.x * CM;
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) s = __fadd_rn(s, __fmul_rn(kr[c], kr[c]));
    skn[threadIdx.x] = s;
  }
  __syncthreads();
}

// (|q|^2 - 2 q.k) + |k|^2 for the staged key row `kr` of norm `kn`.
template <int CM>
__device__ __forceinline__ float key_dist(const float (&q)[CM], float qn,
                                          const float* kr, float kn) {
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  float acc = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < CM / 4; ++c4) {
    const float4 kv = k4[c4];
    acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 0], kv.x));
    acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 1], kv.y));
    acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 2], kv.z));
    acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 3], kv.w));
  }
  return __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, acc)), kn);
}

// The packed selection key: the bits of max(d, 0) with the low mantissa
// bits replaced by the column `j`, so one int compare orders by quantized
// distance, then column.
__device__ __forceinline__ int pack_key(float d, int low_mask, int j) {
  const float dp = d < 0.f ? 0.f : d;  // keeps NaN
  return (__float_as_int(dp) & ~low_mask) | j;
}

// The banded selection of the block's queries q0 .. q0 + nq - 1 (one per
// thread): the keys are the circular slice of rows q0 - W .. q0 + nq + W - 1
// (mod N), and thread t's candidates are its band, slice positions
// t .. t + 2W, that is the offsets -W .. W around its query, itself (offset
// 0) at +inf. The column a candidate carries, for ties and in the packed
// key, is its band position o = offset + W. All threads of the block must
// call it.
template <int CM, int K, bool PACKED>
__device__ __forceinline__ void select_band(const float* __restrict__ xb,
                                            int N, int C, int q0, int nq,
                                            int W, int low_mask,
                                            TopK<K, PACKED>& top, float* sk,
                                            float* skn) {
  const int t = threadIdx.x;
  const bool valid = t < nq;
  float q[CM];
  const float qn = load_query<CM>(xb, C, q0 + t, valid, q);
  top.init();
  const int rows = nq + 2 * W;
  const RowsCircular row_of{q0 - W, N};
  for (int tile0 = 0; tile0 < rows; tile0 += kTileKeys) {
    const int nt = min(kTileKeys, rows - tile0);
    stage_keys<CM>(xb, C, tile0, nt, row_of, sk, skn);
    if (!valid) continue;
    const int lo = max(0, t - tile0), hi = min(nt, t + 2 * W + 1 - tile0);
    for (int s = lo; s < hi; ++s) {
      const int o = tile0 + s - t;
      float d = key_dist<CM>(q, qn, sk + s * CM, skn[s]);
      if (o == W) d = __int_as_float(0x7f800000);  // self -> +inf
      top.push(PACKED ? pack_key(d, low_mask, o) : orderable(d), o);
    }
  }
}

// write_edges by 4 channels a thread (C % 4 == 0, x and ee 16-byte
// aligned): 16-byte loads of x, 16- or 8-byte stores, the same rounding of
// each element.
__device__ __forceinline__ void write_edges4(const float* __restrict__ xb,
                                             void* __restrict__ ee,
                                             const int* snbr, int C, int k,
                                             int q0, int total4, size_t base,
                                             bool diff_only, bool out_bf16) {
  const int ec4 = (diff_only ? C : 2 * C) / 4, c4n = C / 4;
  const int step = blockDim.x, drow = step / ec4, dc = step % ec4;
  int row = threadIdx.x / ec4, c = threadIdx.x % ec4;
  for (int e = threadIdx.x; e < total4; e += step) {
    const bool is_central = !diff_only && c < c4n;
    const int ch = is_central ? c : c - (ec4 - c4n);
    const int qloc = row / k;
    const float4 cen =
        reinterpret_cast<const float4*>(xb + (size_t)(q0 + qloc) * C)[ch];
    float4 v = cen;
    if (!is_central) {
      const float4 nb =
          reinterpret_cast<const float4*>(xb + (size_t)snbr[row] * C)[ch];
      if (out_bf16) {
        v.x = __bfloat162float(__float2bfloat16_rn(__fsub_rn(
            __bfloat162float(__float2bfloat16_rn(nb.x)),
            __bfloat162float(__float2bfloat16_rn(cen.x)))));
        v.y = __bfloat162float(__float2bfloat16_rn(__fsub_rn(
            __bfloat162float(__float2bfloat16_rn(nb.y)),
            __bfloat162float(__float2bfloat16_rn(cen.y)))));
        v.z = __bfloat162float(__float2bfloat16_rn(__fsub_rn(
            __bfloat162float(__float2bfloat16_rn(nb.z)),
            __bfloat162float(__float2bfloat16_rn(cen.z)))));
        v.w = __bfloat162float(__float2bfloat16_rn(__fsub_rn(
            __bfloat162float(__float2bfloat16_rn(nb.w)),
            __bfloat162float(__float2bfloat16_rn(cen.w)))));
      } else {
        v = make_float4(__fsub_rn(nb.x, cen.x), __fsub_rn(nb.y, cen.y),
                        __fsub_rn(nb.z, cen.z), __fsub_rn(nb.w, cen.w));
      }
    }
    if (out_bf16) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 w;
      w.x = *reinterpret_cast<uint32_t*>(&lo);
      w.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(ee) + base)[e] = w;
    } else {
      reinterpret_cast<float4*>(static_cast<float*>(ee) + base)[e] = v;
    }
    c += dc;
    row += drow;
    if (c >= ec4) {
      c -= ec4;
      ++row;
    }
  }
}

// Writes the edge rows of the block's queries q0 .. q0 + nq - 1 of cloud
// `b`: ee [B, N, k, C] `nbr - central` (diff_only) or [B, N, k, 2C]
// `[central, nbr - central]`, f32 or bf16, the neighbor of query slot
// `qloc`, neighbor `t` at snbr[qloc * k + t] (shared memory). With bf16
// output the diff is bf16(f32(bf16(nbr)) - f32(bf16(central))), the rounding
// of the JAX kernels and of the XLA path. The block's rows are one
// contiguous range of ee, written by consecutive threads; each thread steps
// its (row, channel) and (query, slot) by the block's stride, with no
// division in the loop.
__device__ __forceinline__ void write_edges(const float* __restrict__ xb,
                                            void* __restrict__ ee,
                                            const int* snbr, int b, int N,
                                            int C, int k, int q0, int nq,
                                            bool diff_only, bool out_bf16) {
  const int ec = diff_only ? C : 2 * C;
  const int total = nq * k * ec;  // at most 128 * 64 * 256
  const size_t base = ((size_t)b * N + q0) * k * ec;
  if (C % 4 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(ee) % 16 == 0) {
    write_edges4(xb, ee, snbr, C, k, q0, total / 4, base, diff_only,
                 out_bf16);
    return;
  }
  const int step = blockDim.x, drow = step / ec, dc = step % ec;
  const int dq = drow / k, ds = drow % k;
  // element e = row * ec + c, row = qloc * k + slot (local query, neighbor)
  int row = threadIdx.x / ec, c = threadIdx.x % ec;
  int qloc = row / k, slot = row % k;
  for (int e = threadIdx.x; e < total; e += step) {
    const bool is_central = !diff_only && c < C;
    const int ch = is_central ? c : c - (ec - C);
    const float cen = xb[(size_t)(q0 + qloc) * C + ch];
    if (out_bf16) {
      __nv_bfloat16 v = __float2bfloat16_rn(cen);
      if (!is_central) {
        const float nbr = xb[(size_t)snbr[row] * C + ch];
        v = __float2bfloat16_rn(
            __fsub_rn(__bfloat162float(__float2bfloat16_rn(nbr)),
                      __bfloat162float(v)));
      }
      static_cast<__nv_bfloat16*>(ee)[base + e] = v;
    } else {
      float v = cen;
      if (!is_central) v = __fsub_rn(xb[(size_t)snbr[row] * C + ch], cen);
      static_cast<float*>(ee)[base + e] = v;
    }
    c += dc;
    row += drow;
    slot += ds;
    qloc += dq;
    if (c >= ec) {
      c -= ec;
      ++row;
      ++slot;
    }
    if (slot >= k) {
      slot -= k;
      ++qloc;
    }
  }
}

// Host-side dispatch of the compile-time widths: CM, the channel count
// rounded up to one of 4, 8, 16, 32, 64, 128; KM, the neighbor count
// rounded up to 16, 32 or 64. `f` is a launcher with a member template
// `operator()<CM, KM>()`. Returns false for widths past those.
template <int CM, typename F>
bool dispatch_k(int k, const F& f) {
  if (k <= 16) {
    f.template operator()<CM, 16>();
    return true;
  }
  if (k <= 32) {
    f.template operator()<CM, 32>();
    return true;
  }
  if (k <= 64) {
    f.template operator()<CM, 64>();
    return true;
  }
  return false;
}

template <typename F>
bool dispatch_widths(int C, int k, const F& f) {
  if (C <= 4) return dispatch_k<4>(k, f);
  if (C <= 8) return dispatch_k<8>(k, f);
  if (C <= 16) return dispatch_k<16>(k, f);
  if (C <= 32) return dispatch_k<32>(k, f);
  if (C <= 64) return dispatch_k<64>(k, f);
  if (C <= 128) return dispatch_k<128>(k, f);
  return false;
}

// Shared floats a block needs: one key tile, reused afterwards for the
// block's neighbor indices (32 KB at KM = 64, under the 48 KB of static
// shared memory a block may have).
template <int CM, int KM>
__host__ __device__ constexpr int smem_floats() {
  return kTileKeys * CM > kQueries * KM ? kTileKeys * CM : kQueries * KM;
}

}  // namespace spgan
