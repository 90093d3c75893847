// Shared pieces of the two kNN kernels (knn.cu, knn_edge.cu): the f32
// distance fold and the running top-k kept in registers.
//
// Layout: one thread owns one query point; a block holds kQueries queries
// of one cloud and walks all N keys of that cloud in tiles of kTileKeys
// rows staged in shared memory. Every thread of a warp reads the same key
// row at the same time, so the shared-memory reads are broadcasts.
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

// Fills `top` with the K nearest keys of query `qi` (self excluded) in the
// cloud `xb` [N, C]. All threads of the block must call it (it
// synchronizes); `valid` is false for the padding threads past N.
// `low_mask` is the packed mode's index mask, (1 << ceil(log2 N)) - 1.
// `sk` holds kTileKeys * CM floats and `skn` kTileKeys floats of shared
// memory.
template <int CM, int K, bool PACKED>
__device__ __forceinline__ void select_knn(const float* __restrict__ xb, int N,
                                           int C, int qi, bool valid,
                                           int low_mask, TopK<K, PACKED>& top,
                                           float* sk, float* skn) {
  float q[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c)
    q[c] = (valid && c < C) ? xb[(size_t)qi * C + c] : 0.f;
  float qn = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) qn = __fadd_rn(qn, __fmul_rn(q[c], q[c]));
  top.init();

  for (int tile0 = 0; tile0 < N; tile0 += kTileKeys) {
    const int nt = min(kTileKeys, N - tile0);
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kTileKeys * CM; e += blockDim.x) {
      const int t = e / CM, c = e % CM;
      sk[e] = (t < nt && c < C) ? xb[(size_t)(tile0 + t) * C + c] : 0.f;
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
    if (!valid) continue;
    for (int t = 0; t < nt; ++t) {
      const float4* kr = reinterpret_cast<const float4*>(sk + t * CM);
      float acc = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < CM / 4; ++c4) {
        const float4 kv = kr[c4];
        acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 0], kv.x));
        acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 1], kv.y));
        acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 2], kv.z));
        acc = __fadd_rn(acc, __fmul_rn(q[4 * c4 + 3], kv.w));
      }
      const int j = tile0 + t;
      float d = __fadd_rn(__fsub_rn(qn, __fmul_rn(2.f, acc)), skn[t]);
      if (j == qi) d = __int_as_float(0x7f800000);  // self -> +inf
      int key;
      if (PACKED) {
        // bits of max(d, 0) with the low mantissa bits replaced by the
        // column: one int compare orders by quantized distance, then index
        const float dp = d < 0.f ? 0.f : d;
        key = (__float_as_int(dp) & ~low_mask) | j;
      } else {
        key = orderable(d);
      }
      top.push(key, j);
    }
  }
}

// Host-side dispatch of the compile-time widths: CM, the channel count
// rounded up to one of 4, 8, 16, 32, 64, 128; KM, the neighbor count
// rounded up to 16 or 32. `f` is a launcher with a member template
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
// block's neighbor indices.
template <int CM, int KM>
__host__ __device__ constexpr int smem_floats() {
  return kTileKeys * CM > kQueries * KM ? kTileKeys * CM : kQueries * KM;
}

}  // namespace spgan
