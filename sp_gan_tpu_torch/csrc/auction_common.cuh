// Shared pieces of the EMD auction kernels (auction.cu: E, block
// Gauss-Seidel; auction_jacobi.cu: O, Jacobi and packed): the phase eps
// table, a row's best and second value, the round engine's row scan and
// the forced final pass. Every rounded operation is an explicit
// __fsub_rn / __fadd_rn in the order of the plain versions in
// ops/kernels/auction.py and auction_jacobi.py.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace spgan {

constexpr int kMaxPhases = 16;
constexpr float kNeg = -1e30f;  // the JAX kernel's _NEG
constexpr int kAuctionWarps = 16;  // warps of a block of kernels E and O
constexpr int kSlots = 4;  // float4 column slots a lane holds of a row tile

// eps of each phase, f32, passed by value
struct PhaseEps {
  float v[kMaxPhases];
};

// (best, index of best, second) of two disjoint column sets, merged: the
// better best (higher, or equal at a lower index) wins, and the second is
// the larger of the winner's second and the loser's best.
__device__ __forceinline__ void top2_merge(float& b, int& i, float& s,
                                           float b2, int i2, float s2) {
  if (b2 > b || (b2 == b && i2 < i)) {
    s = fmaxf(s2, b);
    b = b2;
    i = i2;
  } else {
    s = fmaxf(s, b2);
  }
}

// One column into a running (best, index of best, second), v = -d - price:
// if v > best the old best becomes a candidate for second, else v does,
// without a branch. Columns must come in ascending order, so that a tie
// keeps the lower index.
__device__ __forceinline__ void top2_take(float& b, int& bi, float& s,
                                          float dv, float pv, int m) {
  const float v = __fsub_rn(-dv, pv);
  s = fmaxf(s, fminf(v, b));
  if (v > b) {
    b = v;
    bi = m;
  }
}

// (best, index, second) merged over the 32 lanes of a warp by shuffles;
// every lane returns the warp's result.
__device__ __forceinline__ void warp_top2(float& b, int& bi, float& s) {
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    top2_merge(b, bi, s, b2, i2, s2);
  }
}

// max(x, 0) that keeps NaN, as jnp.maximum and torch.where do
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

// A row's (best, index, second) from its n partials pb, pi, ps [n],
// merged by top2_merge (exact and order-free).
__device__ __forceinline__ void top2_of_parts(const float* pb, const int* pi,
                                              const float* ps, int n,
                                              float& b, int& bi, float& s) {
  b = pb[0];
  bi = pi[0];
  s = ps[0];
#pragma unroll
  for (int g = 1; g < kAuctionWarps; ++g)
    if (g < n) top2_merge(b, bi, s, pb[g], pi[g], ps[g]);
}

// What a lane keeps of its columns of a bidding row, and how a warp merges
// it. Top2 (kernel E, kernel O's jacobi mode): best = max(-d - price), the
// lowest column on ties, and second = the max over the other columns
// (kNeg as the floor). Min2 (kernel O's packed mode): the two smallest
// packed values (the bits of max(d + price, 0) with the column in the low
// bits, `hi` masking them off); columns differ in their low bits, so the
// values are distinct. Both results are those of the row whatever the
// split of its columns over lanes, warps and blocks, and whatever the
// order of the merges.
struct Top2 {
  float b, s;
  int i;
  __device__ __forceinline__ void init() {
    b = -INFINITY;
    s = kNeg;
    i = INT_MAX;
  }
  __device__ __forceinline__ void take(float dv, float pv, int m) {
    top2_take(b, i, s, dv, pv, m);
  }
  __device__ __forceinline__ void warp_merge() { warp_top2(b, i, s); }
};

struct Min2 {
  int m1, m2, hi;
  __device__ __forceinline__ void init() {
    m1 = INT_MAX;
    m2 = INT_MAX;
  }
  __device__ __forceinline__ void take(float dv, float pv, int m) {
    const float u = clamp0(__fadd_rn(dv, pv));
    const int pk = (__float_as_int(u) & hi) | m;
    m2 = min(m2, max(m1, pk));
    m1 = min(m1, pk);
  }
  __device__ __forceinline__ void merge(int o1, int o2) {
    m2 = min(max(m1, o1), min(m2, o2));
    m1 = min(m1, o1);
  }
  __device__ __forceinline__ void warp_merge() {
    for (int off = 16; off > 0; off >>= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, m1, off);
      const int o2 = __shfl_xor_sync(0xffffffffu, m2, off);
      merge(o1, o2);
    }
  }
};

// *p = v in the shared memory of each of the cluster's kCS blocks (the
// block's own for kCS = 1): stores that need no answer.
template <int kCS, class T>
__device__ __forceinline__ void store_all(T* p, T v) {
  if constexpr (kCS > 1) {
    auto cluster = cooperative_groups::this_cluster();
#pragma unroll
    for (int c = 0; c < kCS; ++c) *cluster.map_shared_rank(p, c) = v;
  } else {
    *p = v;
  }
}

// The round engine's scan: rows u = grp, grp + RG, ... of the nu bidding
// rows (row_of(u) their row of d), kRows of them in flight per group of G
// warps; lane gl of its group takes the float4 slots base + gl + 32 G k
// (k < kSlots) of each tile of 128 G slots of the block's `slots` slots,
// in ascending order, every load issued before any value is used, and
// keeps an Acc of its columns. The warp merges its lanes and lane 0 hands
// the warp's partial to store(u, wg, acc), wg the warp's place in its
// group. M not a multiple of 4, or a d not 16-byte aligned (!kVec), takes
// scalar loads.
template <class Acc, bool kVec, int kRows, class RowOf, class Store>
__device__ __forceinline__ void scan_rows(
    const float* __restrict__ dp, const float* price, int nu, int M,
    int base, int slots, int G, int warp, int lane, const Acc& proto,
    const RowOf& row_of, const Store& store, bool timed, long long& t_cols,
    long long& t_parts) {
  const int RG = kAuctionWarps / G, grp = warp / G, wg = warp - grp * G;
  const int GL = 32 * G, gl = wg * 32 + lane;
  const int tiles = (slots + GL * kSlots - 1) / (GL * kSlots);
  const float4* price4 = reinterpret_cast<const float4*>(price);
  for (int u0 = grp; u0 < nu; u0 += RG * kRows) {
    Acc a[kRows];
    const float* rp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      a[r] = proto;
      a[r].init();
      const int u = u0 + r * RG;
      rp[r] = u < nu ? dp + (size_t)row_of(u) * M : nullptr;
    }
    for (int tile = 0; tile < tiles; ++tile) {
      const int c0 = tile * GL * kSlots + gl;
      float4 v[kRows][kSlots];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int c = base + c0 + k * GL;
          v[r][k] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (rp[r] != nullptr && c0 + k * GL < slots) {
            if (kVec) {
              v[r][k] = __ldg(reinterpret_cast<const float4*>(rp[r]) + c);
            } else {
              const int m = 4 * c;
              v[r][k].x = __ldg(rp[r] + m);
              if (m + 1 < M) v[r][k].y = __ldg(rp[r] + m + 1);
              if (m + 2 < M) v[r][k].z = __ldg(rp[r] + m + 2);
              if (m + 3 < M) v[r][k].w = __ldg(rp[r] + m + 3);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (c0 + k * GL >= slots) continue;
        const int c = base + c0 + k * GL;
        const int m = 4 * c;
        float4 p;
        if (kVec) {
          p = price4[c];
        } else {
          p.x = price[m];
          p.y = m + 1 < M ? price[m + 1] : 0.f;
          p.z = m + 2 < M ? price[m + 2] : 0.f;
          p.w = m + 3 < M ? price[m + 3] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (rp[r] == nullptr) continue;
          a[r].take(v[r][k].x, p.x, m);
          if (kVec || m + 1 < M) a[r].take(v[r][k].y, p.y, m + 1);
          if (kVec || m + 2 < M) a[r].take(v[r][k].z, p.z, m + 2);
          if (kVec || m + 3 < M) a[r].take(v[r][k].w, p.w, m + 3);
        }
      }
    }
    if (timed) t_cols = clock64();  // the columns are done
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int u = u0 + r * RG;
      if (u >= nu) continue;  // uniform over the warp
      a[r].warp_merge();
      if (lane == 0) store(u, wg, a[r]);
    }
    if (timed) t_parts = clock64();  // the partials are written
  }
}

// Forced final pass of one pair, a warp per row: an owned row
// (item_of >= 0) takes its item, the rest argmin_m(d[r, m] + price[m]),
// the lowest index on ties.
__device__ __forceinline__ void forced_pass(const float* __restrict__ dp,
                                            const int32_t* item_of,
                                            const float* price,
                                            int32_t* __restrict__ out, int N,
                                            int M, int warp, int warps,
                                            int lane) {
  for (int r = warp; r < N; r += warps) {
    const int it = item_of[r];
    if (it >= 0) {
      if (lane == 0) out[r] = it;
      continue;
    }
    const float* row = dp + (size_t)r * M;
    float b = INFINITY;
    int bi = 0x7fffffff;
    for (int m = lane; m < M; m += 32) {
      const float v = __fadd_rn(__ldg(row + m), price[m]);
      if (v < b) {
        b = v;
        bi = m;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
      if (b2 < b || (b2 == b && i2 < bi)) {
        b = b2;
        bi = i2;
      }
    }
    if (lane == 0) out[r] = bi;
  }
}

// forced_pass with 16-byte loads (kVec: M % 4 == 0 and d 16-byte
// aligned; price in shared memory, 16-byte aligned): lane l takes the
// float4 columns l, l + 32, ..., eight loads in flight, in ascending order
// within the lane, so the result is forced_pass's. Without kVec it is
// forced_pass.
template <bool kVec>
__device__ __forceinline__ void forced_pass_vec(
    const float* __restrict__ dp, const int32_t* item_of, const float* price,
    int32_t* __restrict__ out, int N, int M, int warp, int warps, int lane) {
  if (!kVec) {
    forced_pass(dp, item_of, price, out, N, M, warp, warps, lane);
    return;
  }
  constexpr int kLoads = 8;
  const int M4 = M / 4;
  const float4* price4 = reinterpret_cast<const float4*>(price);
  for (int r = warp; r < N; r += warps) {
    const int it = item_of[r];
    if (it >= 0) {
      if (lane == 0) out[r] = it;
      continue;
    }
    const float4* row = reinterpret_cast<const float4*>(dp + (size_t)r * M);
    float b = INFINITY;
    int bi = 0x7fffffff;
    for (int c0 = lane; c0 < M4; c0 += 32 * kLoads) {
      float4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int c = c0 + 32 * k;
        v[k] = c < M4 ? __ldg(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int c = c0 + 32 * k;
        if (c < M4) {
          const float4 p = price4[c];
          const float x[4] = {__fadd_rn(v[k].x, p.x), __fadd_rn(v[k].y, p.y),
                              __fadd_rn(v[k].z, p.z), __fadd_rn(v[k].w, p.w)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (x[e] < b) {
              b = x[e];
              bi = 4 * c + e;
            }
          }
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
      if (b2 < b || (b2 == b && i2 < bi)) {
        b = b2;
        bi = i2;
      }
    }
    if (lane == 0) out[r] = bi;
  }
}

}  // namespace spgan
