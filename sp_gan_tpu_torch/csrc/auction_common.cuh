// Shared pieces of the EMD auction kernels (auction.cu: E, block
// Gauss-Seidel; auction_jacobi.cu: O, Jacobi and packed): the phase eps
// table, a row's best and second value, and the forced final pass. Every
// rounded operation is an explicit __fsub_rn / __fadd_rn in the order of
// the plain versions in ops/kernels/auction.py and auction_jacobi.py.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace spgan {

constexpr int kMaxPhases = 16;
constexpr float kNeg = -1e30f;  // the JAX kernel's _NEG

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

// One warp's scan of a row of d [M]: best = max_m(-d[m] - price[m]), the
// lowest m on ties, and second = the max over every other column with -1e30
// as the floor; lane l takes columns l, l + 32, ... and the lanes merge by
// shuffles, so every lane returns the row's result.
__device__ __forceinline__ void row_top2(const float* __restrict__ row,
                                         const float* price, int M, int lane,
                                         float& b, int& bi, float& s) {
  b = -INFINITY;
  s = kNeg;
  bi = 0x7fffffff;
#pragma unroll 4
  for (int m = lane; m < M; m += 32) {
    const float v = __fsub_rn(-__ldg(row + m), price[m]);
    if (v > b) {
      s = fmaxf(s, b);
      b = v;
      bi = m;
    } else {
      s = fmaxf(s, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float b2 = __shfl_xor_sync(0xffffffffu, b, off);
    const int i2 = __shfl_xor_sync(0xffffffffu, bi, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    top2_merge(b, bi, s, b2, i2, s2);
  }
}

// One column into a running (best, index of best, second): the same
// result as row_top2's branch, without it. Columns must come in ascending
// order, so that a tie keeps the lower index.
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
