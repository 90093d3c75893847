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

}  // namespace spgan
