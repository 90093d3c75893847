// Kernel C: the EdgeBlock tail with BatchNorm folded into per-channel
// affines, ee [B, N, k, 2C] f32 or bf16 -> out [B, N, F] f32. The serving
// path folds eval BatchNorm into f32 edges (f32 mode); the fused training
// forward (--fused_train, --fused_dphase) folds the batch statistics and
// hands it bf16 edges under mixed_edge (bf16 mode, at the entry point
// below). Each mode runs on the tensor cores wherever its layout fits:
// f32 mode in edgeblock_tf32.cu, every product as three TF32 products
// (ebt_tf_fits: F2 dividing 128, F in {64, 128}, k <= 64; at F = 128,
// F2 = 64, C <= 120 at k = 10 and C <= 64 at k = 64, which takes both
// serving calls), bf16 mode in edgeblock_train_tc.cu (ebt_tc_fits(
// kEbtTail, ...): C a multiple of 4, F2 dividing 256, F = 128, k <= 64; at
// F2 = 64, C <= 224 at k = 10, C <= 144 at k = 40 and C <= 96 at k = 64).
// The two kernels here are both modes at the other widths, up to k = 64;
// in bf16 mode where the weights fit in shared memory beside one point's
// rows (bf16 mode has no variant with the weights in global memory).
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/edgeblock.py::
// edge_tail_pallas (_edge_tail_kernel). Per point, with diff = ee[..., C:],
// lrelu of slope `neg` and each a* = [scale row; shift row]:
//   h   = lrelu(lrelu(diff @ w1 * a1[0] + a1[1]) @ w2 * a2[0] + a2[1])
//   att = softmax over the k neighbors of h                     [k, F]
//   v   = lrelu(ee @ wx * ax[0] + ax[1]) * att                  [k, F]
//   out = bout + sum_{j, g} v[j, g] * wout[j, g, :]              [F]
//
// Two kernels, launched back to back on the caller's stream:
//  1. edge_rows_kernel computes v for every edge row into a scratch
//     [B, N, k, F]. The small weights (w1, w2, both halves of wx and the
//     affines: 115 KB at EdgeConv2's widths) are loaded into shared memory
//     once per block; each block then walks tiles of P points. A thread
//     owns a few output channels of one point (4 at F = 128, one past
//     k = 16) and keeps their k values in registers, so the softmax over k
//     needs no exchange; past k = 32 (KM = 64) h and v would not fit in
//     registers together, so the thread takes h and its softmax first,
//     stores the weights to its column of the scratch, then takes v and
//     multiplies them there. Input rows are read from shared memory as
//     float4 broadcasts, each feeding the thread's channels. In f32 mode,
//     where the weights and one point's rows do not fit in shared memory
//     (wide C at large k: at F = 128, F2 = 64 and k = 64, C > 100), the
//     weights stay in global memory, read through the read-only cache
//     (GW), and shared memory holds only the affines and the points' rows.
//  2. conv_out_kernel contracts v over (k, F): a [B*N, k*F] x [k*F, F]
//     product in 128-row tiles, 8 x F/16 outputs per thread, wout streamed
//     through shared memory in slices of 8 rows.
//
// What bounds them on an H100: f32 operations, at 67 TFLOP/s without
// tensor cores (1.76 ms for EdgeConv2's serving shape, ee [64, 2048, 10,
// 128], 118 GFLOP, against 0.67 GB of input). v makes one round trip
// through device memory, the price of letting the contraction take
// 128-point tiles, so that each wout value fetched from L2 serves 128
// points rather than the few whose edge rows fit beside the weights in
// shared memory. Arithmetic is plain f32 FMA; bf16 mode here rounds the
// operands to bf16 first and keeps the rounded v in the f32 scratch.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "edgeblock_tf32.cuh"
#include "edgeblock_train_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPoints = 32;  // points per tile of edge_rows_kernel

__device__ __forceinline__ float lrelu(float v, float neg) {
  return v >= 0.f ? v : neg * v;
}

// x rounded to bf16 (nearest even) when rb, else x unchanged
__device__ __forceinline__ float rnd(float x, int rb) {
  return rb ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// acc[i][j] += dot(a[j * lda + 0 .. K), column c0 + i * cs of W[0 .. K))
// for i < TC, j < k; a is in shared memory (the k rows of one point), W
// row-major with row length ldw. K and lda are multiples of 4 and a is
// 16-byte aligned. Each float4 of a feeds 4 * TC fused multiply-adds.
// With GW, W is in global memory (read through the read-only cache) and
// has only its first kw rows: those past them count as zero.
template <int KM, int TC, bool GW = false>
__device__ __forceinline__ void rows_dot(const float* a, int lda,
                                         const float* W, int ldw, int c0,
                                         int cs, int K, int k,
                                         float (&acc)[TC][KM], int kw = 0) {
  for (int kk = 0; kk < K; kk += 4) {
    float w[TC][4];
#pragma unroll
    for (int i = 0; i < TC; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (GW)
          w[i][q] = kk + q < kw ? __ldg(W + (kk + q) * ldw + c0 + i * cs)
                                : 0.f;
        else
          w[i][q] = W[(kk + q) * ldw + c0 + i * cs];
      }
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < k) {
        const float4 x = *reinterpret_cast<const float4*>(a + j * lda + kk);
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          acc[i][j] = fmaf(x.x, w[i][0], acc[i][j]);
          acc[i][j] = fmaf(x.y, w[i][1], acc[i][j]);
          acc[i][j] = fmaf(x.z, w[i][2], acc[i][j]);
          acc[i][j] = fmaf(x.w, w[i][3], acc[i][j]);
        }
      }
    }
  }
}

struct Rows {
  const void* ee;          // f32, or bf16 with rb
  const float *w1, *a1, *w2, *a2, *wx, *ax;
  float* v;
  long long M;             // points, B * N
  int C, Cp, F2, F, k, P;  // Cp: C rounded up to a multiple of 4
  float neg;
  int rb;                  // bf16 mode: matmul operands rounded to bf16
};

// Shared memory, in floats, each part a multiple of 4:
//   W1 [Cp][F2] | W2 [F2][F] | WX0 [Cp][F] | WX1 [Cp][F] | A1 [2][F2] |
//   A2 [2][F] | AX [2][F] | CEN [P*k][Cp] | DIF [P*k][Cp] | H1 [P*k][F2]
// Rows C..Cp-1 of the weights and columns C..Cp-1 of CEN and DIF are zero,
// so the padded terms add exact zeros. Where the weights and one point's
// rows do not fit (in f32 mode), the weights stay in global memory (GW)
// and their four parts take no shared memory.
__host__ __device__ inline int weight_floats(int Cp, int F2, int F,
                                             bool gw = false) {
  return (gw ? 0 : Cp * F2 + F2 * F + 2 * Cp * F) + 2 * F2 + 4 * F;
}

__host__ __device__ inline int point_floats(int Cp, int F2, int k) {
  return k * (2 * Cp + F2);
}

// KM: k rounded up to the register arrays' length. TC: output channels per
// thread in the F-wide pass, TC1 in the F2-wide pass; a thread owns
// channels c0, c0 + F / TC, ... of one point, so that neighbouring threads
// read neighbouring weights and the threads of a warp share a point. GW:
// the weights are read from global memory (f32 mode only: no rounding).
template <int KM, int TC, bool GW = false>
__global__ void __launch_bounds__(kThreads) edge_rows_kernel(const Rows r) {
  constexpr int TC1 = TC > 1 ? TC / 2 : 1;
  extern __shared__ __align__(16) float sm[];
  const int C = r.C, Cp = r.Cp, F2 = r.F2, F = r.F, k = r.k, P = r.P;
  float* W1 = sm;
  float* W2 = W1 + (GW ? 0 : Cp * F2);
  float* WX0 = W2 + (GW ? 0 : F2 * F);
  float* WX1 = WX0 + (GW ? 0 : Cp * F);
  float* A1 = WX1 + (GW ? 0 : Cp * F);
  float* A2 = A1 + 2 * F2;
  float* AX = A2 + 2 * F;
  float* CEN = AX + 2 * F;
  float* DIF = CEN + P * k * Cp;
  float* H1 = DIF + P * k * Cp;
  const int tid = threadIdx.x;

  const int rb = r.rb;
  if constexpr (!GW) {
    for (int i = tid; i < Cp * F2; i += kThreads) {
      const int row = i / F2, c = i - row * F2;
      W1[i] = row < C ? rnd(r.w1[row * F2 + c], rb) : 0.f;
    }
    for (int i = tid; i < F2 * F; i += kThreads) W2[i] = rnd(r.w2[i], rb);
    for (int i = tid; i < Cp * F; i += kThreads) {
      const int row = i / F, c = i - row * F;
      WX0[i] = row < C ? rnd(r.wx[row * F + c], rb) : 0.f;
      WX1[i] = row < C ? rnd(r.wx[(C + row) * F + c], rb) : 0.f;
    }
  }
  // the products' weights: in shared memory, or with GW as given
  const float* w1 = GW ? r.w1 : W1;
  const float* w2 = GW ? r.w2 : W2;
  const float* wx0 = GW ? r.wx : WX0;
  const float* wx1 = GW ? r.wx + C * F : WX1;
  for (int i = tid; i < 2 * F2; i += kThreads) A1[i] = r.a1[i];
  for (int i = tid; i < 2 * F; i += kThreads) {
    A2[i] = r.a2[i];
    AX[i] = r.ax[i];
  }
  for (int i = tid; i < 2 * P * k * Cp; i += kThreads) CEN[i] = 0.f;
  __syncthreads();

  const int C2 = 2 * C;
  for (long long p0 = (long long)blockIdx.x * P; p0 < r.M;
       p0 += (long long)gridDim.x * P) {
    const int np = r.M - p0 < P ? (int)(r.M - p0) : P;

    // the tile's edge rows, split into the central and the diff halves
    const long long base = p0 * k * C2;
    const float* src = static_cast<const float*>(r.ee) + base;
    const __nv_bfloat16* srcb =
        static_cast<const __nv_bfloat16*>(r.ee) + base;
    for (int i = tid; i < np * k * C2; i += kThreads) {
      const int row = i / C2, c = i - row * C2;
      const float val = rb ? __bfloat162float(srcb[i]) : src[i];
      if (c < C)
        CEN[row * Cp + c] = val;
      else
        DIF[row * Cp + c - C] = val;
    }
    __syncthreads();

    // h1 = lrelu(diff @ w1 * a1[0] + a1[1])
    const int cs1 = F2 / TC1;
    for (int t = tid; t < np * cs1; t += kThreads) {
      const int pp = t / cs1, c0 = t - pp * cs1;
      float acc[TC1][KM];
#pragma unroll
      for (int i = 0; i < TC1; ++i)
#pragma unroll
        for (int j = 0; j < KM; ++j) acc[i][j] = 0.f;
      rows_dot<KM, TC1, GW>(DIF + pp * k * Cp, Cp, w1, F2, c0, cs1, Cp, k,
                            acc, C);
#pragma unroll
      for (int i = 0; i < TC1; ++i) {
        const int c = c0 + i * cs1;
        const float s = A1[c], sh = A1[F2 + c];
#pragma unroll
        for (int j = 0; j < KM; ++j)
          if (j < k)
            H1[(pp * k + j) * F2 + c] =
                rnd(lrelu(acc[i][j] * s + sh, r.neg), rb);
      }
    }
    __syncthreads();

    // attention weights and values of TC channels of point pp, all k rows
    const int cs = F / TC;
    for (int t = tid; t < np * cs; t += kThreads) {
      const int pp = t / cs, c0 = t - pp * cs;
      if constexpr (KM <= 32) {
        float h[TC][KM], v[TC][KM];
#pragma unroll
        for (int i = 0; i < TC; ++i)
#pragma unroll
          for (int j = 0; j < KM; ++j) h[i][j] = v[i][j] = 0.f;
        rows_dot<KM, TC, GW>(H1 + pp * k * F2, F2, w2, F, c0, cs, F2, k, h,
                             F2);
        rows_dot<KM, TC, GW>(CEN + pp * k * Cp, Cp, wx0, F, c0, cs, Cp, k, v,
                             C);
        rows_dot<KM, TC, GW>(DIF + pp * k * Cp, Cp, wx1, F, c0, cs, Cp, k, v,
                             C);
        float* dst = r.v + (p0 + pp) * k * F;
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          const int c = c0 + i * cs;
          const float s2 = A2[c], sh2 = A2[F + c];
          const float sx = AX[c], shx = AX[F + c];
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (j < k) {
              h[i][j] = lrelu(h[i][j] * s2 + sh2, r.neg);
              m = fmaxf(m, h[i][j]);
            }
          }
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (j < k) {
              h[i][j] = expf(h[i][j] - m);
              sum += h[i][j];
            }
          }
#pragma unroll
          for (int j = 0; j < KM; ++j)
            if (j < k)
              dst[j * F + c] =
                  rnd(lrelu(v[i][j] * sx + shx, r.neg) * (h[i][j] / sum), rb);
        }
      } else {
        // past 32 rows h and v together would pass the 255 registers a
        // thread may have: h first, its softmax (the same operations in
        // the same order) stored to the thread's own column of v, then v,
        // which multiplies it there
        float* dst = r.v + (p0 + pp) * k * F;
        float h[TC][KM];
#pragma unroll
        for (int i = 0; i < TC; ++i)
#pragma unroll
          for (int j = 0; j < KM; ++j) h[i][j] = 0.f;
        rows_dot<KM, TC, GW>(H1 + pp * k * F2, F2, w2, F, c0, cs, F2, k, h,
                             F2);
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          const int c = c0 + i * cs;
          const float s2 = A2[c], sh2 = A2[F + c];
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (j < k) {
              h[i][j] = lrelu(h[i][j] * s2 + sh2, r.neg);
              m = fmaxf(m, h[i][j]);
            }
          }
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KM; ++j) {
            if (j < k) {
              h[i][j] = expf(h[i][j] - m);
              sum += h[i][j];
            }
          }
#pragma unroll
          for (int j = 0; j < KM; ++j)
            if (j < k) dst[j * F + c] = h[i][j] / sum;
        }
        float v[TC][KM];
#pragma unroll
        for (int i = 0; i < TC; ++i)
#pragma unroll
          for (int j = 0; j < KM; ++j) v[i][j] = 0.f;
        rows_dot<KM, TC, GW>(CEN + pp * k * Cp, Cp, wx0, F, c0, cs, Cp, k, v,
                             C);
        rows_dot<KM, TC, GW>(DIF + pp * k * Cp, Cp, wx1, F, c0, cs, Cp, k, v,
                             C);
#pragma unroll
        for (int i = 0; i < TC; ++i) {
          const int c = c0 + i * cs;
          const float sx = AX[c], shx = AX[F + c];
#pragma unroll
          for (int j = 0; j < KM; ++j)
            if (j < k)
              dst[j * F + c] =
                  rnd(lrelu(v[i][j] * sx + shx, r.neg) * dst[j * F + c], rb);
        }
      }
    }
    __syncthreads();
  }
}

// out[m, :] = bout + v[m, :] @ wout for m < M; v [M, K], wout [K, BN].
// K is a multiple of 8 and v 16-byte aligned.
template <int BN>
__global__ void __launch_bounds__(kThreads)
    conv_out_kernel(const float* __restrict__ v,
                    const float* __restrict__ wout,
                    const float* __restrict__ bout, float* __restrict__ out,
                    long long M, int K) {
  constexpr int BM = 128, BK = 8, TN = BN / 16;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = (long long)blockIdx.x * BM;
  const int ar = tid >> 1, ak = (tid & 1) * 4;
  const bool arow = m0 + ar < M;
  const float* ap = v + (m0 + ar) * K + ak;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const float4 a = arow ? *reinterpret_cast<const float4*>(ap + k0)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    As[ak + 0][ar] = a.x;
    As[ak + 1][ar] = a.y;
    As[ak + 2][ar] = a.z;
    As[ak + 3][ar] = a.w;
    for (int i = tid; i < BK * BN / 4; i += kThreads) {
      const int row = i / (BN / 4), c4 = (i % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[row][c4]) =
          *reinterpret_cast<const float4*>(wout + (long long)(k0 + row) * BN +
                                           c4);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 hi = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(x[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty * 8 + i;
    if (row < M) {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        out[row * BN + tx + 16 * j] = acc[i][j] + bout[tx + 16 * j];
    }
  }
}

template <int KM, int TC, bool GW = false>
cudaError_t launch_rows(const Rows& r, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      edge_rows_kernel<KM, TC, GW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, edge_rows_kernel<KM, TC, GW>, kThreads, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = (r.M + r.P - 1) / r.P;
  const long long most = (long long)sms * per_sm;
  const int grid = (int)(tiles < most ? tiles : most);
  edge_rows_kernel<KM, TC, GW><<<grid, kThreads, smem, stream>>>(r);
  return cudaGetLastError();
}

// the widths kernel C takes, but for C's limit of shared memory: k <= 64
// in both modes
bool widths_ok(int B, int N, int C, int F2, int F, int k) {
  return B > 0 && N > 0 && C > 0 && k > 0 && k <= 64 && F2 > 0 &&
         F2 % 4 == 0 && (F == 64 || F == 128);
}

// The designs spgan_edge_tail takes, as spgan_edge_tail_route numbers them
enum Route { kTf32 = 0, kTcBf16 = 1, kFma = 2, kFmaGlobal = 3 };

// The FMA kernels' plan at these widths: the points P a block of
// edge_rows_kernel holds, whether the weights stay in global memory (gw)
// and the block's shared memory; 0 or a cudaError_t.
int fma_plan(int C, int F2, int F, int k, int bf16, int* P, bool* gw,
             size_t* smem) {
  const int Cp = (C + 3) / 4 * 4;
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t pbytes = 4 * (size_t)point_floats(Cp, F2, k);
  // the weights in shared memory where one point's rows fit beside them;
  // else, in f32 mode, read from global memory
  *gw = !bf16 &&
        4 * (size_t)weight_floats(Cp, F2, F) + pbytes > (size_t)limit;
  const size_t wbytes = 4 * (size_t)weight_floats(Cp, F2, F, *gw);
  int p = kMaxPoints;
  while (p > 1 && wbytes + p * pbytes > (size_t)limit) p /= 2;
  if (wbytes + p * pbytes > (size_t)limit) return (int)cudaErrorInvalidValue;
  *P = p;
  *smem = wbytes + p * pbytes;
  return 0;
}

// The design a launch at these widths takes (a Route), with the FMA
// kernels' plan where it is one of theirs; a negative cudaError_t where
// none takes them.
int route(int B, int N, int C, int F2, int F, int k, int bf16, int* P,
          bool* gw, size_t* smem) {
  if (!widths_ok(B, N, C, F2, F, k)) return -(int)cudaErrorInvalidValue;
  if (!bf16 && ebt_tf_fits(C, F2, F, k)) return kTf32;
  if (bf16 && ebt_tc_fits(kEbtTail, C, F2, F, k)) return kTcBf16;
  const int err = fma_plan(C, F2, F, k, bf16, P, gw, smem);
  return err ? -err : (*gw ? kFmaGlobal : kFma);
}

}  // namespace

// The design spgan_edge_tail takes at these widths, decided as it decides
// it: 0 the tensor cores in f32 mode (edgeblock_tf32.cu), 1 the tensor
// cores in bf16 mode (edgeblock_train_tc.cu), 2 the FMA kernels with the
// weights in shared memory, 3 the FMA kernels with the weights in global
// memory (f32 mode only); a negative cudaError_t where it refuses them.
extern "C" int spgan_edge_tail_route(int B, int N, int C, int F2, int F,
                                     int k, int bf16) {
  int P = 0;
  bool gw = false;
  size_t smem = 0;
  return route(B, N, C, F2, F, k, bf16, &P, &gw, &smem);
}

// Floats of the scratch spgan_edge_tail takes at these widths in the mode
// `bf16` names, or a negative cudaError_t: on the tensor cores in f32 mode
// (where ebt_tf_fits) an f32 v [B, N, k, F] and wout transposed, in bf16
// mode (where ebt_tc_fits(kEbtTail, ...)) a bf16 v and wout's bf16 pair;
// else an f32 v [B, N, k, F]. Refuses (cudaErrorInvalidValue) what
// spgan_edge_tail_route and spgan_edge_tail refuse.
extern "C" long long spgan_edge_tail_scratch(int B, int N, int C, int F2,
                                             int F, int k, int bf16) {
  int P = 0;
  bool gw = false;
  size_t smem = 0;
  const int how = route(B, N, C, F2, F, k, bf16, &P, &gw, &smem);
  if (how < 0) return how;
  if (how == kTf32) return ebt_tf_scratch(B, N, C, F2, F, k);
  if (how == kTcBf16) return ebt_tc_scratch(kEbtTail, B, N, C, F2, F, k);
  return (long long)B * N * k * F;
}

// ee [B, N, k, 2C]; w1 [C, F2]; a1 [2, F2]; w2 [F2, F]; a2, ax [2, F];
// wx [2C, F]; wout [k, F, F]; bout [F]; vbuf the scratch, as many floats
// as spgan_edge_tail_scratch says; out [B, N, F]. All f32 except ee, which
// is bf16 when `bf16` is set; all contiguous, on the device. Launches its
// kernels on `stream` and returns the first nonzero cudaError_t (0 on
// success). Takes F in {64, 128}, F2 a multiple of 4, 1 <= k <= 64, and C
// small enough that one point's rows fit in shared memory (in bf16 mode,
// with the weights beside them, where the tensor cores do not take it).
//
// bf16 mode, the JAX kernel's `cd = bfloat16`: the operands of the chain's
// matmuls (the edge rows, w1, w2, wx, the activations before @ w2) and v
// before @ wout are rounded to bf16; wout stays f32, as the JAX kernel's
// mixed bf16 x f32 dot promotes it. Each product of two bf16 values is
// exact in f32, so only the order of the f32 sums differs from the plain
// version (on the tensor cores also wout's bf16 pair, within 2^-17 of
// each product). The affines, leaky ReLU and softmax stay f32.
//
// f32 mode on the tensor cores splits each operand x into tf32 hi + lo and
// takes each product as three TF32 products (hi hi + hi lo + lo hi, each
// within about 2^-21 of the f32 product); elsewhere it runs f32 FMAs.
extern "C" int spgan_edge_tail(const void* ee, const void* w1, const void* a1,
                               const void* w2, const void* a2, const void* wx,
                               const void* ax, const void* wout,
                               const void* bout, void* vbuf, void* out, int B,
                               int N, int C, int F2, int F, int k, float neg,
                               int bf16, void* stream) {
  int P = 0;
  bool gw = false;
  size_t smem = 0;
  const int how = route(B, N, C, F2, F, k, bf16, &P, &gw, &smem);
  if (how < 0) return -how;
  if (how == kTf32)
    return ebt_tf_tail(
        static_cast<const float*>(ee), static_cast<const float*>(w1),
        static_cast<const float*>(a1), static_cast<const float*>(w2),
        static_cast<const float*>(a2), static_cast<const float*>(wx),
        static_cast<const float*>(ax), static_cast<const float*>(wout),
        static_cast<const float*>(bout), static_cast<float*>(out),
        static_cast<float*>(vbuf), B, N, C, F2, F, k, neg,
        static_cast<cudaStream_t>(stream));
  if (how == kTcBf16)
    return ebt_tc_tail(
        ee, static_cast<const float*>(w1), static_cast<const float*>(a1),
        static_cast<const float*>(w2), static_cast<const float*>(a2),
        static_cast<const float*>(wx), static_cast<const float*>(ax),
        static_cast<const float*>(wout), static_cast<const float*>(bout),
        static_cast<float*>(out), static_cast<float*>(vbuf), B, N, C, F2, F,
        k, neg, static_cast<cudaStream_t>(stream));
  const int Cp = (C + 3) / 4 * 4;

  const Rows r{ee, static_cast<const float*>(w1),
               static_cast<const float*>(a1), static_cast<const float*>(w2),
               static_cast<const float*>(a2), static_cast<const float*>(wx),
               static_cast<const float*>(ax), static_cast<float*>(vbuf),
               (long long)B * N, C, Cp, F2, F, k, P, neg, bf16 ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (gw)
    err = launch_rows<64, 1, true>(r, smem, s);
  else if (k > 32)
    err = launch_rows<64, 1>(r, smem, s);
  else if (k > 16)
    err = launch_rows<32, 1>(r, smem, s);
  else if (F == 128)
    err = launch_rows<16, 4>(r, smem, s);
  else
    err = launch_rows<16, 2>(r, smem, s);
  if (err != cudaSuccess) return (int)err;

  const long long M = (long long)B * N;
  const int grid = (int)((M + 127) / 128);
  const float* vb = static_cast<const float*>(vbuf);
  const float* wo = static_cast<const float*>(wout);
  const float* bo = static_cast<const float*>(bout);
  float* o = static_cast<float*>(out);
  if (F == 128)
    conv_out_kernel<128><<<grid, kThreads, 0, s>>>(vb, wo, bo, o, M, k * F);
  else
    conv_out_kernel<64><<<grid, kThreads, 0, s>>>(vb, wo, bo, o, M, k * F);
  return (int)cudaGetLastError();
}
