// Kernels I-L: the fused train-mode EdgeBlock's batch-statistics sweep (I)
// and its three backward sweeps (J, K, L), ee [B, N, k, 2C] f32 or bf16.
//
// Replace the TPU kernels of sp_gan_tpu/ops/pallas/edgeblock_train.py:
//   I  _stats2_pallas (_stats2_kernel): sum and sum of squares over every
//      edge row of h2 = lrelu(diff @ w1 * a1[0] + a1[1]) @ w2   -> [2, F]
//   J  backward pass 1 (_bwd_pass1_kernel): [S2a, S2b, Sxa, Sxb] [4, F],
//      d_wout [k, F, F], d_bout [F]
//   K  backward pass 2 (_bwd_pass2_kernel): [S1a, S1b] [2, F2], d_w2
//      [F2, F]
//   L  backward pass 3 (_bwd_pass3_kernel): d_ee [B, N, k, 2C] in ee's
//      type, d_w1 [C, F2], d_wx [2C, F]
// Every sweep recomputes the chain of the JAX `_chunk_common` from the edge
// rows (diff = ee[..., C:], lrelu of slope `neg`, a* = [scale; shift]):
//   p1 = diff @ w1 * a1[0] + a1[1]; y1 = lrelu(p1)
//   p2 = y1 @ w2 * a2[0] + a2[1];  w = softmax_k(lrelu(p2))
//   px = ee @ wx * ax[0] + ax[1];  v = lrelu(px)
// and the top of the backward from d_u = d_out @ wout[j]^T:
//   d_p2 = w * (d_u v - sum_k(w d_u v)) * lrelu'(p2)
//   d_px = d_u w lrelu'(px)
// bf16 mode (the JAX kernels' cd = bfloat16, a bf16 ee): both operands of
// every matmul, including the transposed weights and d_out, are rounded to
// bf16 and the products summed in f32; a product of two bf16 values is
// exact in f32, so only the order of the sums differs from the plain
// version. The affines, leaky ReLU, softmax and BatchNorm arithmetic stay
// f32. f32 mode rounds nothing.
//
// Design. Each entry point launches, on the caller's stream and in order:
//  - prep_weights_kernel: w1, w2, wx and their transposes, rounded in bf16
//    mode, into the scratch (read through the read-only cache);
//  - (J) gemm_kernel for d_u = d_out @ wout^T [B*N, k*F], the input of
//    J, K and L, which J returns: wout [k, F, F] (640 KB in f32) does not
//    fit in shared memory, so the product runs once in 64 x 64 tiles of
//    points rather than once per sweep and tile;
//  - train_tile_kernel<pass>: blocks walk tiles of TP points; the tile's
//    edge rows and the chain's intermediates sit in shared memory; a
//    thread owns one channel of one point and keeps its k values in
//    registers, so the softmax over k and its backward need no exchange.
//    Per-channel sums go to per-thread registers, then per block to a
//    scratch row in a fixed order;
//  - gemm_kernel with split K for the weight gradients (d_wout = u^T d_out,
//    d_w2 = y1^T d_h2, d_w1 = diff^T d_h1, d_wx = ee^T d_hx) from the
//    operands the tile pass wrote to scratch: each block writes its slice's
//    partial product;
//  - reduce_kernel: the partials summed in slice (or block) order.
// No float atomics: two launches on one card give bit-identical results.
//
// bf16 mode of J, K and L: edgeblock_train_tc.cu (tensor cores); the entry
// points below hand a bf16 ee to it wherever its shared-memory layout fits
// (ebt_tc_fits), else run the FMA path here. The rest here is I in both
// modes, J, K and L in f32 mode, and J, K and L in bf16 mode at widths
// too wide for the tensor cores' layout.
//
// What bounds it on an H100: operations at the f32 rate, bytes at the bf16
// tensor-core peak. At the default training step (ee [24, 2048, 10, 128]
// bf16, F2 = 64, F = 128; 491,520 edge rows) I is 12.1 GFLOP, K 44.3, J
// 60.4 and L 76.5 (0.01 to 0.08 ms at the bf16 tensor-core peak of 989
// TFLOP/s, 0.18 to 1.14 ms at the 67 TFLOP/s f32 rate), against 63 to 503
// MB moved, the f32 d_u that J writes and K and L read among them (0.02 to
// 0.15 ms at 3.35 TB/s). These kernels run the products as f32 FMAs (in
// bf16 mode on operands rounded to bf16), no tensor cores, and round-trip
// the chain's intermediates that feed the weight gradients and d_u through
// device memory: a first design that is right, not a fast one. In f32 mode
// that FMA order is what chip_smoke.py's kernel_slopes re-derives.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "edgeblock_train_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 16;   // points per tile of train_tile_kernel
constexpr int kAcc = 5;        // per-thread channel sums (J: 5)
constexpr int GM = 64, GN = 64, GK = 16;  // gemm_kernel tile

enum Pass { kStats = 0, kBwd1 = 1, kBwd2 = 2, kBwd3 = 3 };

__device__ __forceinline__ float lrelu(float v, float neg) {
  return v >= 0.f ? v : neg * v;
}

__device__ __forceinline__ float dlrelu(float v, float neg) {
  return v >= 0.f ? 1.f : neg;
}

// x rounded to bf16 (nearest even) when rb, else x unchanged
__device__ __forceinline__ float rnd(float x, int rb) {
  return rb ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// acc[j] += dot(a[j * lda + 0 .. K), column c of W[0 .. K)) for j < k; a
// in shared memory (16-byte aligned, lda and K multiples of 4), W
// row-major with row length ldw in global memory. Neighbouring threads
// take neighbouring columns, so each weight row is one coalesced read,
// and the threads of a warp share a point, so each float4 of a is a
// broadcast.
template <int KM>
__device__ __forceinline__ void rows_dot(const float* a, int lda,
                                         const float* __restrict__ W, int ldw,
                                         int c, int K, int k,
                                         float (&acc)[KM]) {
  for (int kk = 0; kk < K; kk += 4) {
    const float w0 = __ldg(W + (kk + 0) * ldw + c);
    const float w1 = __ldg(W + (kk + 1) * ldw + c);
    const float w2 = __ldg(W + (kk + 2) * ldw + c);
    const float w3 = __ldg(W + (kk + 3) * ldw + c);
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      if (j < k) {
        const float4 x = *reinterpret_cast<const float4*>(a + j * lda + kk);
        acc[j] = fmaf(x.x, w0, acc[j]);
        acc[j] = fmaf(x.y, w1, acc[j]);
        acc[j] = fmaf(x.z, w2, acc[j]);
        acc[j] = fmaf(x.w, w3, acc[j]);
      }
    }
  }
}

template <int KM>
__device__ __forceinline__ void zero(float (&a)[KM]) {
#pragma unroll
  for (int j = 0; j < KM; ++j) a[j] = 0.f;
}

struct Args {
  const void* ee;          // [M, 2C] edge rows, f32 or bf16 (rb)
  const float* wr;         // prep_weights_kernel's output
  const float *a1, *a2, *ax, *gb2x, *gb1;
  const float* du;         // [P, k, F] (J, K, L)
  const float* dout;       // [P, F] (J)
  const float *s2, *s1;    // final sums [4, F] (K, L), [2, F2] (L)
  float* u;                // J: v * w [P, k, F]
  float *y1s, *dh2s;       // K: y1 [M, F2], d_h2 [M, F]
  float *dh1s, *dhxs;      // L: d_h1 [M, F2], d_hx [M, F]
  void* dee;               // L: d_ee [M, 2C] in ee's type
  float* part;             // [gridDim.x][nsum] per-block channel sums
  long long P;             // points, B * N
  int C, F2, F, k, TP;
  float neg, m;            // m: edge rows B * N * k, as the JAX kernels'
  int rb;
};

// Shared memory of train_tile_kernel, in floats (each part a multiple of
// 4): EE [R][2C] | Y1 [R][F2] | P1 [R][F2] (K, L) | DH [R][F] (K, L) |
// DHX [R][F] (L) | DH1 [R][F2] (L) | RED [kThreads][kAcc], R = TP * k.
struct Layout {
  int ee, y1, p1, dh, dhx, dh1, red, total;
};

__host__ __device__ inline Layout layout(int pass, int C, int F2, int F,
                                         int k, int TP) {
  const int R = TP * k;
  Layout L;
  int o = 0;
  L.ee = o;
  o += R * 2 * C;
  L.y1 = o;
  o += R * F2;
  L.p1 = o;
  if (pass >= kBwd2) o += R * F2;
  L.dh = o;
  if (pass >= kBwd2) o += R * F;
  L.dhx = o;
  if (pass == kBwd3) o += R * F;
  L.dh1 = o;
  if (pass == kBwd3) o += R * F2;
  L.red = o;
  o += kThreads * kAcc;
  L.total = o;
  return L;
}

// the per-channel sums a pass accumulates, and their width
__host__ __device__ inline int n_acc(int pass) {
  return pass == kStats ? 2 : pass == kBwd1 ? 5 : pass == kBwd2 ? 2 : 0;
}

__host__ __device__ inline int acc_width(int pass, int F2, int F) {
  return pass == kBwd2 ? F2 : F;
}

// The sweeps. Stage A loads a tile's edge rows; B computes y1 (F2-wide
// threads); C the F-wide chain and the top of the backward; D (K, L) d_y1
// and d_p1; E (L) d_ee. A thread's channel is its index modulo the stage's
// width, which divides kThreads, so it keeps one channel over all tiles.
template <int PASS, int KM>
__global__ void __launch_bounds__(kThreads)
    train_tile_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int C = a.C, C2 = 2 * C, F2 = a.F2, F = a.F, k = a.k, TP = a.TP;
  const Layout L = layout(PASS, C, F2, F, k, TP);
  float* EE = sm + L.ee;
  float* Y1 = sm + L.y1;
  float* P1 = sm + L.p1;
  float* DH = sm + L.dh;
  float* DHX = sm + L.dhx;
  float* DH1 = sm + L.dh1;
  float* RED = sm + L.red;
  const float* w1 = a.wr;
  const float* w2 = w1 + C * F2;
  const float* wx = w2 + F2 * F;
  const float* w2t = wx + C2 * F;
  const float* w1t = w2t + F * F2;
  const float* wxt = w1t + F2 * C;
  const int tid = threadIdx.x, rb = a.rb;
  const float neg = a.neg, m = a.m;
  float acc[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};

  for (long long p0 = (long long)blockIdx.x * TP; p0 < a.P;
       p0 += (long long)gridDim.x * TP) {
    const int np = a.P - p0 < TP ? (int)(a.P - p0) : TP;
    const long long r0 = p0 * k;  // the tile's first edge row

    // A: the tile's edge rows
    {
      const long long base = r0 * C2;
      const float* src = static_cast<const float*>(a.ee) + base;
      const __nv_bfloat16* srcb =
          static_cast<const __nv_bfloat16*>(a.ee) + base;
      for (int i = tid; i < np * k * C2; i += kThreads)
        EE[i] = rb ? __bfloat162float(srcb[i]) : src[i];
    }
    __syncthreads();

    // B: p1 and y1 = lrelu(p1), rounded as the operand of @ w2
    for (int t = tid; t < np * F2; t += kThreads) {
      const int pp = t / F2, c = t - pp * F2;
      float h[KM];
      zero(h);
      rows_dot<KM>(EE + pp * k * C2 + C, C2, w1, F2, c, C, k, h);
      const float s = a.a1[c], sh = a.a1[F2 + c];
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          const float p = h[j] * s + sh;
          const float y = rnd(lrelu(p, neg), rb);
          const int row = pp * k + j;
          Y1[row * F2 + c] = y;
          if (PASS >= kBwd2) P1[row * F2 + c] = p;
          if (PASS == kBwd2) a.y1s[(r0 + row) * F2 + c] = y;
        }
      }
    }
    __syncthreads();

    // C: the F-wide chain, one channel of one point per thread
    for (int t = tid; t < np * F; t += kThreads) {
      const int pp = t / F, c = t - pp * F;
      const long long row0 = r0 + pp * k;
      float h2[KM];
      zero(h2);
      rows_dot<KM>(Y1 + pp * k * F2, F2, w2, F, c, F2, k, h2);
      if (PASS == kStats) {
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) {
            acc[0] += h2[j];
            acc[1] += h2[j] * h2[j];
          }
        }
        continue;
      }
      float hx[KM];
      zero(hx);
      rows_dot<KM>(EE + pp * k * C2, C2, wx, F, c, C2, k, hx);
      const float s2 = a.a2[c], sh2 = a.a2[F + c];
      const float sx = a.ax[c], shx = a.ax[F + c];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          h2[j] = h2[j] * s2 + sh2;                 // p2
          hx[j] = hx[j] * sx + shx;                 // px
          mx = fmaxf(mx, lrelu(h2[j], neg));
        }
      }
      float w[KM];
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        w[j] = 0.f;
        if (j < k) {
          w[j] = expf(lrelu(h2[j], neg) - mx);
          sum += w[j];
        }
      }
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) w[j] = w[j] / sum;
      if (PASS == kBwd1) {
#pragma unroll
        for (int j = 0; j < KM; ++j)
          if (j < k)
            a.u[(row0 + j) * F + c] = rnd(lrelu(hx[j], neg) * w[j], rb);
        acc[4] += a.dout[(p0 + pp) * F + c];
      }
      // softmax backward over k
      const float* du = a.du + row0 * F + c;
      float sw = 0.f;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) sw += w[j] * (du[j * F] * lrelu(hx[j], neg));
      const float g2 = a.gb2x[c], b2 = a.gb2x[F + c];
      const float gx = a.gb2x[2 * F + c], bx = a.gb2x[3 * F + c];
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          const float d = du[j * F];
          const float dp2 =
              w[j] * (d * lrelu(hx[j], neg) - sw) * dlrelu(h2[j], neg);
          const float dpx = d * w[j] * dlrelu(hx[j], neg);
          const float xh2 = (h2[j] - b2) / g2;
          const float xhx = (hx[j] - bx) / gx;
          if (PASS == kBwd1) {
            acc[0] += dp2;
            acc[1] += dp2 * xh2;
            acc[2] += dpx;
            acc[3] += dpx * xhx;
          } else {
            const float dh2 =
                rnd(s2 * (dp2 - a.s2[c] / m - xh2 * (a.s2[F + c] / m)), rb);
            const int row = pp * k + j;
            DH[row * F + c] = dh2;
            if (PASS == kBwd2) a.dh2s[(row0 + j) * F + c] = dh2;
            if (PASS == kBwd3) {
              const float dhx = rnd(
                  sx * (dpx - a.s2[2 * F + c] / m -
                        xhx * (a.s2[3 * F + c] / m)),
                  rb);
              DHX[row * F + c] = dhx;
              a.dhxs[(row0 + j) * F + c] = dhx;
            }
          }
        }
      }
    }
    __syncthreads();
    if (PASS == kStats || PASS == kBwd1) continue;

    // D: d_y1 = d_h2 @ w2^T, d_p1 = d_y1 lrelu'(p1)
    for (int t = tid; t < np * F2; t += kThreads) {
      const int pp = t / F2, i = t - pp * F2;
      float dy[KM];
      zero(dy);
      rows_dot<KM>(DH + pp * k * F, F, w2t, F2, i, F, k, dy);
      const float g1 = a.gb1[i], b1 = a.gb1[F2 + i], s1 = a.a1[i];
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          const int row = pp * k + j;
          const float p = P1[row * F2 + i];
          const float dp1 = dy[j] * dlrelu(p, neg);
          const float xh1 = (p - b1) / g1;
          if (PASS == kBwd2) {
            acc[0] += dp1;
            acc[1] += dp1 * xh1;
          } else {
            const float dh1 = rnd(
                s1 * (dp1 - a.s1[i] / m - xh1 * (a.s1[F2 + i] / m)), rb);
            DH1[row * F2 + i] = dh1;
            a.dh1s[(r0 + row) * F2 + i] = dh1;
          }
        }
      }
    }
    __syncthreads();
    if (PASS == kBwd2) continue;

    // E: d_ee = [d_hx @ wx^T][:C] ++ ([d_hx @ wx^T][C:] + d_h1 @ w1^T)
    for (int t = tid; t < np * C2; t += kThreads) {
      const int pp = t / C2, c = t - pp * C2;
      float df[KM];
      zero(df);
      rows_dot<KM>(DHX + pp * k * F, F, wxt, C2, c, F, k, df);
      if (c >= C) {
        float dd[KM];
        zero(dd);
        rows_dot<KM>(DH1 + pp * k * F2, F2, w1t, C, c - C, F2, k, dd);
#pragma unroll
        for (int j = 0; j < KM; ++j) df[j] += dd[j];
      }
      const long long o = (r0 + pp * k) * C2 + c;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          if (rb)
            static_cast<__nv_bfloat16*>(a.dee)[o + j * C2] =
                __float2bfloat16_rn(df[j]);
          else
            static_cast<float*>(a.dee)[o + j * C2] = df[j];
        }
      }
    }
    __syncthreads();
  }

  // the block's channel sums, threads of one channel added in index order
  constexpr int nacc = PASS == kStats ? 2 : PASS == kBwd1 ? 5 :
                       PASS == kBwd2 ? 2 : 0;
  if (nacc > 0) {
    const int width = PASS == kBwd2 ? F2 : F;
#pragma unroll
    for (int q = 0; q < kAcc; ++q) RED[tid * kAcc + q] = acc[q];
    __syncthreads();
    for (int i = tid; i < nacc * width; i += kThreads) {
      const int q = i / width, c = i - q * width;
      float s = 0.f;
      for (int t = c; t < kThreads; t += width) s += RED[t * kAcc + q];
      a.part[(long long)blockIdx.x * nacc * width + i] = s;
    }
  }
}

// out[s][m][n] = sum over kk in slice s of A[m, kk] * B[kk, n] with
// A[m, kk] = A[m * a_m + kk * a_k] (f32, or bf16 with a_bf16) and
// B[kk, n] = B[kk * b_k + n * b_n], both rounded to bf16 when rb.
struct Gemm {
  const void* A;
  int a_bf16;
  long long a_m, a_k;
  const float* B;
  long long b_k, b_n;
  float* out;
  int M, N;
  long long K, kslice;
  int rb;
};

__global__ void __launch_bounds__(kThreads) gemm_kernel(const Gemm g) {
  __shared__ __align__(16) float As[GK][GM];
  __shared__ __align__(16) float Bs[GK][GN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const long long kb = (long long)blockIdx.z * g.kslice;
  const long long ke = kb + g.kslice < g.K ? kb + g.kslice : g.K;
  const float* Af = static_cast<const float*>(g.A);
  const __nv_bfloat16* Ab = static_cast<const __nv_bfloat16*>(g.A);
  const bool a_kfast = g.a_k == 1, b_nfast = g.b_n == 1;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (long long k0 = kb; k0 < ke; k0 += GK) {
    // loads run along whichever index is contiguous in memory
    for (int e = tid; e < GM * GK; e += kThreads) {
      const int mm = a_kfast ? e / GK : e % GM;
      const int kk = a_kfast ? e % GK : e / GM;
      const long long gk = k0 + kk;
      float v = 0.f;
      if (m0 + mm < g.M && gk < ke) {
        const long long off = (m0 + mm) * g.a_m + gk * g.a_k;
        v = g.a_bf16 ? __bfloat162float(Ab[off]) : Af[off];
      }
      As[kk][mm] = rnd(v, g.rb);
    }
    for (int e = tid; e < GN * GK; e += kThreads) {
      const int nn = b_nfast ? e % GN : e / GK;
      const int kk = b_nfast ? e / GN : e % GK;
      const long long gk = k0 + kk;
      float v = 0.f;
      if (n0 + nn < g.N && gk < ke) v = g.B[gk * g.b_k + (n0 + nn) * g.b_n];
      Bs[kk][nn] = rnd(v, g.rb);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = g.out + (long long)blockIdx.z * g.M * g.N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int mm = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tx * 4 + j;
      if (mm < g.M && nn < g.N) out[(long long)mm * g.N + nn] = acc[i][j];
    }
  }
}

// out[i] = sum over s < S, in order, of part[s * stride + offset + i]
__global__ void reduce_kernel(const float* __restrict__ part, int S,
                              long long stride, long long offset,
                              long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += part[q * stride + offset + i];
    out[i] = s;
  }
}

// w1 [C, F2], w2 [F2, F], wx [2C, F] (wx may be null: pass I) and their
// transposes, rounded to bf16 when rb, into wr in the order
// w1 | w2 | wx | w2^T | w1^T | wx^T
__global__ void prep_weights_kernel(const float* __restrict__ w1,
                                    const float* __restrict__ w2,
                                    const float* __restrict__ wx,
                                    float* __restrict__ wr, int C, int F2,
                                    int F, int rb) {
  const int C2 = 2 * C, n1 = C * F2, n2 = F2 * F, nx = wx ? C2 * F : 0;
  float* o_w1 = wr;
  float* o_w2 = o_w1 + n1;
  float* o_wx = o_w2 + n2;
  float* o_w2t = o_wx + C2 * F;
  float* o_w1t = o_w2t + n2;
  float* o_wxt = o_w1t + n1;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n1 + n2 + nx;
       i += gridDim.x * blockDim.x) {
    if (i < n1) {
      const int r = i / F2, c = i - r * F2;
      const float v = rnd(w1[i], rb);
      o_w1[i] = v;
      o_w1t[c * C + r] = v;
    } else if (i < n1 + n2) {
      const int j = i - n1, r = j / F, c = j - r * F;
      const float v = rnd(w2[j], rb);
      o_w2[j] = v;
      o_w2t[c * F2 + r] = v;
    } else {
      const int j = i - n1 - n2, r = j / F, c = j - r * F;
      const float v = rnd(wx[j], rb);
      o_wx[j] = v;
      o_wxt[c * C2 + r] = v;
    }
  }
}

int weight_floats(int C, int F2, int F) {
  return (2 * (C * F2 + F2 * F + 2 * C * F) + 3) / 4 * 4;
}

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

template <int PASS, int KM>
void* tile_fn() {
  return reinterpret_cast<void*>(train_tile_kernel<PASS, KM>);
}

void* tile_kernel(int pass, int k) {
  const bool big = k > 16;
  switch (pass) {
    case kStats: return big ? tile_fn<kStats, 32>() : tile_fn<kStats, 16>();
    case kBwd1: return big ? tile_fn<kBwd1, 32>() : tile_fn<kBwd1, 16>();
    case kBwd2: return big ? tile_fn<kBwd2, 32>() : tile_fn<kBwd2, 16>();
    default: return big ? tile_fn<kBwd3, 32>() : tile_fn<kBwd3, 16>();
  }
}

// Tile size, grid and shared memory of a sweep: TP points (at most
// kMaxTile) such that two blocks fit on an SM where they can, grid the
// blocks that fit on the card at once (at most one per tile).
struct TilePlan {
  int TP, grid;
  size_t smem;
};

int tile_plan(int pass, long long P, int C, int F2, int F, int k,
              TilePlan* tp) {
  int dev = 0, limit = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const Layout one = layout(pass, C, F2, F, k, 1);
  const size_t fixed = 4 * (size_t)(kThreads * kAcc);
  const size_t per_point = 4 * (size_t)(one.total - kThreads * kAcc);
  size_t budget = (size_t)limit / 2;
  if (fixed + per_point > budget) budget = (size_t)limit;
  if (fixed + per_point > budget) return (int)cudaErrorInvalidValue;
  int TP = (int)((budget - fixed) / per_point);
  if (TP > kMaxTile) TP = kMaxTile;
  tp->TP = TP;
  tp->smem = 4 * (size_t)layout(pass, C, F2, F, k, TP).total;
  void* fn = tile_kernel(pass, k);
  if ((err = cudaFuncSetAttribute(fn,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)tp->smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fn, kThreads, tp->smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (P + TP - 1) / TP;
  const long long most = (long long)sms * per_sm;
  tp->grid = (int)(tiles < most ? tiles : most);
  return 0;
}

// Split of a product's K rows into slices: about four blocks per SM in
// all, slices a multiple of GK rows.
struct Split {
  int S;
  long long kslice;
};

Split split(int M, int N, long long K, int sms) {
  const long long tiles = (long long)((M + GM - 1) / GM) * ((N + GN - 1) / GN);
  long long S = (4LL * sms + tiles - 1) / tiles;
  const long long most = (K + GK - 1) / GK;
  if (S > most) S = most;
  if (S < 1) S = 1;
  long long ks = (K + S - 1) / S;
  ks = (ks + GK - 1) / GK * GK;
  return {(int)((K + ks - 1) / ks), ks};
}

// A weight gradient out [M, N] = sum over K of A[m, kk] B[kk, n], through
// slice partials in `part` and reduce_kernel
int weight_grad(const void* A, int a_bf16, long long a_m, long long a_k,
                const float* B, long long b_k, long long b_n, float* out,
                int M, int N, long long K, int rb, float* part, int sms,
                cudaStream_t s) {
  const Split sp = split(M, N, K, sms);
  const Gemm g{A, a_bf16, a_m, a_k, B, b_k, b_n, part, M, N, K, sp.kslice,
               rb};
  const dim3 grid((M + GM - 1) / GM, (N + GN - 1) / GN, sp.S);
  gemm_kernel<<<grid, kThreads, 0, s>>>(g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)M * N;
  reduce_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(part, sp.S, n, 0, n,
                                                       out);
  return (int)cudaGetLastError();
}

long long gemm_part_floats(int M, int N, long long K, int sms) {
  return (long long)split(M, N, K, sms).S * M * N;
}

// Scratch of a pass, in floats, in the order wr | part | gemm partials |
// intermediates (J: u; K: y1, d_h2; L: d_h1, d_hx)
struct Scratch {
  long long wr, part, gemm, inter, total;
};

int scratch_plan(int pass, int B, int N, int C, int F2, int F, int k,
                 Scratch* sc, TilePlan* tp) {
  if (!ebt_widths_ok(B, N, C, F2, F, k)) return (int)cudaErrorInvalidValue;
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  const long long P = (long long)B * N, M = P * k;
  if ((err = tile_plan(pass, P, C, F2, F, k, tp))) return err;
  long long gemm = 0;
  if (pass == kBwd1) gemm = gemm_part_floats(k * F, F, P, sms);
  if (pass == kBwd2) gemm = gemm_part_floats(F2, F, M, sms);
  if (pass == kBwd3) {
    const long long a = gemm_part_floats(C, F2, M, sms);
    const long long b = gemm_part_floats(2 * C, F, M, sms);
    gemm = a > b ? a : b;
  }
  const long long inter = pass == kBwd1   ? P * k * F
                          : pass >= kBwd2 ? M * (F2 + F)
                                          : 0;
  sc->wr = 0;
  sc->part = weight_floats(C, F2, F);
  sc->gemm = sc->part +
             (long long)tp->grid * n_acc(pass) * acc_width(pass, F2, F);
  sc->inter = sc->gemm + gemm;
  sc->total = sc->inter + inter;
  return 0;
}

int launch_prep(const void* w1, const void* w2, const void* wx, float* wr,
                int C, int F2, int F, int rb, cudaStream_t s) {
  prep_weights_kernel<<<64, 256, 0, s>>>(
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(wx), wr, C, F2, F, rb);
  return (int)cudaGetLastError();
}

int launch_tile(int pass, int k, const TilePlan& tp, const Args& a,
                cudaStream_t s) {
  void* fn = tile_kernel(pass, k);
  void* params[] = {const_cast<Args*>(&a)};
  return (int)cudaLaunchKernel(fn, dim3(tp.grid), dim3(kThreads), params,
                               tp.smem, s);
}

// the channel sums of a sweep: its blocks' partials, in block order
int reduce_sums(const float* part, int grid, int nsum, long long offset,
                long long n, float* out, cudaStream_t s) {
  reduce_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(part, grid, nsum,
                                                       offset, n, out);
  return (int)cudaGetLastError();
}

Args base_args(const void* ee, float* scratch, const Scratch& sc,
               const TilePlan& tp, int B, int N, int C, int F2, int F, int k,
               float neg, int bf16) {
  Args a{};
  a.ee = ee;
  a.wr = scratch + sc.wr;
  a.part = scratch + sc.part;
  a.P = (long long)B * N;
  a.C = C;
  a.F2 = F2;
  a.F = F;
  a.k = k;
  a.TP = tp.TP;
  a.neg = neg;
  a.m = (float)((long long)B * N * k);
  a.rb = bf16 ? 1 : 0;
  return a;
}

}  // namespace

// Floats of scratch that pass `pass` (0: I, 1: J, 2: K, 3: L) needs at
// these widths in the mode `bf16` names (a bf16 ee when set), or a
// negative cudaError_t: in bf16 mode J, K and L take the tensor-core
// path's scratch where its layout fits. The widths the kernels take: C a
// multiple of 4, F2 a multiple of 4 dividing 256, F in {64, 128},
// 1 <= k <= 32.
extern "C" long long spgan_ebt_scratch(int pass, int B, int N, int C, int F2,
                                       int F, int k, int bf16) {
  if (bf16 && pass != kStats && ebt_tc_fits(pass, C, F2, F, k))
    return ebt_tc_scratch(pass, B, N, C, F2, F, k);
  Scratch sc;
  TilePlan tp;
  const int err = scratch_plan(pass, B, N, C, F2, F, k, &sc, &tp);
  return err ? -(long long)err : sc.total;
}

// Kernel I. ee [B, N, k, 2C] (bf16 when `bf16`, else f32); w1 [C, F2]; a1
// [2, F2]; w2 [F2, F]; out [2, F] f32: the sum and the sum of squares of
// h2 over the B * N * k edge rows. Returns the first nonzero cudaError_t.
extern "C" int spgan_ebt_stats2(const void* ee, const void* w1,
                                const void* a1, const void* w2, void* out,
                                void* scratch, int B, int N, int C, int F2,
                                int F, int k, float neg, int bf16,
                                void* stream) {
  Scratch sc;
  TilePlan tp;
  int err = scratch_plan(kStats, B, N, C, F2, F, k, &sc, &tp);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  Args a = base_args(ee, scr, sc, tp, B, N, C, F2, F, k, neg, bf16);
  a.a1 = static_cast<const float*>(a1);
  if ((err = launch_prep(w1, w2, nullptr, scr + sc.wr, C, F2, F, a.rb, s)))
    return err;
  if ((err = launch_tile(kStats, k, tp, a, s))) return err;
  return reduce_sums(a.part, tp.grid, 2 * F, 0, 2 * F,
                     static_cast<float*>(out), s);
}

// Kernel J. d_out [B, N, F] f32; a2, ax [2, F]; wx [2C, F]; gb2x [4, F]
// (gamma2, beta2, gammax, betax); wout [k, F, F]. Writes sums [4, F]
// (S2a, S2b, Sxa, Sxb), d_wout [k, F, F], d_bout [F] and d_u [B, N, k, F]
// = d_out @ wout[j]^T, the input of K and L.
extern "C" int spgan_ebt_bwd1(const void* ee, const void* dout,
                              const void* w1, const void* a1, const void* w2,
                              const void* a2, const void* wx, const void* ax,
                              const void* gb2x, const void* wout, void* sums,
                              void* dwout, void* dbout, void* du,
                              void* scratch, int B, int N, int C, int F2,
                              int F, int k, float neg, int bf16,
                              void* stream) {
  if (bf16 && ebt_tc_fits(kBwd1, C, F2, F, k))
    return ebt_tc_bwd1(
        ee, static_cast<const float*>(dout), static_cast<const float*>(w1),
        static_cast<const float*>(a1), static_cast<const float*>(w2),
        static_cast<const float*>(a2), static_cast<const float*>(wx),
        static_cast<const float*>(ax), static_cast<const float*>(gb2x),
        static_cast<const float*>(wout), static_cast<float*>(sums),
        static_cast<float*>(dwout), static_cast<float*>(dbout),
        static_cast<float*>(du), static_cast<float*>(scratch), B, N, C, F2,
        F, k, neg, static_cast<cudaStream_t>(stream));
  Scratch sc;
  TilePlan tp;
  int err = scratch_plan(kBwd1, B, N, C, F2, F, k, &sc, &tp);
  if (err) return err;
  int sms = 0;
  if ((err = sm_count(&sms))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const long long P = (long long)B * N;
  Args a = base_args(ee, scr, sc, tp, B, N, C, F2, F, k, neg, bf16);
  a.a1 = static_cast<const float*>(a1);
  a.a2 = static_cast<const float*>(a2);
  a.ax = static_cast<const float*>(ax);
  a.gb2x = static_cast<const float*>(gb2x);
  a.du = static_cast<const float*>(du);
  a.dout = static_cast<const float*>(dout);
  a.u = scr + sc.inter;
  if ((err = launch_prep(w1, w2, wx, scr + sc.wr, C, F2, F, a.rb, s)))
    return err;
  // d_u [P, k F] = d_out [P, F] @ wout.reshape(k F, F)^T, one slice
  const Gemm g{dout, 0, F, 1, static_cast<const float*>(wout), 1, F,
               static_cast<float*>(du), (int)P, k * F, F, F, a.rb};
  gemm_kernel<<<dim3((unsigned)((P + GM - 1) / GM), (k * F + GN - 1) / GN, 1),
                kThreads, 0, s>>>(g);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_tile(kBwd1, k, tp, a, s))) return err;
  if ((err = reduce_sums(a.part, tp.grid, 5 * F, 0, 4 * F,
                         static_cast<float*>(sums), s)))
    return err;
  if ((err = reduce_sums(a.part, tp.grid, 5 * F, 4 * F, F,
                         static_cast<float*>(dbout), s)))
    return err;
  // d_wout [k F, F] = u^T [k F, P] @ d_out [P, F]
  return weight_grad(a.u, 0, 1, (long long)k * F,
                     static_cast<const float*>(dout), F, 1,
                     static_cast<float*>(dwout), k * F, F, P, a.rb,
                     scr + sc.gemm, sms, s);
}

// Kernel K. d_u from J; s2 [4, F] the sums from J; gb1 [2, F2] (gamma1,
// beta1). Writes s1 [2, F2] (S1a, S1b) and d_w2 [F2, F].
extern "C" int spgan_ebt_bwd2(const void* ee, const void* du, const void* w1,
                              const void* a1, const void* w2, const void* a2,
                              const void* wx, const void* ax,
                              const void* gb2x, const void* s2,
                              const void* gb1, void* s1, void* dw2,
                              void* scratch, int B, int N, int C, int F2,
                              int F, int k, float neg, int bf16,
                              void* stream) {
  if (bf16 && ebt_tc_fits(kBwd2, C, F2, F, k))
    return ebt_tc_bwd2(
        ee, static_cast<const float*>(du), static_cast<const float*>(w1),
        static_cast<const float*>(a1), static_cast<const float*>(w2),
        static_cast<const float*>(a2), static_cast<const float*>(wx),
        static_cast<const float*>(ax), static_cast<const float*>(gb2x),
        static_cast<const float*>(s2), static_cast<const float*>(gb1),
        static_cast<float*>(s1), static_cast<float*>(dw2),
        static_cast<float*>(scratch), B, N, C, F2, F, k, neg,
        static_cast<cudaStream_t>(stream));
  Scratch sc;
  TilePlan tp;
  int err = scratch_plan(kBwd2, B, N, C, F2, F, k, &sc, &tp);
  if (err) return err;
  int sms = 0;
  if ((err = sm_count(&sms))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const long long M = (long long)B * N * k;
  Args a = base_args(ee, scr, sc, tp, B, N, C, F2, F, k, neg, bf16);
  a.a1 = static_cast<const float*>(a1);
  a.a2 = static_cast<const float*>(a2);
  a.ax = static_cast<const float*>(ax);
  a.gb2x = static_cast<const float*>(gb2x);
  a.gb1 = static_cast<const float*>(gb1);
  a.du = static_cast<const float*>(du);
  a.s2 = static_cast<const float*>(s2);
  a.y1s = scr + sc.inter;
  a.dh2s = a.y1s + M * F2;
  if ((err = launch_prep(w1, w2, wx, scr + sc.wr, C, F2, F, a.rb, s)))
    return err;
  if ((err = launch_tile(kBwd2, k, tp, a, s))) return err;
  if ((err = reduce_sums(a.part, tp.grid, 2 * F2, 0, 2 * F2,
                         static_cast<float*>(s1), s)))
    return err;
  // d_w2 [F2, F] = y1^T [F2, M] @ d_h2 [M, F]
  return weight_grad(a.y1s, 0, 1, F2, a.dh2s, F, 1, static_cast<float*>(dw2),
                     F2, F, M, a.rb, scr + sc.gemm, sms, s);
}

// Kernel L. s1 [2, F2] from K. Writes d_ee [B, N, k, 2C] (bf16 when
// `bf16`, else f32), d_w1 [C, F2] and d_wx [2C, F].
extern "C" int spgan_ebt_bwd3(const void* ee, const void* du, const void* w1,
                              const void* a1, const void* w2, const void* a2,
                              const void* wx, const void* ax,
                              const void* gb2x, const void* s2,
                              const void* gb1, const void* s1, void* dee,
                              void* dw1, void* dwx, void* scratch, int B,
                              int N, int C, int F2, int F, int k, float neg,
                              int bf16, void* stream) {
  if (bf16 && ebt_tc_fits(kBwd3, C, F2, F, k))
    return ebt_tc_bwd3(
        ee, static_cast<const float*>(du), static_cast<const float*>(w1),
        static_cast<const float*>(a1), static_cast<const float*>(w2),
        static_cast<const float*>(a2), static_cast<const float*>(wx),
        static_cast<const float*>(ax), static_cast<const float*>(gb2x),
        static_cast<const float*>(s2), static_cast<const float*>(gb1),
        static_cast<const float*>(s1), dee, static_cast<float*>(dw1),
        static_cast<float*>(dwx), static_cast<float*>(scratch), B, N, C, F2,
        F, k, neg, static_cast<cudaStream_t>(stream));
  Scratch sc;
  TilePlan tp;
  int err = scratch_plan(kBwd3, B, N, C, F2, F, k, &sc, &tp);
  if (err) return err;
  int sms = 0;
  if ((err = sm_count(&sms))) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* scr = static_cast<float*>(scratch);
  const long long M = (long long)B * N * k;
  Args a = base_args(ee, scr, sc, tp, B, N, C, F2, F, k, neg, bf16);
  a.a1 = static_cast<const float*>(a1);
  a.a2 = static_cast<const float*>(a2);
  a.ax = static_cast<const float*>(ax);
  a.gb2x = static_cast<const float*>(gb2x);
  a.gb1 = static_cast<const float*>(gb1);
  a.du = static_cast<const float*>(du);
  a.s2 = static_cast<const float*>(s2);
  a.s1 = static_cast<const float*>(s1);
  a.dee = dee;
  a.dh1s = scr + sc.inter;
  a.dhxs = a.dh1s + M * F2;
  if ((err = launch_prep(w1, w2, wx, scr + sc.wr, C, F2, F, a.rb, s)))
    return err;
  if ((err = launch_tile(kBwd3, k, tp, a, s))) return err;
  // d_w1 [C, F2] = diff^T [C, M] @ d_h1 [M, F2]; d_wx [2C, F] = ee^T @ d_hx
  const size_t es = bf16 ? 2 : 4;
  const char* diff = static_cast<const char*>(ee) + C * es;
  if ((err = weight_grad(diff, a.rb, 1, 2 * C, a.dh1s, F2, 1,
                         static_cast<float*>(dw1), C, F2, M, a.rb,
                         scr + sc.gemm, sms, s)))
    return err;
  return weight_grad(ee, a.rb, 1, 2 * C, a.dhxs, F, 1,
                     static_cast<float*>(dwx), 2 * C, F, M, a.rb,
                     scr + sc.gemm, sms, s);
}
