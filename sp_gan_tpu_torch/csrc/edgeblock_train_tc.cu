// Kernels J, K and L and kernel C in bf16 mode, on the H100's tensor cores:
// the three backward passes of the fused train-mode EdgeBlock and the
// EdgeBlock tail of its forward, for a bf16 ee [B, N, k, 2C].
//
// Replace, in the JAX kernels' bf16 mode (cd = bfloat16), the TPU kernels
//   J  backward pass 1 (sp_gan_tpu/ops/pallas/edgeblock_train.py,
//      _bwd_pass1_kernel, pallas_call :450): sums [4, F] (S2a, S2b, Sxa,
//      Sxb), d_wout [k, F, F], d_bout [F], and d_u [B, N, k, F] = d_out @
//      wout[j]^T (f32, the input of K and L);
//   K  backward pass 2 (_bwd_pass2_kernel, pallas_call :461): s1 [2, F2]
//      (S1a, S1b), d_w2 [F2, F];
//   L  backward pass 3 (_bwd_pass3_kernel, pallas_call :471): d_ee
//      [B, N, k, 2C] bf16, d_w1 [C, F2], d_wx [2C, F];
//   C  the EdgeBlock tail (sp_gan_tpu/ops/pallas/edgeblock.py::
//      edge_tail_pallas, pallas_call :102): out [B, N, F] f32 = bout +
//      v.reshape(k F) @ wout.reshape(k F, F), v = bf16(lrelu(px) * att).
// The arithmetic is that of edgeblock_train.cu and edgeblock.cu (their
// headers state the chain): every matmul of the chain takes bf16 operands,
// rounded at the same places, and sums in f32; the affines, leaky ReLU,
// softmax and BatchNorm backward are f32. Here each matmul is
// mma.sync.m16n8k16 (bf16 x bf16 -> f32), whose sum order differs from the
// plain version's and from the FMA kernels', and the BatchNorm x-hats and
// the softmax multiply by a reciprocal where those divide (an ulp apart; a
// thread's channel constants are taken once). C's contraction keeps wout
// f32, as the port's contract has it (bf16 v x f32 wout, f32 sums): wout
// is split into a bf16 pair hi + lo (hi = bf16(wout), lo = bf16(wout -
// hi), exact differences), two products into one f32 sum, which carries
// about 16 of wout's 24 significant bits (each term within 2^-17 of the
// f32 product).
//
// Design. An entry point launches, on the caller's stream and in order:
//  - (J) tc_round_kernel: wout and d_out rounded to bf16 into the scratch;
//    (C) tc_split_kernel: wout split into its bf16 pair;
//  - (J) tc_du_gemm_kernel: d_u = d_out @ wout^T [B*N, k*F] in 128 x 64
//    tiles, the whole depth F in shared memory, written f32;
//  - tc_tile_kernel<pass, KM>: one persistent block an SM (8 warps) walks
//    tiles of TP points (R = TP * k edge rows, padded to Rp, a multiple of
//    16); KM is k where k is 10, the default step's (the loops over a
//    point's k rows unroll exactly), else 32 with k checked at run time.
//    w1, w2, wx sit in shared memory as bf16 for the block's life, each
//    once: the forward products read them through ldmatrix.trans, the
//    transposed ones of K and L through ldmatrix. C and F2 are padded with
//    zeros to multiples of 16, which is exact. The next tile's ee rows load
//    by cp.async into the second ee buffer while the current tile
//    computes, and its d_u rows (J: and d_out rows) are prefetched into
//    L2. Each product runs on the tensor cores into an f32 staging tile;
//    the elementwise stages between products take one (point, channel)
//    pair a thread, so the k rows of a point meet without shuffles, and
//    write the next product's operand as bf16, rounded where the plain
//    version rounds:
//      h1 = diff @ w1 -> y1 = bf16(lrelu(p1)) (K: also to the scratch)
//      h2 = y1 @ w2, hx = ee @ wx -> softmax over k; J: u = bf16(v w), C:
//        its v, the same product, to the scratch; then (J, K, L) the top
//        of the backward from d_u: J the channel sums in registers; K
//        d_h2 (bf16, also to the scratch); L d_h2, d_hx (bf16; d_hx also
//        to the scratch)
//      (K, L) d_y1 = d_h2 @ w2^T -> d_p1; K the channel sums of d_p1 and
//        d_p1 x-hat1 in registers; L d_h1 (bf16, also to the scratch)
//      (L) d_full = d_hx @ wx^T, d_diff = d_h1 @ w1^T -> d_ee (bf16)
//  - tc_wg_gemm_kernel: the weight gradients d_wout = u^T d_out (J), d_w2
//    = y1^T d_h2 (K), d_w1 = diff^T d_h1 and d_wx = ee^T d_hx (L) from the
//    bf16 operands (exact: bf16 mode has rounded them already), split over
//    slices of the contraction rows, each slice's partial product written
//    by one block;
//  - tc_sum_kernel: J's and K's channel sums over their blocks, and each
//    weight gradient over its slices, in order;
//  - (C) tc_tail_gemm_kernel: out = bout + v [B*N, k F] @ (hi + lo) in
//    64-row tiles of the full width F = 128 (the width of EdgeConv2, the
//    one block whose tail runs in bf16 mode), three steps of 32 rows of the depth
//    in flight by cp.async. wout (k F x F, 320 KB as one bf16 copy at the
//    default widths) does not fit in shared memory beside the chain's
//    weights, so the contraction is a second pass over the bf16 v rather
//    than a stage of the tile pass.
// No float atomics: two launches on one card give bit-identical results.
// Widths whose weights and a tile of one point do not fit in a block's
// shared memory (ebt_tc_fits; at F = 128, F2 = 64, k = 10: J and L with C
// > 192, K with C > 208, C with C > 224), and C's tail at F = 64, stay on
// the FMA paths of edgeblock_train.cu and edgeblock.cu, so no width is
// refused that the FMA kernels take.
//
// Shared memory of tc_tile_kernel, in bytes, Cp = C and F2p = F2 rounded up to
// 16, rows padded by 8 bf16 or 8 f32 (ldmatrix and the staging stores free
// of bank conflicts): the weights w1 Cp (F2p + 8) 2, w2 F2p (F + 8) 2, wx
// 2Cp (F + 8) 2; two ee buffers Rp (2Cp + 8) 2 each; y1 (L: then d_h1) Rp
// (F2p + 8) 2; (K, L) d_h2 Rp (F + 8) 2; (L) d_hx Rp (F + 8) 2; (K, L) p1
// Rp (F2p + 8) 4; staging h2 (then d_y1, d_diff) Rp (W2 + 8) 4 and hx (then
// d_full) Rp (Wx + 8) 4, W2 = max(F, F2p, Cp) and Wx = max(F, 2Cp) for J
// and L, W2 = max(F, F2p) and Wx = F for K and C; (J, K) 256 x 5 f32 for
// the channel sums. TP is the most points whose layout fits (at most 160
// rows). At the default training step (C = 64, F2 = 64,
// F = 128, k = 10) the weights take 61,440 B; J takes TP = 8 (Rp = 80):
// ee 2 x 21,760, y1 11,520, staging 2 x 43,520, sums 5,120, 208,640 B in
// all; K takes TP = 6 (Rp = 64): ee 2 x 17,408, y1 9,216, d_h2 17,408, p1
// 18,432, staging 2 x 34,816, sums 5,120, 216,064 B; L takes TP = 6: as K
// with d_hx 17,408 and without the sums, 228,352 B; C takes TP = 9 (Rp =
// 96): ee 2 x 26,112, y1 13,824, staging 2 x 52,224, 231,936 B; of the
// 232,448 a block may have. tc_tail_gemm_kernel takes 3 x (64 x 40 + 2 x
// 32 x (F + 8)) bf16: 67,584 B at F = 128.
//
// What bounds it: at that step (ee [24, 2048, 10, 128] bf16, 491,520 edge
// rows) J's products are 60.4 GFLOP, K's 44.3, L's 76.5 and C's 44.3
// (0.045 to 0.077 ms at the bf16 tensor-core peak of 989 TFLOP/s); each
// input read and each output written once, the f32 d_u [24, 2048, 10,
// 128] that J writes and K and L read (252 MB) among them, J moves 0.40
// GB, K 0.38, L 0.50 and C 0.15 (0.045 to 0.150 ms at 3.35 TB/s): bytes.
// The kernels also move the bf16 operands of the weight gradients (u, y1,
// d_h2, d_h1, d_hx) and C's bf16 v (126 MB each way) through device
// memory, and C multiplies by wout twice (hi and lo).
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "edgeblock_train_tc.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kMaxRows = 160;  // edge rows a tile holds at most
constexpr int kAcc = 5;        // per-thread channel sums (J 5, K 2)
// the passes, as edgeblock_train.cu numbers them, and kernel C's tail
constexpr int kJ = 1, kK = 2, kL = 3, kC = kEbtTail;
constexpr int DU_M = 128, DU_N = 64;           // tc_du_gemm_kernel tile
constexpr int WG_M = 64, WG_N = 64, WG_K = 32, WG_THREADS = 128;
// tc_tail_gemm_kernel: TG_M rows of out a block at the full width TG_F (C
// runs on the tensor cores at F = 128 only), TG_K rows of the depth a step
constexpr int TG_M = 64, TG_F = 128, TG_K = 32, TG_STAGES = 3;

__device__ __forceinline__ float lrelu(float v, float neg) {
  return v >= 0.f ? v : neg * v;
}

__device__ __forceinline__ float dlrelu(float v, float neg) {
  return v >= 0.f ? 1.f : neg;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices; lanes 8i .. 8i + 7 give the row addresses of
// matrix i
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major fragment) b (16 x 8, column-major fragment)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// all but the N groups committed last are in
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the 128-byte lines of [p, p + bytes) into L2, by the block's threads
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const char* c = static_cast<const char*>(p);
  for (long long o = threadIdx.x * 128LL; o < bytes; o += kThreads * 128LL)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
}

// D [Mr, N] f32 (row stride ldd) = A [Mr, K] @ B on the tensor cores, all
// in shared memory: A bf16 row-major (stride lda); B bf16 [K, N] row-major
// (stride ldb), read through ldmatrix.trans, or with BNK given as B^T
// [N, K] row-major, read through ldmatrix. Mr, N, K multiples of 16; the
// blocks of 16 rows and 8 NT columns of D are dealt to the warps in turn,
// each summed over K in ascending order.
template <bool BNK, int NT>
__device__ __forceinline__ void tile_mm_n(const bf16* A, int lda,
                                          const bf16* B, int ldb, float* D,
                                          int ldd, int Mr, int N, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = N / (8 * NT), units = (Mr >> 4) * nb;
  for (int u = warp; u < units; u += kWarps) {
    const int m0 = (u / nb) << 4, n0 = (u % nb) * 8 * NT;
    const bf16* ap = A + (m0 + (lane & 15)) * lda + ((lane >> 4) << 3);
    const bf16* bp =
        BNK ? B + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ldb +
                  (((lane >> 3) & 1) << 3)
            : B + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ldb + n0 +
                  ((lane >> 4) << 3);
    float acc[NT][4];
#pragma unroll
    for (int h = 0; h < NT; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < K; k0 += 16) {
      uint32_t a[4];
      ldsm(a, ap + k0);
#pragma unroll
      for (int h = 0; h < NT / 2; ++h) {
        uint32_t b[4];
        if (BNK)
          ldsm(b, bp + h * 16 * ldb + k0);
        else
          ldsm_t(b, bp + k0 * ldb + h * 16);
        mma(acc[2 * h], a, b[0], b[1]);
        mma(acc[2 * h + 1], a, b[2], b[3]);
      }
    }
    const int g = lane >> 2, t2 = (lane & 3) << 1;
#pragma unroll
    for (int h = 0; h < NT; ++h) {
      float* d = D + (m0 + g) * ldd + n0 + h * 8 + t2;
      *reinterpret_cast<float2*>(d) = make_float2(acc[h][0], acc[h][1]);
      *reinterpret_cast<float2*>(d + 8 * ldd) =
          make_float2(acc[h][2], acc[h][3]);
    }
  }
}

// tile_mm_n in blocks of 16 x 32 where N allows, else 16 x 16
template <bool BNK>
__device__ __forceinline__ void tile_mm(const bf16* A, int lda, const bf16* B,
                                        int ldb, float* D, int ldd, int Mr,
                                        int N, int K) {
  if (N % 32 == 0)
    tile_mm_n<BNK, 4>(A, lda, B, ldb, D, ldd, Mr, N, K);
  else
    tile_mm_n<BNK, 2>(A, lda, B, ldb, D, ldd, Mr, N, K);
}

__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of tc_tile_kernel's shared memory (the header's budget)
struct Layout {
  int Cp, F2p, Rp;
  int w1, w2, wx, ee0, ee1, y1, dh, dhx, p1, h2, hx, red, total;
};

__host__ __device__ inline Layout layout(int pass, int C, int F2, int F,
                                         int k, int TP) {
  Layout L;
  L.Cp = up16(C);
  L.F2p = up16(F2);
  L.Rp = up16(TP * k);
  const int Cp = L.Cp, F2p = L.F2p, Rp = L.Rp;
  const bool bwd = pass == kK || pass == kL;  // d_y1 and BN1's backward
  // the staging widths: L's d_diff is Cp and its d_full 2Cp wide, and J
  // takes L's widths so that the two take the tensor cores at the same C;
  // K and C stage only F- and F2-wide products
  const bool wide = pass == kJ || pass == kL;
  const int w2s = wide ? imax(F, imax(F2p, Cp)) : imax(F, F2p);
  const int wxs = wide ? imax(F, 2 * Cp) : F;
  int o = 0;
  L.w1 = o;
  o += Cp * (F2p + 8) * 2;
  L.w2 = o;
  o += F2p * (F + 8) * 2;
  L.wx = o;
  o += 2 * Cp * (F + 8) * 2;
  L.ee0 = o;
  o += Rp * (2 * Cp + 8) * 2;
  L.ee1 = o;
  o += Rp * (2 * Cp + 8) * 2;
  L.y1 = o;
  o += Rp * (F2p + 8) * 2;
  L.dh = o;
  if (bwd) o += Rp * (F + 8) * 2;
  L.dhx = o;
  if (pass == kL) o += Rp * (F + 8) * 2;
  L.p1 = o;
  if (bwd) o += Rp * (F2p + 8) * 4;
  L.h2 = o;
  o += Rp * (w2s + 8) * 4;
  L.hx = o;
  o += Rp * (wxs + 8) * 4;
  L.red = o;
  if (pass == kJ || pass == kK) o += kThreads * kAcc * 4;
  L.total = o;
  return L;
}

struct Args {
  const bf16* ee;                           // [M, 2C]
  const float *w1, *w2, *wx;                // f32 weights
  const float *a1, *a2, *ax, *gb2x, *gb1;   // affines, BN gammas and betas
  const float* du;                          // [P, k, F] (J, K, L)
  const float* dout;                        // J: [P, F]
  const float *s2, *s1;                     // K, L: J's sums [4, F]; L: K's
                                            // [2, F2]
  bf16* u;                                  // J: bf16(v w) [M, F]; C: v
  bf16 *y1, *dh2;                           // K: [M, F2], [M, F]
  bf16 *dh1, *dhx;                          // L: [M, F2], [M, F]
  bf16* dee;                                // L: d_ee [M, 2C]
  float* part;                              // J: [gridDim.x][5 F]; K:
                                            // [gridDim.x][2 F2]
  long long P;                              // points, B * N
  int C, F2, F, k, TP;
  float neg, m;                             // m: edge rows B * N * k
  Layout L;
};

// cp.async of the edge rows of `tile` into E: the centre half to columns
// [0, C), the diff half to [Cp, Cp + C); the padding stays zero
__device__ __forceinline__ void load_ee(const Args& a, bf16* E,
                                        long long tile) {
  const int C = a.C, C2 = 2 * C, Cp = a.L.Cp, lee = 2 * Cp + 8;
  const long long p0 = tile * a.TP;
  const int np = a.P - p0 < a.TP ? (int)(a.P - p0) : a.TP;
  const int rows = np * a.k;
  const bf16* src = a.ee + p0 * a.k * C2;
  if (C % 8 == 0) {
    const int per = C2 / 8;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * 8;
      cp_async16(E + r * lee + (c < C ? c : Cp + c - C), src + r * C2 + c);
    }
  } else {
    const int per = C2 / 4;
    for (int i = threadIdx.x; i < rows * per; i += kThreads) {
      const int r = i / per, c = (i - r * per) * 4;
      cp_async8(E + r * lee + (c < C ? c : Cp + c - C), src + r * C2 + c);
    }
  }
  cp_async_commit();
}

// the d_u rows (J: and the d_out rows) of `tile` into L2; C has none
__device__ __forceinline__ void prefetch_tile(const Args& a, int pass,
                                              long long tile) {
  if (pass == kC) return;
  const long long p0 = tile * a.TP;
  const int np = a.P - p0 < a.TP ? (int)(a.P - p0) : a.TP;
  prefetch_l2(a.du + p0 * a.k * a.F, 4LL * np * a.k * a.F);
  if (pass == kJ) prefetch_l2(a.dout + p0 * a.F, 4LL * np * a.F);
}

template <int PASS, int KM>
__global__ void __launch_bounds__(kThreads, 1) tc_tile_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const Layout L = a.L;
  // KM is k itself where k is 10, else a bound of it
  const int k = KM == 10 ? KM : a.k;
  const int C = a.C, C2 = 2 * C, F2 = a.F2, F = a.F, TP = a.TP;
  const int Cp = L.Cp, F2p = L.F2p;
  const int lee = 2 * Cp + 8, lw1 = F2p + 8, lwf = F + 8;  // bf16 strides
  const int tid = threadIdx.x;
  const float neg = a.neg, m = a.m;
  bf16* W1 = reinterpret_cast<bf16*>(sm + L.w1);
  bf16* W2 = reinterpret_cast<bf16*>(sm + L.w2);
  bf16* WX = reinterpret_cast<bf16*>(sm + L.wx);
  bf16* EE0 = reinterpret_cast<bf16*>(sm + L.ee0);  // two ee buffers
  bf16* EE1 = reinterpret_cast<bf16*>(sm + L.ee1);
  bf16* Y1 = reinterpret_cast<bf16*>(sm + L.y1);    // y1, then (L) d_h1
  bf16* DH = reinterpret_cast<bf16*>(sm + L.dh);
  bf16* DHX = reinterpret_cast<bf16*>(sm + L.dhx);
  float* P1 = reinterpret_cast<float*>(sm + L.p1);
  // h1 (J, C), h2, d_y1, d_diff
  float* H2 = reinterpret_cast<float*>(sm + L.h2);
  float* HX = reinterpret_cast<float*>(sm + L.hx);  // hx, d_full
  constexpr bool BWD = PASS == kK || PASS == kL;    // d_y1, BN1's backward
  float* H1 = BWD ? P1 : H2;

  // zeros everywhere, so padding rows and columns read as 0; then the
  // weights, rounded to bf16
  for (int i = tid; i < L.total / 16; i += kThreads)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  for (int i = tid; i < C * F2; i += kThreads) {
    const int r = i / F2, c = i - r * F2;
    W1[r * lw1 + c] = __float2bfloat16_rn(a.w1[i]);
  }
  for (int i = tid; i < F2 * F; i += kThreads) {
    const int r = i / F, c = i - r * F;
    W2[r * lwf + c] = __float2bfloat16_rn(a.w2[i]);
  }
  for (int i = tid; i < C2 * F; i += kThreads) {
    const int r = i / F, c = i - r * F;
    WX[(r < C ? r : Cp + r - C) * lwf + c] = __float2bfloat16_rn(a.wx[i]);
  }

  // a thread keeps one channel cf of the F-wide stage and one channel c1
  // of the F2-wide stages (F and F2 divide kThreads), and their constants
  const int cf = tid % F, c1 = tid % F2;
  const float s2 = a.a2[cf], sh2 = a.a2[F + cf];
  const float sx = a.ax[cf], shx = a.ax[F + cf];
  float ig2 = 0.f, b2 = 0.f, igx = 0.f, bx = 0.f;  // (J, K, L)
  if (PASS != kC) {
    ig2 = 1.f / a.gb2x[cf];
    b2 = a.gb2x[F + cf];
    igx = 1.f / a.gb2x[2 * F + cf];
    bx = a.gb2x[3 * F + cf];
  }
  const float s1 = a.a1[c1], sh1 = a.a1[F2 + c1];
  float S2a = 0.f, S2b = 0.f, Sxa = 0.f, Sxb = 0.f;  // (K, L) sums / m
  float ig1 = 0.f, b1 = 0.f, S1a = 0.f, S1b = 0.f;
  if (BWD) {
    S2a = a.s2[cf] / m;
    S2b = a.s2[F + cf] / m;
    ig1 = 1.f / a.gb1[c1];
    b1 = a.gb1[F2 + c1];
  }
  if (PASS == kL) {
    Sxa = a.s2[2 * F + cf] / m;
    Sxb = a.s2[3 * F + cf] / m;
    S1a = a.s1[c1] / m;
    S1b = a.s1[F2 + c1] / m;
  }

  const long long tiles = (a.P + TP - 1) / TP;
  float acc[kAcc] = {0.f, 0.f, 0.f, 0.f, 0.f};
  long long tile = blockIdx.x;
  if (tile < tiles) {
    load_ee(a, EE0, tile);
    prefetch_tile(a, PASS, tile);
  }
  for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const long long p0 = tile * TP, r0 = p0 * k;
    const int np = a.P - p0 < TP ? (int)(a.P - p0) : TP;
    const int R = np * k, Mr = up16(R);
    cp_async_wait_all();
    __syncthreads();  // this tile's ee rows are in; the last tile is done
    if (tile + gridDim.x < tiles) {
      load_ee(a, buf ? EE0 : EE1, tile + gridDim.x);
      prefetch_tile(a, PASS, tile + gridDim.x);
    }
    const bf16* E = buf ? EE1 : EE0;

    // h1 = diff @ w1; p1 and y1 = bf16(lrelu(p1)), the operand of @ w2
    tile_mm<false>(E + Cp, lee, W1, lw1, H1, F2p + 8, Mr, F2p, Cp);
    __syncthreads();
    for (int row = tid / F2; row < R; row += kThreads / F2) {
      float* h = H1 + row * (F2p + 8) + c1;
      const float p = *h * s1 + sh1;
      if (BWD) *h = p;
      const bf16 y = __float2bfloat16_rn(lrelu(p, neg));
      Y1[row * lw1 + c1] = y;
      if (PASS == kK) a.y1[(r0 + row) * F2 + c1] = y;
    }
    __syncthreads();
    // h2 = y1 @ w2, hx = ee @ wx
    tile_mm<false>(Y1, lw1, W2, lwf, H2, F + 8, Mr, F, F2p);
    tile_mm<false>(E, lee, WX, lwf, HX, F + 8, Mr, F, 2 * Cp);
    __syncthreads();

    // the F-wide chain, one channel of one point per thread
    for (int pp = tid / F; pp < np; pp += kThreads / F) {
      const int c = cf;
      const long long row0 = r0 + pp * k;
      float h2[KM], hx[KM];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          const int o = (pp * k + j) * (F + 8) + c;
          h2[j] = H2[o] * s2 + sh2;  // p2
          hx[j] = HX[o] * sx + shx;  // px
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
      const float isum = 1.f / sum;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) w[j] = w[j] * isum;
      if (PASS == kJ || PASS == kC) {
#pragma unroll
        for (int j = 0; j < KM; ++j)
          if (j < k)
            a.u[(row0 + j) * F + c] =
                __float2bfloat16_rn(lrelu(hx[j], neg) * w[j]);
      }
      if (PASS == kJ) acc[4] += a.dout[(p0 + pp) * F + c];
      if (PASS == kC) continue;
      // softmax backward over k
      const float* du = a.du + row0 * F + c;
      float sw = 0.f;
#pragma unroll
      for (int j = 0; j < KM; ++j)
        if (j < k) sw += w[j] * (du[j * F] * lrelu(hx[j], neg));
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        if (j < k) {
          const float d = du[j * F];
          const float dp2 =
              w[j] * (d * lrelu(hx[j], neg) - sw) * dlrelu(h2[j], neg);
          const float dpx = d * w[j] * dlrelu(hx[j], neg);
          const float xh2 = (h2[j] - b2) * ig2;
          const float xhx = (hx[j] - bx) * igx;
          if (PASS == kJ) {
            acc[0] += dp2;
            acc[1] += dp2 * xh2;
            acc[2] += dpx;
            acc[3] += dpx * xhx;
          } else if (PASS == kK) {
            const int row = pp * k + j;
            const bf16 dh2 =
                __float2bfloat16_rn(s2 * (dp2 - S2a - xh2 * S2b));
            DH[row * lwf + c] = dh2;
            a.dh2[(row0 + j) * F + c] = dh2;
          } else {
            const int row = pp * k + j;
            DH[row * lwf + c] =
                __float2bfloat16_rn(s2 * (dp2 - S2a - xh2 * S2b));
            const bf16 dhx =
                __float2bfloat16_rn(sx * (dpx - Sxa - xhx * Sxb));
            DHX[row * lwf + c] = dhx;
            a.dhx[(row0 + j) * F + c] = dhx;
          }
        }
      }
    }
    if (PASS == kJ || PASS == kC) continue;
    __syncthreads();

    // d_y1 = d_h2 @ w2^T; d_p1 = d_y1 lrelu'(p1); K: the sums of d_p1 and
    // d_p1 x-hat1; L: d_h1 (bf16) over y1
    tile_mm<true>(DH, lwf, W2, lwf, H2, F2p + 8, Mr, F2p, F);
    __syncthreads();
    for (int row = tid / F2; row < R; row += kThreads / F2) {
      const float p = P1[row * (F2p + 8) + c1];
      const float dp1 = H2[row * (F2p + 8) + c1] * dlrelu(p, neg);
      const float xh1 = (p - b1) * ig1;
      if (PASS == kK) {
        acc[0] += dp1;
        acc[1] += dp1 * xh1;
        continue;
      }
      const bf16 dh1 = __float2bfloat16_rn(s1 * (dp1 - S1a - xh1 * S1b));
      Y1[row * lw1 + c1] = dh1;
      a.dh1[(r0 + row) * F2 + c1] = dh1;
    }
    if (PASS == kK) continue;
    __syncthreads();

    // d_ee = [d_full][:C] ++ ([d_full][C:] + d_diff), d_full = d_hx @ wx^T
    // (columns as wx's rows in shared memory), d_diff = d_h1 @ w1^T
    tile_mm<true>(DHX, lwf, WX, lwf, HX, 2 * Cp + 8, Mr, 2 * Cp, F);
    tile_mm<true>(Y1, lw1, W1, lw1, H2, Cp + 8, Mr, Cp, F2p);
    __syncthreads();
    for (int t = tid; t < R * C; t += kThreads) {  // two columns a thread
      const int row = t / C, c = (t - row * C) * 2;
      const float* df = HX + row * (2 * Cp + 8) + (c < C ? c : Cp + c - C);
      float2 v = make_float2(df[0], df[1]);
      if (c >= C) {
        v.x += H2[row * (Cp + 8) + c - C];
        v.y += H2[row * (Cp + 8) + c - C + 1];
      }
      *reinterpret_cast<__nv_bfloat162*>(a.dee + (r0 + row) * C2 + c) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  }

  // J, K: the block's channel sums (J 5 over F channels, K 2 over F2),
  // threads of one channel added in index order
  if (PASS == kJ || PASS == kK) {
    constexpr int nacc = PASS == kJ ? kAcc : 2;
    const int width = PASS == kJ ? F : F2;
    float* RED = reinterpret_cast<float*>(sm + L.red);
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

// out [P, KF] f32 = A [P, F] @ Bw^T, A and Bw [KF, F] bf16 row-major:
// 128 x 64 tiles of out, the whole depth F in shared memory, 8 warps of
// 32 x 32
__global__ void __launch_bounds__(kThreads)
    tc_du_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bw,
                   float* __restrict__ out, long long P, int KF, int F) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int ld = F + 8, tid = threadIdx.x;
  bf16* As = reinterpret_cast<bf16*>(sm);
  bf16* Bs = As + DU_M * ld;
  const long long m0 = (long long)blockIdx.x * DU_M;
  const int n0 = blockIdx.y * DU_N, per = F / 8;
  for (int i = tid; i < DU_M * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * 8;
    if (m0 + r < P) cp_async16(As + r * ld + c, A + (m0 + r) * F + c);
  }
  for (int i = tid; i < DU_N * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * 8;
    cp_async16(Bs + r * ld + c, Bw + (long long)(n0 + r) * F + c);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  for (int k0 = 0; k0 < F; k0 += 16) {
    uint32_t a[2][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm(a[i], As + (wm + i * 16 + (lane & 15)) * ld + k0 +
                     ((lane >> 4) << 3));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldsm(b[j], Bs + (wn + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld +
                     k0 + (((lane >> 3) & 1) << 3));
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma(acc[i][2 * j], a[i], b[j][0], b[j][1]);
        mma(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
      }
  }
  const int g = lane >> 2, t2 = (lane & 3) << 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + i * 16 + g + 8 * h;
      if (row >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float2*>(out + row * KF + n0 + wn + j * 8 + t2) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
}

// out[s] [Ma, Nb] = sum over the rows r of slice s of A[r, m] B[r, n]; A
// and B bf16 with row strides lda and ldb (the contraction index is the
// row), read through ldmatrix.trans. 64 x 64 tiles, 4 warps of 32 x 32,
// 32 rows a step, the next step's rows loaded into registers while the
// current one is multiplied. Ma, Nb, lda, ldb multiples of 4, A and B
// 8-byte aligned. PASS only names the launch in a profile.
template <int PASS>
__global__ void __launch_bounds__(WG_THREADS)
    tc_wg_gemm_kernel(const bf16* __restrict__ A, long long lda,
                   const bf16* __restrict__ B, long long ldb,
                   float* __restrict__ out, int Ma, int Nb, long long K,
                   long long kslice) {
  __shared__ __align__(16) bf16 As[WG_K][WG_M + 8];
  __shared__ __align__(16) bf16 Bs[WG_K][WG_N + 8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * WG_M, n0 = blockIdx.y * WG_N;
  const long long kb = (long long)blockIdx.z * kslice;
  const long long ke = kb + kslice < K ? kb + kslice : K;
  constexpr int kChunks = WG_K * WG_M / 4 / WG_THREADS;  // 4 bf16 each
  uint2 ra[kChunks], rb[kChunks];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int e = tid + q * WG_THREADS, r = e >> 4, c = (e & 15) << 2;
      const long long gk = k0 + r;
      ra[q] = rb[q] = make_uint2(0u, 0u);
      if (gk < ke && m0 + c < Ma)
        ra[q] = *reinterpret_cast<const uint2*>(A + gk * lda + m0 + c);
      if (gk < ke && n0 + c < Nb)
        rb[q] = *reinterpret_cast<const uint2*>(B + gk * ldb + n0 + c);
    }
  };
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  if (kb < ke) fetch(kb);
  for (long long k0 = kb; k0 < ke; k0 += WG_K) {
    __syncthreads();  // the last step's reads are done
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const int e = tid + q * WG_THREADS, r = e >> 4, c = (e & 15) << 2;
      *reinterpret_cast<uint2*>(&As[r][c]) = ra[q];
      *reinterpret_cast<uint2*>(&Bs[r][c]) = rb[q];
    }
    __syncthreads();
    if (k0 + WG_K < ke) fetch(k0 + WG_K);
#pragma unroll
    for (int kk = 0; kk < WG_K; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_t(a[i], &As[kk + (lane & 7) + ((lane >> 4) << 3)]
                        [wm + i * 16 + (((lane >> 3) & 1) << 3)]);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_t(b[j], &Bs[kk + (lane & 7) + (((lane >> 3) & 1) << 3)]
                        [wn + j * 16 + ((lane >> 4) << 3)]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma(acc[i][2 * j], a[i], b[j][0], b[j][1]);
          mma(acc[i][2 * j + 1], a[i], b[j][2], b[j][3]);
        }
    }
  }
  float* o = out + (long long)blockIdx.z * Ma * Nb;
  const int g = lane >> 2, t2 = (lane & 3) << 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + i * 16 + g + 8 * h;
      if (row >= Ma) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + wn + j * 8 + t2;
        if (col < Nb)
          *reinterpret_cast<float2*>(o + (long long)row * Nb + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
    }
}

// out[i] = sum over s < S, in order, of part[s * stride + offset + i];
// eight loads in flight. PASS only names the launch in a profile.
template <int PASS>
__global__ void tc_sum_kernel(const float* __restrict__ part, int S,
                           long long stride, long long offset, long long n,
                           float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int q = 0; q < S; ++q) s += part[q * stride + offset + i];
    out[i] = s;
  }
}

// bf16 copies of a [na] and b [nb] (multiples of 4, 16-byte aligned)
__global__ void tc_round_kernel(const float* __restrict__ a, bf16* ab,
                             long long na, const float* __restrict__ b,
                             bf16* bb, long long nb) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (na + nb) / 4; i += (long long)gridDim.x * blockDim.x) {
    const bool first = i < na / 4;
    const long long j = first ? i : i - na / 4;
    const float4 v = reinterpret_cast<const float4*>(first ? a : b)[j];
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(first ? ab : bb)[j] = w;
  }
}

// w [n] f32 as the bf16 pair hi = bf16(w), lo = bf16(w - hi) (w - hi is
// exact in f32), so that hi + lo is w to about 16 significant bits
__global__ void tc_split_kernel(const float* __restrict__ w, bf16* hi,
                                bf16* lo, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const float x = w[i];
    const bf16 h = __float2bfloat16_rn(x);
    hi[i] = h;
    lo[i] = __float2bfloat16_rn(x - __bfloat162float(h));
  }
}

// Dynamic shared memory of tc_tail_gemm_kernel: TG_STAGES steps of an A
// tile [TG_M][TG_K + 8] and the two B tiles [TG_K][TG_F + 8], bf16
constexpr int kTailSmem =
    TG_STAGES * (TG_M * (TG_K + 8) + 2 * TG_K * (TG_F + 8)) * 2;

// out [P, F] f32 = bout + A [P, KF] @ (Bh + Bl) [KF, F], F = TG_F; A, Bh
// and Bl bf16 row-major, KF a multiple of TG_K. A block takes TG_M rows of
// out at the full width F, 8 warps of 32 x F / 4; the depth goes TG_K rows
// a step,
// TG_STAGES steps in flight by cp.async. Each 16 rows of a step multiply A
// by Bh, then by Bl, into one f32 sum per output, in ascending order of the
// depth; bout is added last, as the plain version adds it.
__global__ void __launch_bounds__(kThreads)
    tc_tail_gemm_kernel(const bf16* __restrict__ A,
                        const bf16* __restrict__ Bh,
                        const bf16* __restrict__ Bl,
                        const float* __restrict__ bout,
                        float* __restrict__ out, long long P, int KF) {
  constexpr int F = TG_F, LA = TG_K + 8, LB = F + 8;
  constexpr int SA = TG_M * LA, SB = TG_K * LB;  // bf16 of an A, a B tile
  constexpr int NT = F / 32;                     // n8 tiles of a warp
  constexpr int CA = TG_K / 8, CB = F / 8;       // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char sm[];
  bf16* As = reinterpret_cast<bf16*>(sm);        // [stage][TG_M][LA]
  bf16* Bs = As + TG_STAGES * SA;                // [stage][hi, lo][TG_K][LB]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * TG_M;
  const int steps = KF / TG_K;
  // the rows of A past P stay as they are: they feed only rows of out that
  // are not written
  auto load = [&](int step) {
    if (step < steps) {
      const int st = step % TG_STAGES, k0 = step * TG_K;
      for (int i = tid; i < TG_M * CA; i += kThreads) {
        const int r = i / CA, c = (i - r * CA) * 8;
        if (m0 + r < P)
          cp_async16(As + st * SA + r * LA + c, A + (m0 + r) * KF + k0 + c);
      }
      for (int i = tid; i < 2 * TG_K * CB; i += kThreads) {
        const int h = i / (TG_K * CB), e = i - h * TG_K * CB;
        const int r = e / CB, c = (e - r * CB) * 8;
        cp_async16(Bs + (st * 2 + h) * SB + r * LB + c,
                   (h ? Bl : Bh) + (long long)(k0 + r) * F + c);
      }
    }
    cp_async_commit();  // an empty group past the last step
  };
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * (F / 4);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
  load(0);
  load(1);
  for (int step = 0; step < steps; ++step) {
    load(step + 2);  // into the stage the last step's reads have left
    cp_async_wait<2>();
    __syncthreads();  // this step's tiles are in
    const bf16* as = As + (step % TG_STAGES) * SA;
    const bf16* bs = Bs + (step % TG_STAGES) * 2 * SB;
#pragma unroll
    for (int kk = 0; kk < TG_K; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm(af[i], as + (wm + i * 16 + (lane & 15)) * LA + kk +
                        ((lane >> 4) << 3));
#pragma unroll
      for (int h = 0; h < 2; ++h)  // hi, then lo
#pragma unroll
        for (int n = 0; n < NT / 2; ++n) {
          uint32_t b[4];
          ldsm_t(b, bs + h * SB +
                        (kk + (lane & 7) + (((lane >> 3) & 1) << 3)) * LB +
                        wn + n * 16 + ((lane >> 4) << 3));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            mma(acc[i][2 * n], af[i], b[0], b[1]);
            mma(acc[i][2 * n + 1], af[i], b[2], b[3]);
          }
        }
    }
    __syncthreads();  // the step's reads are done before its stage refills
  }
  const int g = lane >> 2, t2 = (lane & 3) << 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = m0 + wm + i * 16 + g + 8 * h;
      if (row >= P) continue;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = wn + n * 8 + t2;
        *reinterpret_cast<float2*>(out + row * F + col) =
            make_float2(acc[i][n][2 * h] + bout[col],
                        acc[i][n][2 * h + 1] + bout[col + 1]);
      }
    }
}

template <int PASS, int KM>
void* tile_fn() {
  return reinterpret_cast<void*>(tc_tile_kernel<PASS, KM>);
}

template <int PASS>
void* tile_fn_k(int k) {
  return k == 10 ? tile_fn<PASS, 10>() : tile_fn<PASS, 32>();
}

void* tile_kernel_of(int pass, int k) {
  switch (pass) {
    case kJ: return tile_fn_k<kJ>(k);
    case kK: return tile_fn_k<kK>(k);
    case kL: return tile_fn_k<kL>(k);
    default: return tile_fn_k<kC>(k);
  }
}

// What a call asks of the runtime, asked once: per device its SM count and
// a block's shared-memory limit; per (device, kernel) the dynamic shared
// memory allowed so far, raised and never lowered, so that a launch of
// another thread keeps its allowance; per (device, kernel, bytes) the
// blocks an SM holds.
std::mutex g_mu;
std::map<int, std::pair<int, int>> g_attrs;
std::map<std::pair<int, const void*>, int> g_allowed;
std::map<std::tuple<int, const void*, int>, int> g_per_sm;

int device_attrs(int* sms, int* smem_limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(g_mu);
  auto it = g_attrs.find(dev);
  if (it == g_attrs.end()) {
    int n = 0, limit = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    it = g_attrs.emplace(dev, std::make_pair(n, limit)).first;
  }
  *sms = it->second.first;
  *smem_limit = it->second.second;
  return 0;
}

// Lets `fn` take `bytes` of dynamic shared memory on the current device
// and, where `per_sm` is given, counts the blocks of kThreads an SM holds
// at that size.
int allow_smem(const void* fn, int bytes, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(g_mu);
  int& allowed = g_allowed[std::make_pair(dev, fn)];
  if (bytes > allowed) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = bytes;
  }
  if (!per_sm) return 0;
  const auto key = std::make_tuple(dev, fn, bytes);
  auto it = g_per_sm.find(key);
  if (it == g_per_sm.end()) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads,
                                                        bytes);
    if (err != cudaSuccess) return (int)err;
    it = g_per_sm.emplace(key, n).first;
  }
  *per_sm = it->second;
  return 0;
}

// Split of a weight gradient's K contraction rows: about two blocks an SM
// in all, slices a multiple of WG_K rows
struct Split {
  int S;
  long long kslice;
};

Split split(int Ma, int Nb, long long K, int sms) {
  const long long tiles =
      (long long)((Ma + WG_M - 1) / WG_M) * ((Nb + WG_N - 1) / WG_N);
  long long S = (2LL * sms + tiles - 1) / tiles;
  const long long most = (K + WG_K - 1) / WG_K;
  if (S > most) S = most;
  if (S < 1) S = 1;
  long long ks = (K + S - 1) / S;
  ks = (ks + WG_K - 1) / WG_K * WG_K;
  return {(int)((K + ks - 1) / ks), ks};
}

long long al4(long long floats) { return (floats + 3) / 4 * 4; }

// The tile size (the most points whose layout fits, at most kMaxRows edge
// rows), grid (the blocks that fit on the card at once, at most one a
// tile) and scratch (in floats) of a pass: J: part
// | slices | wout bf16 | d_out bf16 | u bf16; K: part | slices | y1 bf16 |
// d_h2 bf16; L: slices | d_h1 bf16 | d_hx bf16; C: v bf16 | wout hi bf16 |
// wout lo bf16.
struct Plan {
  int TP, grid, sms;
  Layout L;
  Split s1, s2;  // J: d_wout; K: d_w2; L: d_w1, d_wx
  long long part, slices, wout_b, wlo_b, dout_b, u_b, y1_b, dh2_b, dh1_b,
      dhx_b, total;
};

int plan(int pass, int B, int N, int C, int F2, int F, int k, Plan* p) {
  if (!ebt_widths_ok(B, N, C, F2, F, k) || pass < kJ || pass > kC ||
      (pass == kC && F != TG_F))
    return (int)cudaErrorInvalidValue;
  int limit = 0, per_sm = 0;
  int err = device_attrs(&p->sms, &limit);
  if (err) return err;
  const long long P = (long long)B * N, M = P * k;
  int TP = kMaxRows / k > 1 ? kMaxRows / k : 1;
  while (TP > 1 && layout(pass, C, F2, F, k, TP).total > limit) --TP;
  if (layout(pass, C, F2, F, k, TP).total > limit)
    return (int)cudaErrorInvalidValue;
  p->TP = TP;
  p->L = layout(pass, C, F2, F, k, TP);
  if ((err = allow_smem(tile_kernel_of(pass, k), p->L.total, &per_sm)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (P + TP - 1) / TP;
  const long long most = (long long)p->sms * per_sm;
  p->grid = (int)(tiles < most ? tiles : most);
  long long o = 0;
  if (pass == kJ) {
    p->s1 = split(k * F, F, P, p->sms);
    p->part = o;
    o += al4((long long)p->grid * kAcc * F);
    p->slices = o;
    o += al4((long long)p->s1.S * k * F * F);
    p->wout_b = o;
    o += al4((long long)k * F * F / 2);
    p->dout_b = o;
    o += al4(P * F / 2);
    p->u_b = o;
    o += al4(M * F / 2);
  } else if (pass == kK) {
    p->s1 = split(F2, F, M, p->sms);
    p->part = o;
    o += al4((long long)p->grid * 2 * F2);
    p->slices = o;
    o += al4((long long)p->s1.S * F2 * F);
    p->y1_b = o;
    o += al4(M * F2 / 2);
    p->dh2_b = o;
    o += al4(M * F / 2);
  } else if (pass == kC) {
    p->u_b = o;
    o += al4(M * F / 2);
    p->wout_b = o;
    o += al4((long long)k * F * F / 2);
    p->wlo_b = o;
    o += al4((long long)k * F * F / 2);
  } else {
    p->s1 = split(C, F2, M, p->sms);
    p->s2 = split(2 * C, F, M, p->sms);
    const long long a = (long long)p->s1.S * C * F2;
    const long long b = (long long)p->s2.S * 2 * C * F;
    p->slices = o;
    o += al4(a > b ? a : b);
    p->dh1_b = o;
    o += al4(M * F2 / 2);
    p->dhx_b = o;
    o += al4(M * F / 2);
  }
  p->total = o;
  return 0;
}

int launch_tile(int pass, int k, const Plan& p, const Args& a,
                cudaStream_t s) {
  void* params[] = {const_cast<Args*>(&a)};
  return (int)cudaLaunchKernel(tile_kernel_of(pass, k), dim3(p.grid),
                               dim3(kThreads), params, p.L.total, s);
}

template <int PASS>
int sum_slices(const float* part, int S, long long stride, long long offset,
        long long n, float* out, cudaStream_t s) {
  tc_sum_kernel<PASS><<<(int)((n + 255) / 256), 256, 0, s>>>(part, S, stride,
                                                         offset, n, out);
  return (int)cudaGetLastError();
}

// a weight gradient out [Ma, Nb] = A^T B over K rows, by slices
template <int PASS>
int weight_grad(const bf16* A, long long lda, const bf16* B, long long ldb,
                float* out, int Ma, int Nb, long long K, const Split& sp,
                float* slices, cudaStream_t s) {
  const dim3 grid((Ma + WG_M - 1) / WG_M, (Nb + WG_N - 1) / WG_N, sp.S);
  tc_wg_gemm_kernel<PASS><<<grid, WG_THREADS, 0, s>>>(A, lda, B, ldb, slices,
                                                    Ma, Nb, K, sp.kslice);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)Ma * Nb;
  return sum_slices<PASS>(slices, sp.S, n, 0, n, out, s);
}

Args base_args(const void* ee, const float* w1, const float* a1,
               const float* w2, const float* a2, const float* wx,
               const float* ax, const float* gb2x, const float* du,
               const Plan& p, int B, int N, int C, int F2, int F, int k,
               float neg) {
  Args a{};
  a.ee = static_cast<const bf16*>(ee);
  a.w1 = w1;
  a.w2 = w2;
  a.wx = wx;
  a.a1 = a1;
  a.a2 = a2;
  a.ax = ax;
  a.gb2x = gb2x;
  a.du = du;
  a.P = (long long)B * N;
  a.C = C;
  a.F2 = F2;
  a.F = F;
  a.k = k;
  a.TP = p.TP;
  a.neg = neg;
  a.m = (float)((long long)B * N * k);
  a.L = p.L;
  return a;
}

}  // namespace

bool ebt_tc_fits(int pass, int C, int F2, int F, int k) {
  int sms = 0, limit = 0;
  return ebt_widths_ok(1, 1, C, F2, F, k) && (pass != kC || F == TG_F) &&
         device_attrs(&sms, &limit) == 0 &&
         layout(pass, C, F2, F, k, 1).total <= limit;
}

long long ebt_tc_scratch(int pass, int B, int N, int C, int F2, int F,
                         int k) {
  Plan p;
  const int err = plan(pass, B, N, C, F2, F, k, &p);
  return err ? -(long long)err : p.total;
}

int ebt_tc_bwd1(const void* ee, const float* dout, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* wout, float* sums, float* dwout, float* dbout,
                float* du, float* scratch, int B, int N, int C, int F2, int F,
                int k, float neg, cudaStream_t s) {
  Plan p;
  int err = plan(kJ, B, N, C, F2, F, k, &p);
  if (err) return err;
  const long long P = (long long)B * N, KF = (long long)k * F;
  bf16* wout_b = reinterpret_cast<bf16*>(scratch + p.wout_b);
  bf16* dout_b = reinterpret_cast<bf16*>(scratch + p.dout_b);
  Args a = base_args(ee, w1, a1, w2, a2, wx, ax, gb2x, du, p, B, N, C, F2, F,
                     k, neg);
  a.dout = dout;
  a.u = reinterpret_cast<bf16*>(scratch + p.u_b);
  a.part = scratch + p.part;
  tc_round_kernel<<<2 * p.sms, 256, 0, s>>>(wout, wout_b, KF * F, dout, dout_b,
                                         P * F);
  if ((err = (int)cudaGetLastError())) return err;
  // d_u [P, k F] = bf16(d_out) @ bf16(wout.reshape(k F, F))^T
  const int du_smem = (DU_M + DU_N) * (F + 8) * 2;
  if ((err = allow_smem(reinterpret_cast<const void*>(tc_du_gemm_kernel),
                        du_smem, nullptr)))
    return err;
  tc_du_gemm_kernel<<<dim3((unsigned)((P + DU_M - 1) / DU_M),
                        (unsigned)(KF / DU_N)),
                   kThreads, du_smem, s>>>(dout_b, wout_b, du, P, (int)KF, F);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_tile(kJ, k, p, a, s))) return err;
  if ((err = sum_slices<kJ>(a.part, p.grid, kAcc * F, 0, 4 * F, sums, s)))
    return err;
  if ((err = sum_slices<kJ>(a.part, p.grid, kAcc * F, 4 * F, F, dbout, s)))
    return err;
  // d_wout [k F, F] = u^T [k F, P] @ bf16(d_out) [P, F]
  return weight_grad<kJ>(a.u, KF, dout_b, F, dwout, (int)KF, F, P, p.s1,
                         scratch + p.slices, s);
}

int ebt_tc_bwd2(const void* ee, const float* du, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* s2, const float* gb1, float* s1, float* dw2,
                float* scratch, int B, int N, int C, int F2, int F, int k,
                float neg, cudaStream_t s) {
  Plan p;
  int err = plan(kK, B, N, C, F2, F, k, &p);
  if (err) return err;
  const long long M = (long long)B * N * k;
  Args a = base_args(ee, w1, a1, w2, a2, wx, ax, gb2x, du, p, B, N, C, F2, F,
                     k, neg);
  a.gb1 = gb1;
  a.s2 = s2;
  a.y1 = reinterpret_cast<bf16*>(scratch + p.y1_b);
  a.dh2 = reinterpret_cast<bf16*>(scratch + p.dh2_b);
  a.part = scratch + p.part;
  if ((err = launch_tile(kK, k, p, a, s))) return err;
  if ((err = sum_slices<kK>(a.part, p.grid, 2 * F2, 0, 2 * F2, s1, s)))
    return err;
  // d_w2 [F2, F] = y1^T [F2, M] @ d_h2 [M, F]
  return weight_grad<kK>(a.y1, F2, a.dh2, F, dw2, F2, F, M, p.s1,
                         scratch + p.slices, s);
}

int ebt_tc_bwd3(const void* ee, const float* du, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* s2, const float* gb1, const float* s1, void* dee,
                float* dw1, float* dwx, float* scratch, int B, int N, int C,
                int F2, int F, int k, float neg, cudaStream_t s) {
  Plan p;
  int err = plan(kL, B, N, C, F2, F, k, &p);
  if (err) return err;
  const long long M = (long long)B * N * k;
  Args a = base_args(ee, w1, a1, w2, a2, wx, ax, gb2x, du, p, B, N, C, F2, F,
                     k, neg);
  a.gb1 = gb1;
  a.s2 = s2;
  a.s1 = s1;
  a.dh1 = reinterpret_cast<bf16*>(scratch + p.dh1_b);
  a.dhx = reinterpret_cast<bf16*>(scratch + p.dhx_b);
  a.dee = static_cast<bf16*>(dee);
  if ((err = launch_tile(kL, k, p, a, s))) return err;
  // d_w1 [C, F2] = diff^T [C, M] @ d_h1 [M, F2]; d_wx [2C, F] = ee^T @ d_hx
  if ((err = weight_grad<kL>(a.ee + C, 2 * C, a.dh1, F2, dw1, C, F2, M, p.s1,
                             scratch + p.slices, s)))
    return err;
  return weight_grad<kL>(a.ee, 2 * C, a.dhx, F, dwx, 2 * C, F, M, p.s2,
                         scratch + p.slices, s);
}

int ebt_tc_tail(const void* ee, const float* w1, const float* a1,
                const float* w2, const float* a2, const float* wx,
                const float* ax, const float* wout, const float* bout,
                float* out, float* scratch, int B, int N, int C, int F2,
                int F, int k, float neg, cudaStream_t s) {
  Plan p;
  int err = plan(kC, B, N, C, F2, F, k, &p);
  if (err) return err;
  const long long P = (long long)B * N, KF = (long long)k * F;
  bf16* hi = reinterpret_cast<bf16*>(scratch + p.wout_b);
  bf16* lo = reinterpret_cast<bf16*>(scratch + p.wlo_b);
  Args a = base_args(ee, w1, a1, w2, a2, wx, ax, nullptr, nullptr, p, B, N, C,
                     F2, F, k, neg);
  a.u = reinterpret_cast<bf16*>(scratch + p.u_b);
  tc_split_kernel<<<p.sms, 256, 0, s>>>(wout, hi, lo, KF * F);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_tile(kC, k, p, a, s))) return err;
  // out [P, F] = bout + v [P, k F] @ (hi + lo) [k F, F]
  if ((err = allow_smem(reinterpret_cast<const void*>(tc_tail_gemm_kernel),
                        kTailSmem, nullptr)))
    return err;
  tc_tail_gemm_kernel<<<(unsigned)((P + TG_M - 1) / TG_M), kThreads,
                        kTailSmem, s>>>(a.u, hi, lo, bout, out, P, (int)KF);
  return (int)cudaGetLastError();
}
