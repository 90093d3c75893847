// Kernel C in f32 mode on the H100's tensor cores: the EdgeBlock tail of
// the serving path, ee [B, N, k, 2C] f32 -> out [B, N, F] f32, every
// product split into three TF32 products.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/edgeblock.py::
// edge_tail_pallas (_edge_tail_kernel, pallas_call :102) in f32, the
// function edgeblock.cu's header states:
//   h   = lrelu(lrelu(diff @ w1 * a1[0] + a1[1]) @ w2 * a2[0] + a2[1])
//   v   = lrelu(ee @ wx * ax[0] + ax[1]) * softmax_k(h)
//   out = bout + v.reshape(k F) @ wout.reshape(k F, F)
//
// Precision. One TF32 product keeps about 11 of an operand's 24
// significant bits, too few for the f32 gate the port holds kernel C to
// (|err| <= 1e-5 + 1e-4 |plain|). Each product here is three: x = hi + lo
// with hi = tf32(x) and lo = tf32(x - hi) (x - hi is exact in f32; tf32
// rounds to nearest, ties away, as cvt.rna.tf32.f32), and
// a b = ah bh + ah bl + al bh, summed in f32 by mma.sync m16n8k8
// (CUTLASS's 3xTF32). The dropped al bl and the rounding of lo are each
// within 2^-22 of |a b|. The tensor cores' f32 sums may truncate rather
// than round, so no sum takes many of them: in the chain the large
// products ah bh go to one f32 sum and the small ones to another (one
// tensor-core addition per 8 of the depth for the large ones), added at
// the end; the contraction over k F sums 32 of the depth at a time from
// zero and adds those sums in f32. The affines, leaky ReLU and softmax are
// f32 (exp, and the softmax's reciprocal of its sum). No float atomics:
// two launches on one card give bit-identical results.
//
// Design. spgan_edge_tail launches, on the caller's stream and in order:
//  - tf_transpose_kernel: wout [k F, F] transposed to [F, k F], the
//    layout ldmatrix reads a B fragment from;
//  - tf_tile_kernel<KM>: one persistent block an SM (16 warps) walks tiles
//    of TP points (R = TP k edge rows, padded to Rp, a multiple of 16: at
//    most as many 16-row blocks as give each warp two in the widest
//    product, 64 rows at F = 128, 128 at F = 64). w1, w2 and wx sit in
//    shared memory in f32 for the block's life, each transposed
//    ([out][in], rows padded by 4 floats so that ldmatrix reads them
//    without bank conflicts); their pre-split pairs would take twice that
//    and do not fit at EdgeConv2's widths, so each B fragment is split as
//    it is loaded, once for all the row blocks its warp takes. A tile's ee
//    rows are read and split into their pair (EH, EL) as they are stored,
//    the centre half to columns [0, C), the diff half to [Cp, Cp + C) with
//    Cp = C rounded up to 8 (the padding is zero, which is exact); the
//    next tile's rows are prefetched into L2 meanwhile. Each product runs
//    on the tensor cores, a warp taking 16 output columns and its share of
//    the row blocks:
//      h1 = diff @ w1, and from its fragments y1 = lrelu(p1) as its pair
//        (YH, YL)
//      h2 = y1 @ w2 -> S over y1 (after a barrier); att =
//        softmax_k(lrelu(p2)) in place, one (point, channel) pair a
//        thread, so the k rows meet without shuffles (up to k = 32 its k
//        values in registers, past it in three passes over S's column:
//        64 values beside the rest would pass the 128 registers a thread
//        of a 512-thread block may have)
//      hx = ee @ wx, and from its fragments v = lrelu(px) att -> the f32
//        scratch v [B N k, F]
//  - tf_tail_gemm_kernel<F>: out = bout + v [B N, k F] @ wout in 128-row
//    tiles of the full width F, 16 warps of 32 x F / 4, TK rows of the
//    depth a step, TSTAGES steps in flight by cp.async, both operands split
//    as loaded. wout in f32 (655 KB at F = 128, k = 10) does not fit in
//    shared memory beside the chain's weights, so the contraction is a
//    second pass over v, as in the FMA design.
// Widths whose weights and a tile of one point do not fit (ebt_tf_fits:
// at F = 128, F2 = 64, C > 120 at k = 10, C > 64 at k = 64), and F2 = 256,
// stay on the FMA kernels of edgeblock.cu, which take them; none is
// refused that those take.
//
// Shared memory of tf_tile_kernel, in bytes, Cp = C rounded up to 8 and
// F2p = F2 rounded up to 16: the weights w1^T F2p (Cp + 4) 4, w2^T F
// (F2p + 4) 4, wx^T F (2Cp + 4) 4; the tile's ee pair 2 Rp (2Cp + 4) 4;
// S Rp max(F + 8, 2 (F2p + 4)) 4 (y1's pair, then h2 and att). At
// EdgeConv2's widths (C = 64, F2 = 64, F = 128, k = 10) the weights take
// 119,808 B and a tile of TP = 6 points (60 rows, Rp = 64) 102,400 B: ee's
// pair 67,584, S 34,816; 222,208 B of the 232,448 a block may have. Past
// k = 32 a tile holds one point there: at k = 40, 40 rows in Rp = 48
// (196,608 B), at k = 64, 64 rows (222,208 B, as at k = 10). At
// EdgeConv1's (C = 3, F2 = 32, F = 64) a tile holds 12 points (Rp = 128),
// 3 at k = 40 and 2 at k = 64.
// tf_tail_gemm_kernel takes TSTAGES (TM + F) (TK + 4) 4 B: 147,456 at F =
// 128.
//
// What bounds it. At EdgeConv2's serving call (ee [64, 2048, 10, 128],
// F2 = 64, F = 128; 1,310,720 edge rows) the function is 118 GFLOP; the
// port's three TF32 products make it 354, 0.72 ms at the TF32 tensor-core
// peak of 495 TFLOP/s (1.76 ms at the 67 TFLOP/s f32 rate of the FMA
// design). Its bytes: ee read once (0.67 GB), v written and read (0.67 GB
// each way) and out written, 0.62 ms at 3.35 TB/s. Operations, then; at
// k = 40 both four times as large (ee 2.7 GB, 1416 GFLOP of products).
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "edgeblock_tf32.cuh"

namespace {

// threads of a block of tf_tile_kernel and tf_tail_gemm_kernel: 16 warps
constexpr int kTile = 512, kWarps = kTile / 32;
// the 16-row blocks of a tile a warp takes at most in mm3
constexpr int kMaxBlocks = 2;
// tf_tail_gemm_kernel: TM rows of out a block, TK rows of the depth a step
constexpr int TM = 128, TK = 32, TSTAGES = 4, LT = TK + 4;
// its warps as TM / 32 row groups of 32 rows by TCG column groups
constexpr int TCG = kWarps / (TM / 32);

__device__ __forceinline__ float lrelu(float v, float neg) {
  return v >= 0.f ? v : neg * v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 4 f32 matrices (8 x 8 b16 as ldmatrix sees them) from the
// shared-memory address each lane gives; lanes 8i .. 8i + 7 give the row
// addresses of matrix i, and lane l receives element l % 4 of row l / 4
// of each
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// the f32 bit pattern b rounded to tf32 (10 stored mantissa bits), to
// nearest with ties away from zero, as cvt.rna.tf32.f32 rounds: half an
// ulp added to the magnitude, the low 13 bits cleared (two integer
// instructions; the conversion instruction itself runs on a slower pipe)
__device__ __forceinline__ uint32_t to_tf32(uint32_t b) {
  return (b + 0x1000u) & 0xffffe000u;
}

// v = hi + (v - hi), hi = tf32(v); lo = tf32(v - hi)
__device__ __forceinline__ void split(uint32_t v, uint32_t& hi,
                                      uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(__float_as_uint(
      __fsub_rn(__uint_as_float(v), __uint_as_float(hi))));
}

// d += a (16 x 8, row-major fragment) b (8 x 8, column-major fragment)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the N groups committed last are in
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ inline int up8(int x) { return (x + 7) / 8 * 8; }
__host__ __device__ inline int up16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// The edge rows a tile holds at most: as many 16-row blocks as the 16
// warps take, kMaxBlocks each, in the widest product (mm3: 16 / (N / 16)
// warps share 16 columns), 64 at F = 128, 128 at F = 64 with F2 <= 64.
__host__ __device__ inline int max_rows(int F, int F2) {
  return kMaxBlocks * 16 * kWarps * 16 / imax(F, up16(F2));
}

// tf_tile_kernel's shared memory (the header's budget): row strides and
// float offsets of each part, and its size in bytes. Strides of the
// ldmatrix operands are 4 more than a multiple of 8 floats, so that the 8
// rows of a matrix fall in 8 different 16-byte bank groups; S's is 8 more
// than a multiple of 32, so that a warp's float2 stores of an accumulator
// fragment hit every bank once.
struct Layout {
  int Cp, F2p, Rp, lee, lw1, lw2, lwx, ly1, ls;
  int w1, w2, wx, eh, el, s, bytes;
};

__host__ __device__ inline Layout layout(int C, int F2, int F, int k,
                                         int TP) {
  Layout L;
  L.Cp = up8(C);
  L.F2p = up16(F2);
  L.Rp = up16(TP * k);
  L.lee = 2 * L.Cp + 4;
  L.lw1 = L.Cp + 4;
  L.lw2 = L.F2p + 4;
  L.lwx = 2 * L.Cp + 4;
  L.ly1 = L.F2p + 4;
  L.ls = imax(F, L.F2p) + 8;
  int o = 0;
  L.w1 = o;
  o += L.F2p * L.lw1;
  L.w2 = o;
  o += F * L.lw2;
  L.wx = o;
  o += F * L.lwx;
  L.eh = o;  // ee's tf32 pair
  o += L.Rp * L.lee;
  L.el = o;
  o += L.Rp * L.lee;
  L.s = o;  // y1's tf32 pair, then h2 and att over it
  o += L.Rp * imax(L.ls, 2 * L.ly1);
  L.bytes = 4 * o;
  return L;
}

struct Args {
  const float* ee;                           // [P k, 2C]
  const float *w1, *a1, *w2, *a2, *wx, *ax;  // the chain, f32
  float* v;                                  // [P k, F]
  long long P;                               // points, B * N
  int C, F2, F, k, TP;
  float neg;
  Layout L;
};

// One warp's share of mm3: MBW 16-row blocks (A's lane addresses ah, al,
// astep bytes apart) by the two 8-column blocks at B's lane address b,
// the depth K in steps of 8. The products al bh and ah bl go to one f32
// sum and ah bh to another, added at the end: the cores' sums may
// truncate rather than round, and a sum of the large products alone takes
// one tensor-core addition per 8 of the depth, not three.
template <int MBW>
__device__ __forceinline__ void mm3_warp(uint32_t ah, uint32_t al,
                                         uint32_t astep, uint32_t b, int K,
                                         float (&d)[kMaxBlocks][2][4]) {
  float big[MBW][2][4], small[MBW][2][4];
#pragma unroll
  for (int i = 0; i < MBW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) big[i][n][q] = small[i][n][q] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < K; kk += 8) {
    const uint32_t ko = kk * 4;
    uint32_t bh[4], bl[4], xh[MBW][4], xl[MBW][4];
    ldsm(bh, b + ko);
#pragma unroll
    for (int i = 0; i < MBW; ++i) {
      ldsm(xh[i], ah + i * astep + ko);
      ldsm(xl[i], al + i * astep + ko);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split(bh[q], bh[q], bl[q]);
#pragma unroll
    for (int i = 0; i < MBW; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        mma(small[i][n], xl[i], bh[2 * n], bh[2 * n + 1]);
        mma(small[i][n], xh[i], bl[2 * n], bl[2 * n + 1]);
        mma(big[i][n], xh[i], bh[2 * n], bh[2 * n + 1]);
      }
  }
#pragma unroll
  for (int i = 0; i < MBW; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) d[i][n][q] = big[i][n][q] + small[i][n][q];
}

// D [Mr, N] = A [Mr, K] @ B from shared memory: A as its tf32 pair AH, AL
// (row-major, stride lda), B f32 given as B^T [N, K] (row stride ldb); Mr,
// N multiples of 16, N <= 128, K a multiple of 8. A warp takes 16 columns
// (two 8-column blocks) and the 16-row blocks mstart, mstart + mg, ... of
// them, where mg = 16 / (N / 16) warps share the columns; each B fragment
// is split once for all its row blocks, A comes split. With SYNC the
// block meets at a barrier before the first result is taken, so that epi
// may overwrite A. epi(row, col, d[col], d[col + 1]) takes the result,
// two columns at a time.
template <bool SYNC, class Epi>
__device__ __forceinline__ void mm3(const float* AH, const float* AL, int lda,
                                    const float* BT, int ldb, int Mr, int N,
                                    int K, Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pairs = N >> 4, mb = Mr >> 4, mg = kWarps / pairs;
  const int mstart = warp / pairs, n0 = (warp % pairs) << 4;
  const int mbw = mb > mstart ? (mb - mstart + mg - 1) / mg : 0;
  // the row and column (in floats) this lane addresses for ldmatrix: A's
  // matrices are rows 0-7 / 8-15 by depth 0-3 / 4-7, B^T's the two column
  // blocks by depth 0-3 / 4-7
  const int ar = (lane & 7) + (((lane >> 3) & 1) << 3), ac = (lane >> 4) << 2;
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = ((lane >> 3) & 1) << 2;
  const int ao = ((mstart << 4) + ar) * lda + ac;
  const uint32_t ah = smem_addr(AH + ao), al = smem_addr(AL + ao);
  const uint32_t astep = (mg << 4) * lda * 4;
  const uint32_t b = smem_addr(BT + (n0 + br) * ldb + bc);
  float d[kMaxBlocks][2][4];
  if (mbw >= 2)
    mm3_warp<2>(ah, al, astep, b, K, d);
  else if (mbw == 1)
    mm3_warp<1>(ah, al, astep, b, K, d);
  if (SYNC) __syncthreads();  // every warp's reads of A are done
  const int g = lane >> 2, t2 = (lane & 3) << 1;
#pragma unroll
  for (int i = 0; i < kMaxBlocks; ++i) {
    if (i < mbw) {
      const int row = ((mstart + i * mg) << 4) + g;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = n0 + (n << 3) + t2;
        epi(row, col, d[i][n][0], d[i][n][1]);
        epi(row + 8, col, d[i][n][2], d[i][n][3]);
      }
    }
  }
}

// f(r, c) for every r < rows and c < per, dealt to the block's threads in
// row-major order (one division a thread)
template <class Fn>
__device__ __forceinline__ void for_each(int rows, int per, Fn f) {
  const int dr = kTile / per, dc = kTile - dr * per;
  int r = threadIdx.x / per, c = threadIdx.x - r * per;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
}

// the column of E that column c (< 2C) of an edge row goes to: the centre
// half to [0, C), the diff half to [Cp, Cp + C)
__device__ __forceinline__ int ee_col(int c, int C, int Cp) {
  return c < C ? c : Cp + c - C;
}

// The `rows` edge rows from src into E as their tf32 pair: each value x
// to EH as tf32(x) and to EL as tf32(x - tf32(x)); the padding stays zero
__device__ __forceinline__ void load_split(const float* src, float* EH,
                                           float* EL, int rows, int C, int Cp,
                                           int lee) {
  const int C2 = 2 * C;
  if (C % 4 == 0) {
    for_each(rows, C2 / 4, [&](int r, int c) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(src + r * C2) + c);
      uint4 h, l;
      split(x.x, h.x, l.x);
      split(x.y, h.y, l.y);
      split(x.z, h.z, l.z);
      split(x.w, h.w, l.w);
      const int o = r * lee + ee_col(4 * c, C, Cp);
      *reinterpret_cast<uint4*>(EH + o) = h;
      *reinterpret_cast<uint4*>(EL + o) = l;
    });
  } else {
    for_each(rows, C2, [&](int r, int c) {
      uint32_t h, l;
      split(__float_as_uint(__ldg(src + r * C2 + c)), h, l);
      const int o = r * lee + ee_col(c, C, Cp);
      EH[o] = __uint_as_float(h);
      EL[o] = __uint_as_float(l);
    });
  }
}

// the 128-byte lines of [p, p + bytes) into L2, by the block's threads
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  const char* c = static_cast<const char*>(p);
  for (long long o = threadIdx.x * 128LL; o < bytes; o += kTile * 128LL)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + o));
}

// KM is k itself where k is 10, else a bound of it (32 or 64)
template <int KM>
__global__ void __launch_bounds__(kTile, 1) tf_tile_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const Layout L = a.L;
  const int k = KM == 10 ? KM : a.k;
  const int C = a.C, C2 = 2 * C, F2 = a.F2, F = a.F, TP = a.TP;
  const int Cp = L.Cp, F2p = L.F2p, lee = L.lee, ly1 = L.ly1, ls = L.ls;
  const int tid = threadIdx.x;
  const float neg = a.neg;
  float* W1 = sm + L.w1;  // w1^T [F2p][lw1]
  float* W2 = sm + L.w2;  // w2^T [F][lw2]
  float* WX = sm + L.wx;  // wx^T [F][lwx], input columns as EH's
  float* EH = sm + L.eh;  // this tile's ee rows as their tf32 pair
  float* EL = sm + L.el;
  float* YH = sm + L.s;   // y1 as its tf32 pair
  float* YL = YH + L.Rp * ly1;
  float* S = sm + L.s;    // h2, then att in place, over y1

  // zeros everywhere, so padding rows and columns read as 0; then the
  // weights, transposed
  for (int i = tid; i < L.bytes / 16; i += kTile)
    reinterpret_cast<float4*>(sm)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  for (int i = tid; i < C * F2; i += kTile) {
    const int r = i / F2, c = i - r * F2;
    W1[c * L.lw1 + r] = a.w1[i];
  }
  for (int i = tid; i < F2 * F; i += kTile) {
    const int r = i / F, c = i - r * F;
    W2[c * L.lw2 + r] = a.w2[i];
  }
  for (int i = tid; i < C2 * F; i += kTile) {
    const int r = i / F, c = i - r * F;
    WX[c * L.lwx + ee_col(r, C, Cp)] = a.wx[i];
  }

  // a thread keeps one channel cf of the softmax stage (F divides kTile)
  // and its a2 constants
  const int cf = tid % F;
  const float s2 = a.a2[cf], sh2 = a.a2[F + cf];
  // the a1 constants of the columns its h1 fragments hold (a warp takes
  // one pair of 8-column blocks of the F2p columns; those past F2 get 0,
  // so y1 is 0 there); c1 + {0, 1, 8, 9}
  const int lane = tid & 31;
  const int c1 = (((tid >> 5) % (F2p >> 4)) << 4) + ((lane & 3) << 1);
  float s1[4], sh1[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = c1 + (q & 1) + ((q >> 1) << 3);
    s1[q] = c < F2 ? a.a1[c] : 0.f;
    sh1[q] = c < F2 ? a.a1[F2 + c] : 0.f;
  }
  // and the ax constants of the columns its hx fragments hold (a warp
  // takes one pair of 8-column blocks, mm3): cx + {0, 1, 8, 9}
  const int cx = (((tid >> 5) % (F >> 4)) << 4) + ((lane & 3) << 1);
  const float sx0 = a.ax[cx], sx1 = a.ax[cx + 1];
  const float sx8 = a.ax[cx + 8], sx9 = a.ax[cx + 9];
  const float shx0 = a.ax[F + cx], shx1 = a.ax[F + cx + 1];
  const float shx8 = a.ax[F + cx + 8], shx9 = a.ax[F + cx + 9];

  const long long tiles = (a.P + TP - 1) / TP;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long p0 = tile * TP, r0 = p0 * k;
    const int np = a.P - p0 < TP ? (int)(a.P - p0) : TP;
    const int R = np * k, Mr = up16(R);
    __syncthreads();  // the last tile's reads of EH, EL and S are done
    // this tile's ee rows into EH and EL as their tf32 pair, the next
    // tile's into L2
    if (tile + gridDim.x < tiles) {
      const long long q0 = (tile + gridDim.x) * TP;
      const long long nq = a.P - q0 < TP ? a.P - q0 : TP;
      prefetch_l2(a.ee + q0 * k * C2, 4LL * nq * k * C2);
    }
    load_split(a.ee + r0 * C2, EH, EL, R, C, Cp, lee);
    __syncthreads();

    // h1 = diff @ w1; y1 = lrelu(p1) as its tf32 pair into YH, YL
    mm3<false>(EH + Cp, EL + Cp, lee, W1, L.lw1, Mr, F2p, Cp,
               [&](int row, int col, float x, float y) {
                 const bool up = col & 8;  // the second block of the pair
                 const float px = x * (up ? s1[2] : s1[0]) +
                                  (up ? sh1[2] : sh1[0]);
                 const float py = y * (up ? s1[3] : s1[1]) +
                                  (up ? sh1[3] : sh1[1]);
                 uint2 h, l;
                 split(__float_as_uint(lrelu(px, neg)), h.x, l.x);
                 split(__float_as_uint(lrelu(py, neg)), h.y, l.y);
                 *reinterpret_cast<uint2*>(YH + row * ly1 + col) = h;
                 *reinterpret_cast<uint2*>(YL + row * ly1 + col) = l;
               });
    __syncthreads();
    // h2 = y1 @ w2 -> S, over y1 once every warp has read it; att =
    // softmax over k of lrelu(p2) in place
    mm3<true>(YH, YL, ly1, W2, L.lw2, Mr, F, F2p,
              [&](int row, int col, float x, float y) {
                *reinterpret_cast<float2*>(S + row * ls + col) =
                    make_float2(x, y);
              });
    __syncthreads();
    for (int pp = tid / F; pp < np; pp += kTile / F) {
      float* s = S + pp * k * ls + cf;
      if constexpr (KM <= 32) {
        float h[KM];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) {
            h[j] = lrelu(s[j * ls] * s2 + sh2, neg);
            mx = fmaxf(mx, h[j]);
          }
        }
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KM; ++j) {
          if (j < k) {
            h[j] = expf(h[j] - mx);
            sum += h[j];
          }
        }
        const float isum = 1.f / sum;
#pragma unroll
        for (int j = 0; j < KM; ++j)
          if (j < k) s[j * ls] = h[j] * isum;
      } else {
        // past 32 rows the k values would not stay in registers under the
        // block's cap of 128 a thread: three passes over the column of S
        // instead (the same operations in the same order), the exponents
        // stored in place between the second and the third
        float mx = -INFINITY;
        for (int j = 0; j < k; ++j)
          mx = fmaxf(mx, lrelu(s[j * ls] * s2 + sh2, neg));
        float sum = 0.f;
        for (int j = 0; j < k; ++j) {
          const float e = expf(lrelu(s[j * ls] * s2 + sh2, neg) - mx);
          s[j * ls] = e;
          sum += e;
        }
        const float isum = 1.f / sum;
        for (int j = 0; j < k; ++j) s[j * ls] *= isum;
      }
    }
    __syncthreads();
    // hx = ee @ wx; v = lrelu(px) att, from the fragments to the scratch
    float* v = a.v + r0 * F;
    mm3<false>(EH, EL, lee, WX, L.lwx, Mr, F, 2 * Cp,
        [&](int row, int col, float x, float y) {
          if (row < R) {
            const float2 w = *reinterpret_cast<const float2*>(
                S + row * ls + col);
            const bool up = col & 8;  // the second block of the pair
            const float px = x * (up ? sx8 : sx0) + (up ? shx8 : shx0);
            const float py = y * (up ? sx9 : sx1) + (up ? shx9 : shx1);
            *reinterpret_cast<float2*>(v + (long long)row * F + col) =
                make_float2(lrelu(px, neg) * w.x, lrelu(py, neg) * w.y);
          }
        });
  }
}

// wt [F, KF] = w [KF, F] transposed
__global__ void tf_transpose_kernel(const float* __restrict__ w,
                                    float* __restrict__ wt, int KF, int F) {
  const long long n = (long long)KF * F;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / F), c = (int)(i - (long long)r * F);
    wt[(long long)c * KF + r] = w[i];
  }
}

// Dynamic shared memory of tf_tail_gemm_kernel<F>: TSTAGES steps of an A
// tile [TM][LT] and a B^T tile [F][LT], f32
constexpr int tail_smem(int F) { return TSTAGES * (TM + F) * LT * 4; }

// out [P, F] f32 = bout + A [P, KF] @ B [KF, F], B given as B^T [F, KF],
// both f32 row-major, KF a multiple of TK. A block takes TM rows of out at
// the full width F, 16 warps of 32 x F / 4; the depth goes TK rows a step,
// TSTAGES steps in flight by cp.async. Both operands are split as loaded
// from shared memory; each step sums its depth on the tensor cores from
// zero (al bh, then ah bl, then ah bh at each 8 of the depth, each over
// all the warp's outputs), and the steps' sums are added in f32 in
// ascending order of the depth; bout is added last, as the plain version
// adds it.
template <int F>
__global__ void __launch_bounds__(kTile, 1)
    tf_tail_gemm_kernel(const float* __restrict__ A,
                        const float* __restrict__ Bt,
                        const float* __restrict__ bout,
                        float* __restrict__ out, long long P, int KF) {
  constexpr int SA = TM * LT, SB = F * LT;  // floats of an A, a B tile
  constexpr int NT = F / TCG / 8;           // 8-column blocks of a warp
  constexpr int CH = TK / 4;                // 16-byte chunks of a row
  extern __shared__ __align__(16) float smf[];
  float* As = smf;                    // [stage][TM][LT]
  float* Bs = As + TSTAGES * SA;      // [stage][F][LT]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * TM;
  const int steps = KF / TK;
  // the rows of A past P stay as they are: they feed only rows of out that
  // are not written
  auto load = [&](int step) {
    if (step < steps) {
      const int st = step % TSTAGES, k0 = step * TK;
      for (int i = tid; i < TM * CH; i += kTile) {
        const int r = i / CH, c = (i - r * CH) * 4;
        if (m0 + r < P)
          cp_async16(As + st * SA + r * LT + c, A + (m0 + r) * KF + k0 + c);
      }
      for (int i = tid; i < F * CH; i += kTile) {
        const int r = i / CH, c = (i - r * CH) * 4;
        cp_async16(Bs + st * SB + r * LT + c, Bt + (long long)r * KF + k0 + c);
      }
    }
    cp_async_commit();  // an empty group past the last step
  };
  const int wm = (warp / TCG) * 32, wn = (warp % TCG) * (F / TCG);
  const int ar = (lane & 7) + (((lane >> 3) & 1) << 3), ac = (lane >> 4) << 2;
  const int br = (lane & 7) + ((lane >> 4) << 3), bc = ((lane >> 3) & 1) << 2;
  // the lane's ldmatrix addresses in stage 0: A's two row blocks, B's
  // column-block pairs
  const uint32_t a0 = smem_addr(As + (wm + ar) * LT + ac);
  const uint32_t b0 = smem_addr(Bs + (wn + br) * LT + bc);
  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][n][q] = 0.f;
  for (int st = 0; st < TSTAGES - 1; ++st) load(st);
  for (int step = 0; step < steps; ++step) {
    // into the stage the last step's reads have left
    load(step + TSTAGES - 1);
    cp_async_wait<TSTAGES - 1>();
    __syncthreads();  // this step's tiles are in
    const uint32_t as = a0 + (step % TSTAGES) * SA * 4;
    const uint32_t bs = b0 + (step % TSTAGES) * SB * 4;
    float part[2][NT][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) part[i][n][q] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[NT / 2][4], bl[NT / 2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) ldsm(ah[i], as + (i * 16 * LT + kk) * 4);
#pragma unroll
      for (int n = 0; n < NT / 2; ++n) {
        ldsm(bh[n], bs + (n * 16 * LT + kk) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) split(bh[n][q], bh[n][q], bl[n][q]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) split(ah[i][q], ah[i][q], al[i][q]);
      // al bh, then ah bl, then ah bh over all the warp's accumulators
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int n = 0; n < NT / 2; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t(&a)[4] = t == 0 ? al[i] : ah[i];
              const uint32_t(&b)[4] = t == 1 ? bl[n] : bh[n];
              mma(part[i][2 * n + h], a, b[2 * h], b[2 * h + 1]);
            }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][n][q] += part[i][n][q];
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

void* tile_kernel(int k) {
  return k == 10   ? reinterpret_cast<void*>(tf_tile_kernel<10>)
         : k <= 32 ? reinterpret_cast<void*>(tf_tile_kernel<32>)
                   : reinterpret_cast<void*>(tf_tile_kernel<64>);
}

const void* tail_kernel(int F) {
  return F == 128 ? reinterpret_cast<const void*>(tf_tail_gemm_kernel<128>)
                  : reinterpret_cast<const void*>(tf_tail_gemm_kernel<64>);
}

// What a call asks of the runtime, asked once: per device its SM count and
// a block's shared-memory limit; per (device, kernel) the dynamic shared
// memory allowed so far, raised and never lowered; per (device, kernel,
// bytes) the blocks an SM holds.
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
// and, where `per_sm` is given, counts the blocks of `threads` an SM holds
// at that size.
int allow_smem(const void* fn, int bytes, int threads, int* per_sm) {
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
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads,
                                                        bytes);
    if (err != cudaSuccess) return (int)err;
    it = g_per_sm.emplace(key, n).first;
  }
  *per_sm = it->second;
  return 0;
}

bool widths_ok(int C, int F2, int F, int k) {
  return C > 0 && k >= 1 && k <= 64 && F2 > 0 && F2 % 4 == 0 &&
         128 % F2 == 0 && (F == 64 || F == 128);
}

long long al4(long long floats) { return (floats + 3) / 4 * 4; }

// The tile size (the most points whose layout fits, at most kMaxRows edge
// rows) and grid (the blocks that fit on the card at once, at most one a
// tile) of tf_tile_kernel; the scratch, in floats: v | wout^T.
struct Plan {
  int TP, grid;
  Layout L;
  long long v, wt, total;
};

int plan(int B, int N, int C, int F2, int F, int k, Plan* p) {
  if (B <= 0 || N <= 0 || !widths_ok(C, F2, F, k))
    return (int)cudaErrorInvalidValue;
  int sms = 0, limit = 0, per_sm = 0;
  int err = device_attrs(&sms, &limit);
  if (err) return err;
  int TP = max_rows(F, F2) / k;
  while (TP > 1 && layout(C, F2, F, k, TP).bytes > limit) --TP;
  if (layout(C, F2, F, k, TP).bytes > limit)
    return (int)cudaErrorInvalidValue;
  p->TP = TP;
  p->L = layout(C, F2, F, k, TP);
  if ((err = allow_smem(tile_kernel(k), p->L.bytes, kTile, &per_sm)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long P = (long long)B * N, tiles = (P + TP - 1) / TP;
  const long long most = (long long)sms * per_sm;
  p->grid = (int)(tiles < most ? tiles : most);
  const long long KF = (long long)k * F;
  p->v = 0;
  p->wt = al4(P * k * F);
  p->total = p->wt + al4(KF * F);
  return 0;
}

}  // namespace

bool ebt_tf_fits(int C, int F2, int F, int k) {
  int sms = 0, limit = 0;
  return widths_ok(C, F2, F, k) && device_attrs(&sms, &limit) == 0 &&
         layout(C, F2, F, k, 1).bytes <= limit;
}

long long ebt_tf_scratch(int B, int N, int C, int F2, int F, int k) {
  Plan p;
  const int err = plan(B, N, C, F2, F, k, &p);
  return err ? -(long long)err : p.total;
}

int ebt_tf_tail(const float* ee, const float* w1, const float* a1,
                const float* w2, const float* a2, const float* wx,
                const float* ax, const float* wout, const float* bout,
                float* out, float* scratch, int B, int N, int C, int F2,
                int F, int k, float neg, cudaStream_t s) {
  Plan p;
  int err = plan(B, N, C, F2, F, k, &p);
  if (err) return err;
  const long long P = (long long)B * N;
  const int KF = k * F;
  float* wt = scratch + p.wt;
  tf_transpose_kernel<<<64, 256, 0, s>>>(wout, wt, KF, F);
  if ((err = (int)cudaGetLastError())) return err;
  Args a{};
  a.ee = ee;
  a.w1 = w1;
  a.a1 = a1;
  a.w2 = w2;
  a.a2 = a2;
  a.wx = wx;
  a.ax = ax;
  a.v = scratch + p.v;
  a.P = P;
  a.C = C;
  a.F2 = F2;
  a.F = F;
  a.k = k;
  a.TP = p.TP;
  a.neg = neg;
  a.L = p.L;
  void* params[] = {&a};
  if ((err = (int)cudaLaunchKernel(tile_kernel(k), dim3(p.grid),
                                   dim3(kTile), params, p.L.bytes, s)))
    return err;
  // out [P, F] = bout + v [P, k F] @ wout [k F, F]
  const int smem = tail_smem(F);
  if ((err = allow_smem(tail_kernel(F), smem, kTile, nullptr)))
    return err;
  const dim3 grid((unsigned)((P + TM - 1) / TM));
  if (F == 128)
    tf_tail_gemm_kernel<128><<<grid, kTile, smem, s>>>(a.v, wt, bout, out, P,
                                                       KF);
  else
    tf_tail_gemm_kernel<64><<<grid, kTile, smem, s>>>(a.v, wt, bout, out, P,
                                                      KF);
  return (int)cudaGetLastError();
}
