// Kernel N: both nearest-neighbour reductions of the Chamfer distance.
// x [B, N, C] and y [B, M, C] f32 -> d1 [B, N] f32 and i1 [B, N] int32
// (each point of x: squared distance to its nearest point of y and that
// point's index), d2 [B, M] f32 and i2 [B, M] int32 (the same from y to x).
// Ties go to the lowest index in both directions.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/chamfer.py::
// _chamfer_pallas_raw (_chamfer_kernel), the forward of chamfer_pallas that
// sp_gan_tpu/ops/dispatch.py::chamfer_directed takes above B*N*M = 128 Mi.
// The TPU kernel streams query tiles of x against all of y, reduces each
// [TQ, M] block by rows for d1 and folds its column minima into a revisited
// output block for d2 (strict <, so the earlier tile, the lower row, keeps
// a tie). Blocks of a CUDA grid run in no order and share no running
// minimum, so here the column minima meet in device memory.
//
// Design: one pass over the distance matrix, each d[n, m] computed once.
// A block of 256 threads takes one cloud's tile of 16 RX rows of x (RX = 16
// for C <= 3, 8 above) and walks y in tiles of 256 points staged in shared
// memory (coordinates by channel, and norms). Thread (tx, ty) holds RX
// rows of x in registers and takes the tile's columns ty, ty + 16, ...:
//   - row minima stay in registers over all tiles (strict <, columns in
//     ascending order), then merge over the 16 threads of a row by
//     shuffles, the lower index winning a tie;
//   - column minima over the thread's RX rows (strict <, rows ascending)
//     become a 64-bit key, the orderable bits of the distance above the
//     row's index, which merge by min over the two rows of a warp
//     (shuffle), then over the block's 8 warps in shared memory, then over
//     the cloud's blocks by one atomicMin a column into `colkey` [B, M],
//     which the launch sets to all ones. A second, short kernel unpacks
//     colkey into d2 and i2.
// A minimum of keys is exact and does not depend on the order of the
// merges, and equal distances leave the lowest index: the plain version's
// argmin. -0 would order below +0 in the key, while strict < holds them
// equal, so the key maps -0 to +0 (the fold below never gives -0: its last
// operation adds |y|^2 >= +0).
//
// Arithmetic: d[n, m] = (|x_n|^2 - 2 x_n.y_m) + |y_m|^2, the dot product
// and the norms folded over the channels left to right with every product
// and partial sum rounded to f32 (__fmul_rn/__fadd_rn, no contraction),
// the order of ops/pairwise.py::pairwise_sqdist; it is the value both
// directions reduce, so the kernel equals its plain version bit for bit.
// The one FMA, |x|^2 + (-2) x.y, rounds once where the plain version
// rounds -2 x.y and then the sum: doubling is exact, so the two agree.
//
// What bounds it on an H100: per pair of points the function needs the
// distance (2C + 2 f32 operations) and a compare in each direction; at
// [64, 2048, 2048] with C = 3 that is 2.7 G operations, 80 us at the
// card's 33.5 T non-FMA f32 operations a second, against 6.3 MB of
// inputs and outputs (2 us): operations. The pass does the distance once
// (2C + 1 instructions with the FMA) and a compare and two selects in each
// direction, 2C + 7 a pair; measured on the H100, the selects take as long
// as the distance.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileY = 256;  // y points a shared-memory tile
constexpr int kPerY = kTileY / 16;  // columns of a tile a thread takes
constexpr int kWarpsN = kThreads / 32;
static_assert(kTileY == kThreads, "a thread stages one point of a tile");

// uint32 image of a float that orders like the float, and its inverse
__device__ __forceinline__ unsigned orderable_u(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable_u(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <int C>
__device__ __forceinline__ float sq_norm(const float (&v)[C]) {
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int c = 1; c < C; ++c) s = __fadd_rn(s, __fmul_rn(v[c], v[c]));
  return s;
}

template <int C, int RX>
__global__ void __launch_bounds__(kThreads, 2)
    chamfer_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ d1, int32_t* __restrict__ i1,
                   unsigned long long* __restrict__ colkey, int N, int M) {
  __shared__ float sy[C][kTileY];
  __shared__ float syn[kTileY];
  __shared__ unsigned long long red[kWarpsN][kTileY];
  const int b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int ty = t & 15, tx = t >> 4;
  const int n0 = blockIdx.x * (16 * RX) + tx * RX;
  const float* xb = x + (size_t)b * N * C;
  const float* yb = y + (size_t)b * M * C;
  unsigned long long* ck = colkey + (size_t)b * M;

  // the thread's rows of x; a row past N gets |x|^2 = inf, so its
  // distances are inf and never a strict minimum
  float xv[RX][C], xn[RX];
#pragma unroll
  for (int i = 0; i < RX; ++i) {
    const bool valid = n0 + i < N;
#pragma unroll
    for (int c = 0; c < C; ++c)
      xv[i][c] = valid ? xb[(size_t)(n0 + i) * C + c] : 0.f;
    xn[i] = valid ? sq_norm<C>(xv[i]) : INFINITY;
  }
  float rb[RX];
  int ri[RX];
#pragma unroll
  for (int i = 0; i < RX; ++i) {
    rb[i] = INFINITY;
    ri[i] = 0;
  }

  for (int m0 = 0; m0 < M; m0 += kTileY) {
    // stage the tile (a column past M gets |y|^2 = inf); the last tile's
    // reads of sy ended at its second barrier
    {
      const int m = m0 + t;
      float v[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        v[c] = m < M ? yb[(size_t)m * C + c] : 0.f;
        sy[c][t] = v[c];
      }
      syn[t] = m < M ? sq_norm<C>(v) : INFINITY;
    }
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kPerY; ++j) {
      const int jj = ty + 16 * j, m = m0 + jj;
      float yv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) yv[c] = sy[c][jj];
      const float yn = syn[jj];
      float cd = INFINITY;
      int ci = 0;
#pragma unroll
      for (int i = 0; i < RX; ++i) {
        float acc = __fmul_rn(xv[i][0], yv[0]);
#pragma unroll
        for (int c = 1; c < C; ++c)
          acc = __fadd_rn(acc, __fmul_rn(xv[i][c], yv[c]));
        const float dd = __fadd_rn(__fmaf_rn(-2.f, acc, xn[i]), yn);
        if (dd < rb[i]) {
          rb[i] = dd;
          ri[i] = m;
        }
        if (dd < cd) {
          cd = dd;
          ci = i;
        }
      }
      unsigned long long key = ~0ull;
      if (m < M && n0 < N) {
        const float c0 = cd == 0.f ? 0.f : cd;  // -0 as +0
        key = ((unsigned long long)orderable_u(c0) << 32) |
              (unsigned)(n0 + ci);
      }
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, 16);
      key = o < key ? o : key;
      if (lane < 16) red[warp][jj] = key;
    }
    __syncthreads();
    // the block's column minima into the cloud's; the next tile's staging
    // waits on nothing here, and its barrier comes before the next writes
    // of red
    if (m0 + t < M) {
      unsigned long long k = red[0][t];
#pragma unroll
      for (int w = 1; w < kWarpsN; ++w) k = red[w][t] < k ? red[w][t] : k;
      atomicMin(ck + m0 + t, k);
    }
  }

  // row minima over the 16 threads of each row
#pragma unroll
  for (int i = 0; i < RX; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float d2 = __shfl_xor_sync(0xffffffffu, rb[i], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, ri[i], off);
      if (d2 < rb[i] || (d2 == rb[i] && j2 < ri[i])) {
        rb[i] = d2;
        ri[i] = j2;
      }
    }
    if (ty == 0 && n0 + i < N) {
      d1[(size_t)b * N + n0 + i] = rb[i];
      i1[(size_t)b * N + n0 + i] = ri[i];
    }
  }
}

// d2, i2 [n] from the column keys
__global__ void unpack_kernel(const unsigned long long* __restrict__ colkey,
                              float* __restrict__ d2,
                              int32_t* __restrict__ i2, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const unsigned long long k = colkey[e];
  d2[e] = from_orderable_u((unsigned)(k >> 32));
  i2[e] = (int32_t)(unsigned)(k & 0xffffffffull);
}

template <int C>
cudaError_t launch(const float* x, const float* y, float* d1, int32_t* i1,
                   float* d2, int32_t* i2, unsigned long long* colkey, int B,
                   int N, int M, cudaStream_t st) {
  constexpr int RX = C <= 3 ? 16 : 8;  // 16 rows at C = 4 spill
  const long long n2 = (long long)B * M;
  cudaError_t err = cudaMemsetAsync(colkey, 0xff, n2 * 8, st);
  if (err != cudaSuccess) return err;
  chamfer_kernel<C, RX><<<dim3((N + 16 * RX - 1) / (16 * RX), B), kThreads,
                          0, st>>>(x, y, d1, i1, colkey, N, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  unpack_kernel<<<(unsigned)((n2 + 255) / 256), 256, 0, st>>>(colkey, d2, i2,
                                                             n2);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, C] and y [B, M, C] f32 contiguous on the device; d1, i1 [B, N];
// d2, i2 [B, M]; scratch [B, M] int64 (the column keys). Launches on
// `stream` and returns the first nonzero cudaError_t (0 on success). Takes
// C <= 8.
extern "C" int spgan_chamfer(const void* x, const void* y, void* d1, void* i1,
                             void* d2, void* i2, void* scratch, int B, int N,
                             int M, int C, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || C > 8 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* d1f = static_cast<float*>(d1);
  float* d2f = static_cast<float*>(d2);
  int32_t* i1p = static_cast<int32_t*>(i1);
  int32_t* i2p = static_cast<int32_t*>(i2);
  auto* ck = static_cast<unsigned long long*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return (int)launch<1>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 2: return (int)launch<2>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 3: return (int)launch<3>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 4: return (int)launch<4>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 5: return (int)launch<5>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 6: return (int)launch<6>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    case 7: return (int)launch<7>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
    default:
      return (int)launch<8>(xf, yf, d1f, i1p, d2f, i2p, ck, B, N, M, st);
  }
}
