// Kernel F: banded self-kNN + exact neighbor gather + edge features, the
// `--knn_mode approx` twin of kernel B. x [B, N, C] f32 -> ee
// [B, N, k, C] (`nbr - central`, diff_only) or [B, N, k, 2C]
// (`[central, nbr - central]`) in f32 or bf16, and GLOBAL neighbor indices
// idx [B, N, k] int32.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/knn.py::
// knn_edge_window_pallas (_knn_edge_window_kernel). Query i's candidates
// are exactly the circular band of offsets 0 < |o| <= W around it (rows
// i + o mod N); 2W < N keeps the band free of duplicates. Selection is on
// f32 distances, with the band position p = o + W (0 .. 2W) as the column:
//   exact  - ascending (distance, p): ties go to the lower offset, not to
//            the lower global index;
//   packed - ascending int32 key: the bits of max(distance, 0) with the low
//            `bits` bits replaced by p. The caller passes the mask of the
//            JAX kernel, bits = bit_length(tq + 2W - 1) at ITS query tile
//            tq (256, halved until it divides N), so the quantum is the
//            TPU kernel's whatever tile this kernel uses. The JAX kernel's
//            column is the key's position in its tile's slice, query row
//            + p, which orders a query's candidates as p does.
// Results do not depend on this kernel's tile sizes: each query sees its
// band and nothing else.
//
// Design: a block of kQueries consecutive queries walks one contiguous
// circular slice of kQueries + 2W key rows (read modulo N, so the TPU's
// wrap-padded copy of x is never built), staged in shared memory tiles by
// the code kernels A, B and G share (knn_common.cuh); each thread evaluates
// only the 2W + 1 rows of its own band. The edge rows are written as
// kernel B writes them.
//
// What bounds it on an H100: at the P1 training shape (campaign config,
// [4, 8192, 64] -> bf16 diffs, k=10, W=512) the band is 2 * 4 * 8192 *
// 1024 * 64 = 4.29 GFLOP of f32 distance arithmetic (0.064 ms at 67
// TFLOP/s) against ~52 MB of input and output (0.016 ms at 3.35 TB/s), so
// operations bound it. As in kernel B the distances stay FMA-free f32 off
// the tensor cores, one query per thread with a serial top-k insert per
// candidate; P1's 64 x 4 blocks of 128 threads put about two blocks on
// each of the 132 SMs, so the latency of that serial loop, not the
// arithmetic, sets the time of this first version.
#include "knn_common.cuh"

namespace {

template <int CM, int KM, bool PACKED>
__global__ void __launch_bounds__(spgan::kQueries)
    knn_edge_window_kernel(const float* __restrict__ x, void* __restrict__ ee,
                           int32_t* __restrict__ idx, int N, int C, int k,
                           int W, int low_mask, bool diff_only,
                           bool out_bf16) {
  __shared__ __align__(16) float sbuf[spgan::smem_floats<CM, KM>()];
  __shared__ float skn[spgan::kTileKeys];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * spgan::kQueries;
  const int nq = min(spgan::kQueries, N - q0);
  const float* xb = x + (size_t)b * N * C;
  spgan::TopK<KM, PACKED> top;
  spgan::select_band<CM, KM, PACKED>(xb, N, C, q0, nq, W, low_mask, top, sbuf,
                                     skn);

  int* snbr = reinterpret_cast<int*>(sbuf);
  __syncthreads();  // every thread is done with the last key tile
  if (threadIdx.x < nq) {
    const int qi = q0 + threadIdx.x;
    const size_t o = ((size_t)b * N + qi) * k;
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      if (t < k) {
        int p = PACKED ? (top.key[t] & low_mask) : top.idx[t];
        p = min(max(p, 0), 2 * W);  // memory safety on NaN input only
        int g = qi - W + p;         // the global row, mod N
        g = g < 0 ? g + N : (g >= N ? g - N : g);
        snbr[threadIdx.x * k + t] = g;
        idx[o + t] = g;
      }
    }
  }
  __syncthreads();
  spgan::write_edges(xb, ee, snbr, b, N, C, k, q0, nq, diff_only, out_bf16);
}

struct KnnEdgeWindowLaunch {
  const float* x;
  void* ee;
  int32_t* idx;
  int B, N, C, k, W, low_mask;
  bool diff_only, out_bf16, packed;
  cudaStream_t stream;

  template <int CM, int KM>
  void operator()() const {
    const dim3 grid((N + spgan::kQueries - 1) / spgan::kQueries, B);
    if (packed)
      knn_edge_window_kernel<CM, KM, true>
          <<<grid, spgan::kQueries, 0, stream>>>(x, ee, idx, N, C, k, W,
                                                 low_mask, diff_only,
                                                 out_bf16);
    else
      knn_edge_window_kernel<CM, KM, false>
          <<<grid, spgan::kQueries, 0, stream>>>(x, ee, idx, N, C, k, W,
                                                 low_mask, diff_only,
                                                 out_bf16);
  }
};

}  // namespace

// x [B, N, C] f32 contiguous on the device; ee [B, N, k, C or 2C] in f32
// or bf16 (out_bf16); idx [B, N, k] int32. `low_mask` is the packed key's
// column mask, at least 2W. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success). Takes C <= 128,
// 1 <= k <= min(32, 2W), 2W < N and N <= 2^30.
extern "C" int spgan_knn_edge_window(const void* x, void* ee, void* idx,
                                     int B, int N, int C, int k, int W,
                                     int low_mask, int diff_only, int packed,
                                     int out_bf16, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || W <= 0 || k > 2 * W ||
      2 * W >= N || N > (1 << 30) || low_mask < 2 * W ||
      (low_mask & (low_mask + 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const KnnEdgeWindowLaunch f{static_cast<const float*>(x),
                              ee,
                              static_cast<int32_t*>(idx),
                              B,
                              N,
                              C,
                              k,
                              W,
                              low_mask,
                              diff_only != 0,
                              out_bf16 != 0,
                              packed != 0,
                              static_cast<cudaStream_t>(stream)};
  if (!spgan::dispatch_widths(C, k, f)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
