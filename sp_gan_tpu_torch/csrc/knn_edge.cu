// Kernel B: fused self-kNN + exact neighbor gather + edge features.
// x [B, N, C] f32 -> ee [B, N, k, C] (`nbr - central`, diff_only) or
// [B, N, k, 2C] (`[central, nbr - central]`) in f32 or bf16, and
// idx [B, N, k] int32.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/knn.py::knn_edge_pallas
// (_knn_edge_kernel). Selection is always on f32 distances:
//   exact  - ascending (distance, index), what argmin rounds give;
//   packed - ascending int32 key: the bits of max(distance, 0) with the low
//            ceil(log2 N) bits replaced by the column index, so distances
//            within one quantum order by index (knn.py:225-258).
// The TPU gathers the neighbor rows with one-hot matmuls on the MXU; here
// each block writes its queries' edge rows straight from x, which stays in
// L2. With bf16 output the diff is bf16(f32(bf16(nbr)) - f32(bf16(central))),
// the rounding of the JAX kernel and of the XLA path.
//
// What bounds it on an H100: at the serving shape [64, 2048, 64], k=10 the
// distances are 2*64*2048^2*64 = 34.4 GFLOP of f32 arithmetic (0.51 ms at
// 67 TFLOP/s), against 0.71 GB of input and output in the f32 concat form
// that the fused eval path asks for (0.21 ms at 3.35 TB/s; 207 MB and 62 us
// for bf16 diffs), so it is bound by f32 operations. It keeps them off the tensor cores on
// purpose: selection needs the exact f32 distances. This first version
// issues a separate multiply and add per channel (no FMA, to stay
// bit-identical with its PyTorch twin) and one query per thread; more
// queries per thread and key-tile prefetch are the next steps.
#include "knn_common.cuh"

namespace {

template <int CM, int KM, bool PACKED>
__global__ void __launch_bounds__(spgan::kQueries)
    knn_edge_kernel(const float* __restrict__ x, void* __restrict__ ee,
                    int32_t* __restrict__ idx, int N, int C, int k,
                    int low_mask, bool diff_only, bool out_bf16) {
  __shared__ __align__(16) float sbuf[spgan::smem_floats<CM, KM>()];
  __shared__ float skn[spgan::kTileKeys];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * spgan::kQueries;
  const int qi = q0 + threadIdx.x;
  const bool valid = qi < N;
  const float* xb = x + (size_t)b * N * C;
  spgan::TopK<KM, PACKED> top;
  spgan::select_knn<CM, KM, PACKED>(xb, N, C, qi, valid, low_mask, top, sbuf,
                                    skn, 0, N);

  // the block's neighbor lists go to shared memory (reusing the key tile)
  // so that the edge rows can be written by consecutive threads
  int* snbr = reinterpret_cast<int*>(sbuf);
  __syncthreads();  // every thread is done with the last key tile
  if (valid) {
    const size_t o = ((size_t)b * N + qi) * k;
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      if (t < k) {
        int j = PACKED ? (top.key[t] & low_mask) : top.idx[t];
        j = min(max(j, 0), N - 1);  // memory safety on NaN input only
        snbr[threadIdx.x * k + t] = j;
        idx[o + t] = j;
      }
    }
  }
  __syncthreads();
  spgan::write_edges(xb, ee, snbr, b, N, C, k, q0,
                     min(spgan::kQueries, N - q0), diff_only, out_bf16);
}

struct KnnEdgeLaunch {
  const float* x;
  void* ee;
  int32_t* idx;
  int B, N, C, k, low_mask;
  bool diff_only, out_bf16, packed;
  cudaStream_t stream;

  template <int CM, int KM>
  void operator()() const {
    const dim3 grid((N + spgan::kQueries - 1) / spgan::kQueries, B);
    if (packed)
      knn_edge_kernel<CM, KM, true><<<grid, spgan::kQueries, 0, stream>>>(
          x, ee, idx, N, C, k, low_mask, diff_only, out_bf16);
    else
      knn_edge_kernel<CM, KM, false><<<grid, spgan::kQueries, 0, stream>>>(
          x, ee, idx, N, C, k, low_mask, diff_only, out_bf16);
  }
};

}  // namespace

// x [B, N, C] f32 contiguous on the device; ee [B, N, k, C or 2C] in f32
// or bf16 (out_bf16); idx [B, N, k] int32. Launches on `stream` and returns
// the cudaError_t of the launch (0 on success). Takes C <= 128,
// 1 <= k <= min(32, N) and N <= 2^30.
extern "C" int spgan_knn_edge(const void* x, void* ee, void* idx, int B,
                              int N, int C, int k, int diff_only, int packed,
                              int out_bf16, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N || N > (1 << 30))
    return (int)cudaErrorInvalidValue;
  int bits = 1;
  while ((1 << bits) < N) ++bits;  // ceil(log2 N), at least 1
  const KnnEdgeLaunch f{static_cast<const float*>(x),
                        ee,
                        static_cast<int32_t*>(idx),
                        B,
                        N,
                        C,
                        k,
                        (1 << bits) - 1,
                        diff_only != 0,
                        out_bf16 != 0,
                        packed != 0,
                        static_cast<cudaStream_t>(stream)};
  if (!spgan::dispatch_widths(C, k, f)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
