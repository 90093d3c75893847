// Kernel A: exact self-kNN, idx [B, N, k] int32 and dist [B, N, k] f32.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/knn.py::knn_pallas
// (_knn_kernel): squared distances of each query to every point of its
// cloud, self masked to +inf, the k smallest in ascending order with ties
// to the lower index (k rounds of min/argmin on the TPU; a running top-k in
// registers here, which gives the same order).
//
// What bounds it on an H100: per candidate key a thread spends a few
// FLOPs on the distance and up to k compare-and-shift steps on its running
// top-k, so the latency of that serial loop, not bytes, bounds it. At the
// serving shape [64, 2048, 3], k=10 (the fused eval path runs EdgeConv1 at
// the full batch) 1024 blocks of 128 queries cover the card. At the unfused
// path's batch-1 shape [1, 2048, 3] only 16 blocks run, on 16 of the 132
// SMs: 0.458 ms measured against a 0.4 us bound (chip_smoke.py on an H100,
// 700 W). A warp per query, or keys split across threads with a top-k
// merge, would fill the card there.
#include "knn_common.cuh"

namespace {

template <int CM, int KM>
__global__ void __launch_bounds__(spgan::kQueries)
    knn_kernel(const float* __restrict__ x, int32_t* __restrict__ idx,
               float* __restrict__ dist, int N, int C, int k) {
  __shared__ __align__(16) float sk[spgan::kTileKeys * CM];
  __shared__ float skn[spgan::kTileKeys];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * spgan::kQueries + threadIdx.x;
  const bool valid = qi < N;
  const float* xb = x + (size_t)b * N * C;
  spgan::TopK<KM, false> top;
  spgan::select_knn<CM, KM, false>(xb, N, C, qi, valid, 0, top, sk, skn, 0,
                                   N);
  if (!valid) return;
  const size_t o = ((size_t)b * N + qi) * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      idx[o + t] = top.idx[t];
      dist[o + t] = spgan::unorderable(top.key[t]);
    }
  }
}

struct KnnLaunch {
  const float* x;
  int32_t* idx;
  float* dist;
  int B, N, C, k;
  cudaStream_t stream;

  template <int CM, int KM>
  void operator()() const {
    const dim3 grid((N + spgan::kQueries - 1) / spgan::kQueries, B);
    knn_kernel<CM, KM><<<grid, spgan::kQueries, 0, stream>>>(x, idx, dist, N,
                                                             C, k);
  }
};

}  // namespace

// x [B, N, C] f32 contiguous on the device; idx, dist [B, N, k]. Launches on
// `stream` and returns the cudaError_t of the launch (0 on success).
// Takes C <= 128 and 1 <= k <= min(32, N).
extern "C" int spgan_knn(const void* x, void* idx, void* dist, int B, int N,
                         int C, int k, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || k <= 0 || k > N)
    return (int)cudaErrorInvalidValue;
  const KnnLaunch f{static_cast<const float*>(x), static_cast<int32_t*>(idx),
                    static_cast<float*>(dist), B, N, C, k,
                    static_cast<cudaStream_t>(stream)};
  if (!spgan::dispatch_widths(C, k, f)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
