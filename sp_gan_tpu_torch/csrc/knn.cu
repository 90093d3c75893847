// Kernels A and G: exact self-kNN, idx [B, N, k] int32 and dist [B, N, k]
// f32, bit-equal to knn_plain at any N.
//
// Replaces the TPU kernels sp_gan_tpu/ops/pallas/knn.py::knn_pallas
// (_knn_kernel, A) and knn_pallas_blocked (_knn_blocked_kernel, G, which
// knn_pallas takes for N > 8192): squared distances of each query to every
// point of its cloud, self masked to +inf, the k smallest in ascending
// order with ties to the lower index. A and G are one code path, the
// selection engine of knn_filter.cuh (its header has the design and the
// proof): a CUDA-core fold of every pair at C <= 4, a TF32 tensor-core
// filter in front of the exact f32 fold above; one running list a query,
// walked from the block's own tile. The wrappers (ops/kernels/knn.py,
// knn_blocked.py) route by N as the JAX package does, and count their
// launches apart.
//
// What bounds it on an H100: at EdgeConv1's calls (C = 3: the serving
// request's [64, 2048, 3], P2's [16, 16384, 3]) the exact fold of every
// pair, 9 f32 operations that are not FMAs a pair, 0.072 ms and 1.16 ms
// at 33.5 Tops/s; at P2's EdgeConv2 call [16, 16384, 64] the three TF32
// products, 1.65 TFLOP, 3.3 ms at 495 TFLOP/s. chip_smoke.py counts the
// pairs each call folds exactly and bounds it by that count.
#include "knn_filter.cuh"

// int32 words of scratch spgan_knn needs: the norms of the filter (B * N,
// C > 4) and, with S > 1 key chunks, the partial lists.
extern "C" long long spgan_knn_scratch(int B, int N, int C, int k) {
  return spgan::select_scratch_words<spgan::ListOut>(B, N, C, k);
}

// x [B, N, C] f32 contiguous on the device; idx, dist [B, N, k]; scratch
// of spgan_knn_scratch(B, N, C, k) int32, needing no initialisation;
// refined null or one unsigned 64-bit counter, to which the call adds the
// (query, key) pairs it folds exactly. mu and nu: the filter's margin
// (knn_filter.cuh). Launches on `stream` and returns the first nonzero
// cudaError_t (0 on success). Takes C <= 128, 1 <= k <= min(64, N) and
// B <= 65535.
extern "C" int spgan_knn(const void* x, void* scratch, void* idx, void* dist,
                         void* refined, int B, int N, int C, int k, float mu,
                         float nu, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || C > 128 || k <= 0 ||
      k > N || k > 64)
    return (int)cudaErrorInvalidValue;
  const spgan::Select<spgan::ListOut> f{
      {static_cast<int32_t*>(idx), static_cast<float*>(dist), k},
      static_cast<const float*>(x),
      static_cast<int32_t*>(scratch),
      static_cast<unsigned long long*>(refined),
      B,
      N,
      C,
      k,
      0,
      mu,
      nu,
      static_cast<cudaStream_t>(stream)};
  return f();
}
