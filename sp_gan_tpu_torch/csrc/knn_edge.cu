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
// The selection is kernels A and G's engine (knn_filter.cuh, which has the
// design and the proof, the packed mode's threshold tau_q included): at C
// <= 4 a CUDA-core fold of every pair, above a TF32 tensor-core filter in
// front of the exact f32 fold, so the picks are the fold's in either
// order. The selection kernel hands its lists to the merge pass, which
// keeps many blocks an SM in flight (the filter two or three) and, once a
// block's lists are whole, turns the TPU's one-hot gather on the MXU into
// write_edges (knn_common.cuh): each block writes its queries' edge rows
// straight from x, which stays in L2, by consecutive threads, 16 bytes a
// load. With bf16 output the diff is bf16(f32(bf16(nbr)) -
// f32(bf16(central))), the rounding of the JAX kernel and of the XLA path.
//
// What bounds it on an H100: at the serving shape [64, 2048, 64], k=10,
// f32 concat edges, the three TF32 products of the filter (3 * 2 * 64 *
// 2048^2 * 64 = 103 GFLOP, 0.208 ms at 495 TFLOP/s) and the 0.71 GB of
// input and output (0.212 ms at 3.35 TB/s), with the exact folds of the
// candidates (counted on the card) beside them; at the training shape
// [24, 2048, 64], bf16 diffs, the products (0.078 ms) over 85 MB of bytes.
#include "knn_filter.cuh"

// int32 words of scratch spgan_knn_edge needs: the norms of the filter (C
// > 4) and the partial lists its merge pass reads.
extern "C" long long spgan_knn_edge_scratch(int B, int N, int C, int k) {
  return spgan::select_scratch_words<spgan::EdgeOut<false>>(B, N, C, k);
}

// x [B, N, C] f32 contiguous on the device; ee [B, N, k, C or 2C] in f32
// or bf16 (out_bf16); idx [B, N, k] int32; scratch of
// spgan_knn_edge_scratch(B, N, C, k) int32, needing no initialisation;
// refined null or one unsigned 64-bit counter, to which the call adds the
// (query, key) pairs it folds exactly; mu and nu the filter's margin.
// Launches on `stream` and returns the first nonzero cudaError_t (0 on
// success). Takes C <= 128, 1 <= k <= min(64, N), B <= 65535 and N <=
// 2^30.
extern "C" int spgan_knn_edge(const void* x, void* scratch, void* ee,
                              void* idx, void* refined, int B, int N, int C,
                              int k, int diff_only, int packed, int out_bf16,
                              float mu, float nu, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || N > (1 << 30) || C <= 0 || C > 128 ||
      k <= 0 || k > N || k > 64)
    return (int)cudaErrorInvalidValue;
  int bits = 1;
  while ((1 << bits) < N) ++bits;  // ceil(log2 N), at least 1
  const int low_mask = (1 << bits) - 1;
  const float* xf = static_cast<const float*>(x);
  int32_t* words = static_cast<int32_t*>(scratch);
  int32_t* out_idx = static_cast<int32_t*>(idx);
  unsigned long long* count = static_cast<unsigned long long*>(refined);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (packed) {
    const spgan::Select<spgan::EdgeOut<true>> f{
        {xf, ee, out_idx, C, k, low_mask, diff_only != 0, out_bf16 != 0},
        xf, words, count, B, N, C, k, low_mask, mu, nu, st};
    return f();
  }
  const spgan::Select<spgan::EdgeOut<false>> f{
      {xf, ee, out_idx, C, k, low_mask, diff_only != 0, out_bf16 != 0},
      xf, words, count, B, N, C, k, low_mask, mu, nu, st};
  return f();
}
