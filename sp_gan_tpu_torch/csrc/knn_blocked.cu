// Kernel G: exact self-kNN with the key axis split across thread blocks,
// idx [B, N, k] int32 and dist [B, N, k] f32, for clouds above 8192 points.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/knn.py::knn_pallas_blocked
// (_knn_blocked_kernel), which knn_pallas switches to for N > 8192. The
// function is kernel A's: squared distances of each query to every other
// point of its cloud (self at +inf), the k smallest in ascending
// (distance, index) order. The TPU kernel walks key blocks in sequence and
// merges each block's top-k into a running list kept in its output block;
// on a GPU blocks run in parallel and in no order, so the key walk becomes
// two passes:
//
//   1. partial: the grid's y axis cuts the keys into chunks of kKeyChunk
//      rows; a block takes kQueries queries against one chunk (the tile
//      loop of kernel A, knn_common.cuh) and writes each query's k best of
//      that chunk, (orderable distance, index), to a scratch
//      [B, N, S, k] for S = ceil(N / kKeyChunk) chunks;
//   2. merge: a thread per query pushes its S * k partial entries through
//      the same register top-k, in chunk order.
//
// Every candidate carries the distance kernel A computes for it (the same
// FMA-free f32 fold) and (distance, index) is a total order, so the k
// smallest of all N - 1 keys are among the chunks' k smallest and come out
// in the same order: the result is bit-identical to kernel A's and to
// knn_plain's, whatever the chunking.
//
// What bounds it on an H100: at P2's EdgeConv2 shape [16, 16384, 64], k=10
// the distances are 2 * 16 * 16384^2 * 64 = 550 GFLOP of f32 arithmetic,
// 8.2 ms at 67 TFLOP/s, against 67 MB of input and 21 MB of output: bound by
// operations (at EdgeConv1's [16, 16384, 3], 26 GFLOP, 0.38 ms). As in
// kernel A the distances stay off the tensor cores and each candidate
// costs a serial top-k insert. The split gives a batch of 16 clouds
// 128 x 8 x 16 = 16,384 blocks, so the card stays full at any batch; the
// scratch round trip (2 * B * N * S * k * 4 bytes, 168 MB at P2) is small
// beside the arithmetic.
#include "knn_common.cuh"

namespace {

constexpr int kKeyChunk = 2048;  // keys per block of the partial pass
constexpr int kMergeThreads = 128;

template <int CM, int KM>
__global__ void __launch_bounds__(spgan::kQueries)
    knn_partial_kernel(const float* __restrict__ x,
                       int32_t* __restrict__ part_key,
                       int32_t* __restrict__ part_idx, int N, int C, int k,
                       int S) {
  __shared__ __align__(16) float sk[spgan::kTileKeys * CM];
  __shared__ float skn[spgan::kTileKeys];
  const int b = blockIdx.z, s = blockIdx.y;
  const int qi = blockIdx.x * spgan::kQueries + threadIdx.x;
  const bool valid = qi < N;
  const int key0 = s * kKeyChunk, key1 = min(N, key0 + kKeyChunk);
  const float* xb = x + (size_t)b * N * C;
  spgan::TopK<KM, false> top;
  spgan::select_knn<CM, KM, false>(xb, N, C, qi, valid, 0, top, sk, skn, key0,
                                   key1);
  if (!valid) return;
  const size_t o = (((size_t)b * N + qi) * S + s) * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      part_key[o + t] = top.key[t];
      part_idx[o + t] = top.idx[t];
    }
  }
}

template <int KM>
__global__ void __launch_bounds__(kMergeThreads)
    knn_merge_kernel(const int32_t* __restrict__ part_key,
                     const int32_t* __restrict__ part_idx,
                     int32_t* __restrict__ idx, float* __restrict__ dist,
                     int64_t rows, int k, int S) {
  const int64_t row = (int64_t)blockIdx.x * kMergeThreads + threadIdx.x;
  if (row >= rows) return;
  spgan::TopK<KM, false> top;
  top.init();
  const size_t base = (size_t)row * S * k;
  for (int e = 0; e < S * k; ++e)
    top.push(part_key[base + e], part_idx[base + e]);
  const size_t o = (size_t)row * k;
#pragma unroll
  for (int t = 0; t < KM; ++t) {
    if (t < k) {
      idx[o + t] = top.idx[t];
      dist[o + t] = spgan::unorderable(top.key[t]);
    }
  }
}

struct KnnBlockedLaunch {
  const float* x;
  int32_t *part_key, *part_idx, *idx;
  float* dist;
  int B, N, C, k, S;
  cudaStream_t stream;

  template <int CM, int KM>
  void operator()() const {
    const dim3 grid((N + spgan::kQueries - 1) / spgan::kQueries, S, B);
    knn_partial_kernel<CM, KM><<<grid, spgan::kQueries, 0, stream>>>(
        x, part_key, part_idx, N, C, k, S);
    if (cudaPeekAtLastError() != cudaSuccess) return;
    const int64_t rows = (int64_t)B * N;
    const unsigned blocks =
        (unsigned)((rows + kMergeThreads - 1) / kMergeThreads);
    knn_merge_kernel<KM><<<blocks, kMergeThreads, 0, stream>>>(
        part_key, part_idx, idx, dist, rows, k, S);
  }
};

}  // namespace

// The key chunks of the partial pass for N points: the caller allocates
// part_key and part_idx of B * N * S * k int32 each.
extern "C" int spgan_knn_blocked_chunks(int N) {
  return (N + kKeyChunk - 1) / kKeyChunk;
}

// x [B, N, C] f32 contiguous on the device; idx, dist [B, N, k]; part_key,
// part_idx scratch of B * N * S * k int32, S = spgan_knn_blocked_chunks(N),
// needing no initialisation. Launches both passes on `stream` and returns
// the first nonzero cudaError_t (0 on success). Takes C <= 128,
// 1 <= k <= min(32, N - 1) and B <= 65535.
extern "C" int spgan_knn_blocked(const void* x, void* part_key,
                                 void* part_idx, void* idx, void* dist, int B,
                                 int N, int C, int k, void* stream) {
  if (B <= 0 || B > 65535 || N <= 1 || C <= 0 || k <= 0 || k >= N)
    return (int)cudaErrorInvalidValue;
  const KnnBlockedLaunch f{static_cast<const float*>(x),
                           static_cast<int32_t*>(part_key),
                           static_cast<int32_t*>(part_idx),
                           static_cast<int32_t*>(idx),
                           static_cast<float*>(dist),
                           B,
                           N,
                           C,
                           k,
                           spgan_knn_blocked_chunks(N),
                           static_cast<cudaStream_t>(stream)};
  if (!spgan::dispatch_widths(C, k, f)) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
