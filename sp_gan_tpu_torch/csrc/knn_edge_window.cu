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
// Results do not depend on this kernel's tiles or split: each query sees
// its band and nothing else.
//
// Design. Above 4 channels F runs the selection engine of kernels A, B and
// G (knn_filter.cuh, which has the design and the proof, the band
// included): a block of 128 queries walks the circular slice of rows q0 -
// W .. q0 + nq + W - 1 (mod N, so the TPU's wrap-padded copy of x is never
// built) in tiles, from the tile that holds its own queries; each warp's
// three-product TF32 mma.sync estimates cover its queries x the tile, the
// band mask drops a query's keys outside its band, and only the keys that
// pass the filter's threshold get the exact f32 fold. The merge pass
// writes the edge rows as kernel B's does (EdgeOut, write_edges). At C <= 4
// every band pair is folded on the CUDA cores (select_band below, one
// query a thread), where a filter would spend as much on a pair.
//
// What bounds it on an H100: at the P1 training shape (campaign config,
// [4, 8192, 64] -> bf16 diffs, k=10, W=512) the filter's three TF32
// products over the block slices (3 * 2 * 4 * 8192 * 1152 * 64 = 14.5
// GFLOP, 0.029 ms at 495 TFLOP/s) and the exact folds of the pairs that
// pass (2 C + 3 f32 operations each, counted on the card), against ~52 MB
// of input and output (0.016 ms at 3.35 TB/s); chip_smoke.py adds the
// folds the call counts (`refined=`).
#include "knn_filter.cuh"

namespace {

// C <= 4: every band pair folded on the CUDA cores, one query a thread;
// the edge rows written as kernel B writes them.
template <int CM, int KM, bool PACKED>
__global__ void __launch_bounds__(spgan::kQueries)
    knn_edge_window_kernel(const float* __restrict__ x, void* __restrict__ ee,
                           int32_t* __restrict__ idx,
                           unsigned long long* __restrict__ refined, int N,
                           int C, int k, int W, int low_mask, bool diff_only,
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
  if (refined != nullptr && threadIdx.x == 0)
    atomicAdd(refined, (unsigned long long)nq * (2 * W + 1));

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
  unsigned long long* refined;
  int B, N, C, k, W, low_mask;
  bool diff_only, out_bf16, packed;
  cudaStream_t stream;

  template <int CM, int KM>
  void operator()() const {
    const dim3 grid((N + spgan::kQueries - 1) / spgan::kQueries, B);
    if (packed)
      knn_edge_window_kernel<CM, KM, true>
          <<<grid, spgan::kQueries, 0, stream>>>(x, ee, idx, refined, N, C, k,
                                                 W, low_mask, diff_only,
                                                 out_bf16);
    else
      knn_edge_window_kernel<CM, KM, false>
          <<<grid, spgan::kQueries, 0, stream>>>(x, ee, idx, refined, N, C, k,
                                                 W, low_mask, diff_only,
                                                 out_bf16);
  }
};

}  // namespace

// int32 words of scratch spgan_knn_edge_window needs: above 4 channels the
// norms of the filter and the partial lists its merge pass reads; none at
// C <= 4.
extern "C" long long spgan_knn_edge_window_scratch(int B, int N, int C, int k,
                                                   int W) {
  if (C <= spgan::kFilterAbove) return 0;
  return spgan::select_scratch_words<spgan::EdgeOut<false, true>>(B, N, C, k,
                                                                  W);
}

// x [B, N, C] f32 contiguous on the device; ee [B, N, k, C or 2C] in f32
// or bf16 (out_bf16); idx [B, N, k] int32; scratch of
// spgan_knn_edge_window_scratch(B, N, C, k, W) int32, needing no
// initialisation; refined null or one unsigned 64-bit counter, to which the
// call adds the (query, key) pairs it folds exactly; mu and nu the filter's
// margin. `low_mask` is the packed key's column mask, 2^b - 1 >= 2W.
// Launches on `stream` and returns the first nonzero cudaError_t (0 on
// success). Takes C <= 128, 1 <= k <= min(32, 2W), 2W < N, B <= 65535 and
// N <= 2^30.
extern "C" int spgan_knn_edge_window(const void* x, void* scratch, void* ee,
                                     void* idx, void* refined, int B, int N,
                                     int C, int k, int W, int low_mask,
                                     int diff_only, int packed, int out_bf16,
                                     float mu, float nu, void* stream) {
  if (B <= 0 || B > 65535 || N <= 0 || C <= 0 || C > 128 || k <= 0 ||
      k > 32 || W <= 0 || k > 2 * W || 2 * W >= N || N > (1 << 30) ||
      low_mask < 2 * W || (low_mask & (low_mask + 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  int32_t* out_idx = static_cast<int32_t*>(idx);
  unsigned long long* count = static_cast<unsigned long long*>(refined);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= spgan::kFilterAbove) {
    const KnnEdgeWindowLaunch f{xf,        ee,      out_idx,  count,
                                B,         N,       C,        k,
                                W,         low_mask, diff_only != 0,
                                out_bf16 != 0, packed != 0, st};
    spgan::dispatch_k<4>(k, f);
    return (int)cudaGetLastError();
  }
  int32_t* words = static_cast<int32_t*>(scratch);
  if (packed) {
    const spgan::Select<spgan::EdgeOut<true, true>> f{
        {xf, ee, out_idx, C, k, low_mask, diff_only != 0, out_bf16 != 0, W},
        xf, words, count, B, N, C, k, low_mask, mu, nu, st, W};
    return f();
  }
  const spgan::Select<spgan::EdgeOut<false, true>> f{
      {xf, ee, out_idx, C, k, low_mask, diff_only != 0, out_bf16 != 0, W},
      xf, words, count, B, N, C, k, low_mask, mu, nu, st, W};
  return f();
}
