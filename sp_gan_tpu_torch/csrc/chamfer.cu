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
// minimum, so here each direction is its own launch of one kernel: a thread
// owns a query point, its block stages the other cloud in tiles of 64
// points in shared memory (knn_common.cuh) and the thread keeps its running
// minimum with a strict <, in ascending key order.
//
// Arithmetic: d[n, m] = (|x_n|^2 - 2 x_n.y_m) + |y_m|^2 with the fold of
// knn_common.cuh (every product and partial sum rounded to f32, no FMA),
// the order of ops/pairwise.py::pairwise_sqdist. The y-to-x pass keeps that
// expression with the roles of the norms swapped (products commute
// exactly), so both directions see the same value of d[n, m], and the
// kernel equals its plain version bit for bit.
//
// What bounds it on an H100: per pair of points the function needs the
// distance (2C + 2 f32 operations) and a compare in each direction; at
// [64, 2048, 2048] with C = 3 that is 2.7 G operations, 80 us at the
// card's 33.5 T non-FMA f32 operations a second, against 6.3 MB of
// inputs and outputs (2 us): operations. Evaluating d once per direction
// doubles the distance work; keeping both minima in one pass would need a
// cross-block reduction of the column minima.
#include "knn_common.cuh"

namespace {

template <int CM>
__global__ void __launch_bounds__(spgan::kQueries)
    nearest_kernel(const float* __restrict__ q, const float* __restrict__ keys,
                   float* __restrict__ dist, int32_t* __restrict__ idx,
                   int nq, int nk, int C, bool q_is_x) {
  __shared__ __align__(16) float sk[spgan::kTileKeys * CM];
  __shared__ float skn[spgan::kTileKeys];
  const int b = blockIdx.y;
  const int qi = blockIdx.x * spgan::kQueries + threadIdx.x;
  const bool valid = qi < nq;
  const float* qb = q + (size_t)b * nq * C;
  const float* kb = keys + (size_t)b * nk * C;
  float qv[CM];
  const float qn = spgan::load_query<CM>(qb, C, qi, valid, qv);
  float best = INFINITY;
  int bi = 0;
  for (int r0 = 0; r0 < nk; r0 += spgan::kTileKeys) {
    const int nt = min(spgan::kTileKeys, nk - r0);
    spgan::stage_keys<CM>(kb, C, r0, nt, spgan::RowsAsIs{}, sk, skn);
    for (int t = 0; t < nt; ++t) {
      // (|x|^2 - 2 x.y) + |y|^2 whichever cloud the query is in
      const float d =
          q_is_x ? spgan::key_dist<CM>(qv, qn, sk + t * CM, skn[t])
                 : spgan::key_dist<CM>(qv, skn[t], sk + t * CM, qn);
      if (d < best) {
        best = d;
        bi = r0 + t;
      }
    }
  }
  if (!valid) return;
  dist[(size_t)b * nq + qi] = best;
  idx[(size_t)b * nq + qi] = bi;
}

template <int CM>
cudaError_t launch_both(const float* x, const float* y, float* d1,
                        int32_t* i1, float* d2, int32_t* i2, int B, int N,
                        int M, int C, cudaStream_t st) {
  const int q = spgan::kQueries;
  nearest_kernel<CM><<<dim3((N + q - 1) / q, B), q, 0, st>>>(x, y, d1, i1, N,
                                                             M, C, true);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nearest_kernel<CM><<<dim3((M + q - 1) / q, B), q, 0, st>>>(y, x, d2, i2, M,
                                                             N, C, false);
  return cudaGetLastError();
}

}  // namespace

// x [B, N, C] and y [B, M, C] f32 contiguous on the device; d1, i1 [B, N];
// d2, i2 [B, M]. Launches both directions on `stream` and returns the first
// nonzero cudaError_t (0 on success). Takes C <= 8.
extern "C" int spgan_chamfer(const void* x, const void* y, void* d1, void* i1,
                             void* d2, void* i2, int B, int N, int M, int C,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || C <= 0 || C > 8 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  float* d1f = static_cast<float*>(d1);
  float* d2f = static_cast<float*>(d2);
  int32_t* i1p = static_cast<int32_t*>(i1);
  int32_t* i2p = static_cast<int32_t*>(i2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(C <= 4 ? launch_both<4>(xf, yf, d1f, i1p, d2f, i2p, B, N, M,
                                       C, st)
                      : launch_both<8>(xf, yf, d1f, i1p, d2f, i2p, B, N, M,
                                       C, st));
}
