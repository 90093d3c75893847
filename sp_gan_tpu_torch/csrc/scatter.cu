// Kernels D, H and M: deterministic scatter-adds by target through a CSR
// inversion of the index lists, with no float atomics.
//
// Kernel M (spgan_edge_scatter_bwd): backward of the concat-form edge op
// (kernel B without diff_only), ee = [central, nbr - central].
// d_ee [B, N, k, 2C] in f32 or bf16 and idx [B, N, k] int32 ->
//   d_x[b, p, :] = sum_{(q, j): idx[b, q, j] = p} d_ee[b, q, j, C:]
//                  + sum_j (d_ee[b, p, j, :C] - d_ee[b, p, j, C:])
// in f32, accumulated in f32 for bf16 d_ee too. Replaces the TPU kernel
// sp_gan_tpu/ops/pallas/scatter.py::edge_scatter_bwd_pallas
// (_edge_bwd_kernel), which the JAX package runs under SPGAN_EDGE_BWD=pallas
// (sp_gan_tpu/ops/edge.py:147-155): there an O(N^2 k C) one-hot matmul over
// the neighbor half, f32 made exact by a hi/mid/lo bf16 split, the central
// sum added where the target tile is the source tile. Here it is the four
// passes below on the neighbor half (sources at a row stride of 2C), then
// the central sum (j ascending, each term a - b in f32) added last. What
// bounds it on an H100: at the --fused_train step's EdgeConv2 (d_ee
// [24, 2048, 10, 128] bf16) the function moves 125.8 MB of d_ee, 2.0 MB of
// idx and 12.6 MB of d_x (140.4 MB, 42 us at 3.35 TB/s) for 94 MFLOP of
// adds: bytes.
//
// Kernel H (spgan_scatter_add): g [B, S, F] in f32 or bf16 and idx [B, S]
// int32 -> out[b, p, :] = sum_{s: idx[b, s] = p} g[b, s, :], [B, n, F] f32.
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/scatter.py::
// scatter_add_pallas (_scatter_kernel), the backward of the neighbor gather
// once its one-hot would pass 1 GiB (sp_gan_tpu/ops/edge.py:64-72): the
// transpose of gather_neighbors on the unfused large-N path. It runs the
// four passes below with n targets and S sources per cloud and no central
// term. What bounds it on an H100: at P3's shape (g [2, 163840, 64] bf16,
// N=16384, k=10) the function moves 41.9 MB of g, 1.3 MB of idx and
// 8.4 MB of out (51.6 MB, 15 us at 3.35 TB/s) for 21 MFLOP of adds, so
// bytes bound it; passes 1-3 read idx three times and pass 4 reads each
// source row once.
//
// Kernel D (spgan_scatter_diff_bwd): backward of the diff-only edge op
// (kernel B or F with diff_only).
// d_diff [B, N, k, C] in f32 or bf16 and idx [B, N, k] int32 ->
//   d_x[b, p, :] = sum_{(q, j): idx[b, q, j] = p} d_diff[b, q, j, :]
//                  - sum_j d_diff[b, p, j, :]
// in f32, accumulated in f32.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/scatter.py::
// scatter_diff_bwd_pallas (_diff_bwd_kernel). The TPU computes the scatter
// as an O(N^2 k C) one-hot matmul on the MXU, with a hi/mid/lo bf16 split to
// make f32 exact. Here the work is O(N k C): the neighbor lists are inverted
// per cloud into a CSR by target, and each target row sums its in-edges.
//
//   1. count: in-degree of every target (integer atomics);
//   2. scan:  exclusive prefix sum of the in-degrees of each cloud (one
//             block per cloud), giving each target its segment;
//   3. fill:  every edge writes its source (q * k + j) into its target's
//             segment, at a slot taken with an integer atomic, so the order
//             inside a segment is arbitrary;
//   4. sum:   one warp per target row, C channels over the 32 lanes. The
//             warp puts its segment in ascending source order (each source
//             goes to the slot given by its rank, the number of smaller
//             sources in the segment: no bound on the in-degree, and the
//             rank loops' loads are independent), then adds the rows in
//             that order in f32, their loads independent of each other,
//             and subtracts the central sum (j ascending) last, as the TPU
//             kernel does (scatter.py:167-169).
//
// Deterministic: the sums run in a fixed order whatever order the atomics
// of passes 1 and 3 took, so two launches give bit-identical output. No
// float atomics. Plain f32 adds (__fadd_rn), the same order as the
// plain version's index_add_ for the neighbor term.
//
// What bounds it on an H100: at the training shape d_diff [24, 2048, 10,
// 64] bf16 the function must move 62.9 MB of d_diff, 2.0 MB of idx and
// 12.6 MB of d_x (77.5 MB, 23 us at 3.35 TB/s) for 66 MFLOP of adds, so
// it is bound by bytes. Pass 4 reads each source row once (a row of 64
// bf16 is 128 contiguous bytes), but passes 1-3 each read idx again, and
// ranking a segment of in-degree d reads it d times from L1 (hubs of a kNN
// graph reach d in the hundreds). Kernel D is kernel H on the sources
// s = q * k + j (n = N, S = N k) plus the central term.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;       // passes 1, 3 and 4
constexpr int kScanThreads = 1024;  // pass 2, one block per cloud
constexpr int kMaxC = 128;          // 4 channels per lane
constexpr int kChannelsPerLane = kMaxC / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__global__ void __launch_bounds__(kThreads)
    count_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ deg,
                 int n, int64_t per_cloud, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / per_cloud;
  const int p = idx[e];
  if ((unsigned)p < (unsigned)n) atomicAdd(&deg[b * n + p], 1);
}

__global__ void __launch_bounds__(kScanThreads)
    scan_kernel(const int32_t* __restrict__ deg, int32_t* __restrict__ start,
                int32_t* __restrict__ cursor, int N) {
  __shared__ int32_t warp_tot[kScanThreads / 32];
  const int b = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (N + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, N), hi = min(lo + per, N);
  const int32_t* d = deg + (int64_t)b * N;
  int32_t local = 0;
  for (int i = lo; i < hi; ++i) local += d[i];
  // inclusive scan of `local` over the block: warps, then warp totals
  int32_t inc = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += v;
    }
    warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  int32_t run = inc - local + (warp > 0 ? warp_tot[warp - 1] : 0);
  int32_t* s = start + (int64_t)b * (N + 1);
  int32_t* c = cursor + (int64_t)b * N;
  for (int i = lo; i < hi; ++i) {
    s[i] = run;
    c[i] = run;
    run += d[i];
  }
  if (t == kScanThreads - 1) s[N] = run;  // the cloud's edge count
}

__global__ void __launch_bounds__(kThreads)
    fill_kernel(const int32_t* __restrict__ idx, int32_t* __restrict__ cursor,
                int32_t* __restrict__ src, int n, int64_t per_cloud,
                int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / per_cloud;
  const int p = idx[e];
  if ((unsigned)p >= (unsigned)n) return;
  const int32_t slot = atomicAdd(&cursor[b * n + p], 1);
  src[b * per_cloud + slot] = (int32_t)(e - b * per_cloud);
}

// What a target row adds after its in-edges: nothing (kernel H), minus the
// sum of its own central_k source rows (kernel D), or plus the sum of
// a - b over its own rows, a the C values before each source row (kernel M)
enum Central { kNoCentral = 0, kSubtractOwn = 1, kAddConcat = 2 };

// One warp per target row p of cloud b: its segment of sources in
// ascending order, summed in f32, then the central term of `mode` over row
// p's own central_k sources, j ascending, last. Source s is the row of C
// values at g + s * stride.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sum_kernel(const T* __restrict__ g, const int32_t* __restrict__ start,
               const int32_t* __restrict__ src, int32_t* __restrict__ sorted,
               float* __restrict__ out, int B, int n, int64_t per_cloud,
               int C, int64_t stride, int central_k, int mode) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= (int64_t)B * n) return;
  const int64_t b = row / n;
  const int p = (int)(row - b * n);
  const int32_t* s = start + b * (n + 1);
  const int lo = s[p], hi = s[p + 1];
  const int32_t* seg = src + b * per_cloud;
  int32_t* srt = sorted + b * per_cloud;
  const T* gb = g + b * per_cloud * stride;

  // the segment's sources are distinct: each one's rank is its slot
  for (int i = lo + lane; i < hi; i += 32) {
    const int v = seg[i];
    int rank = 0;
    for (int x = lo; x < hi; ++x) rank += seg[x] < v;
    srt[lo + rank] = v;
  }
  __syncwarp();

  float acc[kChannelsPerLane];
#pragma unroll
  for (int t = 0; t < kChannelsPerLane; ++t) acc[t] = 0.0f;
#pragma unroll 4
  for (int r = lo; r < hi; ++r) {
    const T* gr = gb + (int64_t)srt[r] * stride;
#pragma unroll
    for (int t = 0; t < kChannelsPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c < C) acc[t] = __fadd_rn(acc[t], to_f32(gr[c]));
    }
  }
  float* o = out + row * C;
  if (mode == kNoCentral) {
#pragma unroll
    for (int t = 0; t < kChannelsPerLane; ++t) {
      const int c = lane + 32 * t;
      if (c < C) o[c] = acc[t];
    }
    return;
  }
  // the central term, j ascending, last
  const T* own = gb + (int64_t)p * central_k * stride;
#pragma unroll
  for (int t = 0; t < kChannelsPerLane; ++t) {
    const int c = lane + 32 * t;
    if (c < C) {
      float cs = 0.0f;
      for (int j = 0; j < central_k; ++j) {
        const T* r = own + j * stride;
        cs = __fadd_rn(cs, mode == kSubtractOwn
                               ? to_f32(r[c])
                               : __fsub_rn(to_f32(r[c - C]), to_f32(r[c])));
      }
      o[c] = mode == kSubtractOwn ? __fsub_rn(acc[t], cs)
                                  : __fadd_rn(acc[t], cs);
    }
  }
}

// The four passes on the caller's stream: n targets and per_cloud sources
// a cloud, the sources' C values at g + offset + s * stride (s over
// [B, per_cloud]), idx [B, per_cloud], out [B, n, C]; `scratch` holds
// B * (3 n + 1 + 2 per_cloud) int32 and needs no initialising. Returns the
// first nonzero cudaError_t.
int csr_scatter(const void* g, const void* idx, void* out, void* scratch,
                int B, int n, int64_t per_cloud, int C, int64_t offset,
                int64_t stride, bool g_bf16, int central_k, int mode,
                cudaStream_t st) {
  const int64_t total = per_cloud * B;
  int32_t* deg = static_cast<int32_t*>(scratch);
  int32_t* start = deg + (int64_t)B * n;
  int32_t* cursor = start + (int64_t)B * (n + 1);
  int32_t* src = cursor + (int64_t)B * n;
  int32_t* sorted = src + total;
  const int32_t* ix = static_cast<const int32_t*>(idx);
  cudaError_t err =
      cudaMemsetAsync(deg, 0, sizeof(int32_t) * (size_t)B * n, st);
  if (err != cudaSuccess) return (int)err;
  const unsigned edge_blocks = (unsigned)((total + kThreads - 1) / kThreads);
  count_kernel<<<edge_blocks, kThreads, 0, st>>>(ix, deg, n, per_cloud,
                                                  total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scan_kernel<<<B, kScanThreads, 0, st>>>(deg, start, cursor, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  fill_kernel<<<edge_blocks, kThreads, 0, st>>>(ix, cursor, src, n,
                                                 per_cloud, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t rows = (int64_t)B * n;
  const unsigned row_blocks =
      (unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32));
  if (g_bf16)
    sum_kernel<__nv_bfloat16><<<row_blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g) + offset, start, src, sorted,
        static_cast<float*>(out), B, n, per_cloud, C, stride, central_k,
        mode);
  else
    sum_kernel<float><<<row_blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g) + offset, start, src, sorted,
        static_cast<float*>(out), B, n, per_cloud, C, stride, central_k,
        mode);
  return (int)cudaGetLastError();
}

}  // namespace

// d_diff [B, N, k, C] f32 or bf16 (dd_bf16) and idx [B, N, k] int32,
// contiguous on the device; d_x [B, N, C] f32. `scratch` holds
// B * (3 N + 1 + 2 N k) int32 (in-degrees, segment starts, fill cursors,
// sources as filled, sources sorted); nothing in it needs initialising.
// Entries of idx outside [0, N) are ignored. Launches on `stream` and returns the first nonzero
// cudaError_t (0 on success). Takes C <= 128.
extern "C" int spgan_scatter_diff_bwd(const void* d_diff, const void* idx,
                                      void* d_x, void* scratch, int B, int N,
                                      int k, int C, int dd_bf16,
                                      void* stream) {
  if (B <= 0 || N <= 0 || k <= 0 || C <= 0 || C > kMaxC ||
      (int64_t)N * k >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(d_diff, idx, d_x, scratch, B, N, (int64_t)N * k, C, 0,
                     C, dd_bf16 != 0, k, kSubtractOwn,
                     static_cast<cudaStream_t>(stream));
}

// Kernel H. g [B, S, F] f32 or bf16 (g_bf16) and idx [B, S] int32,
// contiguous on the device; out [B, n, F] f32. `scratch` holds
// B * (3 n + 1 + 2 S) int32 (in-degrees, segment starts, fill cursors,
// sources as filled, sources sorted); nothing in it needs initialising.
// Entries of idx outside [0, n) are ignored; a target with no source gets
// zeros. Launches on `stream` and returns the first nonzero cudaError_t
// (0 on success). Takes F <= 128.
extern "C" int spgan_scatter_add(const void* g, const void* idx, void* out,
                                 void* scratch, int B, int S, int n, int F,
                                 int g_bf16, void* stream) {
  if (B <= 0 || S <= 0 || n <= 0 || F <= 0 || F > kMaxC)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(g, idx, out, scratch, B, n, S, F, 0, F, g_bf16 != 0, 0,
                     kNoCentral, static_cast<cudaStream_t>(stream));
}

// Kernel M. d_ee [B, N, k, 2C] f32 or bf16 (ee_bf16) and idx [B, N, k]
// int32, contiguous on the device; d_x [B, N, C] f32. `scratch` holds
// B * (3 N + 1 + 2 N k) int32, as kernel D's; nothing in it needs
// initialising. Entries of idx outside [0, N) are ignored. Launches on
// `stream` and returns the first nonzero cudaError_t (0 on success). Takes
// C <= 128.
extern "C" int spgan_edge_scatter_bwd(const void* d_ee, const void* idx,
                                      void* d_x, void* scratch, int B, int N,
                                      int k, int C, int ee_bf16,
                                      void* stream) {
  if (B <= 0 || N <= 0 || k <= 0 || C <= 0 || C > kMaxC ||
      (int64_t)N * k >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  return csr_scatter(d_ee, idx, d_x, scratch, B, N, (int64_t)N * k, C, C,
                     2 * (int64_t)C, ee_bf16 != 0, k, kAddConcat,
                     static_cast<cudaStream_t>(stream));
}
