// Kernel E: block Gauss-Seidel EMD auction with eps-scaling and a forced
// final pass. d [B, N, M] f32 squared distances -> assignment [B, N] int32,
// the block-rounds each pair ran, [B] int32, and the rows that bid summed
// over those rounds (the rows of d the rounds scanned), [B] int64.
//
// Replaces the TPU kernels sp_gan_tpu/ops/pallas/auction.py::
// auction_assignment_pallas in mode "blockgs" (_auction_kernel_blockgs,
// d resident in VMEM) and "blockgs_hbm" (_auction_kernel_blockgs_hbm, d in
// HBM, one [w, M] block copied in per round, the forced pass in XLA). The
// algorithm is spelled out in ops/kernels/auction.py; its plain version
// there runs the same f32 operations in the same order, so the two agree
// bit for bit.
//
// Design: one thread block per cloud pair (grid = B). The solver state
// lives in shared memory: price [M] f32, owner [M] int32, the inverse
// item_of [N] int32 (a row is unassigned iff item_of < 0; the TPU kernel
// recovers that from owner with an [w, M] compare) and the per-block
// unassigned counts [N / w] int32; 24 KB at N = M = 2048, 193 KB at
// N = M = 16384 (dynamic shared memory above 48 KB). d stays in device
// memory: at N = 2048 neither a pair's 16 MB nor the [w, M] block of a
// round (512 KB) fits a block's 227 KB, and the rows of a round are read
// once each, coalesced, so shared memory would not save a read.
//
// A block-round:
//   1. warp 0 picks the next active block from the cursor (a ballot over
//      the counts, 32 blocks at a time) and lists its unassigned rows;
//   2. a warp per unassigned row scans the row's M columns (lane l takes
//      l, l + 32, ...) for best = max(-d - price) with the lowest index
//      and second = max over the other columns (floor -1e30), then merges
//      the lanes by shuffles; the bid is (best - second) + eps_p;
//   3. a thread per bidder resolves the <= w bids: it wins unless another
//      bidder on its item bid more, or as much from a lower row. Winners
//      hold distinct items, so they apply their evictions, owners, prices
//      and (integer atomic) count changes without conflict;
//   4. thread 0 updates the bidding block's count, the unassigned total,
//      the round counter and the bidder sum.
// The forced final pass (owned rows take their item, the rest argmin of
// d + price) runs in the same kernel, a warp per row.
//
// Exactness: max and compare are exact; the only rounded operations are
// -d - price, best - second, + eps_p, d + price and price + bid, each an
// explicit __fsub_rn / __fadd_rn, the order of the plain version. Integer
// atomics on counts are order-free. So the result does not depend on the
// scheduling of warps or on the number of threads.
//
// What bounds it on an H100: the work depends on the data. A round reads
// the nu bidding rows of d (nu * M * 4 bytes) and does a subtract, a
// compare and a max per element read, so by the card's rates it is bound
// by bytes (3.35 TB/s) over all pairs in flight. In practice one block
// per pair runs its rounds one after another: a round's latency (a row
// scan, four barriers) bounds a pair, and the card is filled only when
// B is well over the 132 SMs.
#include "auction_common.cuh"

namespace {

using spgan::kMaxPhases;
using spgan::PhaseEps;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 64;

__global__ void __launch_bounds__(kThreads)
    auction_kernel(const float* __restrict__ d, int32_t* __restrict__ asg,
                   int32_t* __restrict__ rounds,
                   long long* __restrict__ bidders, int N, int M, int w,
                   int phases, PhaseEps eps, long long cap) {
  extern __shared__ int32_t smem[];
  float* price = reinterpret_cast<float*>(smem);  // [M]
  int32_t* owner = smem + M;                      // [M]
  int32_t* item_of = owner + M;                   // [N]
  int32_t* cnt = item_of + N;                     // [N / w]
  __shared__ int32_t urow[kMaxW];   // unassigned rows of the block, local
  __shared__ int32_t bid_item[kMaxW];
  __shared__ float bid_val[kMaxW];
  __shared__ int s_go, s_j, s_nu, s_cursor, s_tot, s_acc, s_ev;
  __shared__ long long s_it, s_bids;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nb = N / w;
  const float* dp = d + (size_t)blockIdx.x * N * M;

  for (int m = t; m < M; m += kThreads) price[m] = 0.f;
  if (t == 0) {
    s_it = 0;
    s_bids = 0;
    s_cursor = 0;
  }
  for (int p = 0; p < phases; ++p) {
    const float eps_p = eps.v[p];
    for (int m = t; m < M; m += kThreads) owner[m] = -1;
    for (int r = t; r < N; r += kThreads) item_of[r] = -1;
    for (int q = t; q < nb; q += kThreads) cnt[q] = w;
    if (t == 0) s_tot = N;
    __syncthreads();
    while (true) {
      // 1. the next active block and its unassigned rows
      if (warp == 0) {
        const bool go = s_tot > 0 && s_it < cap;
        int j = -1;
        if (go) {
          const int start = s_cursor;
          for (int base = 0; base < nb && j < 0; base += 32) {
            const int q = base + lane;
            const bool act = q < nb && cnt[(start + q) % nb] > 0;
            const unsigned mask = __ballot_sync(0xffffffffu, act);
            if (mask) j = (start + base + __ffs(mask) - 1) % nb;
          }
          if (j < 0) j = start;
          const int rows0 = j * w;
          const bool u0 = lane < w && item_of[rows0 + lane] < 0;
          const bool u1 = lane + 32 < w && item_of[rows0 + lane + 32] < 0;
          const unsigned m0 = __ballot_sync(0xffffffffu, u0);
          const unsigned m1 = __ballot_sync(0xffffffffu, u1);
          const unsigned below = (1u << lane) - 1u;
          const int n0 = __popc(m0);
          if (u0) urow[__popc(m0 & below)] = lane;
          if (u1) urow[n0 + __popc(m1 & below)] = lane + 32;
          if (lane == 0) {
            s_nu = n0 + __popc(m1);
            s_j = j;
            s_cursor = (j + 1) % nb;
            s_acc = 0;
            s_ev = 0;
          }
        }
        if (lane == 0) s_go = go;
      }
      __syncthreads();
      if (!s_go) break;
      const int j = s_j, rows0 = j * w, nu = s_nu;

      // 2. best, second and the bid of each unassigned row
      for (int u = warp; u < nu; u += kWarps) {
        const float* row = dp + (size_t)(rows0 + urow[u]) * M;
        float b, s;
        int bi;
        spgan::row_top2(row, price, M, lane, b, bi, s);
        if (lane == 0) {
          bid_item[u] = bi;
          bid_val[u] = __fadd_rn(__fsub_rn(b, s), eps_p);
        }
      }
      __syncthreads();

      // 3. each item takes its highest bid, ties to the lowest row
      if (t < nu) {
        const int item = bid_item[t];
        const float v = bid_val[t];
        bool win = true;
        for (int u = 0; u < nu; ++u) {
          if (u != t && bid_item[u] == item &&
              (bid_val[u] > v || (bid_val[u] == v && u < t)))
            win = false;
        }
        if (win) {
          const int prev = owner[item];
          if (prev >= 0) {
            item_of[prev] = -1;
            atomicAdd(&cnt[prev / w], 1);
            atomicAdd(&s_ev, 1);
          }
          const int r = rows0 + urow[t];
          owner[item] = r;
          item_of[r] = item;
          price[item] = __fadd_rn(price[item], v);
          atomicAdd(&s_acc, 1);
        }
      }
      __syncthreads();

      // 4. counts, total and the round counter
      if (t == 0) {
        cnt[j] -= s_acc;
        s_tot += s_ev - s_acc;
        s_it += 1;
        s_bids += nu;
      }
      __syncthreads();
    }
  }

  // forced final pass: owned rows take their item, the rest the argmin of
  // d + price (lowest index)
  spgan::forced_pass(dp, item_of, price, asg + (size_t)blockIdx.x * N, N, M,
                     warp, kWarps, lane);
  if (t == 0) {
    rounds[blockIdx.x] = (int32_t)s_it;
    bidders[blockIdx.x] = s_bids;
  }
}

}  // namespace

extern "C" int spgan_auction(const void* d, void* asg, void* rounds,
                             void* bidders, int B, int N, int M, int w,
                             int phases,
                             const void* eps_host, long long cap,
                             void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || w <= 0 || w > kMaxW || N % w ||
      phases <= 0 || phases > kMaxPhases || cap < 0)
    return (int)cudaErrorInvalidValue;
  PhaseEps eps;
  const float* e = static_cast<const float*>(eps_host);
  for (int p = 0; p < kMaxPhases; ++p) eps.v[p] = p < phases ? e[p] : 0.f;
  const size_t smem = sizeof(int32_t) * (2 * (size_t)M + N + N / w);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auction_kernel<<<B, kThreads, smem, st>>>(
      static_cast<const float*>(d), static_cast<int32_t*>(asg),
      static_cast<int32_t*>(rounds), static_cast<long long*>(bidders), N, M,
      w, phases, eps, cap);
  return (int)cudaGetLastError();
}
