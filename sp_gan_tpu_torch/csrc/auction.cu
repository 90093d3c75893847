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
// Design: one thread block of 16 warps per cloud pair (grid = B). The
// solver state lives in shared memory: price [M] f32, owner [M] int32, the
// inverse item_of [N] int32 (a row is unassigned iff item_of < 0; the TPU
// kernel recovers that from owner with an [w, M] compare) and the
// per-block unassigned counts [N / w] int32; 24 KB at N = M = 2048, 193 KB
// at N = M = 16384 (dynamic shared memory above 48 KB). d stays in device
// memory: at N = 2048 neither a pair's 16 MB nor the [w, M] block of a
// round (512 KB) fits a block's 227 KB, and the rows of a round are read
// once each, coalesced, so shared memory would not save a read.
//
// What bounds it on an H100: the rounds of a pair run one after another
// (Gauss-Seidel), and a round reads only the nu bidding rows of d (3.5 a
// round at the metric protocol's launch, 8-20 in --mix's): far too little
// work to fill a block, let alone the card. So the latency of one round
// bounds a pair, and a launch of B pairs takes about the slowest pair's
// rounds times that latency. The design cuts a round to one wave of
// loads and two block barriers; measured on the H100 (chip_smoke.py's
// `launch_e(prof=)` split) the round is then bound by the scan's
// instructions and the serial pick, not by memory:
//
//   scan   the rows are split over groups of G warps (G = 4 at M = 2048:
//          four groups), each lane holding four 16-byte float4 loads of a
//          row, several rows in flight per group, every load issued before
//          any value is used; each lane keeps (best, index, second) of its
//          columns (top2_take), the warp merges them by shuffles and lane
//          0 writes the warp's partial to shared memory (spgan::scan_rows
//          in auction_common.cuh, which kernel O runs too).
//   B1     __syncthreads.
//   pick   when nu <= 32 one warp, under __syncwarp only: lane u merges
//          row u's G partials (top2_merge is exact and order-free) into the
//          bid (best - second) + eps_p, kept in its registers; each bidder
//          wins unless another bidder on its item bid more, or as much from
//          a lower row (the bids meet by shuffles);
//          winners hold distinct items, so they apply their evictions,
//          owners, prices and (integer atomic) count changes without
//          conflict; ballots count the accepted bids and evictions, and
//          the warp keeps the total, the round counter and the bidder sum
//          in registers; it picks the next active block from the cursor (a
//          ballot over the counts, 32 blocks at a time) and lists its
//          unassigned rows. With nu > 32 the merge and the resolve take
//          two warps and two more barriers.
//   B2     __syncthreads.
//
// Where the pairs leave the SMs room (B * 4 <= 132, as in --mix's [24,
// 2048, 2048]), a pair takes a cluster of 4 blocks: each scans its
// quarter of the columns of every bidding row and
// stores its partials into every block's shared memory (distributed
// shared memory, stores that need no answer); B1 is the cluster's
// barrier, after which every block runs the same merge, resolve and pick
// on its own copy of the state, so the copies stay equal with no more
// traffic. The partials come in two sets, by the round's parity, so that
// one barrier a round keeps a block from overwriting what a slower one
// still reads. The result is the same: each block scans whole float4
// slots, and the merge is order-free.
//
// The forced final pass (owned rows take their item, the rest argmin of
// d + price) runs in the same kernel, a warp per row, float4 loads.
//
// Exactness: max and compare are exact; the only rounded operations are
// -d - price, best - second, + eps_p, d + price and price + bid, each an
// explicit __fsub_rn / __fadd_rn, the order of the plain version. The
// (best, index, second) of a row does not depend on how its columns are
// split or merged, and integer atomics on counts are order-free. So the
// result does not depend on the scheduling of warps, on G or on the rows
// in flight, nor on the cluster. M not a multiple of 4, or a d not 16-byte
// aligned, takes the same code with scalar loads, one block a pair.
//
// Three variants, by what the launch leaves the SMs: a cluster of 4 blocks
// a pair with B * 4 <= 132 SMs (R3's 24 pairs, the checks' 2-4); else two
// blocks an SM (64 registers a thread, one row in flight a group), as at
// the metric protocol's 256 pairs; and the scalar loads, one block an SM.
//
// The byte and operation bound: a round reads the nu bidding rows of d
// (nu * M * 4 bytes) and does a subtract, a compare and a max per element
// read; each row read again comes from device memory (a pair's d is 16 MB
// at N = 2048), so with the card full of pairs the rounds share its 3.35
// TB/s.
#include "auction_common.cuh"

namespace {

using spgan::kMaxPhases;
using spgan::PhaseEps;

constexpr int kWarps = spgan::kAuctionWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxW = 64;
using spgan::kSlots;

template <bool kVec, int kRows, int kMinBlocks, int kCS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    auction_kernel(const float* __restrict__ d, int32_t* __restrict__ asg,
                   int32_t* __restrict__ rounds,
                   long long* __restrict__ bidders, int N, int M, int w,
                   int G, int phases, PhaseEps eps, long long cap,
                   long long* __restrict__ prof) {
  extern __shared__ __align__(16) int32_t smem[];
  float* price = reinterpret_cast<float*>(smem);  // [M]
  int32_t* owner = smem + M;                      // [M]
  int32_t* item_of = owner + M;                   // [N]
  int32_t* cnt = item_of + N;                     // [N / w]
  __shared__ int32_t urow[kMaxW];   // unassigned rows of the block, local
  __shared__ int32_t bid_item[kMaxW];
  __shared__ float bid_val[kMaxW];
  // each row's partials, a warp's; two sets, by the round's parity, so
  // that a cluster's blocks read a round's while they write the next's
  __shared__ float part_b[2][kMaxW][kWarps];
  __shared__ int part_i[2][kMaxW][kWarps];
  __shared__ float part_s[2][kMaxW][kWarps];
  __shared__ int s_go, s_j, s_nu, s_acc, s_ev;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nb = N / w;
  // kCS > 1: a cluster of kCS blocks per pair, block `crank` scanning the
  // pair's columns [crank, crank + 1) * M / kCS; each block keeps the
  // whole state and runs the same merge, resolve and pick on the same
  // partials, so the states stay equal
  const int pair = blockIdx.x / kCS, crank = blockIdx.x - pair * kCS;
  const int slots = kCS > 1 ? M / (4 * kCS) : (M + 3) / 4;
  const int base = crank * slots;
  const float* dp = d + (size_t)pair * N * M;
  int par = 0;  // the round's parity

  // warp 0: the next active block from the cursor and its unassigned
  // rows, or s_go = 0 when the phase is over; tot and it are warp 0's
  // registers (the same in every lane)
  int cursor = 0;  // warp 0's
  auto pick = [&](int tot, long long it) {
    const bool go = tot > 0 && it < cap;
    if (go) {
      const int start = cursor;
      int j = -1;
      for (int base = 0; base < nb && j < 0; base += 32) {
        int q = start + base + lane;
        q = q >= nb ? q - nb : q;
        const bool act = base + lane < nb && cnt[q] > 0;
        const unsigned mask = __ballot_sync(0xffffffffu, act);
        if (mask) {
          j = start + base + __ffs(mask) - 1;
          j = j >= nb ? j - nb : j;
        }
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
      cursor = j + 1 == nb ? 0 : j + 1;
      if (lane == 0) {
        s_nu = n0 + __popc(m1);
        s_j = j;
        s_acc = 0;
        s_ev = 0;
      }
    }
    if (lane == 0) s_go = go;
  };

  // thread u < nu: row u's bid (item, value) from its kCS * G partials
  auto merge = [&](int u, float eps_p, int& item, float& val) {
    float b, s;
    int bi;
    spgan::top2_of_parts(part_b[par][u], part_i[par][u], part_s[par][u],
                         kCS * G, b, bi, s);
    item = bi;
    val = __fadd_rn(__fsub_rn(b, s), eps_p);
  };

  // bidder u, who won its item: evicts the owner, takes the item, raises
  // its price; returns 1, or 3 if it evicted an owner
  auto take = [&](int u, int item, float val, int rows0) {
    const int prev = owner[item];
    if (prev >= 0) {
      item_of[prev] = -1;
      atomicAdd(&cnt[prev / w], 1);
    }
    const int r = rows0 + urow[u];
    owner[item] = r;
    item_of[r] = item;
    price[item] = __fadd_rn(price[item], val);
    return prev >= 0 ? 3 : 1;
  };

  // each item takes its highest bid, ties to the lowest row: bidder u
  // wins unless bidder x bids more on its item, or as much with x < u
  auto beaten = [](int u, int item, float val, int x, int ix, float vx) {
    return x != u && ix == item && (vx > val || (vx == val && x < u));
  };

  for (int m = t; m < M; m += kThreads) price[m] = 0.f;
  long long it = 0, bids = 0;  // warp 0's: rounds and bidders so far
  // thread 0's clocks: the round's start, its columns done, its partials
  // written, B1; and their sums over the rounds
  long long t0 = 0, t1 = 0, t_cols = 0, t_parts = 0;
  long long s_cols = 0, s_parts = 0, s_wait = 0, s_pick = 0;
  const bool timed = prof != nullptr && t == 0;
  for (int p = 0; p < phases; ++p) {
    const float eps_p = eps.v[p];
    for (int m = t; m < M; m += kThreads) owner[m] = -1;
    for (int r = t; r < N; r += kThreads) item_of[r] = -1;
    for (int q = t; q < nb; q += kThreads) cnt[q] = w;
    int tot = N;  // warp 0's: unassigned rows
    __syncthreads();
    if (warp == 0) pick(tot, it);
    __syncthreads();
    while (s_go) {
      const int j = s_j, rows0 = j * w, nu = s_nu;
      if (timed) t0 = clock64();
      // the scan: each row's partial of warp wg of its group to slot
      // crank * G + wg, in the shared memory of each of the cluster's blocks
      spgan::scan_rows<spgan::Top2, kVec, kRows>(
          dp, price, nu, M, base, slots, G, warp, lane, spgan::Top2{},
          [&](int u) { return rows0 + urow[u]; },
          [&](int u, int wg, const spgan::Top2& a) {
            const int slot = crank * G + wg;
            spgan::store_all<kCS>(&part_b[par][u][slot], a.b);
            spgan::store_all<kCS>(&part_i[par][u][slot], a.i);
            spgan::store_all<kCS>(&part_s[par][u][slot], a.s);
          },
          timed, t_cols, t_parts);
      if constexpr (kCS > 1)
        cooperative_groups::this_cluster().sync();  // B1, cluster-wide
      else
        __syncthreads();  // B1
      if (timed) t1 = clock64();
      if (nu > 32) {
        int item = 0;
        float val = 0.f;
        if (t < nu) {
          merge(t, eps_p, item, val);
          bid_item[t] = item;
          bid_val[t] = val;
        }
        __syncthreads();
        if (t < nu) {
          bool win = true;
          for (int x = 0; x < nu; ++x)
            win = win && !beaten(t, item, val, x, bid_item[x], bid_val[x]);
          const int won = win ? take(t, item, val, rows0) : 0;
          if (won) atomicAdd(&s_acc, 1);
          if (won & 2) atomicAdd(&s_ev, 1);
        }
        __syncthreads();
        if (warp == 0) {
          if (lane == 0) cnt[j] -= s_acc;
          tot += s_ev - s_acc;
        }
      } else if (warp == 0) {
        // the bids stay in the lanes' registers and meet by shuffles
        int item = -1;
        float val = 0.f;
        if (lane < nu) merge(lane, eps_p, item, val);
        bool win = lane < nu;
        for (int x = 0; x < nu; ++x) {
          const int ix = __shfl_sync(0xffffffffu, item, x);
          const float vx = __shfl_sync(0xffffffffu, val, x);
          win = win && !beaten(lane, item, val, x, ix, vx);
        }
        const int won = win ? take(lane, item, val, rows0) : 0;
        const int acc = __popc(__ballot_sync(0xffffffffu, won & 1));
        const int ev = __popc(__ballot_sync(0xffffffffu, won & 2));
        if (lane == 0) cnt[j] -= acc;
        tot += ev - acc;
      }
      if (warp == 0) {
        it += 1;
        bids += nu;
        __syncwarp();
        pick(tot, it);
      }
      __syncthreads();  // B2
      par ^= 1;
      if (timed) {
        s_cols += t_cols - t0;
        s_parts += t_parts - t_cols;
        s_wait += t1 - t_parts;
        s_pick += clock64() - t1;
      }
    }
  }

  // no block leaves while another may still read its partials
  if constexpr (kCS > 1) cooperative_groups::this_cluster().sync();

  // forced final pass: owned rows take their item, the rest the argmin of
  // d + price (lowest index); a cluster's blocks share the rows
  spgan::forced_pass_vec<kVec>(dp, item_of, price,
                               asg + (size_t)pair * N, N, M,
                               crank * kWarps + warp, kCS * kWarps, lane);
  if (t == 0 && crank == 0) {
    rounds[pair] = (int32_t)it;
    bidders[pair] = bids;
    if (timed) {
      prof[4 * pair] = s_cols;
      prof[4 * pair + 1] = s_parts;
      prof[4 * pair + 2] = s_wait;
      prof[4 * pair + 3] = s_pick;
    }
  }
}

template <bool kVec, int kRows, int kMinBlocks, int kCS>
cudaError_t launch(const float* d, int32_t* asg, int32_t* rounds,
                   long long* bidders, int B, int N, int M, int w, int G,
                   int phases, const PhaseEps& eps, long long cap,
                   long long* prof, size_t smem, cudaStream_t st) {
  auto* kernel = auction_kernel<kVec, kRows, kMinBlocks, kCS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kCS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCS > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, d, asg, rounds, bidders, N, M, w, G,
                           phases, eps, cap, prof);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// d [B, N, M] f32, contiguous on the device; asg [B, N] int32, rounds [B]
// int32, bidders [B] int64. `eps_host` holds the phases' eps (f32, host),
// `cap` the block-rounds a pair may run over all phases. `prof`, if not
// null, receives per pair the SM clock cycles its rounds spent, as thread 0
// sees them, in the loads and columns of warp 0's rows, in its warp
// merges, in waiting for the other warps (B1) and from B1 to B2 (the merge
// of the partials, the resolve and the pick), [B, 4] int64. Launches on
// `stream` and returns the first nonzero cudaError_t (0 on success).
extern "C" int spgan_auction(const void* d, void* asg, void* rounds,
                             void* bidders, int B, int N, int M, int w,
                             int phases, const void* eps_host, long long cap,
                             void* prof, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || w <= 0 || w > kMaxW || N % w ||
      phases <= 0 || phases > kMaxPhases || cap < 0)
    return (int)cudaErrorInvalidValue;
  PhaseEps eps;
  const float* e = static_cast<const float*>(eps_host);
  for (int p = 0; p < kMaxPhases; ++p) eps.v[p] = p < phases ? e[p] : 0.f;
  const size_t smem = sizeof(int32_t) * (2 * (size_t)M + N + N / w);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  // G warps to a row: the fewest whose lanes' kSlots float4 cover the
  // block's M / cs columns; a row's cs * G partials fit kWarps slots
  auto warps_a_row = [M](int cs) {
    int G = 1;
    while (G < kWarps && 128 * kSlots * G * cs < M) G *= 2;
    return G;
  };
  // a cluster of 4 blocks a pair where the pairs leave the SMs for them
  // and the columns split into whole float4 slots
  const bool cluster = vec && M % 16 == 0 && (int64_t)B * 4 <= sms &&
                       warps_a_row(4) * 4 <= kWarps;
  const int G = warps_a_row(cluster ? 4 : 1);
  const float* dd = static_cast<const float*>(d);
  int32_t* a = static_cast<int32_t*>(asg);
  int32_t* r = static_cast<int32_t*>(rounds);
  long long* u = static_cast<long long*>(bidders);
  long long* pf = static_cast<long long*>(prof);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the cluster: 16 float4 in flight a lane; else two blocks an SM, at
  // most 64 registers a thread, one row of 4 float4 in flight a lane per
  // group (two spill, and ran 11% slower at the protocol's launch on the
  // H100); scalar loads: one block an SM, 4 rows in flight
  if (cluster)
    err = launch<true, 4, 1, 4>(dd, a, r, u, B, N, M, w, G, phases, eps, cap,
                                pf, smem, st);
  else if (vec)
    err = launch<true, 1, 2, 1>(dd, a, r, u, B, N, M, w, G, phases, eps, cap,
                                pf, smem, st);
  else
    err = launch<false, 4, 1, 1>(dd, a, r, u, B, N, M, w, G, phases, eps,
                                 cap, pf, smem, st);
  return (int)err;
}
