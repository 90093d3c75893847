// Kernel O: the Jacobi EMD auction with eps-scaling and a forced final
// pass, in two modes. d [B, N, M] f32 squared distances -> assignment
// [B, N] int32, the rounds each pair ran, [B] int32, and the rows that bid
// summed over those rounds, [B] int64.
//
// Replaces the TPU kernel sp_gan_tpu/ops/pallas/auction.py::
// auction_assignment_pallas in mode "jacobi" (_auction_kernel) and mode
// "packed" (_auction_kernel_packed). The algorithm is spelled out in
// ops/kernels/auction_jacobi.py; its plain version there runs the same
// f32 and int32 operations, so the two agree bit for bit.
//
// Design: kernel E's round engine (auction.cu, auction_common.cuh). A
// Jacobi round is E's round with every unassigned row bidding, against
// the prices at the round's start. One block of 16 warps per pair, or,
// where the pairs leave the SMs room (B * 4 <= SMs) and M splits into
// whole float4 slots, a cluster of 4 blocks that each scan a quarter of
// the columns. The state sits in each block's shared memory and stays
// equal across the cluster: price [M], owner [M], the bid keys [M] (64
// bits) and the list of unassigned rows [N], kept incrementally (the
// phase starts it at 0..N-1; a round leaves it its losers, then the
// owners its winners evicted), so its length is the round-start flag and
// no round rescans the owners. A round:
//
//   scan   spgan::scan_rows: groups of G warps walk the listed rows, float4
//          loads, kRows rows in flight a group; a lane keeps (best, index,
//          second) of -d - price (jacobi) or the two smallest packed values
//          of max(d + price, 0) (packed); a warp's partial goes into the
//          shared memory of each of the cluster's blocks (two sets, by the
//          parity of the barrier, so that one barrier keeps a block from
//          overwriting what a slower one still reads).
//   B1     the cluster's barrier (__syncthreads without a cluster).
//   pick   nu <= 32: one warp under __syncwarp. Lane u merges row u's
//          partials into its item and bid, kept in registers; the bids
//          meet by shuffles: jacobi, the highest bid wins, a tie to the
//          lowest row; packed, the highest (bid bits & hi) | row, so a tie
//          goes to the highest row. Winners hold distinct items, so they
//          evict, take and raise the price without conflict, and ballots
//          write the next list.
//          nu > 32 (the first round of every phase has all N rows
//          bidding): the rows go through the scan and B1 in chunks of the
//          P rows whose partials fit; after each chunk a thread per row
//          offers its bid with one shared-memory atomicMax on its item's
//          64-bit key (jacobi: orderable bid bits, then 0x7fff - row,
//          then the row's place u in the list; packed: the int32 key with
//          its sign bit flipped, then u). Then one walk of the items in
//          order moves each item with a bid to the winner named by its
//          key and lists the evicted owners, and one walk of the list
//          keeps the losers, both by block-wide ballots, so that every
//          block of a cluster builds the same list.
//   B2     __syncthreads.
//
// The forced final pass (owned rows take their item, the rest argmin of
// d + price, the lowest index) runs in the same kernel, a warp per row,
// the cluster's blocks sharing the rows (spgan::forced_pass_vec).
//
// Exactness: max, min and compare are exact; the only rounded operations
// are -d - price, best - second, + eps_p, d + price, price + bid and the
// clamps, each an explicit __fsub_rn / __fadd_rn in the plain version's
// order. A row's (best, index, second) and its two smallest packed values
// are those of its columns however they are split over lanes, warps and
// blocks and merged (auction_common.cuh), so they do not depend on G, on
// the rows in flight or on the cluster. Each item's winner is the maximum
// of its bids' keys in a total order (rows differ, so two keys never
// tie): the shuffles and the atomicMax reach the same winner in any order
// of the bidders, the order of the list and of the chunks included. So
// the round's result is the plain version's. The list's order never
// reaches a result; it is still built by ballots in a fixed order, since
// the blocks of a cluster must agree on which row sits at which place.
// -0 is mapped to +0 before a jacobi bid becomes a key (the plain version
// compares floats, where -0 == +0).
//
// What bounds it on an H100: the work depends on the data. A round reads
// the nu bidding rows of d (nu * M * 4 bytes) and does about three
// operations per element read, so by the card's rates it is bound by
// operations over all pairs in flight. The rounds of a pair run one after
// another, about 20 bidders a round at the metric protocol's regime, so a
// round's latency bounds a pair: one wave of loads, the cluster barrier
// and the pick.
#include <algorithm>

#include "auction_common.cuh"

namespace {

using spgan::kMaxPhases;
using spgan::PhaseEps;

constexpr int kWarps = spgan::kAuctionWarps;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;     // rows in flight a group of warps
constexpr int kRegPick = 32;  // the most bidders the one-warp pick takes
constexpr int kPosBits = 15;  // rows and list places in a 64-bit key
constexpr unsigned long long kNoBid = 0ull;
constexpr int kSmall = -0x7fffffff;  // the packed kernel's SMALL
constexpr float kHasBid = -5e29f;   // the plain version's NEG * 0.5

// uint32 image of a float that orders like the float, and its inverse
__device__ __forceinline__ unsigned orderable_u(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable_u(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// The place of this thread's flag among the block's set flags (in thread
// order) and their count. Every thread of the block calls it; two
// barriers.
__device__ __forceinline__ int block_rank(bool f, int* s_cnt, int warp,
                                          int lane, int& total) {
  const unsigned b = __ballot_sync(0xffffffffu, f);
  if (lane == 0) s_cnt[warp] = __popc(b);
  __syncthreads();
  int before = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_cnt[w];
    before += w < warp ? c : 0;
    tot += c;
  }
  __syncthreads();
  total = tot;
  return before + __popc(b & ((1u << lane) - 1u));
}

template <bool PACKED, bool kVec, int kCS>
__global__ void __launch_bounds__(kThreads, 1)
    jacobi_kernel(const float* __restrict__ d, int32_t* __restrict__ asg,
                  int32_t* __restrict__ rounds,
                  long long* __restrict__ bidders, int N, int M, int phases,
                  PhaseEps eps, int iters, int bits, int G, int P) {
  constexpr int PW = PACKED ? 2 : 3;
  extern __shared__ __align__(16) unsigned long long smem64[];
  unsigned long long* key = smem64;                         // [M]
  float* price = reinterpret_cast<float*>(smem64 + M);      // [M]
  int32_t* owner = reinterpret_cast<int32_t*>(price + M);   // [M]
  int32_t* ulist = owner + M;                               // [N]
  // the partials: two parities of PW planes [P][S] int32 (jacobi: best
  // bits, index, second bits; packed: m1, m2), then spare
  int32_t* parts = ulist + ((N + 3) & ~3);
  __shared__ int s_nu;
  __shared__ int s_cnt[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int pair = blockIdx.x / kCS, crank = blockIdx.x - pair * kCS;
  const int slots = kCS > 1 ? M / (4 * kCS) : (M + 3) / 4;
  const int base = crank * slots;
  const int S = kCS * G;  // partials a row
  const int plane = P * S, half = PW * plane;
  const float* dp = d + (size_t)pair * N * M;
  const int low = (1 << bits) - 1, hi = ~low;

  for (int m = t; m < M; m += kThreads) {
    key[m] = kNoBid;
    price[m] = 0.f;
  }
  // every block of the cluster runs before any stores into another's
  if constexpr (kCS > 1) cooperative_groups::this_cluster().sync();

  auto barrier = [] {
    if constexpr (kCS > 1)
      cooperative_groups::this_cluster().sync();
    else
      __syncthreads();
  };

  spgan::Min2 min2_proto;
  min2_proto.hi = hi;
  // the scan of the list's rows c0 .. c0 + cn into parity `par`
  auto scan = [&](int c0, int cn, int par) {
    int32_t* pa = parts + par * half;
    long long t_cols, t_parts;
    auto row_of = [&](int u) { return ulist[c0 + u]; };
    if constexpr (PACKED) {
      spgan::scan_rows<spgan::Min2, kVec, kRows>(
          dp, price, cn, M, base, slots, G, warp, lane, min2_proto, row_of,
          [&](int u, int wg, const spgan::Min2& a) {
            const int at = u * S + crank * G + wg;
            spgan::store_all<kCS>(pa + at, a.m1);
            spgan::store_all<kCS>(pa + plane + at, a.m2);
          },
          false, t_cols, t_parts);
    } else {
      spgan::scan_rows<spgan::Top2, kVec, kRows>(
          dp, price, cn, M, base, slots, G, warp, lane, spgan::Top2{},
          row_of,
          [&](int u, int wg, const spgan::Top2& a) {
            const int at = u * S + crank * G + wg;
            spgan::store_all<kCS>(pa + at, __float_as_int(a.b));
            spgan::store_all<kCS>(pa + plane + at, a.i);
            spgan::store_all<kCS>(pa + 2 * plane + at, __float_as_int(a.s));
          },
          false, t_cols, t_parts);
    }
  };

  // row u's bid from its S partials in parity `par`: its item, the bid as
  // added to the price, and the key that orders it (packed: the int32
  // (bid bits & hi) | row; jacobi: the bid itself, the row breaking ties)
  auto bid_of = [&](int u, int par, float eps_p, int& item, float& val,
                    int& pk) {
    const int* pa = parts + par * half + u * S;
    if constexpr (PACKED) {
      spgan::Min2 a;
      a.m1 = pa[0];
      a.m2 = pa[plane];
#pragma unroll
      for (int g = 1; g < kWarps; ++g)
        if (g < S) a.merge(pa[g], pa[plane + g]);
      item = a.m1 & low;
      const float best_u = __int_as_float(a.m1 & hi);
      const float second_u = __int_as_float(a.m2 & hi);
      const float bid = __fadd_rn(__fsub_rn(second_u, best_u), eps_p);
      pk = __float_as_int(spgan::clamp0(bid)) & hi;  // the row is or'ed in
      val = __int_as_float(pk);
    } else {
      float b, s;
      spgan::top2_of_parts(reinterpret_cast<const float*>(pa), pa + plane,
                           reinterpret_cast<const float*>(pa + 2 * plane), S,
                           b, item, s);
      val = __fadd_rn(__fsub_rn(b, s), eps_p);
      pk = 0;
    }
  };

  // nu <= kRegPick, warp 0: the bids meet by shuffles; writes the next
  // list (losers, then evicted owners) and s_nu
  auto pick_warp = [&](int nu, int par, float eps_p) {
    int item = -1, r = -1, pk = 0;
    float val = 0.f;
    bool win = false;
    if (lane < nu) {
      r = ulist[lane];
      bid_of(lane, par, eps_p, item, val, pk);
      pk |= r;
      win = PACKED ? pk > kSmall : val > kHasBid;
    }
    for (int x = 0; x < nu; ++x) {
      const int ix = __shfl_sync(0xffffffffu, item, x);
      if constexpr (PACKED) {
        const int kx = __shfl_sync(0xffffffffu, pk, x);
        win = win && !(ix == item && kx > pk);
      } else {
        const float vx = __shfl_sync(0xffffffffu, val, x);
        const int rx = __shfl_sync(0xffffffffu, r, x);
        win = win && !(ix == item && (vx > val || (vx == val && rx < r)));
      }
    }
    int prev = -1;
    if (win) {
      prev = owner[item];
      owner[item] = r;
      price[item] = __fadd_rn(price[item], val);
    }
    const unsigned lose = __ballot_sync(0xffffffffu, lane < nu && !win);
    const unsigned ev = __ballot_sync(0xffffffffu, prev >= 0);
    const unsigned below = (1u << lane) - 1u;
    const int nl = __popc(lose);
    __syncwarp();  // every lane has read its row of the list
    if (lane < nu && !win) ulist[__popc(lose & below)] = r;
    if (prev >= 0) ulist[nl + __popc(ev & below)] = prev;
    if (lane == 0) s_nu = nl + __popc(ev);
  };

  // thread t < cn of chunk c0: row c0 + t offers its bid on its item
  auto offer = [&](int c0, int cn, int par, float eps_p) {
    if (t >= cn) return;
    const int u = c0 + t, r = ulist[u];
    int item, pk;
    float val;
    bid_of(t, par, eps_p, item, val, pk);
    unsigned long long k;
    if constexpr (PACKED) {
      pk |= r;
      if (!(pk > kSmall)) return;
      k = ((unsigned long long)((unsigned)pk ^ 0x80000000u) << 32) |
          (unsigned)u;
    } else {
      if (!(val > kHasBid)) return;
      const float v0 = val == 0.f ? 0.f : val;  // -0 as +0
      k = ((unsigned long long)orderable_u(v0) << 32) |
          ((unsigned)((1 << kPosBits) - 1 - r) << kPosBits) | (unsigned)u;
    }
    atomicMax(&key[item], k);
  };

  // nu > kRegPick, after the keys are final: each item with a bid to its
  // winner; the next list (evicted owners, then losers) built in `scratch`
  // and copied back; writes s_nu
  auto resolve_keys = [&](int nu, int* scratch) {
    int ne = 0;
    for (int m0 = 0; m0 < M; m0 += kThreads) {
      const int m = m0 + t;
      const unsigned long long k = m < M ? key[m] : kNoBid;
      int prev = -1;
      if (k != kNoBid) {
        key[m] = kNoBid;
        const int u = (int)(k & ((1u << kPosBits) - 1u));
        const unsigned kh = (unsigned)(k >> 32);
        const float bid = PACKED ? __int_as_float((int)(kh ^ 0x80000000u) & hi)
                                 : from_orderable_u(kh);
        prev = owner[m];
        owner[m] = ulist[u];
        price[m] = __fadd_rn(price[m], bid);
        ulist[u] = -1;  // won
      }
      int tot;
      const int at = block_rank(prev >= 0, s_cnt, warp, lane, tot);
      if (prev >= 0) scratch[ne + at] = prev;
      ne += tot;
    }
    int nl = 0;
    for (int u0 = 0; u0 < nu; u0 += kThreads) {
      const int u = u0 + t;
      const int r = u < nu ? ulist[u] : -1;
      int tot;
      const int at = block_rank(r >= 0, s_cnt, warp, lane, tot);
      if (r >= 0) scratch[ne + nl + at] = r;
      nl += tot;
    }
    __syncthreads();
    for (int i = t; i < ne + nl; i += kThreads) ulist[i] = scratch[i];
    if (t == 0) s_nu = ne + nl;
  };

  int par = 0;             // the parity of the next barrier's partials
  int it = 0;              // rounds so far, the same in every thread
  long long bids = 0;      // bidders so far
  for (int p = 0; p < phases; ++p) {
    const float eps_p = eps.v[p];
    __syncthreads();  // the last phase's round is over in every warp
    for (int m = t; m < M; m += kThreads) owner[m] = -1;
    for (int r = t; r < N; r += kThreads) ulist[r] = r;
    __syncthreads();
    int nu = N, flag = N;
    while (flag > 0 && it < iters) {
      flag = nu;
      it += 1;
      bids += nu;
      if (nu <= min(kRegPick, P)) {
        scan(0, nu, par);
        barrier();  // B1
        if (warp == 0) pick_warp(nu, par, eps_p);
        par ^= 1;
      } else {
        for (int c0 = 0; c0 < nu; c0 += P) {
          const int cn = min(P, nu - c0);
          scan(c0, cn, par);
          barrier();  // B1 of the chunk
          offer(c0, cn, par, eps_p);
          par ^= 1;
        }
        __syncthreads();  // the keys are final
        // the last chunk's parity is free until the next barrier; the
        // other may already take the next round's partials from the
        // cluster. A block alone uses both.
        resolve_keys(nu, kCS > 1 ? parts + (par ^ 1) * half : parts);
      }
      __syncthreads();  // B2
      nu = s_nu;
    }
  }

  // no block leaves while another may still store into it
  if constexpr (kCS > 1) cooperative_groups::this_cluster().sync();

  // forced final pass: item_of in the list's place, owned rows take their
  // item, the rest the argmin of d + price (lowest index); a cluster's
  // blocks share the rows
  int32_t* item_of = ulist;
  for (int r = t; r < N; r += kThreads) item_of[r] = -1;
  __syncthreads();
  for (int m = t; m < M; m += kThreads)
    if (owner[m] >= 0) item_of[owner[m]] = m;
  __syncthreads();
  spgan::forced_pass_vec<kVec>(dp, item_of, price, asg + (size_t)pair * N,
                               N, M, crank * kWarps + warp, kCS * kWarps,
                               lane);
  if (t == 0 && crank == 0) {
    rounds[pair] = it;
    bidders[pair] = bids;
  }
}

template <bool PACKED, bool kVec, int kCS>
cudaError_t launch(const float* d, int32_t* asg, int32_t* rounds,
                   long long* bidders, int B, int N, int M, int phases,
                   const PhaseEps& eps, int iters, int bits, int G, int P,
                   size_t smem, cudaStream_t st) {
  auto* kernel = jacobi_kernel<PACKED, kVec, kCS>;
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
  err = cudaLaunchKernelEx(&cfg, kernel, d, asg, rounds, bidders, N, M,
                           phases, eps, iters, bits, G, P);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool PACKED>
cudaError_t launch_mode(const float* d, int32_t* asg, int32_t* rounds,
                        long long* bidders, int B, int N, int M, int phases,
                        const PhaseEps& eps, int iters, int bits,
                        cudaStream_t st) {
  constexpr int PW = PACKED ? 2 : 3;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, jacobi_kernel<PACKED, true, 4>);
  if (err != cudaSuccess) return err;
  // key, price, owner [M]; the list [N], padded to 16 bytes
  const size_t state = 16 * (size_t)M + 4 * (size_t)((N + 3) & ~3);
  if (state + fa.sharedSizeBytes + 4 * (size_t)N > (size_t)optin)
    return cudaErrorInvalidValue;
  const size_t avail = optin - fa.sharedSizeBytes - state;
  // rows a chunk whose partials (S a row, both parities) fit
  auto rows_fit = [&](int S) {
    return (int)std::min<size_t>(kThreads, avail / (8 * PW * (size_t)S));
  };
  // G warps to a row: the fewest whose lanes' kSlots float4 cover the
  // block's M / cs columns (as kernel E takes them)
  auto warps_a_row = [M](int cs) {
    int G = 1;
    while (G < kWarps && 128 * spgan::kSlots * G * cs < M) G *= 2;
    return G;
  };
  const bool vec = M % 4 == 0 && reinterpret_cast<uintptr_t>(d) % 16 == 0;
  // a cluster of 4 blocks a pair where the pairs leave the SMs room, the
  // columns split into whole float4 slots, the one-warp pick fits and a
  // parity's partials can hold the next list
  const int G4 = warps_a_row(4);
  const int P4 = rows_fit(4 * G4);
  const bool cluster = vec && M % 16 == 0 && (int64_t)B * 4 <= sms &&
                       G4 * 4 <= kWarps && P4 >= kRegPick &&
                       (int64_t)PW * P4 * 4 * G4 >= N;
  int G = cluster ? G4 : warps_a_row(1), P = cluster ? P4 : rows_fit(G);
  while (!cluster && G > 1 && P < kRegPick) P = rows_fit(G /= 2);
  if (P < 1) return cudaErrorInvalidValue;
  // the partials, or the next list where it is longer (a block alone)
  const size_t parts = std::max<size_t>(8 * PW * (size_t)P * G *
                                            (cluster ? 4 : 1),
                                        4 * (size_t)N);
  const size_t smem = state + parts;
  if (cluster)
    return launch<PACKED, true, 4>(d, asg, rounds, bidders, B, N, M, phases,
                                   eps, iters, bits, G, P, smem, st);
  if (vec)
    return launch<PACKED, true, 1>(d, asg, rounds, bidders, B, N, M, phases,
                                   eps, iters, bits, G, P, smem, st);
  return launch<PACKED, false, 1>(d, asg, rounds, bidders, B, N, M, phases,
                                  eps, iters, bits, G, P, smem, st);
}

}  // namespace

// d [B, N, M] f32 contiguous on the device; asg [B, N] int32, rounds [B]
// int32, bidders [B] int64. eps_host: the f32 eps of each of the `phases`
// phases, on the host. `iters` caps the rounds over all phases; `packed`
// selects the packed mode. Launches on `stream` and returns the first
// nonzero cudaError_t (0 on success). Needs 16 M + 8 N bytes of shared
// memory and N <= 2^15.
extern "C" int spgan_auction_jacobi(const void* d, void* asg, void* rounds,
                                    void* bidders, int B, int N, int M,
                                    int phases, const void* eps_host,
                                    int iters, int packed, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || N > (1 << kPosBits) || phases <= 0 ||
      phases > kMaxPhases || iters < 0)
    return (int)cudaErrorInvalidValue;
  PhaseEps eps;
  const float* e = static_cast<const float*>(eps_host);
  for (int p = 0; p < kMaxPhases; ++p) eps.v[p] = p < phases ? e[p] : 0.f;
  // low bits of a packed value: max((max(N, M) - 1).bit_length(), 1)
  const int span = (N > M ? N : M) - 1;
  int bits = 0;
  while (bits < 31 && (span >> bits)) ++bits;
  if (bits < 1) bits = 1;
  const float* dd = static_cast<const float*>(d);
  int32_t* a = static_cast<int32_t*>(asg);
  int32_t* r = static_cast<int32_t*>(rounds);
  long long* u = static_cast<long long*>(bidders);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(packed ? launch_mode<true>(dd, a, r, u, B, N, M, phases, eps,
                                          iters, bits, st)
                      : launch_mode<false>(dd, a, r, u, B, N, M, phases, eps,
                                           iters, bits, st));
}
