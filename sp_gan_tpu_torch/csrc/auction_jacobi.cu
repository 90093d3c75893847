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
// Design: one thread block per cloud pair (grid = B), looping over its
// rounds inside the kernel, d in device memory (a 16 MB pair at N = 2048
// stays in the 50 MB L2 while few pairs run). The state lives in shared
// memory: price [M] f32, owner [M] int32, the best bid of each item in the
// round [M] (64 bits), the inverse item_of [N] int32 (a row is unassigned
// iff item_of < 0; the TPU kernel recovers that from owner with an [N, M]
// compare) and the round's list of unassigned rows [N]; 48 KB at
// N = M = 2048. A round:
//   1. the unassigned rows are listed (their count is the round-start flag
//      of the TPU kernel: the round after convergence runs with no bidder);
//   2. a warp per unassigned row scans its M columns for its best item and
//      bid, and offers the bid with one shared-memory atomicMax on the
//      item's 64-bit key. Jacobi: key = (the bid's orderable bits << 32) |
//      (~row), so the highest bid wins and a tie goes to the lowest row.
//      Packed: key = the TPU kernel's int32 (bid bits & hi) | row, so a
//      tie goes to the highest row, as its max reduce does;
//   3. a thread per item with a bid moves the item to the winner, evicts
//      the previous owner (a row that owned an item did not bid, and the
//      winners of two items are two rows, so the writes never collide) and
//      adds the bid to the price.
// A max is order-free, so the result does not depend on the order in which
// warps offer their bids.
//
// What bounds it on an H100: the work depends on the data. A round reads
// the nu bidding rows of d (nu * M * 4 bytes) and does about three
// operations per element read, so by the card's rates it is bound by bytes
// over all pairs in flight. In practice one block per pair runs its rounds
// one after another: a round's latency (a row scan, four barriers) bounds a
// pair, and B pairs fill only B of the 132 SMs.
#include "auction_common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned long long kNoBid = 0ull;
constexpr int kSmall = -0x7fffffff;  // the packed kernel's SMALL

// uint32 image of a float that orders like the float, and its inverse
__device__ __forceinline__ unsigned orderable_u(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_orderable_u(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// max(x, 0) that keeps NaN, as jnp.maximum does for the packed values
__device__ __forceinline__ float clamp0(float x) { return x < 0.f ? 0.f : x; }

template <bool PACKED>
__global__ void __launch_bounds__(kThreads)
    jacobi_kernel(const float* __restrict__ d, int32_t* __restrict__ asg,
                  int32_t* __restrict__ rounds,
                  long long* __restrict__ bidders, int N, int M, int phases,
                  spgan::PhaseEps eps, int iters, int bits) {
  extern __shared__ unsigned long long smem64[];
  unsigned long long* key = smem64;                       // [M]
  int* key32 = reinterpret_cast<int*>(smem64);            // [M], packed
  float* price = reinterpret_cast<float*>(smem64 + M);    // [M]
  int32_t* owner = reinterpret_cast<int32_t*>(price + M);  // [M]
  int32_t* item_of = owner + M;                           // [N]
  int32_t* urow = item_of + N;                            // [N]
  __shared__ int s_nu, s_flag, s_it;
  __shared__ long long s_bids;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* dp = d + (size_t)blockIdx.x * N * M;
  const int low = (1 << bits) - 1, hi = ~low;

  for (int m = t; m < M; m += kThreads) {
    price[m] = 0.f;
    if (PACKED)
      key32[m] = kSmall;
    else
      key[m] = kNoBid;
  }
  if (t == 0) {
    s_it = 0;
    s_bids = 0;
  }
  for (int p = 0; p < phases; ++p) {
    const float eps_p = eps.v[p];
    __syncthreads();  // every thread has left the last phase's loop
    for (int m = t; m < M; m += kThreads) owner[m] = -1;
    for (int r = t; r < N; r += kThreads) item_of[r] = -1;
    if (t == 0) s_flag = N;
    __syncthreads();
    while (s_flag > 0 && s_it < iters) {
      // 1. the unassigned rows
      if (t == 0) s_nu = 0;
      __syncthreads();
      for (int r0 = 0; r0 < N; r0 += kThreads) {
        const int r = r0 + t;
        const bool u = r < N && item_of[r] < 0;
        const unsigned mask = __ballot_sync(0xffffffffu, u);
        int base = 0;
        if (lane == 0 && mask) base = atomicAdd(&s_nu, __popc(mask));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (u) urow[base + __popc(mask & ((1u << lane) - 1u))] = r;
      }
      __syncthreads();
      const int nu = s_nu;

      // 2. each unassigned row offers its bid on its best item
      for (int u = warp; u < nu; u += kWarps) {
        const int r = urow[u];
        const float* row = dp + (size_t)r * M;
        if (!PACKED) {
          float b, s;
          int bi;
          spgan::row_top2(row, price, M, lane, b, bi, s);
          if (lane == 0) {
            const float bid = __fadd_rn(__fsub_rn(b, s), eps_p);
            atomicMax(&key[bi],
                      ((unsigned long long)orderable_u(bid) << 32) |
                          (unsigned)~(unsigned)r);
          }
        } else {
          // the two smallest packed values (bits of max(d + price, 0) with
          // the column in the low bits) of the row
          int m1 = 0x7fffffff, m2 = 0x7fffffff;
#pragma unroll 4
          for (int m = lane; m < M; m += 32) {
            const float uv = clamp0(__fadd_rn(__ldg(row + m), price[m]));
            const int pk = (__float_as_int(uv) & hi) | m;
            if (pk < m1) {
              m2 = m1;
              m1 = pk;
            } else if (pk < m2) {
              m2 = pk;
            }
          }
          for (int off = 16; off > 0; off >>= 1) {
            const int o1 = __shfl_xor_sync(0xffffffffu, m1, off);
            const int o2 = __shfl_xor_sync(0xffffffffu, m2, off);
            m2 = min(max(m1, o1), min(m2, o2));
            m1 = min(m1, o1);
          }
          if (lane == 0) {
            const float best_u = __int_as_float(m1 & hi);
            const float second_u = __int_as_float(m2 & hi);
            const float bid = __fadd_rn(__fsub_rn(second_u, best_u), eps_p);
            atomicMax(&key32[m1 & low],
                      (__float_as_int(clamp0(bid)) & hi) | r);
          }
        }
      }
      __syncthreads();

      // 3. each item with a bid goes to its winner
      for (int m = t; m < M; m += kThreads) {
        int winner;
        float bid;
        if (PACKED) {
          const int pm = key32[m];
          if (pm == kSmall) continue;
          key32[m] = kSmall;
          winner = pm & low;
          bid = __int_as_float(pm & hi);
        } else {
          const unsigned long long k = key[m];
          if (k == kNoBid) continue;
          key[m] = kNoBid;
          winner = (int)~(unsigned)(k & 0xffffffffull);
          bid = from_orderable_u((unsigned)(k >> 32));
        }
        const int prev = owner[m];
        if (prev >= 0) item_of[prev] = -1;
        owner[m] = winner;
        item_of[winner] = m;
        price[m] = __fadd_rn(price[m], bid);
      }
      __syncthreads();

      // 4. the round-start flag, the round counter and the bidders
      if (t == 0) {
        s_flag = nu;
        s_it += 1;
        s_bids += nu;
      }
      __syncthreads();
    }
  }

  spgan::forced_pass(dp, item_of, price, asg + (size_t)blockIdx.x * N, N, M,
                     warp, kWarps, lane);
  if (t == 0) {
    rounds[blockIdx.x] = s_it;
    bidders[blockIdx.x] = s_bids;
  }
}

}  // namespace

// d [B, N, M] f32 contiguous on the device; asg [B, N] int32, rounds [B]
// int32, bidders [B] int64. eps_host: the f32 eps of each of the `phases`
// phases, on the host. `iters` caps the rounds over all phases; `packed`
// selects the packed mode. Launches on `stream` and returns the first
// nonzero cudaError_t (0 on success). Needs 16 M + 8 N bytes of shared
// memory.
extern "C" int spgan_auction_jacobi(const void* d, void* asg, void* rounds,
                                    void* bidders, int B, int N, int M,
                                    int phases, const void* eps_host,
                                    int iters, int packed, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0 || phases <= 0 ||
      phases > spgan::kMaxPhases || iters < 0)
    return (int)cudaErrorInvalidValue;
  spgan::PhaseEps eps;
  const float* e = static_cast<const float*>(eps_host);
  for (int p = 0; p < spgan::kMaxPhases; ++p)
    eps.v[p] = p < phases ? e[p] : 0.f;
  // low bits of a packed value: max((max(N, M) - 1).bit_length(), 1)
  const int span = (N > M ? N : M) - 1;
  int bits = 0;
  while (bits < 31 && (span >> bits)) ++bits;
  if (bits < 1) bits = 1;
  const size_t smem = 16 * (size_t)M + 8 * (size_t)N;
  auto kernel = packed ? jacobi_kernel<true> : jacobi_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<int32_t*>(asg),
      static_cast<int32_t*>(rounds), static_cast<long long*>(bidders), N, M,
      phases, eps, iters, bits);
  return (int)cudaGetLastError();
}
