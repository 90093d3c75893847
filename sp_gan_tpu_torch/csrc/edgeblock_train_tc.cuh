// Kernels I, J, K, L and kernel C in bf16 mode on the tensor cores
// (edgeblock_train_tc.cu), called by spgan_ebt_stats2, spgan_ebt_bwd1,
// spgan_ebt_bwd2 and spgan_ebt_bwd3 (edgeblock_train.cu) and by
// spgan_edge_tail (edgeblock.cu) for a bf16 ee; their f32 mode stays in
// those two files (C's on the tensor cores in edgeblock_tf32.cu).
#pragma once

#include <cuda_runtime.h>

// The widths kernels I-L take on either engine: C a multiple of 4, F2 a
// multiple of 4 dividing 256, F in {64, 128}; k from 1 to the engine's own
// limit below; and a tile of one point within a block's shared memory
// (ebt_tc_fits for the tensor cores; for the FMA kernels of
// edgeblock_train.cu, at F = 128 and F2 = 64: I C <= 856, J C <= 856, K C
// <= 760, L C <= 664 at k = 32; I C <= 692, J C <= 564, K C <= 532, L C <=
// 500 at k = 40; I C <= 420, J C <= 292, K C <= 260, L C <= 228 at k = 64).
inline bool ebt_widths_ok(int B, int N, int C, int F2, int F) {
  return B > 0 && N > 0 && C > 0 && C % 4 == 0 && F2 > 0 && F2 % 4 == 0 &&
         256 % F2 == 0 && (F == 64 || F == 128);
}

// The most neighbours a point each engine takes: the tensor cores
// (edgeblock_train_tc.cu, bf16 mode, and kernel C's bf16 tail there) and
// the FMA kernels of edgeblock_train.cu (f32 mode, and bf16 mode at widths
// the tensor cores' layout does not hold; past k = 32 on their
// shared-memory design, train_wide_kernel).
constexpr int kEbtTcMaxK = 64;
constexpr int kEbtFmaMaxK = 64;

// Kernel I (the statistics sweep) and kernel C's tail in bf16 mode,
// numbered beside passes 1 (J), 2 (K) and 3 (L) for ebt_tc_fits and
// ebt_tc_scratch, I as edgeblock_train.cu numbers it.
constexpr int kEbtStats = 0;
constexpr int kEbtTail = 4;

// Whether the tensor-core pass 0 (I), 1 (J), 2 (K), 3 (L) or kEbtTail (C)
// takes these widths: they are among ebt_widths_ok's with k <= kEbtTcMaxK
// (C's tail: at F = 128 only, the one width its contraction is built for),
// and its resident weights and a tile of one point fit in a block's shared
// memory (at F = 128, F2 = 64 and k = 10, C <= 192 for J and L, C <= 208
// for K, C <= 224 for C; at k = 40 C <= 112 for J and K, C <= 80 for L,
// C <= 144 for C; at k = 64 C <= 80 for J, C <= 64 for K and L, C <= 96
// for C; I holds no wx and half of ee, and fits far wider). Other widths
// take the FMA paths of edgeblock_train.cu and edgeblock.cu in bf16 mode
// too, I-L's up to k = kEbtFmaMaxK and their own shared-memory limit
// (ebt_widths_ok's comment).
bool ebt_tc_fits(int pass, int C, int F2, int F, int k);

// Floats of scratch that pass 0 (I: its blocks' sums), 1 (J), 2 (K), 3 (L)
// or kEbtTail (C: its bf16 v and wout's bf16 pair) takes in bf16 mode, or
// a negative cudaError_t.
long long ebt_tc_scratch(int pass, int B, int N, int C, int F2, int F, int k);

// I in bf16 mode: the arguments and output of spgan_ebt_stats2.
int ebt_tc_stats2(const void* ee, const float* w1, const float* a1,
                  const float* w2, float* out, float* scratch, int B, int N,
                  int C, int F2, int F, int k, float neg, cudaStream_t s);

// J in bf16 mode: the arguments and outputs of spgan_ebt_bwd1.
int ebt_tc_bwd1(const void* ee, const float* dout, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* wout, float* sums, float* dwout, float* dbout,
                float* du, float* scratch, int B, int N, int C, int F2, int F,
                int k, float neg, cudaStream_t s);

// K in bf16 mode: the arguments and outputs of spgan_ebt_bwd2.
int ebt_tc_bwd2(const void* ee, const float* du, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* s2, const float* gb1, float* s1, float* dw2,
                float* scratch, int B, int N, int C, int F2, int F, int k,
                float neg, cudaStream_t s);

// L in bf16 mode: the arguments and outputs of spgan_ebt_bwd3.
int ebt_tc_bwd3(const void* ee, const float* du, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* s2, const float* gb1, const float* s1, void* dee,
                float* dw1, float* dwx, float* scratch, int B, int N, int C,
                int F2, int F, int k, float neg, cudaStream_t s);

// C in bf16 mode: the arguments and output of spgan_edge_tail, with the
// scratch of ebt_tc_scratch(kEbtTail, ...).
int ebt_tc_tail(const void* ee, const float* w1, const float* a1,
                const float* w2, const float* a2, const float* wx,
                const float* ax, const float* wout, const float* bout,
                float* out, float* scratch, int B, int N, int C, int F2,
                int F, int k, float neg, cudaStream_t s);
