// Kernels J and L in bf16 mode on the tensor cores (edgeblock_train_tc.cu),
// called by spgan_ebt_bwd1 and spgan_ebt_bwd3 (edgeblock_train.cu) for a
// bf16 ee; their f32 mode stays in edgeblock_train.cu.
#pragma once

#include <cuda_runtime.h>

// The widths kernels I-L take: C a multiple of 4, F2 a multiple of 4
// dividing 256, F in {64, 128}, 1 <= k <= 32.
inline bool ebt_widths_ok(int B, int N, int C, int F2, int F, int k) {
  return B > 0 && N > 0 && C > 0 && C % 4 == 0 && k >= 1 && k <= 32 &&
         F2 > 0 && F2 % 4 == 0 && 256 % F2 == 0 && (F == 64 || F == 128);
}

// Whether the tensor-core pass 1 (J) or 3 (L) takes these widths: its
// resident weights and a tile of one point fit in a block's shared memory
// (at F = 128, F2 = 64 and k = 10, C <= 192). Wider blocks take the FMA
// path of edgeblock_train.cu in bf16 mode too.
bool ebt_tc_fits(int pass, int C, int F2, int F, int k);

// Floats of scratch that pass 1 (J) or 3 (L) takes in bf16 mode, or a
// negative cudaError_t.
long long ebt_tc_scratch(int pass, int B, int N, int C, int F2, int F, int k);

// J in bf16 mode: the arguments and outputs of spgan_ebt_bwd1.
int ebt_tc_bwd1(const void* ee, const float* dout, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* wout, float* sums, float* dwout, float* dbout,
                float* du, float* scratch, int B, int N, int C, int F2, int F,
                int k, float neg, cudaStream_t s);

// L in bf16 mode: the arguments and outputs of spgan_ebt_bwd3.
int ebt_tc_bwd3(const void* ee, const float* du, const float* w1,
                const float* a1, const float* w2, const float* a2,
                const float* wx, const float* ax, const float* gb2x,
                const float* s2, const float* gb1, const float* s1, void* dee,
                float* dw1, float* dwx, float* scratch, int B, int N, int C,
                int F2, int F, int k, float neg, cudaStream_t s);
