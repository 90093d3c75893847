// Kernel C in f32 mode on the tensor cores (edgeblock_tf32.cu), called by
// spgan_edge_tail (edgeblock.cu) for an f32 ee wherever its layout fits;
// other widths stay on the FMA kernels of edgeblock.cu.
#pragma once

#include <cuda_runtime.h>

// Whether the split-TF32 path takes these widths: C >= 1, F2 a multiple
// of 4 dividing 128, F in {64, 128}, 1 <= k <= 64, and the block's f32
// weights and a tile of one point fit in its shared memory (at F = 128 and
// F2 = 64: C <= 120 at k = 10, 96 at k = 32, 80 at k = 40, 64 at k = 64).
bool ebt_tf_fits(int C, int F2, int F, int k);

// Floats of scratch the path takes: v [B, N, k, F] and wout transposed
// [F, k F], f32.
long long ebt_tf_scratch(int B, int N, int C, int F2, int F, int k);

// The arguments and output of spgan_edge_tail for an f32 ee, with the
// scratch of ebt_tf_scratch.
int ebt_tf_tail(const float* ee, const float* w1, const float* a1,
                const float* w2, const float* a2, const float* wx,
                const float* ax, const float* wout, const float* bout,
                float* out, float* scratch, int B, int N, int C, int F2,
                int F, int k, float neg, cudaStream_t s);
