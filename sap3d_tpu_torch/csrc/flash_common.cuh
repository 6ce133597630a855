// Device helpers shared by the flash attention kernels
// (flash_fwd.cuh, flash_attention_fwd.cu, flash_attention_bwd.cu):
// row reductions over the lanes that hold one row, and the base-2
// exponential.  One copy here; the build hashes every csrc/*.cuh into each
// library's name, so an edit rebuilds every source that includes it.

#pragma once

#include <stdint.h>

namespace flash {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Max / sum over the quad of lanes (lane % 4) that holds one row of an
// mma.sync or wgmma accumulator.
__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the SFU (what __expf runs after its multiply by log2(e)); -inf
// gives +0.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

}  // namespace flash
