// fp32 products on bf16 tensor cores: the split-bf16 route of the flash
// kernels (flash_attention_fwd.cu, flash_attention_bwd.cu).
//
// An fp32 operand x is split into three bf16 planes, hi = rn(x),
// mid = rn(x - hi), lo = rn(x - hi - mid) (`hopper::split_pack_bf16`), which
// give x back to within 2^-24 |x|.  A product A B then takes six bf16
// wgmma products,
//     mid.mid + hi.lo + lo.hi + hi.mid + mid.hi + hi.hi,
// added in that order, the small terms first and hi.hi last, into one f32
// accumulator: each bf16 product is exact in f32, and the terms left out
// (mid.lo, lo.mid, lo.lo) are of order 2^-24 of the result.  Six products
// at 989 TFLOP/s are 6 x FLOPs / 989e12, 2.5x under fp32 on the CUDA cores
// (67 TFLOP/s); an fp32 tensor core rate (TF32, 3 products) would need
// K-major operands only, which V, dO, Q and K are not everywhere.
//
// Memory operands are split once per call by `split_planes` into a bf16
// tensor [3, rows, wp] (plane-major, zero columns from w to wp), which a
// 3-D tensor map over [3 B, N, wp] addresses as plane p of batch element b
// at z = p B + b; register operands (P, dS) are split by
// `hopper::accum_to_a3`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace split {

constexpr int PLANES = 3;
constexpr int PRODUCTS = 6;

// Plane of A and of B in product i of a split product (0 = hi, 1 = mid,
// 2 = lo), in the order they are added; a bf16 product (one plane) is the
// last, (hi, hi).
__host__ __device__ constexpr int plane_a(int i) {
    return i == 0 ? 1 : i == 2 ? 2 : i == 4 ? 1 : 0;
}
__host__ __device__ constexpr int plane_b(int i) {
    return i == 0 ? 1 : i == 1 ? 2 : i == 3 ? 1 : 0;
}
// The first product a product of operands of np planes takes.
__host__ __device__ constexpr int first_product(int np) { return np == 1 ? PRODUCTS - 1 : 0; }

// The three planes of src [rows, w] float32 into dst [3, rows, wp] bf16,
// columns w .. wp zero; four columns per thread (wp is a multiple of 8).
__global__ void __launch_bounds__(256)
split_planes(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst, long long rows,
             int w, int wp) {
    const long long plane = rows * wp, groups = plane / 4;
    const bool vec = w % 4 == 0;
    uint2* hi = reinterpret_cast<uint2*>(dst);
    uint2* mid = reinterpret_cast<uint2*>(dst + plane);
    uint2* lo = reinterpret_cast<uint2*>(dst + 2 * plane);
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < groups;
         i += (long long)gridDim.x * blockDim.x) {
        const long long r = 4 * i / wp;
        const int c = (int)(4 * i - r * wp);
        float x[4];
        if (vec && c < w) {
            const float4 v = *reinterpret_cast<const float4*>(src + r * w + c);
            x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) x[j] = c + j < w ? src[r * w + c + j] : 0.f;
        }
        uint2 h, m, l;
        hopper::split_pack_bf16(x[0], x[1], h.x, m.x, l.x);
        hopper::split_pack_bf16(x[2], x[3], h.y, m.y, l.y);
        hi[i] = h;
        mid[i] = m;
        lo[i] = l;
    }
}

// Launches `split_planes` on `stream`; returns a cudaError_t.
inline int split(const float* src, __nv_bfloat16* dst, long long rows, int w, int wp,
                 cudaStream_t stream) {
    const long long groups = rows * wp / 4;
    const long long blocks = (groups + 255) / 256 < 132 * 16 ? (groups + 255) / 256 : 132 * 16;
    split_planes<<<(int)blocks, 256, 0, stream>>>(src, dst, rows, w, wp);
    return (int)cudaGetLastError();
}

}  // namespace split
