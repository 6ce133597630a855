// Flash attention forward: o = softmax(q k^T) v, unscaled, and optionally
// lse = m + log(l), the log-sum-exp of each query row's scores.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` as called by
// `_flash_forward` (sap3d_tpu/ops/pallas/flash_attention.py):
//   * without lse (a null lse pointer), `_flash_forward(want_lse=False)`,
//     the `flash_attend_tokens` primal, which is what inference runs (B1);
//   * with lse, `_flash_forward(want_lse=True)`, the custom_vjp forward rule
//     `_fwd_rule` that training runs (B2).  The TPU kernel writes lse as
//     [B, 8, Nq], each row replicated over the 8 sublanes of one tile; that
//     is a layout artifact of the TPU, and here lse is [B, Nq] float32.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C] -> o [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16).  d = C/8 at every call
// site of the model; the kernels take d <= 128 with rows of q and k in
// whole 16-byte chunks (bf16: d a multiple of 8; the wrapper pads q and k
// with zero columns, which add nothing to q.k) and C a multiple of 16.
// There is no 1/sqrt(d) scale.  Scores, the softmax and the accumulator are float32; the
// output is written in v's dtype.  A ragged Nq is masked here instead of
// padded to a block multiple; a ragged Nk is masked with -inf scores.
//
// What bounds it on an H100: at the flagship's sites (batch 16, bf16)
//   x_3_1  Nq=Nk=392,   d=64, C=512:   2.8 GFLOP, 14.5 MB  -> memory-bound
//   x_2_2  Nq=Nk=3136,  d=32, C=256:  90.6 GFLOP, 57.8 MB  -> compute-bound
//   x_1_3  Nq=25088, Nk=3136, d=16, C=128: 362 GFLOP, 130 MB -> compute-bound
// (989 TFLOP/s bf16 tensor-core peak, 3.35 TB/s).  The two compute-bound
// sites also issue d + C = 144 FLOPs per exponential, so the exp unit is
// within an order of magnitude of the tensor-core bound at x_1_3.  lse adds
// 4 bytes per query row (0.4 MB at x_1_3), nothing to the bound.
//
// Design, and why it differs from the TPU kernel.  The TPU kernel keeps all
// of K and V for one batch element resident in VMEM and runs one query block
// per grid step.  At C = 512 that does not fit in 227 KB of shared memory,
// and Hopper's blocks run in parallel rather than in sequence.  So here:
//   * one block per (tile of 64 query rows, tile of columns of C, batch
//     element); the fp32 accumulator of the block's output tile lives in
//     registers;
//   * K and V stream through shared memory in tiles of 64 keys, and an
//     online softmax keeps a running row max m and sum l, rescaling the
//     accumulator when m grows and dividing by l at the end;
//   * the d-wide scores are recomputed for each column tile of C; since
//     d = C/8 that costs d/BC of the P.V work per tile.
//   * lse: every column tile of a row computes the same m and l (same scores,
//     same order), so the blocks of the first column tile write it.
// Two kernels implement this:
//   * bf16 (the inference default): tensor cores through `mma.sync`
//     m16n8k16 with fp32 accumulation.  Four warps own 16 query rows each
//     and 128 columns of C; Q stays in registers as the A operand of Q.K^T,
//     the score fragments are rounded to bf16 in registers and reused as the
//     A operand of P.V (the m16n8 accumulator layout of two adjacent score
//     tiles is the m16n8k16 A layout), and V is read with `ldmatrix.trans`.
//     d is padded to the next of 16/32/64/128 with zeros.  A block covers
//     128 columns of C where C is a multiple of 64, and 16 otherwise (the
//     narrow instantiation, for the 'full' head's x_0_1_sa: d = 2, C = 16,
//     200704 queries, where a 128-column tile would spend 7/8 of its P.V
//     products on zero columns).  No pipelining, no TMA, no wgmma: those
//     are a later change.
//   * fp32: scalar FMAs on the CUDA cores over 4x4 register tiles (256
//     threads, 64 columns of C per block; columns past C are masked),
//     exact fp32 throughout.
//
// Precision against the TPU kernel: that kernel casts the normalised p to
// v's dtype before p.v; the bf16 kernel here casts the unnormalised
// exp(s - m) to bf16 and divides by l (summed in fp32) at the end.  Both sit
// within bf16 rounding of the fp32 result.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
constexpr int C_MULTIPLE = 16;  // C must be a multiple of this

// ---- fp32: CUDA-core kernel ------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int BC = 64;       // output columns (of C) per block
constexpr int LDT = BQ + 4;  // padded row stride of the transposed tiles
constexpr int THREADS = 256; // 16 x 16 threads, each owning a 4 x 4 sub-tile

// Max / sum over the 16 lanes that share a row group (lanes differ in tx,
// the low 4 bits of the lane id).
__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int nq, int nk, int d, int c) {
    extern __shared__ float smem[];
    float* qs = smem;              // [d][LDT]  q tile, transposed
    float* ks = qs + d * LDT;      // [d][LDT]  k tile, transposed
    float* vs = ks + d * LDT;      // [BK][BC]  v tile
    float* ps = vs + BK * BC;      // [BK][LDT] exp(s - m), transposed

    const int tid = threadIdx.x;
    const int tx = tid & 15;   // column group: keys (scores) / C columns (output)
    const int ty = tid >> 4;   // row group: query rows
    const int q0 = blockIdx.x * BQ;
    const int c0 = blockIdx.y * BC;
    const int b = blockIdx.z;

    const float* qb = q + (size_t)b * nq * d;
    const float* kb = k + (size_t)b * nk * d;
    const float* vb = v + (size_t)b * nk * c;

    // q tile, transposed to [d][row]; rows past nq are zero (never stored).
    for (int i = tid; i < BQ * d; i += THREADS) {
        const int r = i / d, j = i - r * d;
        qs[j * LDT + r] = (q0 + r < nq) ? qb[(size_t)(q0 + r) * d + j] : 0.f;
    }

    float acc[4][4];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }

    for (int k0 = 0; k0 < nk; k0 += BK) {
        __syncthreads();  // previous tile's ks/vs/ps fully consumed
        for (int i = tid; i < BK * d; i += THREADS) {
            const int r = i / d, j = i - r * d;
            ks[j * LDT + r] = (k0 + r < nk) ? kb[(size_t)(k0 + r) * d + j] : 0.f;
        }
        for (int i = tid; i < BK * BC; i += THREADS) {
            const int r = i / BC, j = i - r * BC;
            vs[i] = (k0 + r < nk && c0 + j < c) ? vb[(size_t)(k0 + r) * c + c0 + j] : 0.f;
        }
        __syncthreads();

        // scores s[i][j] = q[row ty*4+i] . k[key tx*4+j]
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
        for (int dd = 0; dd < d; ++dd) {
            const float4 a = *reinterpret_cast<const float4*>(&qs[dd * LDT + ty * 4]);
            const float4 bk = *reinterpret_cast<const float4*>(&ks[dd * LDT + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
        }

        // online softmax over this tile's keys
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float tmax = -INFINITY;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (k0 + tx * 4 + j >= nk) s[i][j] = -INFINITY;
                tmax = fmaxf(tmax, s[i][j]);
            }
            tmax = group16_max(tmax);
            const float m_new = fmaxf(m[i], tmax);  // finite: every tile has a valid key
            const float alpha = __expf(m[i] - m_new);  // 0 on the first tile
            float tsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = __expf(s[i][j] - m_new);
                tsum += s[i][j];
            }
            tsum = group16_sum(tsum);
            l[i] = l[i] * alpha + tsum;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) ps[(tx * 4 + j) * LDT + ty * 4 + i] = s[i][j];
        __syncthreads();

        // acc[i][j] += sum_k p[row ty*4+i][k] * v[k][col tx*4+j]
        const int kmax = min(BK, nk - k0);
        for (int kk = 0; kk < kmax; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&ps[kk * LDT + ty * 4]);
            const float4 bv4 = *reinterpret_cast<const float4*>(&vs[kk * BC + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }

    float* ob = o + (size_t)b * nq * c;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + ty * 4 + i;
        if (r >= nq) continue;
        const float inv = 1.f / l[i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (c0 + tx * 4 + j < c) ob[(size_t)r * c + c0 + tx * 4 + j] = acc[i][j] * inv;
        if (lse != nullptr && blockIdx.y == 0 && tx == 0)
            lse[(size_t)b * nq + r] = m[i] + logf(l[i]);
    }
}

int launch_f32(const float* q, const float* k, const float* v, float* o, float* lse,
               int b, int nq, int nk, int d, int c, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (2 * (size_t)d * LDT + BK * BC + BK * LDT);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nq + BQ - 1) / BQ, (c + BC - 1) / BC, b);
    flash_fwd_f32<<<grid, THREADS, smem, stream>>>(q, k, v, o, lse, nq, nk, d, c);
    return (int)cudaGetLastError();
}

// ---- bf16: tensor-core kernel (mma.sync m16n8k16) ---------------------------

constexpr int TC_BQ = 64;        // query rows per block: 4 warps x 16
constexpr int TC_BK = 64;        // keys per streamed tile
constexpr int TC_BC = 128;       // output columns (of C) per block, C a multiple of 64
constexpr int TC_BC_NARROW = 16; // the same for any other C (a multiple of 16)
constexpr int TC_THREADS = 128;
constexpr int TC_PAD = 8;        // row padding (bf16): conflict-free fragment reads

__device__ __forceinline__ void mma_bf16(float (&acc)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// address of row (l & 7) of matrix (l >> 3).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// Two floats as bf16x2, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * group + tig.
//   A (16x16, row): {a0,a1} (group, 2tig..+1), {a2,a3} (group+8, 2tig..+1),
//                   {a4,a5} (group, 2tig+8..+9), {a6,a7} (group+8, 2tig+8..+9)
//   B (16x8, col):  {b0,b1} (k 2tig..+1, n group), {b2,b3} (k 2tig+8..+9, n group)
//   C (16x8):       {c0,c1} (group, 2tig..+1), {c2,c3} (group+8, 2tig..+1)
template <int D, int BCOLS>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               float* __restrict__ lse, int nq, int nk, int d, int c) {
    constexpr int KLD = D + TC_PAD;      // row stride of the K tile
    constexpr int VLD = BCOLS + TC_PAD;  // row stride of the V tile
    __shared__ __align__(16) __nv_bfloat16 ks[TC_BK * KLD];
    __shared__ __align__(16) __nv_bfloat16 vs[TC_BK * VLD];

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int group = lane >> 2, tig = lane & 3;
    const int c0 = blockIdx.y * BCOLS;
    const int b = blockIdx.z;
    const int r0 = blockIdx.x * TC_BQ + warp * 16 + group;  // this lane's rows
    const int r1 = r0 + 8;

    const __nv_bfloat16* qb = q + (size_t)b * nq * d;
    const __nv_bfloat16* kb = k + (size_t)b * nk * d;
    const __nv_bfloat16* vb = v + (size_t)b * nk * c;

    // Q as A fragments, once; rows past nq and columns past d are zero.
    auto q2 = [&](int r, int col) -> uint32_t {
        return (r < nq && col < d)
            ? *reinterpret_cast<const uint32_t*>(&qb[(size_t)r * d + col]) : 0u;
    };
    uint32_t qa[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16 + 2 * tig;
        qa[kk][0] = q2(r0, col);
        qa[kk][1] = q2(r1, col);
        qa[kk][2] = q2(r0, col + 8);
        qa[kk][3] = q2(r1, col + 8);
    }

    float acc[BCOLS / 8][4];
#pragma unroll
    for (int n = 0; n < BCOLS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows r0, r1
    float l0 = 0.f, l1 = 0.f;              // this lane's share of the row sums

    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int k0 = 0; k0 < nk; k0 += TC_BK) {
        __syncthreads();  // the previous tile is consumed
        for (int i = tid; i < TC_BK * (D / 8); i += TC_THREADS) {
            const int r = i / (D / 8), col = (i % (D / 8)) * 8;
            uint4 val = zero;
            if (k0 + r < nk && col < d)
                val = *reinterpret_cast<const uint4*>(&kb[(size_t)(k0 + r) * d + col]);
            *reinterpret_cast<uint4*>(&ks[r * KLD + col]) = val;
        }
        for (int i = tid; i < TC_BK * (BCOLS / 8); i += TC_THREADS) {
            const int r = i / (BCOLS / 8), col = (i % (BCOLS / 8)) * 8;
            uint4 val = zero;
            if (k0 + r < nk && c0 + col < c)
                val = *reinterpret_cast<const uint4*>(&vb[(size_t)(k0 + r) * c + c0 + col]);
            *reinterpret_cast<uint4*>(&vs[r * VLD + col]) = val;
        }
        __syncthreads();

        // s = q k^T for this lane's two rows and 64 keys (8 tiles of 8)
        float s[TC_BK / 8][4];
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const __nv_bfloat16* kp = &ks[(nt * 8 + group) * KLD + kk * 16 + 2 * tig];
                mma_bf16(s[nt], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                         *reinterpret_cast<const uint32_t*>(kp + 8));
            }
        }
        if (k0 + TC_BK > nk) {  // ragged last tile: keys past nk score -inf
#pragma unroll
            for (int nt = 0; nt < TC_BK / 8; ++nt)
#pragma unroll
                for (int j = 0; j < 2; ++j)
                    if (k0 + nt * 8 + 2 * tig + j >= nk) s[nt][j] = s[nt][2 + j] = -INFINITY;
        }

        // online softmax; every tile holds at least one valid key
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        const float alpha0 = __expf(m0 - mn0), alpha1 = __expf(m1 - mn1);  // 0 at first
        m0 = mn0;
        m1 = mn1;
        float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
            s[nt][0] = __expf(s[nt][0] - mn0);
            s[nt][1] = __expf(s[nt][1] - mn0);
            s[nt][2] = __expf(s[nt][2] - mn1);
            s[nt][3] = __expf(s[nt][3] - mn1);
            ps0 += s[nt][0] + s[nt][1];
            ps1 += s[nt][2] + s[nt][3];
        }
        l0 = l0 * alpha0 + ps0;
        l1 = l1 * alpha1 + ps1;
#pragma unroll
        for (int n = 0; n < BCOLS / 8; ++n) {
            acc[n][0] *= alpha0;
            acc[n][1] *= alpha0;
            acc[n][2] *= alpha1;
            acc[n][3] *= alpha1;
        }

        // acc += p v: p from registers (two score tiles = one A fragment),
        // v through ldmatrix.trans (two B fragments per call)
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
            const int vrow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int np = 0; np < BCOLS / 16; ++np) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, &vs[vrow * VLD + np * 16 + (lane >> 4) * 8]);
                mma_bf16(acc[2 * np], pa, bv[0], bv[1]);
                mma_bf16(acc[2 * np + 1], pa, bv[2], bv[3]);
            }
        }
    }

    const float sum0 = quad_sum(l0), sum1 = quad_sum(l1);
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    if (lse != nullptr && blockIdx.y == 0 && tig == 0) {
        if (r0 < nq) lse[(size_t)b * nq + r0] = m0 + logf(sum0);
        if (r1 < nq) lse[(size_t)b * nq + r1] = m1 + logf(sum1);
    }
    __nv_bfloat16* ob = o + (size_t)b * nq * c;
#pragma unroll
    for (int n = 0; n < BCOLS / 8; ++n) {
        const int col = c0 + n * 8 + 2 * tig;
        if (col >= c) continue;
        if (r0 < nq)
            *reinterpret_cast<uint32_t*>(&ob[(size_t)r0 * c + col]) =
                pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
        if (r1 < nq)
            *reinterpret_cast<uint32_t*>(&ob[(size_t)r1 * c + col]) =
                pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
    }
}

template <int D, int BCOLS>
int launch_bf16_dc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, float* lse, int b, int nq, int nk, int d, int c,
                   cudaStream_t stream) {
    const dim3 grid((nq + TC_BQ - 1) / TC_BQ, (c + BCOLS - 1) / BCOLS, b);
    flash_fwd_bf16<D, BCOLS><<<grid, TC_THREADS, 0, stream>>>(q, k, v, o, lse, nq, nk, d, c);
    return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  __nv_bfloat16* o, float* lse, int b, int nq, int nk, int d, int c,
                  cudaStream_t stream) {
    if (c % 64 == 0)
        return launch_bf16_dc<D, TC_BC>(q, k, v, o, lse, b, nq, nk, d, c, stream);
    return launch_bf16_dc<D, TC_BC_NARROW>(q, k, v, o, lse, b, nq, nk, d, c, stream);
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                __nv_bfloat16* o, float* lse, int b, int nq, int nk, int d, int c,
                cudaStream_t stream) {
    if (d % 8) return (int)cudaErrorInvalidValue;  // 16-byte row chunks
    if (d <= 16) return launch_bf16_d<16>(q, k, v, o, lse, b, nq, nk, d, c, stream);
    if (d <= 32) return launch_bf16_d<32>(q, k, v, o, lse, b, nq, nk, d, c, stream);
    if (d <= 64) return launch_bf16_d<64>(q, k, v, o, lse, b, nq, nk, d, c, stream);
    return launch_bf16_d<128>(q, k, v, o, lse, b, nq, nk, d, c, stream);
}

}  // namespace

extern "C" {

// C must be a multiple of this, and d at most the next; the wrapper checks
// both and pads q and k to 16-byte rows (d % 8 == 0 for bf16).
int sap3d_flash_fwd_block_c() { return C_MULTIPLE; }
int sap3d_flash_fwd_max_d() { return MAX_D; }

// dtype: 0 = float32, 1 = bfloat16.  lse: float32 [B, Nq], or null for the
// forward without lse.  Returns a cudaError_t (0 = launched); invalid
// arguments return cudaErrorInvalidValue without launching.
int sap3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    int b, int nq, int nk, int d, int c, int dtype, void* stream) {
    if (b <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D || c <= 0 || c % C_MULTIPLE)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(o),
                          static_cast<float*>(lse), b, nq, nk, d, c, s);
    if (dtype == 1)
        return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
                           b, nq, nk, d, c, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
