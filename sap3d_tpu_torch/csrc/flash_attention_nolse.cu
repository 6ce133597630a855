// Lse-free attention forward for inference, rounding where the TPU kernel
// rounds: o = (p rounded to v's dtype) . v, with p = exp(s - m) / sum(exp(s - m))
// normalised in fp32 before the rounding, s = q k^T unscaled.
//
// Replaces the Pallas TPU kernel `_fwd_kernel_nolse` of `flash_nolse`
// (scripts/bisect_infer.py), the lse-free forward that the inference bisect
// swaps in for `flash_attend_tokens` (kernel B6).  Its body is the TPU
// kernel `_fwd_kernel` of sap3d_tpu/ops/pallas/flash_attention.py without
// the lse output: fp32 scores, the row max m, e = exp(s - m), p = e / sum(e)
// in fp32, then p.astype(v.dtype) . v with fp32 accumulation, the output
// rounded once to v's dtype.
//
// Why not B1 (csrc/flash_attention_fwd.cu): B1 streams the keys once with an
// online softmax, so it rounds the unnormalised exp(s - m_running) to bf16
// and divides by the row sum at the end; the TPU kernel rounds the
// normalised p.  The two differ within bf16 rounding, but where the rounding
// sits moves a random full-width network's bf16 results (PERF.md).  This
// kernel needs the final m and sum before it can form p, so it makes two
// passes over the keys and never rescales an accumulator:
//   * pass 1 streams K tiles, forms s in fp32 and keeps each row's running
//     max m and sum l (l rescaled when m moves); there is no output;
//   * pass 2 streams K and V tiles again, recomputes s, forms
//     p = exp(s - m) * (1 / l) in fp32, rounds p to v's dtype and
//     accumulates o += p . v in fp32; the output is rounded once, with no
//     final division.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C] -> o [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16).  The limits are B1's:
// d <= 128 with rows of q and k in whole 16-byte chunks (the wrapper pads
// them with zero columns) and C a multiple of 16.  A ragged Nq is masked
// here (the TPU kernel pads it to 256); a ragged Nk is masked with -inf
// scores.
//
// What bounds it on an H100, at the flagship's sites (batch 16, bf16):
//   x_3_1  Nq=Nk=392,   d=64, C=512:   2.8 GFLOP, 14.5 MB -> memory-bound
//   x_2_2  Nq=Nk=3136,  d=32, C=256:  91 GFLOP,  57.8 MB -> compute-bound
//   x_1_3  Nq=25088, Nk=3136, d=16, C=128: 363 GFLOP, 130 MB -> compute-bound
// counting the function's 2 B Nq Nk (d + C) FLOPs, B1's.  This design forms
// the scores twice (2 B Nq Nk d more) and takes two exponentials per score
// (one per pass), against B1's one: costs of the design, not of the
// function, so the bound does not count them.
//
// Layout of the work, the first port's design of B1 (B1 has since been
// redesigned for wgmma and TMA; this kernel keeps the first design): one
// block per (64 query rows, a column tile of C, batch element).  bf16 on
// the tensor cores through `mma.sync` m16n8k16 with fp32 accumulation:
// four warps of 16 query rows, Q in registers as the A operand, the rounded p fragments reused in registers
// as the A operand of P.V, V through `ldmatrix.trans`; a column tile of
// 128 where C is a multiple of 64, else 16.  Each column tile repeats pass
// 1.  fp32 on the CUDA cores over 4x4 register tiles (256 threads, 64
// columns per block).  No pipelining, no TMA, no wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

// Shared helpers (row reductions; bf16 pairs rounded to nearest even, the
// lower column in the low half).
using flash::group16_max;
using flash::group16_sum;
using flash::quad_max;
using flash::quad_sum;
using hopper::pack_bf16;

constexpr int MAX_D = 128;
constexpr int C_MULTIPLE = 16;  // C must be a multiple of this

// ---- fp32: CUDA-core kernel ------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per streamed tile
constexpr int BC = 64;       // output columns (of C) per block
constexpr int LDT = BQ + 4;  // padded row stride of the transposed tiles
constexpr int THREADS = 256; // 16 x 16 threads, each owning a 4 x 4 sub-tile

// s[i][j] = q[row ty*4+i] . k[key tx*4+j] from the transposed tiles, keys
// past nk at -inf.
__device__ __forceinline__ void scores_f32(float (&s)[4][4], const float* qs,
                                           const float* ks, int d, int ty, int tx,
                                           int k0, int nk) {
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
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (k0 + tx * 4 + j >= nk) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i][j] = -INFINITY;
        }
}

__device__ __forceinline__ void load_k_f32(float* ks, const float* kb, int k0, int nk,
                                           int d, int tid) {
    for (int i = tid; i < BK * d; i += THREADS) {
        const int r = i / d, j = i - r * d;
        ks[j * LDT + r] = (k0 + r < nk) ? kb[(size_t)(k0 + r) * d + j] : 0.f;
    }
}

__global__ void __launch_bounds__(THREADS)
flash_nolse_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                int nq, int nk, int d, int c) {
    extern __shared__ float smem[];
    float* qs = smem;              // [d][LDT]  q tile, transposed
    float* ks = qs + d * LDT;      // [d][LDT]  k tile, transposed
    float* vs = ks + d * LDT;      // [BK][BC]  v tile
    float* ps = vs + BK * BC;      // [BK][LDT] p, transposed

    const int tid = threadIdx.x;
    const int tx = tid & 15;   // column group: keys (scores) / C columns (output)
    const int ty = tid >> 4;   // row group: query rows
    const int q0 = blockIdx.x * BQ;
    const int c0 = blockIdx.y * BC;
    const int b = blockIdx.z;

    const float* qb = q + (size_t)b * nq * d;
    const float* kb = k + (size_t)b * nk * d;
    const float* vb = v + (size_t)b * nk * c;

    for (int i = tid; i < BQ * d; i += THREADS) {
        const int r = i / d, j = i - r * d;
        qs[j * LDT + r] = (q0 + r < nq) ? qb[(size_t)(q0 + r) * d + j] : 0.f;
    }

    // pass 1: each row's max m and sum l = sum exp(s - m)
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
    }
    for (int k0 = 0; k0 < nk; k0 += BK) {
        __syncthreads();  // the previous tile is consumed
        load_k_f32(ks, kb, k0, nk, d, tid);
        __syncthreads();
        float s[4][4];
        scores_f32(s, qs, ks, d, ty, tx, k0, nk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float tmax = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
            // finite: every tile holds a valid key
            const float m_new = fmaxf(m[i], group16_max(tmax));
            float tsum = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) tsum += __expf(s[i][j] - m_new);
            l[i] = l[i] * __expf(m[i] - m_new) + group16_sum(tsum);  // 0 * 0 at first
            m[i] = m_new;
        }
    }
    float inv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) inv[i] = 1.f / l[i];

    // pass 2: o = sum_k p v with p = exp(s - m) / l
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += BK) {
        __syncthreads();
        load_k_f32(ks, kb, k0, nk, d, tid);
        for (int i = tid; i < BK * BC; i += THREADS) {
            const int r = i / BC, j = i - r * BC;
            vs[i] = (k0 + r < nk && c0 + j < c) ? vb[(size_t)(k0 + r) * c + c0 + j] : 0.f;
        }
        __syncthreads();
        float s[4][4];
        scores_f32(s, qs, ks, d, ty, tx, k0, nk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
                ps[(tx * 4 + j) * LDT + ty * 4 + i] = __expf(s[i][j] - m[i]) * inv[i];
        __syncthreads();
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
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (c0 + tx * 4 + j < c) ob[(size_t)r * c + c0 + tx * 4 + j] = acc[i][j];
    }
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               int b, int nq, int nk, int d, int c, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (2 * (size_t)d * LDT + BK * BC + BK * LDT);
    cudaError_t err = cudaFuncSetAttribute(
        flash_nolse_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nq + BQ - 1) / BQ, (c + BC - 1) / BC, b);
    flash_nolse_f32<<<grid, THREADS, smem, stream>>>(q, k, v, o, nq, nk, d, c);
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

// One tile of TC_BK keys of K (rows past nk and columns past d zero).
template <int D>
__device__ __forceinline__ void load_k_bf16(__nv_bfloat16* ks, const __nv_bfloat16* kb,
                                            int k0, int nk, int d, int tid) {
    constexpr int KLD = D + TC_PAD;
    for (int i = tid; i < TC_BK * (D / 8); i += TC_THREADS) {
        const int r = i / (D / 8), col = (i % (D / 8)) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + r < nk && col < d)
            val = *reinterpret_cast<const uint4*>(&kb[(size_t)(k0 + r) * d + col]);
        *reinterpret_cast<uint4*>(&ks[r * KLD + col]) = val;
    }
}

// s = q k^T for this lane's two rows and the tile's 64 keys (8 tiles of 8),
// keys past nk at -inf.  Fragment layouts (PTX ISA, mma.m16n8k16), lane =
// 4 * group + tig: C {c0,c1} (group, 2tig..+1), {c2,c3} (group+8, 2tig..+1).
template <int D>
__device__ __forceinline__ void scores_bf16(float (&s)[TC_BK / 8][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const __nv_bfloat16* ks, int group, int tig,
                                            int k0, int nk) {
    constexpr int KLD = D + TC_PAD;
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
    if (k0 + TC_BK > nk) {  // ragged last tile
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (k0 + nt * 8 + 2 * tig + j >= nk) s[nt][j] = s[nt][2 + j] = -INFINITY;
    }
}

template <int D, int BCOLS>
__global__ void __launch_bounds__(TC_THREADS)
flash_nolse_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int nq, int nk, int d, int c) {
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
    // A (16x16, row): {a0,a1} (group, 2tig..+1), {a2,a3} (group+8, ..),
    // {a4,a5} (group, 2tig+8..+9), {a6,a7} (group+8, ..).
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

    // pass 1: the rows' max m and sum l; each lane sums its own columns and
    // the quad's sums are added at the end
    float m0 = -INFINITY, m1 = -INFINITY;
    float l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < nk; k0 += TC_BK) {
        __syncthreads();  // the previous tile is consumed
        load_k_bf16<D>(ks, kb, k0, nk, d, tid);
        __syncthreads();
        float s[TC_BK / 8][4];
        scores_bf16<D>(s, qa, ks, group, tig, k0, nk);
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
            mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
            mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
        }
        // finite: every tile holds a valid key
        const float mn0 = fmaxf(m0, quad_max(mx0));
        const float mn1 = fmaxf(m1, quad_max(mx1));
        float ts0 = 0.f, ts1 = 0.f;
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
            ts0 += __expf(s[nt][0] - mn0) + __expf(s[nt][1] - mn0);
            ts1 += __expf(s[nt][2] - mn1) + __expf(s[nt][3] - mn1);
        }
        l0 = l0 * __expf(m0 - mn0) + ts0;  // 0 * 0 on the first tile
        l1 = l1 * __expf(m1 - mn1) + ts1;
        m0 = mn0;
        m1 = mn1;
    }
    const float inv0 = 1.f / quad_sum(l0), inv1 = 1.f / quad_sum(l1);

    // pass 2: o += (p rounded to bf16) v, p = exp(s - m) / l in fp32
    float acc[BCOLS / 8][4];
#pragma unroll
    for (int n = 0; n < BCOLS / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    for (int k0 = 0; k0 < nk; k0 += TC_BK) {
        __syncthreads();
        load_k_bf16<D>(ks, kb, k0, nk, d, tid);
        for (int i = tid; i < TC_BK * (BCOLS / 8); i += TC_THREADS) {
            const int r = i / (BCOLS / 8), col = (i % (BCOLS / 8)) * 8;
            uint4 val = make_uint4(0u, 0u, 0u, 0u);
            if (k0 + r < nk && c0 + col < c)
                val = *reinterpret_cast<const uint4*>(&vb[(size_t)(k0 + r) * c + c0 + col]);
            *reinterpret_cast<uint4*>(&vs[r * VLD + col]) = val;
        }
        __syncthreads();
        float s[TC_BK / 8][4];
        scores_bf16<D>(s, qa, ks, group, tig, k0, nk);
#pragma unroll
        for (int nt = 0; nt < TC_BK / 8; ++nt) {
            s[nt][0] = __expf(s[nt][0] - m0) * inv0;
            s[nt][1] = __expf(s[nt][1] - m0) * inv0;
            s[nt][2] = __expf(s[nt][2] - m1) * inv1;
            s[nt][3] = __expf(s[nt][3] - m1) * inv1;
        }
        // two p tiles of 8 keys are one A fragment; V through ldmatrix.trans
        // (two B fragments per call)
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

    __nv_bfloat16* ob = o + (size_t)b * nq * c;
#pragma unroll
    for (int n = 0; n < BCOLS / 8; ++n) {
        const int col = c0 + n * 8 + 2 * tig;
        if (col >= c) continue;
        if (r0 < nq)
            *reinterpret_cast<uint32_t*>(&ob[(size_t)r0 * c + col]) =
                pack_bf16(acc[n][0], acc[n][1]);
        if (r1 < nq)
            *reinterpret_cast<uint32_t*>(&ob[(size_t)r1 * c + col]) =
                pack_bf16(acc[n][2], acc[n][3]);
    }
}

template <int D, int BCOLS>
int launch_bf16_dc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, int b, int nq, int nk, int d, int c,
                   cudaStream_t stream) {
    const dim3 grid((nq + TC_BQ - 1) / TC_BQ, (c + BCOLS - 1) / BCOLS, b);
    flash_nolse_bf16<D, BCOLS><<<grid, TC_THREADS, 0, stream>>>(q, k, v, o, nq, nk, d, c);
    return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  __nv_bfloat16* o, int b, int nq, int nk, int d, int c,
                  cudaStream_t stream) {
    if (c % 64 == 0)
        return launch_bf16_dc<D, TC_BC>(q, k, v, o, b, nq, nk, d, c, stream);
    return launch_bf16_dc<D, TC_BC_NARROW>(q, k, v, o, b, nq, nk, d, c, stream);
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                __nv_bfloat16* o, int b, int nq, int nk, int d, int c,
                cudaStream_t stream) {
    if (d % 8) return (int)cudaErrorInvalidValue;  // 16-byte row chunks
    if (d <= 16) return launch_bf16_d<16>(q, k, v, o, b, nq, nk, d, c, stream);
    if (d <= 32) return launch_bf16_d<32>(q, k, v, o, b, nq, nk, d, c, stream);
    if (d <= 64) return launch_bf16_d<64>(q, k, v, o, b, nq, nk, d, c, stream);
    return launch_bf16_d<128>(q, k, v, o, b, nq, nk, d, c, stream);
}

}  // namespace

extern "C" {

// C must be a multiple of this, and d at most the next; the wrapper checks
// both and pads q and k to 16-byte rows (d % 8 == 0 for bf16).
int sap3d_flash_nolse_block_c() { return C_MULTIPLE; }
int sap3d_flash_nolse_max_d() { return MAX_D; }

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched);
// invalid arguments return cudaErrorInvalidValue without launching.
int sap3d_flash_nolse(const void* q, const void* k, const void* v, void* o,
                      int b, int nq, int nk, int d, int c, int dtype, void* stream) {
    if (b <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D || c <= 0 || c % C_MULTIPLE)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<float*>(o),
                          b, nq, nk, d, c, s);
    if (dtype == 1)
        return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<__nv_bfloat16*>(o), b, nq, nk, d, c, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
