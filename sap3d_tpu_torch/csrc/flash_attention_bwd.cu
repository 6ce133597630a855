// Flash attention backward: dq, dk, dv of o = softmax(q k^T) v (unscaled)
// from the forward's saved o and lse, with one exponential per score.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` as called by
// `_flash_backward` (sap3d_tpu/ops/pallas/flash_attention.py):
//   * without dlse (a null dlse pointer), `_flash_backward(dlse=None)`, the
//     custom_vjp backward rule `_bwd_rule` that training runs (B3);
//   * with dlse, `_flash_backward(dlse=...)`, the backward rule
//     `_bwd_rule_lse` of `flash_attend_tokens_lse` (B4), whose lse output
//     the ring-attention hop merge consumes.  d lse_i / d s_ij = p_ij, so
//     the lse cotangent folds into the row term: delta_i -= dlse_i.  The TPU
//     kernel sums dlse over the 8 sublanes its lse is replicated on; here
//     dlse is [B, Nq] float32, as lse is.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C], o and do [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16); lse and dlse [B, Nq]
// float32.  Outputs dq [B, Nq, d], dk [B, Nk, d], dv [B, Nk, C] in that
// dtype.  The kernels take d <= 128 with rows of q and k in whole 16-byte
// chunks (bf16: d a multiple of 8; the wrapper pads q and k with zero
// columns and drops those of dq and dk) and C a multiple of 64 up to 512 or
// a multiple of 16 up to 128.  Per query row i and key j:
//   delta_i = sum_c do_ic o_ic - dlse_i        (= sum_j dp_ij p_ij - dlse_i)
//   p_ij    = exp(q_i . k_j - lse_i)
//   dp_ij   = do_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i
// Precision follows the TPU kernel: scores, p, dp, ds and every accumulator
// are float32; p and ds are rounded to the operand dtype before their
// products; dk and dv are accumulated in float32 and rounded once at the
// end; dq is accumulated in float32 and rounded to q's dtype at the end.
//
// What bounds it on an H100: at the flagship's sites (batch 16, bf16) the
// work is 2*B*Nq*Nk*(3d + 2C) FLOPs (five products) and one exponential
// per score:
//   x_3_1  Nq=Nk=392,  d=64, C=512:    7.1 GFLOP,  ~29 MB -> memory-bound
//   x_2_2  Nq=Nk=3136, d=32, C=256:    191 GFLOP, ~116 MB -> compute-bound
//   x_1_3  Nq=25088, Nk=3136, d=16, C=128: 765 GFLOP, ~260 MB -> compute-bound
// (989 TFLOP/s bf16 tensor-core peak, 3.35 TB/s).
//
// Design.  The TPU kernel runs one query block per step of a sequential
// grid axis and sums dk and dv in VMEM across those steps.  Hopper's blocks
// run in parallel and in no order, so the decomposition is FA2's:
//   1. a small kernel computes delta (one warp per query row);
//   2. the main kernel runs one block per (tile of keys, batch element).
//      The block keeps its keys' dk and dv in registers and loops over all
//      query tiles, so dk and dv need no reduction across blocks;
//   3. dq of a query tile gets a contribution from every key tile.  Each
//      block reduces its tile's contribution over its keys (one product
//      over shared memory) and adds it with float32 atomicAdd into a float32
//      scratch; a last small kernel rounds the scratch to q's dtype.
//      The cost: B*Nq*d*(Nk/BKV) atomic adds (about 5e8 at x_1_3), and a
//      sum whose order changes from run to run, so dq differs between runs
//      by float32 rounding (about 1e-6 relative).  The alternative, a second
//      kernel per query tile, recomputes s, p and dp: two of the five
//      products again.
// Rows past Nq and keys past Nk are masked here (p = 0, delta = 0), where
// the TPU version pads lse with +inf and dlse with 0.
//
// Two main kernels:
//   * bf16 (the training default): tensor cores through `mma.sync`
//     m16n8k16 with float32 accumulation.  A warp owns 16 keys and a slab of
//     CW (128 or 64 where C is a multiple of 64; else the narrow 16, at most
//     8 slabs) columns of C; the G = C/CW warps of a key group split
//     the contraction of dp over C and add their partial dp through shared
//     memory, then each holds the full ds of its 16 keys.  Scores are
//     computed transposed (keys are the rows), so that p and ds sit in
//     registers in the A-operand layout of dv = p^T do and dk = ds^T q.  K
//     stays in registers; V, the query tile, do and ds go through shared
//     memory.  d is padded to the next of 16/32/64/128 with zeros.  No
//     pipelining, no TMA, no wgmma: those are a later change.
//   * fp32: scalar FMAs on the CUDA cores, one block per 32 keys.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_D = 128;
constexpr int MAX_C = 512;
constexpr int C_MULTIPLE = 16;
constexpr int WIDE_C_MULTIPLE = 64;  // C above NARROW_MAX_C is a multiple of this
constexpr int NARROW_MAX_C = 128;    // 8 warps of 16 columns

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

// ---- delta = rowsum(do * o) - dlse, and the dq rounding --------------------

template <typename T>
__global__ void __launch_bounds__(256)
bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
          const float* __restrict__ dlse, float* __restrict__ delta, int rows, int c) {
    const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const T* orow = o + (size_t)row * c;
    const T* drow = dout + (size_t)row * c;
    float s = 0.f;
    for (int j = lane; j < c; j += 32) s = fmaf(to_f(orow[j]), to_f(drow[j]), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) delta[row] = dlse == nullptr ? s : s - dlse[row];
}

__global__ void round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                              size_t n) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        dst[i] = __float2bfloat16(src[i]);
}

// ---- fp32: CUDA-core kernel -------------------------------------------------

constexpr int F_BK = 32;       // keys per block
constexpr int F_BQ = 32;       // query rows per inner tile
constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
              int nq, int nk, int d, int c) {
    extern __shared__ float fsm[];
    const int dl = d + 1, cl = c + 1;  // padded row strides
    float* ks = fsm;                   // [F_BK][dl]
    float* vs = ks + F_BK * dl;        // [F_BK][cl]
    float* qs = vs + F_BK * cl;        // [F_BQ][dl]
    float* dos = qs + F_BQ * dl;       // [F_BQ][cl]
    float* ps = dos + F_BQ * cl;       // [F_BQ][F_BK + 1]  p
    float* dss = ps + F_BQ * (F_BK + 1);  // [F_BQ][F_BK + 1]  ds
    float* lses = dss + F_BQ * (F_BK + 1);  // [F_BQ]
    float* dels = lses + F_BQ;              // [F_BQ]

    const int tid = threadIdx.x;
    const int k0 = blockIdx.x * F_BK;
    const int b = blockIdx.y;
    const float* qb = q + (size_t)b * nq * d;
    const float* kb = k + (size_t)b * nk * d;
    const float* vb = v + (size_t)b * nk * c;
    const float* dob = dout + (size_t)b * nq * c;
    const float* lb = lse + (size_t)b * nq;
    const float* deb = delta + (size_t)b * nq;
    float* dqb = dq + (size_t)b * nq * d;

    for (int i = tid; i < F_BK * d; i += F_THREADS) {
        const int r = i / d, j = i - r * d;
        ks[r * dl + j] = (k0 + r < nk) ? kb[(size_t)(k0 + r) * d + j] : 0.f;
    }
    for (int i = tid; i < F_BK * c; i += F_THREADS) {
        const int r = i / c, j = i - r * c;
        vs[r * cl + j] = (k0 + r < nk) ? vb[(size_t)(k0 + r) * c + j] : 0.f;
    }

    // this thread's key (dk/dv rows) and column set: col = sub + 8 * m
    const int my_key = tid >> 3, sub = tid & 7;
    float dvacc[MAX_C / 8], dkacc[MAX_D / 8];
#pragma unroll
    for (int m = 0; m < MAX_C / 8; ++m) dvacc[m] = 0.f;
#pragma unroll
    for (int m = 0; m < MAX_D / 8; ++m) dkacc[m] = 0.f;

    for (int q0 = 0; q0 < nq; q0 += F_BQ) {
        __syncthreads();  // the previous tile is consumed (and ks/vs staged)
        for (int i = tid; i < F_BQ * d; i += F_THREADS) {
            const int r = i / d, j = i - r * d;
            qs[r * dl + j] = (q0 + r < nq) ? qb[(size_t)(q0 + r) * d + j] : 0.f;
        }
        for (int i = tid; i < F_BQ * c; i += F_THREADS) {
            const int r = i / c, j = i - r * c;
            dos[r * cl + j] = (q0 + r < nq) ? dob[(size_t)(q0 + r) * c + j] : 0.f;
        }
        if (tid < F_BQ) {
            const bool ok = q0 + tid < nq;
            lses[tid] = ok ? lb[q0 + tid] : 0.f;
            dels[tid] = ok ? deb[q0 + tid] : 0.f;
        }
        __syncthreads();

        // p and ds for query row qi and keys sub + 8 * m
        {
            const int qi = tid >> 3;
#pragma unroll
            for (int m = 0; m < F_BK / 8; ++m) {
                const int kj = sub + 8 * m;
                float s = 0.f, dp = 0.f;
                for (int j = 0; j < d; ++j) s = fmaf(qs[qi * dl + j], ks[kj * dl + j], s);
                for (int j = 0; j < c; ++j) dp = fmaf(dos[qi * cl + j], vs[kj * cl + j], dp);
                const bool ok = (q0 + qi < nq) && (k0 + kj < nk);
                const float p = ok ? __expf(s - lses[qi]) : 0.f;
                ps[qi * (F_BK + 1) + kj] = p;
                dss[qi * (F_BK + 1) + kj] = p * (dp - dels[qi]);
            }
        }
        __syncthreads();

        // dv[my_key] += p^T do, dk[my_key] += ds^T q.  The loops over this
        // thread's columns are unrolled to MAX_C / 8 and MAX_D / 8 (so the
        // accumulators stay in registers) and leave at the first column past
        // c or d, rather than testing every unrolled column.
        const int qmax = min(F_BQ, nq - q0);
        for (int i = 0; i < qmax; ++i) {
            const float p = ps[i * (F_BK + 1) + my_key];
            const float ds = dss[i * (F_BK + 1) + my_key];
#pragma unroll
            for (int m = 0; m < MAX_C / 8; ++m) {
                if (sub + 8 * m >= c) break;
                dvacc[m] = fmaf(p, dos[i * cl + sub + 8 * m], dvacc[m]);
            }
#pragma unroll
            for (int m = 0; m < MAX_D / 8; ++m) {
                if (sub + 8 * m >= d) break;
                dkacc[m] = fmaf(ds, qs[i * dl + sub + 8 * m], dkacc[m]);
            }
        }

        // dq[query] += ds k over this block's keys
        {
            const int qi = tid >> 3;
            if (q0 + qi < nq) {
                for (int j = sub; j < d; j += 8) {
                    float acc = 0.f;
#pragma unroll 8
                    for (int kj = 0; kj < F_BK; ++kj)
                        acc = fmaf(dss[qi * (F_BK + 1) + kj], ks[kj * dl + j], acc);
                    atomicAdd(&dqb[(size_t)(q0 + qi) * d + j], acc);
                }
            }
        }
    }

    if (k0 + my_key < nk) {
        float* dkr = dk + ((size_t)b * nk + k0 + my_key) * d;
        float* dvr = dv + ((size_t)b * nk + k0 + my_key) * c;
#pragma unroll
        for (int m = 0; m < MAX_C / 8; ++m)
            if (sub + 8 * m < c) dvr[sub + 8 * m] = dvacc[m];
#pragma unroll
        for (int m = 0; m < MAX_D / 8; ++m)
            if (sub + 8 * m < d) dkr[sub + 8 * m] = dkacc[m];
    }
}

int launch_f32(const float* q, const float* k, const float* v, const float* o,
               const float* dout, const float* lse, const float* dlse, float* delta,
               float* dq, float* dk, float* dv, int b, int nq, int nk, int d, int c,
               cudaStream_t stream) {
    const int rows = b * nq;
    bwd_delta<float><<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, dlse, delta, rows, c);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = sizeof(float) * ((size_t)(F_BK + F_BQ) * (d + 1 + c + 1)
                                         + 2 * F_BQ * (F_BK + 1) + 2 * F_BQ);
    err = cudaFuncSetAttribute(flash_bwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nk + F_BK - 1) / F_BK, b);
    flash_bwd_f32<<<grid, F_THREADS, smem, stream>>>(q, k, v, dout, lse, delta, dq, dk, dv,
                                                     nq, nk, d, c);
    return (int)cudaGetLastError();
}

// ---- bf16: tensor-core kernel (mma.sync m16n8k16) ---------------------------

constexpr int TC_BQ = 64;   // query rows per inner tile
constexpr int TC_PAD = 8;   // row padding (bf16): conflict-free fragment reads
constexpr int TC_MAX_THREADS = 256;

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * group + tig.
//   A (16x16, row): {a0,a1} (group, 2tig..+1), {a2,a3} (group+8, 2tig..+1),
//                   {a4,a5} (group, 2tig+8..+9), {a6,a7} (group+8, 2tig+8..+9)
//   B (16x8, col):  {b0,b1} (k 2tig..+1, n group), {b2,b3} (k 2tig+8..+9, n group)
//   C (16x8):       {c0,c1} (group, 2tig..+1), {c2,c3} (group+8, 2tig..+1)
// The transposed scores s^T [16 keys x 8 queries] of two adjacent query
// tiles form one A fragment [16 keys x 16 queries] of dv = p^T do and
// dk = ds^T q.
//
// Block: KG key groups of 16 keys (BKV = 16 KG keys), G column groups of
// CW columns of C; warp w = (kg = w / G, g = w % G); KG * G <= 8.
template <int D, int CW>
__global__ void __launch_bounds__(TC_MAX_THREADS)
flash_bwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
               __nv_bfloat16* __restrict__ dv, int nq, int nk, int d, int c, int kgroups) {
    constexpr int QLD = D + TC_PAD;           // row stride of the q tile
    constexpr int NQT = TC_BQ / 8;            // 8-query tiles of the inner tile
    const int groups = c / CW;                // G
    const int bkv = 16 * kgroups;             // keys per block
    const int vld = c + TC_PAD;               // row stride of v and do tiles
    const int dsld = bkv + TC_PAD;            // row stride of the ds tile
    const int dpld = TC_BQ + 4;               // row stride of the dp partials

    extern __shared__ __align__(16) unsigned char tsm[];
    __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(tsm);  // [bkv][QLD]
    __nv_bfloat16* vs = ks + bkv * QLD;                         // [bkv][vld]
    __nv_bfloat16* qs = vs + bkv * vld;                         // [TC_BQ][QLD]
    __nv_bfloat16* dos = qs + TC_BQ * QLD;                      // [TC_BQ][vld]
    __nv_bfloat16* dss = dos + TC_BQ * vld;                     // [TC_BQ][dsld]
    float* lses = reinterpret_cast<float*>(dss + TC_BQ * dsld); // [TC_BQ]
    float* dels = lses + TC_BQ;                                 // [TC_BQ]
    float* dpp = dels + TC_BQ;                                  // [G][bkv][dpld]

    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int group = lane >> 2, tig = lane & 3;
    const int kg = warp / groups, g = warp % groups;
    const int k0 = blockIdx.x * bkv;
    const int b = blockIdx.y;
    const int kl0 = kg * 16 + group, kl1 = kl0 + 8;  // this lane's keys, in the block
    const int key0 = k0 + kl0, key1 = k0 + kl1;

    const __nv_bfloat16* qb = q + (size_t)b * nq * d;
    const __nv_bfloat16* kb = k + (size_t)b * nk * d;
    const __nv_bfloat16* vb = v + (size_t)b * nk * c;
    const __nv_bfloat16* dob = dout + (size_t)b * nq * c;
    const float* lb = lse + (size_t)b * nq;
    const float* deb = delta + (size_t)b * nq;

    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    // K and V tiles of the block, once; keys past nk and columns past d are 0
    for (int i = tid; i < bkv * (D / 8); i += nthreads) {
        const int r = i / (D / 8), col = (i % (D / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < nk && col < d)
            val = *reinterpret_cast<const uint4*>(&kb[(size_t)(k0 + r) * d + col]);
        *reinterpret_cast<uint4*>(&ks[r * QLD + col]) = val;
    }
    for (int i = tid; i < bkv * (c / 8); i += nthreads) {
        const int r = i / (c / 8), col = (i % (c / 8)) * 8;
        uint4 val = zero;
        if (k0 + r < nk)
            val = *reinterpret_cast<const uint4*>(&vb[(size_t)(k0 + r) * c + col]);
        *reinterpret_cast<uint4*>(&vs[r * vld + col]) = val;
    }
    __syncthreads();

    // K of this warp's 16 keys as A fragments of s^T = k q^T
    uint32_t ka[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int col = kk * 16 + 2 * tig;
        ka[kk][0] = ld32(&ks[kl0 * QLD + col]);
        ka[kk][1] = ld32(&ks[kl1 * QLD + col]);
        ka[kk][2] = ld32(&ks[kl0 * QLD + col + 8]);
        ka[kk][3] = ld32(&ks[kl1 * QLD + col + 8]);
    }

    float dvacc[CW / 8][4];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dvacc[n][e] = 0.f;
    // dk of 16 columns per j; this warp owns j = g, g + G, ...
    float dkacc[D / 16][2][4];
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) dkacc[j][h][e] = 0.f;

    const int cw0 = g * CW;  // this warp's columns of C
    const int nwarps = nthreads >> 5;

    for (int q0 = 0; q0 < nq; q0 += TC_BQ) {
        __syncthreads();  // the previous tile (qs, dos, dss, dpp) is consumed
        for (int i = tid; i < TC_BQ * (D / 8); i += nthreads) {
            const int r = i / (D / 8), col = (i % (D / 8)) * 8;
            uint4 val = zero;
            if (q0 + r < nq && col < d)
                val = *reinterpret_cast<const uint4*>(&qb[(size_t)(q0 + r) * d + col]);
            *reinterpret_cast<uint4*>(&qs[r * QLD + col]) = val;
        }
        for (int i = tid; i < TC_BQ * (c / 8); i += nthreads) {
            const int r = i / (c / 8), col = (i % (c / 8)) * 8;
            uint4 val = zero;
            if (q0 + r < nq)
                val = *reinterpret_cast<const uint4*>(&dob[(size_t)(q0 + r) * c + col]);
            *reinterpret_cast<uint4*>(&dos[r * vld + col]) = val;
        }
        for (int i = tid; i < TC_BQ; i += nthreads) {
            const bool ok = q0 + i < nq;
            lses[i] = ok ? lb[q0 + i] : 0.f;
            dels[i] = ok ? deb[q0 + i] : 0.f;
        }
        __syncthreads();

        // s^T = k q^T (this warp's 16 keys x 64 queries), then p
        float p[NQT][4];
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
                const __nv_bfloat16* qp = &qs[(nt * 8 + group) * QLD + kk * 16 + 2 * tig];
                mma_bf16(p[nt], ka[kk], ld32(qp), ld32(qp + 8));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int ql = nt * 8 + 2 * tig + (e & 1);
                const bool ok = (q0 + ql < nq) && ((e < 2 ? key0 : key1) < nk);
                p[nt][e] = ok ? __expf(p[nt][e] - lses[ql]) : 0.f;
            }
        }

        // dp^T = v do^T over this warp's CW columns of C
        float dp[NQT][4];
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[nt][e] = 0.f;
#pragma unroll 2
        for (int kc = 0; kc < CW / 16; ++kc) {
            const int col = cw0 + kc * 16 + 2 * tig;
            const uint32_t va[4] = {ld32(&vs[kl0 * vld + col]), ld32(&vs[kl1 * vld + col]),
                                    ld32(&vs[kl0 * vld + col + 8]),
                                    ld32(&vs[kl1 * vld + col + 8])};
#pragma unroll
            for (int nt = 0; nt < NQT; ++nt) {
                const __nv_bfloat16* dp_ = &dos[(nt * 8 + group) * vld + col];
                mma_bf16(dp[nt], va, ld32(dp_), ld32(dp_ + 8));
            }
        }
        if (groups > 1) {  // add the partial dp of the key group's G warps
            float* mine = dpp + (size_t)g * bkv * dpld;
#pragma unroll
            for (int nt = 0; nt < NQT; ++nt) {
                const int ql = nt * 8 + 2 * tig;
                *reinterpret_cast<float2*>(&mine[kl0 * dpld + ql]) =
                    make_float2(dp[nt][0], dp[nt][1]);
                *reinterpret_cast<float2*>(&mine[kl1 * dpld + ql]) =
                    make_float2(dp[nt][2], dp[nt][3]);
            }
            __syncthreads();
#pragma unroll
            for (int nt = 0; nt < NQT; ++nt) {
                const int ql = nt * 8 + 2 * tig;
                float2 s0 = make_float2(0.f, 0.f), s1 = make_float2(0.f, 0.f);
                for (int gg = 0; gg < groups; ++gg) {
                    const float* part = dpp + (size_t)gg * bkv * dpld;
                    const float2 a = *reinterpret_cast<const float2*>(&part[kl0 * dpld + ql]);
                    const float2 bb = *reinterpret_cast<const float2*>(&part[kl1 * dpld + ql]);
                    s0.x += a.x; s0.y += a.y; s1.x += bb.x; s1.y += bb.y;
                }
                dp[nt][0] = s0.x; dp[nt][1] = s0.y; dp[nt][2] = s1.x; dp[nt][3] = s1.y;
            }
        }
        // ds = p (dp - delta), kept in dp
#pragma unroll
        for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                dp[nt][e] = p[nt][e] * (dp[nt][e] - dels[nt * 8 + 2 * tig + (e & 1)]);

        // dv += p^T do (this warp's columns), dk += ds^T q (its 16-column slabs)
#pragma unroll
        for (int kk = 0; kk < TC_BQ / 16; ++kk) {
            const uint32_t pa[4] = {
                pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
            const uint32_t sa[4] = {
                pack_bf16(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
            const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
            for (int np = 0; np < CW / 16; ++np) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, &dos[row * vld + cw0 + np * 16 + (lane >> 4) * 8]);
                mma_bf16(dvacc[2 * np], pa, bv[0], bv[1]);
                mma_bf16(dvacc[2 * np + 1], pa, bv[2], bv[3]);
            }
#pragma unroll
            for (int j = 0; j < D / 16; ++j) {
                if (j % groups != g) continue;
                uint32_t bq[4];
                ldmatrix_x4_trans(bq, &qs[row * QLD + j * 16 + (lane >> 4) * 8]);
                mma_bf16(dkacc[j][0], sa, bq[0], bq[1]);
                mma_bf16(dkacc[j][1], sa, bq[2], bq[3]);
            }
        }

        // ds (bf16) to shared memory as [query][key], for dq = ds k
        if (g == 0) {
#pragma unroll
            for (int nt = 0; nt < NQT; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    dss[(nt * 8 + 2 * tig + (e & 1)) * dsld + (e < 2 ? kl0 : kl1)] =
                        __float2bfloat16(dp[nt][e]);
        }
        __syncthreads();

        // dq[64 queries x D] += ds k over the block's keys; units of 16 x 16
        for (int u = warp; u < (TC_BQ / 16) * (D / 16); u += nwarps) {
            const int mq = u / (D / 16), j = u % (D / 16);
            float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            const int r0 = mq * 16 + group;
            for (int kk = 0; kk < bkv / 16; ++kk) {
                const int col = kk * 16 + 2 * tig;
                const uint32_t a[4] = {ld32(&dss[r0 * dsld + col]),
                                       ld32(&dss[(r0 + 8) * dsld + col]),
                                       ld32(&dss[r0 * dsld + col + 8]),
                                       ld32(&dss[(r0 + 8) * dsld + col + 8])};
                uint32_t bk[4];
                const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
                ldmatrix_x4_trans(bk, &ks[row * QLD + j * 16 + (lane >> 4) * 8]);
                mma_bf16(acc[0], a, bk[0], bk[1]);
                mma_bf16(acc[1], a, bk[2], bk[3]);
            }
            float* dqb = dq + (size_t)b * nq * d;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int col = j * 16 + h * 8 + 2 * tig;
                if (col >= d) continue;
                if (q0 + r0 < nq) {
                    atomicAdd(&dqb[(size_t)(q0 + r0) * d + col], acc[h][0]);
                    atomicAdd(&dqb[(size_t)(q0 + r0) * d + col + 1], acc[h][1]);
                }
                if (q0 + r0 + 8 < nq) {
                    atomicAdd(&dqb[(size_t)(q0 + r0 + 8) * d + col], acc[h][2]);
                    atomicAdd(&dqb[(size_t)(q0 + r0 + 8) * d + col + 1], acc[h][3]);
                }
            }
        }
    }

    // dk and dv, rounded once
    __nv_bfloat16* dvb = dv + (size_t)b * nk * c;
    __nv_bfloat16* dkb = dk + (size_t)b * nk * d;
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
        const int col = cw0 + n * 8 + 2 * tig;
        if (key0 < nk)
            *reinterpret_cast<uint32_t*>(&dvb[(size_t)key0 * c + col]) =
                pack_bf16(dvacc[n][0], dvacc[n][1]);
        if (key1 < nk)
            *reinterpret_cast<uint32_t*>(&dvb[(size_t)key1 * c + col]) =
                pack_bf16(dvacc[n][2], dvacc[n][3]);
    }
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
        if (j % groups != g) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int col = j * 16 + h * 8 + 2 * tig;
            if (col >= d) continue;
            if (key0 < nk)
                *reinterpret_cast<uint32_t*>(&dkb[(size_t)key0 * d + col]) =
                    pack_bf16(dkacc[j][h][0], dkacc[j][h][1]);
            if (key1 < nk)
                *reinterpret_cast<uint32_t*>(&dkb[(size_t)key1 * d + col]) =
                    pack_bf16(dkacc[j][h][2], dkacc[j][h][3]);
        }
    }
}

template <int D, int CW>
int launch_bf16_dc(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const __nv_bfloat16* dout, const float* lse, const float* delta,
                   float* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk,
                   int d, int c, cudaStream_t stream) {
    const int groups = c / CW;
    const int kgroups = groups <= 2 ? 4 : 8 / groups;  // warps = kgroups * groups <= 8
    const int bkv = 16 * kgroups;
    const size_t smem =
        sizeof(__nv_bfloat16) * ((size_t)(bkv + TC_BQ) * (D + TC_PAD)
                                 + (size_t)(bkv + TC_BQ) * (c + TC_PAD)
                                 + (size_t)TC_BQ * (bkv + TC_PAD))
        + sizeof(float) * (2 * TC_BQ + (groups > 1 ? (size_t)groups * bkv * (TC_BQ + 4) : 0));
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_bf16<D, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((nk + bkv - 1) / bkv, b);
    flash_bwd_bf16<D, CW><<<grid, 32 * kgroups * groups, smem, stream>>>(
        q, k, v, dout, lse, delta, dq, dk, dv, nq, nk, d, c, kgroups);
    return (int)cudaGetLastError();
}

template <int D>
int launch_bf16_d(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                  const __nv_bfloat16* dout, const float* lse, const float* delta, float* dq,
                  __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk, int d, int c,
                  cudaStream_t stream) {
    if (c % 128 == 0)
        return launch_bf16_dc<D, 128>(q, k, v, dout, lse, delta, dq, dk, dv, b, nq, nk, d, c,
                                      stream);
    if (c % WIDE_C_MULTIPLE == 0)
        return launch_bf16_dc<D, 64>(q, k, v, dout, lse, delta, dq, dk, dv, b, nq, nk, d, c,
                                     stream);
    return launch_bf16_dc<D, 16>(q, k, v, dout, lse, delta, dq, dk, dv, b, nq, nk, d, c,
                                 stream);
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                const float* dlse, float* delta, float* dq_acc, __nv_bfloat16* dq,
                __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk, int d, int c,
                cudaStream_t stream) {
    if (d % 8) return (int)cudaErrorInvalidValue;  // 16-byte row chunks
    const int rows = b * nq;
    bwd_delta<__nv_bfloat16><<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, dlse, delta, rows,
                                                                 c);
    int err = (int)cudaGetLastError();
    if (err) return err;
    if (d <= 16)
        err = launch_bf16_d<16>(q, k, v, dout, lse, delta, dq_acc, dk, dv, b, nq, nk, d, c, stream);
    else if (d <= 32)
        err = launch_bf16_d<32>(q, k, v, dout, lse, delta, dq_acc, dk, dv, b, nq, nk, d, c, stream);
    else if (d <= 64)
        err = launch_bf16_d<64>(q, k, v, dout, lse, delta, dq_acc, dk, dv, b, nq, nk, d, c, stream);
    else
        err = launch_bf16_d<128>(q, k, v, dout, lse, delta, dq_acc, dk, dv, b, nq, nk, d, c, stream);
    if (err) return err;
    const size_t n = (size_t)b * nq * d;
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    round_to_bf16<<<blocks, 256, 0, stream>>>(dq_acc, dq, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sap3d_flash_bwd_max_d() { return MAX_D; }
int sap3d_flash_bwd_max_c() { return MAX_C; }
int sap3d_flash_bwd_c_multiple() { return C_MULTIPLE; }
int sap3d_flash_bwd_wide_c_multiple() { return WIDE_C_MULTIPLE; }
int sap3d_flash_bwd_narrow_max_c() { return NARROW_MAX_C; }

// dtype: 0 = float32, 1 = bfloat16.  Inputs q, k, v, o, dout (= do) in that
// dtype, lse [B, Nq] float32, and dlse [B, Nq] float32 (B4) or null (B3).
// Scratch: delta [B, Nq] float32, and dq_acc [B, Nq, d] float32 set to zero
// by the caller (for float32, dq_acc is dq itself and dq is ignored).
// Outputs dq, dk, dv.  Returns a cudaError_t (0 = launched); invalid
// arguments return cudaErrorInvalidValue without launching.
int sap3d_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, const void* dlse, void* delta,
                    void* dq_acc, void* dq, void* dk, void* dv, int b, int nq, int nk, int d,
                    int c, int dtype, void* stream) {
    if (b <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D || c <= 0 || c > MAX_C ||
        c % C_MULTIPLE || (c > NARROW_MAX_C && c % WIDE_C_MULTIPLE))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(o),
                          static_cast<const float*>(dout), static_cast<const float*>(lse),
                          static_cast<const float*>(dlse), static_cast<float*>(delta),
                          static_cast<float*>(dq_acc),
                          static_cast<float*>(dk), static_cast<float*>(dv), b, nq, nk, d, c,
                          s);
    if (dtype == 1)
        return launch_bf16(static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k),
                           static_cast<const __nv_bfloat16*>(v),
                           static_cast<const __nv_bfloat16*>(o),
                           static_cast<const __nv_bfloat16*>(dout),
                           static_cast<const float*>(lse), static_cast<const float*>(dlse),
                           static_cast<float*>(delta), static_cast<float*>(dq_acc),
                           static_cast<__nv_bfloat16*>(dq),
                           static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                           b, nq, nk, d, c, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
