// The wgmma forward body shared by flash_attention_fwd.cu (B1, B2 and the
// row-stats kernel) and flash_attention_nolse.cu (B6's second pass): the
// kernel `flash_fwd_bf16<D, CW, NP, PRENORM>`, its host plan and launchers,
// and the layout helpers that `flash_row_stats` (flash_attention_fwd.cu)
// shares.  flash_attention_fwd.cu's header states the design; each source
// instantiates what it launches.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "split_bf16.cuh"

namespace {

constexpr int MAX_D = 128;
constexpr int C_MULTIPLE = 16;  // C must be a multiple of this

namespace wg {

constexpr int ROWS = 64;             // query rows per warpgroup: wgmma's M
constexpr int WG_THREADS = 128;
constexpr int MAX_WGS = 2;           // consumer warpgroups per CTA
constexpr int SM_COUNT = 132;        // an H100 SXM's SMs: the plan fills them
constexpr float RESCALE_LOG2 = 8.f;  // a row's max moves only past this (log2 units)
// Bytes allocated beyond the layout to align its base to 1024: the dynamic
// shared memory starts at least 128-byte aligned, so at most 896 are
// skipped (a kernel that finds more traps).  With a whole 1024 the CTA of
// one warpgroup at d = 128, C = 1024 would miss two CTAs per SM by 40 bytes.
constexpr uint32_t SMEM_SLACK = 896;

// Keys per streamed tile beside an accumulator of CW columns.  bf16 (one
// plane): 64 from CW = 64 up (at CW = 256 beside 128 accumulator registers
// a thread; at 64 and 128 so that a thread fits in 128 registers and two
// 256-thread CTAs share an SM), 128 below (the narrow slabs: fewer, longer
// tiles).  Split fp32 (three planes): 64, or 32 at D = 128, where three
// planes of 64-key K tiles would not fit.
__host__ __device__ constexpr int key_tile(int d_tile, int cw, int np) {
    return np == 1 ? (cw >= 64 ? 64 : 128) : (d_tile >= 128 ? 32 : 64);
}

// The slab of C per CTA: the least of 16 ... 256 that covers C (128 in
// split fp32, whose slab keeps a second accumulator, each tile's, beside O).
__host__ __device__ constexpr int slab_width(int c, int np) {
    return c <= 16 ? 16 : c <= 32 ? 32 : c <= 64 ? 64 : c <= 128 || np != 1 ? 128 : 256;
}

__host__ __device__ constexpr uint32_t align1k(uint32_t x) { return (x + 1023u) & ~1023u; }

// Shared memory from a 1024-byte aligned base: the np planes of Q (wgs x 64
// rows each), then the ring's stages of (np planes of the K tile, np
// planes of the V tile), then the mbarriers (Q, full[stages],
// empty[stages]).  Every tile starts on a 1024-byte boundary, so that TMA's
// and wgmma's swizzles agree.  The row-stats kernel takes the same layout
// with no V tile (cw = 0).
struct Layout {
    uint32_t q_plane, k_plane, v_plane, stage, v, stage_bytes, bars, total;
};

__host__ __device__ inline Layout layout(int d_tile, int cw, int wgs, int stages, int np,
                                         int bk) {
    Layout L;
    L.q_plane = align1k(wgs * ROWS * d_tile * 2);
    L.k_plane = align1k(bk * d_tile * 2);
    L.v_plane = align1k(bk * cw * 2);
    L.stage = np * L.q_plane;
    L.v = np * L.k_plane;
    L.stage_bytes = L.v + np * L.v_plane;
    L.bars = L.stage + stages * L.stage_bytes;
    L.total = L.bars + 8 * (1 + 2 * stages);
    return L;
}

__host__ __device__ inline Layout layout(int d_tile, int cw, int wgs, int stages, int np) {
    return layout(d_tile, cw, wgs, stages, np, key_tile(d_tile, cw, np));
}

// How one call is cut: d padded to the q and k box width (d_tile), the slab
// of C per CTA (cw) and the slabs, keys per tile (bk), warpgroups per CTA
// (64 query rows each), ring stages, dynamic shared memory, the grid, and
// the CTAs per SM that the plan counts on (registers and shared memory).
struct Plan {
    int d_tile, cw, slabs, bk, wgs, stages, smem, gx, gy, gz, resident;
};

constexpr int SMEM_PER_SM = 233472;   // an H100's shared memory per SM
constexpr int MAX_CTA_SMEM = 232448;  // the most one CTA may take
constexpr int CTA_RESERVE = 1024;     // the runtime's reserve per CTA

__host__ __device__ constexpr int d_tile_of(int dp) {
    return dp <= 16 ? 16 : dp <= 32 ? 32 : dp <= 64 ? 64 : 128;
}

// np: 1 for bf16 operands, 3 for split fp32 (split_bf16.cuh).
inline Plan plan(int b, int nq, int nk, int dp, int c, int np) {
    (void)nk;  // every key tile costs the same: nk does not change the cut
    Plan p;
    p.d_tile = d_tile_of(dp);
    p.cw = slab_width(c, np);
    p.slabs = (c + p.cw - 1) / p.cw;
    p.bk = key_tile(p.d_tile, p.cw, np);
    // Two warpgroups share each K and V tile (half the L2 reads per query
    // row) unless 64-row CTAs take fewer waves over the SMs.  Registers hold
    // one 256-thread CTA per SM (two in bf16 at CW <= 128, the launch
    // bounds) or twice as many of 128 threads; one warpgroup keeps 2
    // stages, so that two CTAs fit in shared memory, two keep 3, or 2 where
    // 3 do not fit (split planes), and a cut that does not fit is not taken.
    long long best = 0;
    for (int w = MAX_WGS; w >= 1; --w) {
        int stages = w == 1 ? 2 : 3;
        int smem = (int)(layout(p.d_tile, p.cw, w, stages, np).total + SMEM_SLACK);
        if (smem > MAX_CTA_SMEM && stages > 2)
            smem = (int)(layout(p.d_tile, p.cw, w, --stages, np).total + SMEM_SLACK);
        if (smem > MAX_CTA_SMEM) continue;
        const int by_regs = (np == 1 && p.cw <= 128 ? 2 : 1) * (MAX_WGS / w);
        const int by_smem = SMEM_PER_SM / (smem + CTA_RESERVE);
        const int resident = by_regs < by_smem ? by_regs : by_smem;
        const long long ctas = (long long)b * ((nq + w * ROWS - 1) / (w * ROWS)) * p.slabs;
        const long long slots = (long long)SM_COUNT * resident;
        const long long waves = (ctas + slots - 1) / slots;
        if (best == 0 || waves < best) {  // ties keep two warpgroups
            best = waves;
            p.wgs = w;
            p.stages = stages;
            p.smem = smem;
            p.resident = resident;
        }
    }
    p.gx = (nq + ROWS * p.wgs - 1) / (ROWS * p.wgs);
    p.gy = p.slabs;
    p.gz = b;
    return p;
}

struct Params {
    void* o;             // [B, nq, c], bf16 (one plane) or float32 (split)
    float* lse;          // [B, nq], or null (B1)
    const float* row_m;  // PRENORM: each row's max m and 1/l, [B, nq]
    const float* row_inv;
    int nq, nk, c, stages, batch;
};

__device__ __forceinline__ uint8_t* smem_base() {
    extern __shared__ __align__(128) uint8_t dyn_smem[];
    const uint32_t pad = (1024u - (hopper::smem_u32(dyn_smem) & 1023u)) & 1023u;
    if (pad > SMEM_SLACK) __trap();
    return dyn_smem + pad;
}

// Operand descriptors of a tile stored as boxes of R rows x W bf16 columns
// (hopper.cuh states the layouts).  K-major: k-step kk covers columns
// 16 kk ..; MN-major: rows 16 kk ...
template <int W, int R>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + (kk * 16 / W) * (R * W * 2) + (kk * 16 % W) * 2, 16, 16 * W,
                             2 * W);
}

template <int W, int R>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + kk * 32 * W, R * W * 2, 16 * W, 2 * W);
}

// D: d padded to 16/32/64/128 (q and k boxes of min(D, 64) columns); CW:
// the slab of C (v boxes of 16 columns below 64, else 64); NP: planes per
// operand, 1 (bf16 in and out) or 3 (fp32 in and out, each product the six
// of split_bf16.cuh).  PRENORM (B6's second pass): each row's max m and
// 1/l come in (`flash_row_stats`), p = exp(s - m) / l is formed in fp32 and
// rounded to bf16 (or split) before P V, with no running max, no rescale
// and no final division.
template <int D, int CW, int NP, bool PRENORM>
__global__ void __launch_bounds__(MAX_WGS * WG_THREADS, NP == 1 && CW <= 128 ? 2 : 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const Params p) {
    using namespace hopper;
    using flash::ex2;
    using flash::LOG2E;
    using split::plane_a;
    using split::plane_b;
    constexpr int BK = key_tile(D, CW, NP);
    constexpr int KW = D < 64 ? D : 64;
    constexpr int VW = CW < 64 ? 16 : 64;
    constexpr int FIRST = split::first_product(NP);
    const int wgs = blockDim.x / WG_THREADS, stages = p.stages;
    const Layout L = layout(D, CW, wgs, stages, NP);
    uint8_t* sm = smem_base();
    const int q0 = blockIdx.x * wgs * ROWS, c0 = blockIdx.y * CW, b = blockIdx.z;
    const int active = min(wgs, (p.nq - q0 + ROWS - 1) / ROWS);  // warpgroups with rows
    const int nt = (p.nk + BK - 1) / BK;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + stages;
    // v boxes wholly past C (a last slab narrower than CW) are not loaded;
    // their columns of O are never stored
    const int v_boxes = min(CW / VW, (p.c - c0 + VW - 1) / VW);
    const uint32_t tile_bytes = NP * (BK * D * 2 + v_boxes * BK * VW * 2);
    // plane pl of batch element b is z = pl B + b of the tensor maps
    auto load_tile = [&](int t, int st) {
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        mbar_arrive_expect_tx(&full[st], tile_bytes);
        for (int pl = 0; pl < NP; ++pl) {
            for (int j = 0; j < D / KW; ++j)
                tma_load_3d(stage + pl * L.k_plane + j * BK * KW * 2, &tk, &full[st], j * KW,
                            t * BK, pl * p.batch + b);
            for (int j = 0; j < v_boxes; ++j)
                tma_load_3d(stage + L.v + pl * L.v_plane + j * BK * VW * 2, &tv, &full[st],
                            c0 + j * VW, t * BK, pl * p.batch + b);
        }
    };
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);            // thread 0's arrival + the bytes
            mbar_init(&empty[s], 4 * active);  // one arrival per warp
        }
        fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / WG_THREADS;
    if (wg >= active) return;  // all of this warpgroup's rows lie past nq
    if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&bars[0], NP * active * ROWS * D * 2);
        for (int pl = 0; pl < NP; ++pl)
            for (int w = 0; w < active; ++w)
                for (int j = 0; j < D / KW; ++j)
                    tma_load_3d(sm + pl * L.q_plane + w * ROWS * D * 2 + j * ROWS * KW * 2, &tq,
                                &bars[0], j * KW, q0 + w * ROWS, pl * p.batch + b);
        for (int t = 0; t < stages && t < nt; ++t) load_tile(t, t);
    }
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, qd = lane & 3;
    const int row0 = q0 + wg * ROWS + 16 * warp + g, row1 = row0 + 8;
    const uint8_t* qs = sm + wg * ROWS * D * 2;
    float o[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
    // running max (log2 units) and this thread's share of the sums of rows
    // g and g + 8 of its warp; PRENORM: -m log2(e) and 1/l of the two rows
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    if constexpr (PRENORM) {
        const size_t r0 = (size_t)b * p.nq + row0;
        m0 = row0 < p.nq ? -p.row_m[r0] * LOG2E : 0.f;
        m1 = row1 < p.nq ? -p.row_m[r0 + 8] * LOG2E : 0.f;
        l0 = row0 < p.nq ? p.row_inv[r0] : 0.f;
        l1 = row1 < p.nq ? p.row_inv[r0 + 8] : 0.f;
    }
    mbar_wait(&bars[0], 0);

    for (int t = 0; t < nt; ++t) {
        const int st = t % stages;
        const uint8_t* ks = sm + L.stage + st * L.stage_bytes;
        const uint8_t* vs = ks + L.v;
        mbar_wait(&full[st], (t / stages) & 1);
        float s[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int i = FIRST; i < split::PRODUCTS; ++i)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<BK, 0, 0>(s, kmajor<KW, ROWS>(qs + plane_a(i) * L.q_plane, kk),
                                   kmajor<KW, BK>(ks + plane_b(i) * L.k_plane, kk),
                                   i > FIRST || kk > 0);
        wgmma_commit();
        // under the product: once every warp is done with tile t - 1, its
        // stage takes tile t - 1 + stages
        if (threadIdx.x == 0 && t > 0 && t - 1 + stages < nt) {
            const int ps = (t - 1) % stages;
            mbar_wait(&empty[ps], ((t - 1) / stages) & 1);
            load_tile(t - 1 + stages, ps);
        }
        __syncwarp();
        wgmma_wait<0>();
        fence_regs(s);
        if (t == nt - 1 && nt * BK > p.nk) {  // keys past nk score -inf
            const int valid = p.nk - t * BK;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                const int col = 8 * j + 2 * qd;
                if (col >= valid) s[4 * j] = s[4 * j + 2] = -INFINITY;
                if (col + 1 >= valid) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
            }
        }
        if constexpr (PRENORM) {
            // p = 2^(s log2(e) - m log2(e)) / l, in fp32
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                s[4 * j] = ex2(fmaf(s[4 * j], LOG2E, m0)) * l0;
                s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, m0)) * l0;
                s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, m1)) * l1;
                s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, m1)) * l1;
            }
        } else {
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
                mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
            mx0 = flash::quad_max(mx0) * LOG2E;  // finite: every tile holds a valid key
            mx1 = flash::quad_max(mx1) * LOG2E;
            if (__any_sync(0xffffffffu, mx0 > m0 + RESCALE_LOG2 || mx1 > m1 + RESCALE_LOG2)) {
                const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
                const float a0 = ex2(m0 - n0), a1 = ex2(m1 - n1);  // 0 on the first tile
                m0 = n0;
                m1 = n1;
                l0 *= a0;
                l1 *= a1;
#pragma unroll
                for (int j = 0; j < CW / 8; ++j) {
                    o[4 * j] *= a0;
                    o[4 * j + 1] *= a0;
                    o[4 * j + 2] *= a1;
                    o[4 * j + 3] *= a1;
                }
            }
            const float nm0 = -m0, nm1 = -m1;
            float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;  // two chains per row
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                s[4 * j] = ex2(fmaf(s[4 * j], LOG2E, nm0));
                s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, nm0));
                s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, nm1));
                s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, nm1));
                if (j & 1) {
                    sb0 += s[4 * j] + s[4 * j + 1];
                    sb1 += s[4 * j + 2] + s[4 * j + 3];
                } else {
                    sa0 += s[4 * j] + s[4 * j + 1];
                    sa1 += s[4 * j + 2] + s[4 * j + 3];
                }
            }
            l0 += sa0 + sb0;
            l1 += sa1 + sb1;
        }
        // o += p v, p as the register A operand: rounded to bf16 (one
        // plane), or split into three
        uint32_t pa[NP][BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            if constexpr (NP == 1) accum_to_a(s, kk, pa[0][kk]);
            else accum_to_a3(s, kk, pa[0][kk], pa[1][kk], pa[2][kk]);
        }
        auto products = [&](float(&acc)[CW / 2], bool overwrite) {
            wgmma_fence();
#pragma unroll
            for (int i = FIRST; i < split::PRODUCTS; ++i)
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    wgmma_rs<CW, 1>(acc, pa[plane_a(i)][kk],
                                    mnmajor<VW, BK>(vs + plane_b(i) * L.v_plane, kk),
                                    !overwrite || i > FIRST || kk > 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(acc);
        };
        if constexpr (NP == 1) {
            fence_regs(o);
            products(o, false);
        } else {  // this tile's products in a fresh accumulator, added in float32
            float ot[CW / 2];
            products(ot, true);
#pragma unroll
            for (int i = 0; i < CW / 2; ++i) o[i] += ot[i];
        }
        fence_regs(pa);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
    }

    float i0 = 1.f, i1 = 1.f;  // PRENORM: p was divided by l already
    if constexpr (!PRENORM) {
        l0 = flash::quad_sum(l0);
        l1 = flash::quad_sum(l1);
        if (p.lse != nullptr && blockIdx.y == 0 && qd == 0) {
            if (row0 < p.nq) p.lse[(size_t)b * p.nq + row0] = (m0 + log2f(l0)) * flash::LN2;
            if (row1 < p.nq) p.lse[(size_t)b * p.nq + row1] = (m1 + log2f(l1)) * flash::LN2;
        }
        i0 = 1.f / l0;
        i1 = 1.f / l1;
    }
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
        const int col = c0 + 8 * j + 2 * qd;
        if (col >= p.c) continue;
        const size_t e0 = ((size_t)b * p.nq + row0) * p.c + col, e1 = e0 + 8 * (size_t)p.c;
        if constexpr (NP == 1) {
            __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o);
            if (row0 < p.nq)
                *reinterpret_cast<uint32_t*>(&ob[e0]) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
            if (row1 < p.nq)
                *reinterpret_cast<uint32_t*>(&ob[e1]) =
                    pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        } else {
            float* ob = static_cast<float*>(p.o);
            if (row0 < p.nq)
                *reinterpret_cast<float2*>(&ob[e0]) = make_float2(o[4 * j] * i0, o[4 * j + 1] * i0);
            if (row1 < p.nq)
                *reinterpret_cast<float2*>(&ob[e1]) =
                    make_float2(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
        }
    }
}

template <int D, int CW, int NP, bool PRENORM>
int launch_dc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
              const Params& prm, const Plan& pl, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D, CW, NP, PRENORM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16<D, CW, NP, PRENORM><<<dim3(pl.gx, pl.gy, pl.gz), pl.wgs * WG_THREADS, pl.smem,
                                         stream>>>(tq, tk, tv, prm);
    return (int)cudaGetLastError();
}

// CTAs of the instantiation a plan launches resident on one SM, from the
// card's occupancy calculator (-1 if it cannot say).
template <int D, int CW, int NP, bool PRENORM>
int resident_dc(const Plan& pl) {
    int n = -1;
    if (cudaFuncSetAttribute(flash_fwd_bf16<D, CW, NP, PRENORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_bf16<D, CW, NP, PRENORM>,
                                                      pl.wgs * WG_THREADS,
                                                      pl.smem) != cudaSuccess)
        return -1;
    return n;
}

// Calls f.template run<D, CW, NP>() for the plan's instantiation: the 36 of
// D in {16, 32, 64, 128} x CW in {16, 32, 64, 128, 256} (split: up to 128)
// x NP in {1, 3}.
template <int D, int NP, typename F>
int by_cw(const Plan& pl, const F& f) {
    switch (pl.cw) {
        case 16: return f.template run<D, 16, NP>();
        case 32: return f.template run<D, 32, NP>();
        case 64: return f.template run<D, 64, NP>();
        case 128: return f.template run<D, 128, NP>();
    }
    if constexpr (NP == 1) return f.template run<D, 256, NP>();
    return (int)cudaErrorInvalidValue;
}

template <int NP, typename F>
int by_d(const Plan& pl, const F& f) {
    switch (pl.d_tile) {
        case 16: return by_cw<16, NP>(pl, f);
        case 32: return by_cw<32, NP>(pl, f);
        case 64: return by_cw<64, NP>(pl, f);
        default: return by_cw<128, NP>(pl, f);
    }
}

template <typename F>
int dispatch(const Plan& pl, int np, const F& f) {
    return np == 1 ? by_d<1>(pl, f) : by_d<split::PLANES>(pl, f);
}

template <bool PRENORM>
struct Launch {
    const CUtensorMap &tq, &tk, &tv;
    const Params& prm;
    const Plan& pl;
    cudaStream_t stream;
    template <int D, int CW, int NP>
    int run() const { return launch_dc<D, CW, NP, PRENORM>(tq, tk, tv, prm, pl, stream); }
};

template <bool PRENORM>
struct Resident {
    const Plan& pl;
    template <int D, int CW, int NP>
    int run() const { return resident_dc<D, CW, NP, PRENORM>(pl); }
};

// q [np B, nq, dp], k [np B, nk, dp], v [np B, nk, c] bf16 (plane p of
// batch element b at p B + b); o [B, nq, c], bf16 (np = 1) or float32.
// PRENORM: row_m and row_inv [B, nq] from `flash_row_stats`; lse unused.
template <bool PRENORM>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, void* o,
           float* lse, const float* row_m, const float* row_inv, int b, int nq, int nk, int dp,
           int c, int np, cudaStream_t stream) {
    if (dp % 8) return (int)cudaErrorInvalidValue;  // 16-byte rows
    const Plan pl = plan(b, nq, nk, dp, c, np);
    const int kw = pl.d_tile < 64 ? pl.d_tile : 64, vw = pl.cw < 64 ? 16 : 64;
    CUtensorMap tq, tk, tv;
    int err;
    if ((err = hopper::make_map_bf16_3d(&tq, q, dp, nq, np * b, kw, ROWS))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, k, dp, nk, np * b, kw, pl.bk))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, v, c, nk, np * b, vw, pl.bk))) return err;
    const Params prm{o, lse, row_m, row_inv, nq, nk, c, pl.stages, b};
    return dispatch(pl, np, Launch<PRENORM>{tq, tk, tv, prm, pl, stream});
}

// The bf16 planes of q, k, v in `planes` (3 B (nq dp + nk dp + nk c), dp =
// d rounded up to 8): where the split pass writes them.
struct SplitPlanes {
    __nv_bfloat16 *q, *k, *v;
};

inline SplitPlanes split_planes_of(__nv_bfloat16* planes, int b, int nq, int nk, int dp) {
    SplitPlanes s;
    s.q = planes;
    s.k = s.q + (size_t)split::PLANES * b * nq * dp;
    s.v = s.k + (size_t)split::PLANES * b * nk * dp;
    return s;
}

// fp32: q, k, v split into their planes in `planes`, then the split kernel.
template <bool PRENORM>
int launch_split(const float* q, const float* k, const float* v, float* o, float* lse,
                 const float* row_m, const float* row_inv, __nv_bfloat16* planes, int b, int nq,
                 int nk, int d, int c, cudaStream_t stream) {
    const int dp = (d + 7) / 8 * 8;
    const SplitPlanes sp = split_planes_of(planes, b, nq, nk, dp);
    int err;
    if ((err = split::split(q, sp.q, (long long)b * nq, d, dp, stream))) return err;
    if ((err = split::split(k, sp.k, (long long)b * nk, d, dp, stream))) return err;
    if ((err = split::split(v, sp.v, (long long)b * nk, c, c, stream))) return err;
    return launch<PRENORM>(sp.q, sp.k, sp.v, o, lse, row_m, row_inv, b, nq, nk, dp, c,
                           split::PLANES, stream);
}

}  // namespace wg

inline int np_of(int dtype) { return dtype == 0 ? split::PLANES : 1; }

inline bool takes(int b, int nq, int nk, int d, int c) {
    return b > 0 && nq > 0 && nk > 0 && d > 0 && d <= MAX_D && c > 0 && c % C_MULTIPLE == 0;
}

}  // namespace
