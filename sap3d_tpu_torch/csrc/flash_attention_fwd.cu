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
// site of the model; the kernel takes d <= 128 with rows of q and k in
// whole 16-byte chunks (d a multiple of 8: in bf16 the wrapper pads q and k
// with zero columns, which add nothing to q.k; in float32 the split pass
// writes the planes so) and C a multiple of 16.
// There is no 1/sqrt(d) scale.  Scores, the softmax and the accumulator are float32; the
// output is written in v's dtype.  A ragged Nq is masked here instead of
// padded to a block multiple; a ragged Nk is masked with -inf scores.
//
// What bounds it on an H100 (bf16, batch 16 unless said; 989 TFLOP/s
// tensor-core peak, 3.35 TB/s; B Nq Nk exponentials at the SFU's ~16 per
// clock per SM, ~4e12/s, which the bound leaves out):
//   site                 Nq     Nk    d     C  GFLOP    MB  bound (ms)  exps (ms)
//   flagship x_3_1      392    392   64   512    2.8  14.5  0.0043 memory  0.0006
//   flagship x_2_2     3136   3136   32   256   90.6  57.8  0.0916 compute 0.039
//   flagship x_1_3    25088   3136   16   128    362   130  0.3666 compute 0.315
//   GN deconv_pool3    3136   3136   64   512    181   116  0.1833 compute 0.039
//   GN deconv_pool4    3136   3136  128  1024    362   231  0.3666 compute 0.039
//   x_0_1_sa (B = 2) 200704   3136    2    16   45.3  26.1  0.0458 compute 0.315
// lse adds 4 bytes per query row, nothing to the bound.  At x_1_3 and
// x_0_1_sa the exponentials take as long as the products or longer.
// float32 takes six bf16 products per product (split_bf16.cuh): its bound
// is 6x the FLOPs at 989 TFLOP/s (x_2_2 0.550 ms, x_1_3 2.20, deconv_pool4
// 2.20), the exponentials unchanged; the split pass reads q, k, v once and
// writes three bf16 planes of each (10 bytes per element).
//
// Design (B1 and B2, bf16 and float32, run one body).  The TPU kernel keeps all of K
// and V of a batch element in VMEM and runs one query block per grid step;
// Hopper's blocks run in parallel and a block has 227 KB of shared memory,
// so here one CTA owns 128 query rows (two warpgroups of 64, wgmma's M, that
// share each K and V tile), or 64 rows and one warpgroup where that cut
// takes fewer waves over the SMs (x_2_2 and the GN sites), a slab of CW
// columns of C and one batch element, and streams the keys:
//   * Q comes in once by TMA; K and V tiles of BK keys stream through a
//     ring of 2 or 3 stages, each a full mbarrier (TMA completes the bytes)
//     and an empty one (one arrival per warp when the stage is consumed).
//     Thread 0 of the CTA issues every load, refilling the stage of tile
//     t - 1 while the product of tile t runs.  Rows past Nq and Nk, columns
//     from d to the box width (16, 32, 64, 2 x 64) and from C to the slab
//     width are TMA's zero fill of 3-D tensor maps [B, N, width]; keys past
//     Nk are masked to -inf in the last key tile only.
//   * S = Q K^T by wgmma from shared memory (both operands K-major), f32;
//     O += P V by wgmma with P from registers (the S accumulator rounded
//     to bf16, `accum_to_a`) and V MN-major; O stays f32 in registers.
//   * CW = 16, 32, 64, 128 or 256, the least that covers C up to 256; wider
//     C is cut into ceil(C/256) slabs of 256, each recomputing S (2 d of
//     the slab's 2 (d + 256) FLOPs per score: at C = 1024 the work is
//     2 N^2 (4 d + C), where 128-column tiles cost 2 N^2 (8 d + C) and
//     twice the exponentials).  BK = 64 from CW = 64 up, 128 below; up to
//     CW = 128 a thread fits in 128 registers, so two 256-thread CTAs share
//     an SM (16 warps: at x_1_3 15% faster than one CTA of 128-key tiles).
//   * Exponentials: the scores' running max is kept in log2 units and
//     p = 2^(s log2(e) - m) is one FMA and one ex2.approx.  A warp moves
//     its rows' max (and rescales l and its O rows) only when a row's tile
//     max exceeds it by more than 2^8: p then stays below 256, and the
//     rescale of CW/2 accumulator registers runs a few times per row
//     instead of once per tile.  lse = (m + log2 l) ln 2.
//   * Each warpgroup runs S, softmax, P V in sequence: issuing S(t + 1)
//     before the softmax of tile t, or the two warpgroups taking turns at
//     the tensor cores under named barriers, measured no faster on an H100
//     (PERF.md).
//   * lse: every slab of a row computes the same m and l (same scores, same
//     order), so the CTAs of the first slab write it.
//   * float32 (NP = 3 planes): `split_planes` first writes the hi, mid and
//     lo bf16 planes of q, k and v into one scratch tensor, each a 3-D
//     tensor map over [3 B, N, width]; every tile of Q, K and V is then the
//     three planes of its box, S is the six SS products of split_bf16.cuh
//     (small first, hi.hi last) into one f32 accumulator, P is split in
//     registers (`accum_to_a3`) and each tile's P V, six RS products, goes
//     to a fresh accumulator that is added to O in float32: the tensor
//     core's own sum over many key tiles drops low bits (o 6e-5 from a
//     float32 order of the same sums over 392 key tiles, where float32
//     adds keep 1e-6).  Two accumulators cap the slab at 128 columns.  The
//     softmax, the lazily moved max, l, lse and the plan's rules are
//     unchanged; o is stored in float32.  Tripled tiles take 32-key tiles
//     at d = 128, two stages where three do not fit, and one 256-thread CTA
//     per SM.
//   * The choice of CW, BK, the warpgroups per CTA, the stages and the grid
//     is one host function, `plan`, mirrored in Python by
//     `ops/cuda/flash_attention.py:launch_plan` (the card tests hold the
//     two equal, `sap3d_flash_fwd_plan`).
//
// Rounding: the TPU kernel casts the normalised p to v's dtype before p.v;
// this kernel rounds the unnormalised p = 2^(s log2(e) - m) (m a running
// max, within 2^8 of the row's true running max) to bf16, sums l from the
// f32 p, and divides by l at the end.  Both sit within bf16 rounding of
// the fp32 result.  In float32 nothing is rounded to bf16 beyond the
// planes, whose six products are an fp32 product to within 2^-24.

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

// ---- wgmma kernel fed by TMA: bf16 operands, or fp32 as split bf16 planes --------

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
// and wgmma's swizzles agree.
struct Layout {
    uint32_t q_plane, k_plane, v_plane, stage, v, stage_bytes, bars, total;
};

__host__ __device__ inline Layout layout(int d_tile, int cw, int wgs, int stages, int np) {
    const int bk = key_tile(d_tile, cw, np);
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

// np: 1 for bf16 operands, 3 for split fp32 (split_bf16.cuh).
inline Plan plan(int b, int nq, int nk, int dp, int c, int np) {
    (void)nk;  // every key tile costs the same: nk does not change the cut
    Plan p;
    p.d_tile = dp <= 16 ? 16 : dp <= 32 ? 32 : dp <= 64 ? 64 : 128;
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
    void* o;     // [B, nq, c], bf16 (one plane) or float32 (split)
    float* lse;  // [B, nq], or null (B1)
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
// of split_bf16.cuh).
template <int D, int CW, int NP>
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
    const uint8_t* qs = sm + wg * ROWS * D * 2;
    float o[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) o[i] = 0.f;
    // running max (log2 units) and this thread's share of the sums of rows
    // g and g + 8 of its warp
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
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

    l0 = flash::quad_sum(l0);
    l1 = flash::quad_sum(l1);
    const int row0 = q0 + wg * ROWS + 16 * warp + g, row1 = row0 + 8;
    if (p.lse != nullptr && blockIdx.y == 0 && qd == 0) {
        if (row0 < p.nq) p.lse[(size_t)b * p.nq + row0] = (m0 + log2f(l0)) * flash::LN2;
        if (row1 < p.nq) p.lse[(size_t)b * p.nq + row1] = (m1 + log2f(l1)) * flash::LN2;
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
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

template <int D, int CW, int NP>
int launch_dc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
              const Params& prm, const Plan& pl, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16<D, CW, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_bf16<D, CW, NP><<<dim3(pl.gx, pl.gy, pl.gz), pl.wgs * WG_THREADS, pl.smem,
                                stream>>>(tq, tk, tv, prm);
    return (int)cudaGetLastError();
}

// CTAs of the instantiation a plan launches resident on one SM, from the
// card's occupancy calculator (-1 if it cannot say).
template <int D, int CW, int NP>
int resident_dc(const Plan& pl) {
    int n = -1;
    if (cudaFuncSetAttribute(flash_fwd_bf16<D, CW, NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_fwd_bf16<D, CW, NP>,
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

struct Launch {
    const CUtensorMap &tq, &tk, &tv;
    const Params& prm;
    const Plan& pl;
    cudaStream_t stream;
    template <int D, int CW, int NP>
    int run() const { return launch_dc<D, CW, NP>(tq, tk, tv, prm, pl, stream); }
};

struct Resident {
    const Plan& pl;
    template <int D, int CW, int NP>
    int run() const { return resident_dc<D, CW, NP>(pl); }
};

// q [np B, nq, dp], k [np B, nk, dp], v [np B, nk, c] bf16 (plane p of
// batch element b at p B + b); o [B, nq, c], bf16 (np = 1) or float32.
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, void* o,
           float* lse, int b, int nq, int nk, int dp, int c, int np, cudaStream_t stream) {
    if (dp % 8) return (int)cudaErrorInvalidValue;  // 16-byte rows
    const Plan pl = plan(b, nq, nk, dp, c, np);
    const int kw = pl.d_tile < 64 ? pl.d_tile : 64, vw = pl.cw < 64 ? 16 : 64;
    CUtensorMap tq, tk, tv;
    int err;
    if ((err = hopper::make_map_bf16_3d(&tq, q, dp, nq, np * b, kw, ROWS))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, k, dp, nk, np * b, kw, pl.bk))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, v, c, nk, np * b, vw, pl.bk))) return err;
    const Params prm{o, lse, nq, nk, c, pl.stages, b};
    return dispatch(pl, np, Launch{tq, tk, tv, prm, pl, stream});
}

// fp32: q, k, v split into their planes in `planes` (3 B (nq dp + nk dp +
// nk c) bf16, dp = d rounded up to 8), then the split kernel.
int launch_split(const float* q, const float* k, const float* v, float* o, float* lse,
                 __nv_bfloat16* planes, int b, int nq, int nk, int d, int c,
                 cudaStream_t stream) {
    const int dp = (d + 7) / 8 * 8;
    __nv_bfloat16* qp = planes;
    __nv_bfloat16* kp = qp + (size_t)split::PLANES * b * nq * dp;
    __nv_bfloat16* vp = kp + (size_t)split::PLANES * b * nk * dp;
    int err;
    if ((err = split::split(q, qp, (long long)b * nq, d, dp, stream))) return err;
    if ((err = split::split(k, kp, (long long)b * nk, d, dp, stream))) return err;
    if ((err = split::split(v, vp, (long long)b * nk, c, c, stream))) return err;
    return launch(qp, kp, vp, o, lse, b, nq, nk, dp, c, split::PLANES, stream);
}

}  // namespace wg

int np_of(int dtype) { return dtype == 0 ? split::PLANES : 1; }

bool takes(int b, int nq, int nk, int d, int c) {
    return b > 0 && nq > 0 && nk > 0 && d > 0 && d <= MAX_D && c > 0 && c % C_MULTIPLE == 0;
}

}  // namespace

extern "C" {

// C must be a multiple of this, and d at most the next; the wrapper checks
// both (and in bf16 pads q and k to 16-byte rows, d % 8 == 0).
int sap3d_flash_fwd_block_c() { return C_MULTIPLE; }
int sap3d_flash_fwd_max_d() { return MAX_D; }

// The kernel's plan for a call with d (rounded up to 8 here) and C in
// `dtype` (0 = float32, split; 1 = bfloat16) into out[11]: d_tile, cw,
// slabs, bk, wgs, stages, smem bytes, grid x, y, z, and the CTAs per SM it
// counts on.  Returns cudaErrorInvalidValue for arguments the kernel does
// not take.
int sap3d_flash_fwd_plan(int b, int nq, int nk, int d, int c, int dtype, int* out) {
    if (!takes(b, nq, nk, d, c) || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
    const wg::Plan p = wg::plan(b, nq, nk, (d + 7) / 8 * 8, c, np_of(dtype));
    const int v[11] = {p.d_tile, p.cw, p.slabs, p.bk, p.wgs,     p.stages,
                       p.smem,   p.gx, p.gy,    p.gz, p.resident};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return 0;
}

// CTAs of the kernel that the plan of such a call launches resident on one
// SM, from the card's occupancy calculator; -1 if it cannot say.
int sap3d_flash_fwd_resident_ctas(int b, int nq, int nk, int d, int c, int dtype) {
    if (!takes(b, nq, nk, d, c) || (dtype != 0 && dtype != 1)) return -1;
    const wg::Plan p = wg::plan(b, nq, nk, (d + 7) / 8 * 8, c, np_of(dtype));
    return wg::dispatch(p, np_of(dtype), wg::Resident{p});
}

// dtype: 0 = float32, 1 = bfloat16.  lse: float32 [B, Nq], or null for the
// forward without lse.  float32: d as it is, `planes` bf16 scratch of
// 3 B (Nq dp + Nk dp + Nk C) elements, dp = d rounded up to 8; bfloat16: d
// a multiple of 8, `planes` not read.  Returns a cudaError_t (0 =
// launched); invalid arguments, and a tensor map that
// cuTensorMapEncodeTiled refuses, return an error without launching.
int sap3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    void* planes, int b, int nq, int nk, int d, int c, int dtype, void* stream) {
    if (!takes(b, nq, nk, d, c)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return wg::launch_split(static_cast<const float*>(q), static_cast<const float*>(k),
                                static_cast<const float*>(v), static_cast<float*>(o),
                                static_cast<float*>(lse), static_cast<__nv_bfloat16*>(planes),
                                b, nq, nk, d, c, s);
    if (dtype == 1)
        return wg::launch(static_cast<const __nv_bfloat16*>(q),
                          static_cast<const __nv_bfloat16*>(k),
                          static_cast<const __nv_bfloat16*>(v), o, static_cast<float*>(lse),
                          b, nq, nk, d, c, 1, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
