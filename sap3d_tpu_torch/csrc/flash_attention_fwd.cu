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
// Row statistics (`flash_row_stats<D, NP>`, below; the kernel body of B1,
// B2 and B6's second pass is flash_fwd.cuh's): each query row's max m and 1/l, l = sum_j exp(s_ij - m), or
// lse = m + log l, from q and k alone.  Q once by TMA, K through a ring of
// two 64-key stages, S by the same wgmma sequence as above (six split
// products in fp32), an exact running max (l rescaled when it moves: two
// registers a thread).  2 B Nq Nk d FLOPs, a ninth of the forward's at
// d = C/8 (GN deconv_pool4, bf16: 0.041 ms of bound), and one exponential
// per score, which bounds it where d is small.  B6 takes m and 1/l into
// its second pass (`flash_fwd_bf16<.., PRENORM = true>`,
// flash_attention_nolse.cu); B5's backward takes lse into B3.
//
// Rounding: the TPU kernel casts the normalised p to v's dtype before p.v;
// this kernel rounds the unnormalised p = 2^(s log2(e) - m) (m a running
// max, within 2^8 of the row's true running max) to bf16, sums l from the
// f32 p, and divides by l at the end.  Both sit within bf16 rounding of
// the fp32 result.  In float32 nothing is rounded to bf16 beyond the
// planes, whose six products are an fp32 product to within 2^-24.

#include "flash_fwd.cuh"

namespace {
namespace wg {

// ---- row statistics: each query row's max m and 1/l -----------------------------

// Keys per streamed tile of the row-stats kernel, and its ring's stages.
constexpr int STATS_BK = 64;
constexpr int STATS_STAGES = 2;

// How the row-stats kernel cuts a call: the forward's layout with no V
// tile, 64-key tiles in a ring of two, two warpgroups per CTA unless 64-row
// CTAs take fewer waves (registers hold two 256-thread CTAs per SM).
inline Plan stats_plan(int b, int nq, int dp, int np) {
    Plan p;
    p.d_tile = d_tile_of(dp);
    p.cw = 0;
    p.slabs = 1;
    p.bk = STATS_BK;
    p.stages = STATS_STAGES;
    long long best = 0;
    for (int w = MAX_WGS; w >= 1; --w) {
        const int smem =
            (int)(layout(p.d_tile, 0, w, STATS_STAGES, np, STATS_BK).total + SMEM_SLACK);
        const int by_regs = 2 * (MAX_WGS / w);
        const int by_smem = SMEM_PER_SM / (smem + CTA_RESERVE);
        const int resident = by_regs < by_smem ? by_regs : by_smem;
        const long long ctas = (long long)b * ((nq + w * ROWS - 1) / (w * ROWS));
        const long long slots = (long long)SM_COUNT * resident;
        const long long waves = (ctas + slots - 1) / slots;
        if (best == 0 || waves < best) {
            best = waves;
            p.wgs = w;
            p.smem = smem;
            p.resident = resident;
        }
    }
    p.gx = (nq + ROWS * p.wgs - 1) / (ROWS * p.wgs);
    p.gy = 1;
    p.gz = b;
    return p;
}

struct StatsParams {
    float* m;    // [B, nq] each row's max score, or null
    float* inv;  // [B, nq] 1 / sum_j exp(s_ij - m_i), or null
    float* lse;  // [B, nq] m + log(l), or null
    int nq, nk, batch;
};

// Each query row's max m of s = q k^T (unscaled) and l = sum_j exp(s - m),
// written as m and 1/l (B6's second pass) or as lse = m + log l (B5's
// backward).  Q comes in once by TMA and K streams through a ring of 64-key
// tiles, as in `flash_fwd_bf16` without V; S is the same wgmma sequence (the
// six split products in fp32), so both passes of B6 form the same scores.
// The max is exact (l is rescaled when it moves): only two sums a thread
// carry it.
template <int D, int NP>
__global__ void __launch_bounds__(MAX_WGS * WG_THREADS, 2)
flash_row_stats(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const StatsParams p) {
    using namespace hopper;
    using flash::ex2;
    using flash::LOG2E;
    using split::plane_a;
    using split::plane_b;
    constexpr int BK = STATS_BK;
    constexpr int KW = D < 64 ? D : 64;
    constexpr int FIRST = split::first_product(NP);
    constexpr int stages = STATS_STAGES;
    const int wgs = blockDim.x / WG_THREADS;
    const Layout L = layout(D, 0, wgs, stages, NP, BK);
    uint8_t* sm = smem_base();
    const int q0 = blockIdx.x * wgs * ROWS, b = blockIdx.z;
    const int active = min(wgs, (p.nq - q0 + ROWS - 1) / ROWS);
    const int nt = (p.nk + BK - 1) / BK;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* full = bars + 1;
    uint64_t* empty = bars + 1 + stages;
    auto load_tile = [&](int t, int st) {
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        mbar_arrive_expect_tx(&full[st], NP * BK * D * 2);
        for (int pl = 0; pl < NP; ++pl)
            for (int j = 0; j < D / KW; ++j)
                tma_load_3d(stage + pl * L.k_plane + j * BK * KW * 2, &tk, &full[st], j * KW,
                            t * BK, pl * p.batch + b);
    };
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * active);
        }
        fence_barrier_init();
    }
    __syncthreads();
    const int wg = threadIdx.x / WG_THREADS;
    if (wg >= active) return;
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
    // the rows' running max (score units) and this thread's share of l
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(&bars[0], 0);

    for (int t = 0; t < nt; ++t) {
        const int st = t % stages;
        const uint8_t* ks = sm + L.stage + st * L.stage_bytes;
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
        if (threadIdx.x == 0 && t > 0 && t - 1 + stages < nt) {
            const int ps = (t - 1) % stages;
            mbar_wait(&empty[ps], ((t - 1) / stages) & 1);
            load_tile(t - 1 + stages, ps);
        }
        __syncwarp();
        wgmma_wait<0>();
        fence_regs(s);
        // this warp is done with the tile's shared memory
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
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
        // finite: every tile holds a valid key
        const float n0 = fmaxf(m0, flash::quad_max(mx0)), n1 = fmaxf(m1, flash::quad_max(mx1));
        const float nm0 = -n0 * LOG2E, nm1 = -n1 * LOG2E;
        float sa0 = 0.f, sa1 = 0.f, sb0 = 0.f, sb1 = 0.f;  // two chains per row
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            const float e0 = ex2(fmaf(s[4 * j], LOG2E, nm0)) + ex2(fmaf(s[4 * j + 1], LOG2E, nm0));
            const float e1 =
                ex2(fmaf(s[4 * j + 2], LOG2E, nm1)) + ex2(fmaf(s[4 * j + 3], LOG2E, nm1));
            if (j & 1) {
                sb0 += e0;
                sb1 += e1;
            } else {
                sa0 += e0;
                sa1 += e1;
            }
        }
        // l rescaled to the new max (0 * 0 on the first tile)
        l0 = l0 * ex2((m0 - n0) * LOG2E) + (sa0 + sb0);
        l1 = l1 * ex2((m1 - n1) * LOG2E) + (sa1 + sb1);
        m0 = n0;
        m1 = n1;
    }

    l0 = flash::quad_sum(l0);
    l1 = flash::quad_sum(l1);
    if (qd != 0) return;
    const int row0 = q0 + wg * ROWS + 16 * warp + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= p.nq) continue;
        const float m = h ? m1 : m0, l = h ? l1 : l0;
        const size_t at = (size_t)b * p.nq + row;
        if (p.m != nullptr) p.m[at] = m;
        if (p.inv != nullptr) p.inv[at] = 1.f / l;
        if (p.lse != nullptr) p.lse[at] = m + log2f(l) * flash::LN2;
    }
}

template <int D, int NP>
int launch_stats_d(const CUtensorMap& tq, const CUtensorMap& tk, const StatsParams& prm,
                   const Plan& pl, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(flash_row_stats<D, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
    flash_row_stats<D, NP><<<dim3(pl.gx, pl.gy, pl.gz), pl.wgs * WG_THREADS, pl.smem, stream>>>(
        tq, tk, prm);
    return (int)cudaGetLastError();
}

template <int NP>
int launch_stats_np(const CUtensorMap& tq, const CUtensorMap& tk, const StatsParams& prm,
                    const Plan& pl, cudaStream_t stream) {
    switch (pl.d_tile) {
        case 16: return launch_stats_d<16, NP>(tq, tk, prm, pl, stream);
        case 32: return launch_stats_d<32, NP>(tq, tk, prm, pl, stream);
        case 64: return launch_stats_d<64, NP>(tq, tk, prm, pl, stream);
        default: return launch_stats_d<128, NP>(tq, tk, prm, pl, stream);
    }
}

// q [np B, nq, dp], k [np B, nk, dp] bf16 planes (np = 1: the bf16 tensors).
inline int launch_stats(const __nv_bfloat16* q, const __nv_bfloat16* k, float* m, float* inv,
                        float* lse, int b, int nq, int nk, int dp, int np, cudaStream_t stream) {
    if (dp % 8) return (int)cudaErrorInvalidValue;
    const Plan pl = stats_plan(b, nq, dp, np);
    const int kw = pl.d_tile < 64 ? pl.d_tile : 64;
    CUtensorMap tq, tk;
    int err;
    if ((err = hopper::make_map_bf16_3d(&tq, q, dp, nq, np * b, kw, ROWS))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, k, dp, nk, np * b, kw, STATS_BK))) return err;
    const StatsParams prm{m, inv, lse, nq, nk, b};
    return np == 1 ? launch_stats_np<1>(tq, tk, prm, pl, stream)
                   : launch_stats_np<split::PLANES>(tq, tk, prm, pl, stream);
}

}  // namespace wg
}  // namespace

// Called first by each launching entry point.  In a host thread that has
// made no runtime call yet (autograd's device thread runs a backward there)
// the current device's primary context is not yet current, and a
// cudaFuncSetAttribute before any launch fails with an invalid argument:
// cudaSetDevice makes it current.  A last error left by an earlier call of
// another library in this thread is dropped, so that the cudaGetLastError
// after each launch reports that launch.
inline void prepare_thread() {
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess) (void)cudaSetDevice(dev);
    (void)cudaGetLastError();
}

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
    prepare_thread();
    if (!takes(b, nq, nk, d, c) || (dtype != 0 && dtype != 1)) return -1;
    const wg::Plan p = wg::plan(b, nq, nk, (d + 7) / 8 * 8, c, np_of(dtype));
    return wg::dispatch(p, np_of(dtype), wg::Resident<false>{p});
}

// dtype: 0 = float32, 1 = bfloat16.  lse: float32 [B, Nq], or null for the
// forward without lse.  float32: d as it is, `planes` bf16 scratch of
// 3 B (Nq dp + Nk dp + Nk C) elements, dp = d rounded up to 8; bfloat16: d
// a multiple of 8, `planes` not read.  Returns a cudaError_t (0 =
// launched); invalid arguments, and a tensor map that
// cuTensorMapEncodeTiled refuses, return an error without launching.
int sap3d_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                    void* planes, int b, int nq, int nk, int d, int c, int dtype, void* stream) {
    prepare_thread();
    if (!takes(b, nq, nk, d, c)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return wg::launch_split<false>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(o),
                                       static_cast<float*>(lse), nullptr, nullptr,
                                       static_cast<__nv_bfloat16*>(planes), b, nq, nk, d, c, s);
    if (dtype == 1)
        return wg::launch<false>(static_cast<const __nv_bfloat16*>(q),
                                 static_cast<const __nv_bfloat16*>(k),
                                 static_cast<const __nv_bfloat16*>(v), o, static_cast<float*>(lse),
                                 nullptr, nullptr, b, nq, nk, d, c, 1, s);
    return (int)cudaErrorInvalidValue;
}

// Each query row's max m and 1/l of s = q k^T, or lse = m + log l, into
// float32 [B, Nq] outputs (any of m, inv, lse may be null).  dtype 0 =
// float32: d as it is, `planes` bf16 scratch of 3 B (Nq dp + Nk dp)
// elements, dp = d rounded up to 8; 1 = bfloat16: d a multiple of 8,
// `planes` not read.  Returns a cudaError_t (0 = launched).
int sap3d_flash_row_stats(const void* q, const void* k, void* m, void* inv, void* lse,
                          void* planes, int b, int nq, int nk, int d, int dtype, void* stream) {
    prepare_thread();
    if (!takes(b, nq, nk, d, C_MULTIPLE) || (dtype != 0 && dtype != 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float *mo = static_cast<float*>(m), *io = static_cast<float*>(inv),
          *lo = static_cast<float*>(lse);
    if (dtype == 1)
        return wg::launch_stats(static_cast<const __nv_bfloat16*>(q),
                                static_cast<const __nv_bfloat16*>(k), mo, io, lo, b, nq, nk, d, 1,
                                s);
    const int dp = (d + 7) / 8 * 8;
    const wg::SplitPlanes sp =
        wg::split_planes_of(static_cast<__nv_bfloat16*>(planes), b, nq, nk, dp);
    int err;
    if ((err = split::split(static_cast<const float*>(q), sp.q, (long long)b * nq, d, dp, s)))
        return err;
    if ((err = split::split(static_cast<const float*>(k), sp.k, (long long)b * nk, d, dp, s)))
        return err;
    return wg::launch_stats(sp.q, sp.k, mo, io, lo, b, nq, nk, dp, split::PLANES, s);
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
