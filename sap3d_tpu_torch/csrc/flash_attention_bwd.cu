// Flash attention backward: dq, dk, dv of o = softmax(q k^T) v (unscaled)
// from the forward's saved o and lse.
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
//     dlse is [B, Nq] float32, as lse is.  B3 and B4 run one kernel body.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C], o and do [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16); lse and dlse [B, Nq]
// float32.  Outputs dq [B, Nq, d], dk [B, Nk, d], dv [B, Nk, C] in that
// dtype.  Rows of q and k come in whole 16-byte chunks (bf16: the wrapper
// pads q and k with zero columns; float32: the split pass writes the
// planes so; the wrapper drops those columns of dq and dk).  d <= 64; C a
// multiple of 16 up to 128 or of 64 up to 512.  Per query row i and key j:
//   delta_i = sum_c do_ic o_ic - dlse_i        (= sum_j dp_ij p_ij - dlse_i)
//   p_ij    = exp(q_i . k_j - lse_i)
//   dp_ij   = do_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i
// Precision follows the TPU kernel: scores, p, dp, ds and every accumulator
// are float32; p and ds are rounded to the operand dtype before their
// products; dk, dv and dq are accumulated in float32 and rounded once at
// the end.  In float32 every operand is split into three bf16 planes and
// each product is six bf16 products (split_bf16.cuh): an fp32 product to
// within 2^-24, nothing rounded to bf16.
//
// What bounds it on an H100: 2*B*Nq*Nk*(3d + 2C) FLOPs (five products) at
// 989 TFLOP/s bf16, or the bytes of q, k, v, o, do, lse in and dq, dk, dv
// out at 3.35 TB/s, whichever is longer; and one exponential per score,
// which the bound leaves out.  Per site (bf16, batch 16 unless said):
//   site                 Nq      Nk    d    C   GFLOP    MB  bound (ms)
//   flagship x_3_1      392     392   64  512     6.0    29  0.0086  memory
//   flagship x_2_2     3136    3136   32  256   191     116  0.1935  compute
//   flagship x_1_3    25088    3136   16  128   765     260  0.7740  compute
//   GN pool2           3136    3136   32  256   191     116  0.1935  compute
//   GN deconv_pool3    3136    3136   64  512   383     231  0.3870  compute
//   x_0_1_sa (B = 2) 200704    3136    2   16    95.7    31  0.0967  compute
// At x_0_1_sa the 1.26e9 exponentials alone, at the SFU's ~16 per clock per
// SM (~4e12/s on 132 SMs), take ~0.3 ms, three times the bound.  float32:
// six times the FLOPs (x_2_2 1.161 ms, x_1_3 4.64, deconv_pool3 2.32).
//
// Design of the bf16 kernels (B3 and B4; float32 below).  Hopper's blocks run in parallel and in no
// order, so the TPU kernel's sequential sweep over query blocks with dk and
// dv summed in VMEM becomes one CTA per (64 keys, batch element, query
// range) that keeps its keys' sums in registers and walks its query tiles:
//   1. `bwd_row_stats` writes (lse, delta) of every query row, padded to
//      whole 64-row tiles with (+inf, 0) so that padded rows get p = 0.
//   2. `flash_bwd_dkdq`, one warpgroup per CTA.  Its thread 0 loads K and V
//      of the CTA's 64 keys once with TMA and keeps a ring of 2 stages of
//      (q tile, do tile, the rows' lse and delta) in flight, each stage
//      signalled by an mbarrier (TMA and bulk copies); a stage goes back to
//      the ring through a second mbarrier once every warp is done with it,
//      and is refilled with the tile after next.  The products run on
//      wgmma:
//        s^T  = k q^T   (SS, K = d padded to 16/32/64 by TMA's zero fill)
//        dp^T = v do^T  (SS, K = C; issued before the exponentials of s^T,
//                        which overlap it)
//        ds^T = p^T (dp^T - delta); ds^T and p^T rounded to bf16 in
//                        registers
//        dv  += p^T do  (RS; here where C <= 64, or 128 with d <= 16)
//        dk  += ds^T q  (RS)
//        dq   = ds k    (SS: ds^T written once to shared memory over the
//                        do tile, read MN-major)
//      and adds each warp's 16 rows of the f32 dq tile to f32 scratch with
//      one bulk reduce-add (cp.reduce.async.bulk), not per-element atomics:
//      4 B Nq/64 ceil(Nk/64) bulk operations in all.
//      No producer warp: a CTA of one warpgroup at 168 registers leaves
//      room for 3 CTAs per SM (4 at 128), where a fifth warp, allocated the
//      same registers at launch, left room for 2 (3); on an H100 the
//      producer-warp version of this kernel was slower at x_1_3,
//      deconv_pool3 and x_0_1_sa and no faster at x_2_2 (PERF.md).
//   3. `flash_bwd_dv` where dv is not the dkdq kernel's: one CTA per (64
//      keys, batch, range, column slab of 256 or 64 of C) recomputes s^T and
//      p^T (d = C/8 makes that ~5% of the products, plus one more
//      exponential per score) and runs dv += p^T do (RS).  Why two kernels:
//      a 64-key dv accumulator is 64 x C f32, 256 registers a thread at
//      C = 512 in one warpgroup (C/2 at any C beside the dk and dq
//      accumulators spills above C = 64, or 128 with d <= 16), and resident
//      V plus two do stages take 200 KB of shared memory at C = 512.  Split
//      this way, no kernel halves its key tile at C = 512 and no warpgroup
//      sums partial dp with another.
//   4. Where the query range is split, dk and dv of each CTA go to f32
//      scratch by the same bulk reduce-add and `round_to_bf16` rounds them
//      once, as it rounds dq; unsplit, a CTA alone holds its keys' sums and
//      writes them in bf16.
// Query split (chosen on the host, `flash_attention_bwd.py:query_split`):
// with B ceil(Nk/64) CTAs per range and 132 x (dkdq CTAs resident per SM)
// slots, S minimises waves x (query tiles per range + 2), the 2 standing
// for a CTA's set-up and epilogue: S = 16 at x_0_1_sa (98 CTAs without),
// 1 at the flagship's and GN sites (x_3_1: one wave of 112 CTAs without a
// split; x_1_3: 784 CTAs, 1.98 waves of 3 per SM).  Rows past Nq or Nk
// and the columns from d to 16/32/64 are TMA's zero fill of 3-D tensor
// maps [B, N, width] (a 2-D map over [B N, width] would read the next
// batch element's rows); keys past Nk are also masked to p = 0.
// wgmma's k-steps over C are unrolled where C is 16 ... 512 by powers of
// two: a loop over them makes ptxas serialise every wgmma of the kernel
// (C7515); other C count them at run time.
// float32 (B3 and B4 on split bf16 planes, `launch_split`): `split_planes`
// writes the hi, mid and lo planes of q, k, v and do into one scratch
// tensor (3-D tensor maps over [3 B, N, width]); `bwd_row_stats<float>`
// as above.  Three planes of V (192 KB at C = 512) do not stay resident
// beside the rest, so `flash_bwd_dkdq_split` (dk, dq) streams, per query
// tile, dp^T = v do^T over chunks of 64 (or 16) columns of C, each chunk's
// v and do planes through a ring of 2-4 stages; the q tiles and their
// (lse, delta) have a ring of two; ds^T is split in registers
// (`accum_to_a3`) for dk += ds^T q and written as three planes for
// dq = ds k.  dv is `flash_bwd_dv<D, CW, 3>`'s, by slabs of 64 (or 16;
// 128 at d_tile 64) columns.  dk and dv take each query tile's products in a fresh
// accumulator and add it to their sums in float32: the tensor core's own
// sum over a CTA's 392 query tiles (x_1_3) drops low bits, 1.3e-4 of dk's
// L2 norm, 1.4x the float32 limit.  Every product is the six of split_bf16.cuh; dq, dk and dv
// are bulk-added to float32 outputs the wrapper zeroes, and nothing is
// rounded.  One 128-thread CTA per SM at 64-column chunks (shared memory);
// the query split rule is the bf16 one with that residency.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "split_bf16.cuh"

namespace {

// d up to this in both dtypes (the widest q and k tile: three planes of a
// 128-wide tile do not fit beside the rest of the split kernel).
constexpr int MAX_D = 64;
constexpr int MAX_C = 512;
constexpr int C_MULTIPLE = 16;
constexpr int WIDE_C_MULTIPLE = 64;  // C above NARROW_MAX_C is a multiple of this
constexpr int NARROW_MAX_C = 128;

// ---- the bf16 rounding of dq (and of dk, dv over query splits) ----------------

__global__ void round_to_bf16(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                              size_t n) {
    for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
         i += (size_t)gridDim.x * blockDim.x)
        dst[i] = __float2bfloat16(src[i]);
}

// ---- wgmma kernels fed by TMA: bf16 operands, or fp32 as split bf16 planes ----

constexpr int BLK = 64;                 // keys per CTA, queries per tile: wgmma's M
constexpr int STAGES = 2;               // query tiles in flight
constexpr int THREADS = 128;            // one warpgroup; its thread 0 also issues the loads
constexpr int WG_BARRIER = 1;           // the warpgroup's named barrier
constexpr uint32_t STATS_BYTES = BLK * 8;           // (lse, delta) of a tile's rows
constexpr uint32_t DS_BYTES = BLK * BLK * 2;        // ds^T of a tile, bf16
constexpr int MAX_CTA_SMEM = 232448;                // the most one CTA may take

__host__ __device__ constexpr uint32_t align1k(uint32_t x) { return (x + 1023u) & ~1023u; }

// Shared memory of a CTA in bytes from a 1024-byte aligned base: the np
// planes of K (and of V), then the ring's stages of (the np planes of the
// q tile, the np planes of a do tile or of the region that dq's products
// reuse, lse and delta), then the mbarriers.  *_plane: the bytes of one
// plane of each.
struct Smem {
    uint32_t k_plane, v_plane, q_plane, t_plane, v, stage, stage_bytes, tile, stats, bars, total;
};

__host__ __device__ inline Smem smem_layout(int d_tile, int v_cols, uint32_t tile_bytes,
                                            int np = 1) {
    Smem s;
    s.k_plane = s.q_plane = align1k(BLK * d_tile * 2);
    s.v_plane = align1k(BLK * v_cols * 2);
    s.t_plane = align1k(tile_bytes);
    s.v = np * s.k_plane;
    s.stage = s.v + np * s.v_plane;
    s.tile = np * s.q_plane;
    s.stats = s.tile + np * s.t_plane;
    s.stage_bytes = s.stats + align1k(STATS_BYTES);
    s.bars = s.stage + STAGES * s.stage_bytes;
    s.total = s.bars + 8 * (1 + 2 * STAGES);
    return s;
}

__host__ __device__ inline uint32_t dkdq_tile_bytes(int d_tile, int c) {
    const uint32_t dout = BLK * c * 2, dsdq = DS_BYTES + BLK * d_tile * 4;
    return dout > dsdq ? dout : dsdq;
}

struct BwdParams {
    const float2* stats;     // [B, nqp] (lse log2(e), delta)
    float* dq;               // [B, nq, dp] float32 scratch, added to
    float* dk;               // [B, nk, dp] float32 scratch, added to (splits > 1)
    float* dv;               // [B, nk, c]
    __nv_bfloat16* dk_out;   // [B, nk, dp] bf16, written (splits == 1)
    __nv_bfloat16* dv_out;   // [B, nk, c]
    int nq, nk, dp, c, nqp, nqt, splits, slabs, batch;
};

__device__ __forceinline__ uint8_t* smem_base() {
    extern __shared__ uint8_t dyn_smem[];
    return dyn_smem + ((1024u - (hopper::smem_u32(dyn_smem) & 1023u)) & 1023u);
}

// Operand descriptors of a tile stored as boxes of BLK rows x W bf16
// columns (hopper.cuh states the layouts).  K-major: k-step kk covers
// columns 16 kk ..; MN-major: rows 16 kk ...
template <int W>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + (kk * 16 / W) * (BLK * W * 2) + (kk * 16 % W) * 2, 16, 16 * W,
                             2 * W);
}

template <int W>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kk) {
    return hopper::smem_desc(tile + kk * 32 * W, BLK * W * 2, 16 * W, 2 * W);
}

// What thread 0 loads, with TMA and bulk copies, each completing on an
// mbarrier: K (and V) of the CTA's keys once, and per query tile into a
// stage of the ring the q tile, the do boxes and the rows' (lse, delta);
// each of the np planes of a tensor (plane pl of batch element b at
// z = pl batch + b of its map).
struct Loader {
    const CUtensorMap *tq, *tk, *tv, *tdo;
    uint8_t* sm;
    Smem L;
    const float2* stats;
    int nqp, b, k0, d_tile, v_boxes, do_col0, do_boxes, box_cols, np, batch;

    __device__ __forceinline__ uint64_t* bars() const {
        return reinterpret_cast<uint64_t*>(sm + L.bars);
    }

    __device__ __forceinline__ void kv() const {
        using namespace hopper;
        const uint32_t box_bytes = BLK * box_cols * 2;
        mbar_arrive_expect_tx(bars(), np * (BLK * d_tile * 2 + v_boxes * box_bytes));
        for (int pl = 0; pl < np; ++pl) {
            tma_load_3d(sm + pl * L.k_plane, tk, bars(), 0, k0, pl * batch + b);
            for (int j = 0; j < v_boxes; ++j)
                tma_load_3d(sm + L.v + pl * L.v_plane + j * box_bytes, tv, bars(), j * box_cols,
                            k0, pl * batch + b);
        }
    }

    __device__ __forceinline__ void tile(int t, int st) const {
        using namespace hopper;
        uint64_t* full = bars() + 1 + st;
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        const uint32_t box_bytes = BLK * box_cols * 2;
        mbar_arrive_expect_tx(full,
                              np * (BLK * d_tile * 2 + do_boxes * box_bytes) + STATS_BYTES);
        for (int pl = 0; pl < np; ++pl) {
            tma_load_3d(stage + pl * L.q_plane, tq, full, 0, t * BLK, pl * batch + b);
            for (int j = 0; j < do_boxes; ++j)
                tma_load_3d(stage + L.tile + pl * L.t_plane + j * box_bytes, tdo, full,
                            do_col0 + j * box_cols, t * BLK, pl * batch + b);
        }
        bulk_load(stage + L.stats, stats + (size_t)b * nqp + t * BLK, STATS_BYTES, full);
    }

    // K (and V) and the ring's first tiles
    __device__ __forceinline__ void prologue(int t0, int t1) const {
        kv();
        for (int i = 0; i < STAGES && t0 + i < t1; ++i) tile(t0 + i, i);
    }

    // At the start of tile i (query tile t): once every warp is done with
    // tile i - 1 (its dq bulk add has read its rows, usually long before),
    // that stage goes back to the ring and takes tile t + STAGES - 1.
    __device__ __forceinline__ void refill(int i, int t, int t1, int lane) const {
        using namespace hopper;
        if (i == 0) return;
        uint64_t* empty = bars() + 1 + STAGES + (i - 1) % STAGES;
        if (lane == 0) {
            bulk_wait_read();
            mbar_arrive(empty);
        }
        if (threadIdx.x == 0 && t + STAGES - 1 < t1) {
            mbar_wait(empty, ((i - 1) / STAGES) & 1);
            tile(t + STAGES - 1, (i - 1) % STAGES);
        }
    }
};

__device__ __forceinline__ void init_barriers(uint8_t* sm, const Smem& L) {
    using namespace hopper;
    if (threadIdx.x == 0) {
        uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
        mbar_init(&bars[0], 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&bars[1 + s], 1);           // full: thread 0's arrival + bytes
            mbar_init(&bars[1 + STAGES + s], 4);  // empty: one arrival per warp
        }
        fence_barrier_init();
    }
    __syncthreads();
}

__device__ __forceinline__ void tile_range(const BwdParams& p, int split, int& t0, int& t1) {
    t0 = (int)((long long)split * p.nqt / p.splits);
    t1 = (int)((long long)(split + 1) * p.nqt / p.splits);
}

using flash::ex2;
using flash::LOG2E;

// p^T = exp(s^T - lse) = 2^(s^T log2(e) - lse log2(e)), one FMA and one
// ex2 per score: rows are keys, columns queries (the stats hold
// lse log2(e); padded rows +inf, so p = 0).  Keys past nk are masked in a
// CTA's last key tile only (MASK).
template <bool MASK>
__device__ __forceinline__ void exp_scores(float (&p)[32], const float (&s)[32],
                                           const float2* stats, int qd, bool key_ok0,
                                           bool key_ok1) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float l0 = stats[8 * j + 2 * qd].x, l1 = stats[8 * j + 2 * qd + 1].x;
        p[4 * j + 0] = ex2(fmaf(s[4 * j + 0], LOG2E, -l0));
        p[4 * j + 1] = ex2(fmaf(s[4 * j + 1], LOG2E, -l1));
        p[4 * j + 2] = ex2(fmaf(s[4 * j + 2], LOG2E, -l0));
        p[4 * j + 3] = ex2(fmaf(s[4 * j + 3], LOG2E, -l1));
        if constexpr (MASK) {
            if (!key_ok0) p[4 * j + 0] = p[4 * j + 1] = 0.f;
            if (!key_ok1) p[4 * j + 2] = p[4 * j + 3] = 0.f;
        }
    }
}

__device__ __forceinline__ void exp_scores(float (&p)[32], const float (&s)[32],
                                           const float2* stats, int qd, bool key_ok0,
                                           bool key_ok1, bool last_key_tile) {
    if (last_key_tile) exp_scores<true>(p, s, stats, qd, key_ok0, key_ok1);
    else exp_scores<false>(p, s, stats, qd, key_ok0, key_ok1);
}

// The 16 rows of warp `warp` of an m64nN f32 accumulator (this thread's
// rows row0 and row0 + 8, columns below `cols`) into a row-major f32
// staging tile of `ld` columns.
template <int N>
__device__ __forceinline__ void stage_rows(const float (&acc)[N / 2], float* stg, int ld, int cols,
                                           int row0, int qd) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col < cols) {
            *reinterpret_cast<float2*>(&stg[row0 * ld + col]) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
            *reinterpret_cast<float2*>(&stg[(row0 + 8) * ld + col]) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
    }
}

// The rows of warp `warp` of an m64nN f32 accumulator (the CTA's keys
// key0 and key0 + 8 for this thread), rounded to bf16 once, into rows of
// `ld` elements of out (keys past nk and columns past `cols` left out): the
// epilogue of an unsplit query range, whose CTA alone holds its keys' sums.
template <int N>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[N / 2], __nv_bfloat16* out,
                                                int ld, int cols, int key0, int nk, int qd) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
        const int col = 8 * j + 2 * qd;
        if (col >= cols) continue;
        if (key0 < nk)
            *reinterpret_cast<uint32_t*>(&out[(size_t)key0 * ld + col]) =
                hopper::pack_bf16(acc[4 * j], acc[4 * j + 1]);
        if (key0 + 8 < nk)
            *reinterpret_cast<uint32_t*>(&out[(size_t)(key0 + 8) * ld + col]) =
                hopper::pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
}

// dk and dq, and dv where CF = C (16, 32, 64, or 128 at D = 16; 0: dv is
// `flash_bwd_dv`'s).  D: d padded to 16/32/64; CB: the columns of a do and
// v box (64, or 16 where C is not a multiple of 64); KC: C / 16 where the
// registry's widths make it known at compile time (the dp^T product's
// k-steps then unroll: a loop over them makes ptxas serialise every wgmma
// of the kernel), else 0 (C / 16 steps at run time).
template <int D, int CB, int CF, int KC>
__global__ void __launch_bounds__(THREADS, D == 16 && CF <= 32 ? 4 : 3)
flash_bwd_dkdq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               const BwdParams p) {
    using namespace hopper;
    const Smem L = smem_layout(D, p.c, dkdq_tile_bytes(D, p.c));
    uint8_t* sm = smem_base();
    const int b = blockIdx.y, k0 = blockIdx.x * BLK;
    int t0, t1;
    tile_range(p, blockIdx.z, t0, t1);
    init_barriers(sm, L);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Loader ld{&tq, &tk,  &tv,      &tdo,     sm, L,  p.stats, p.nqp,
                    b,   k0,   D,    p.c / CB, 0, p.c / CB, CB,     1,       p.batch};
    if (threadIdx.x == 0) ld.prologue(t0, t1);
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* full = bars + 1;
    const int g = lane >> 2, qd = lane & 3;
    const int row0 = 16 * warp + g;  // this thread's accumulator rows: row0, row0 + 8
    const bool key_ok0 = k0 + row0 < p.nk, key_ok1 = k0 + row0 + 8 < p.nk;
    const bool ragged = k0 + BLK > p.nk;  // this CTA holds keys past nk
    const uint8_t* ks = sm;
    const uint8_t* vs = sm + L.v;
    float dk[D / 2], dv[CF > 0 ? CF / 2 : 1];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (CF > 0 ? CF / 2 : 1); ++i) dv[i] = 0.f;
    mbar_wait(bars, 0);  // K and V

    for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % STAGES;
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        uint8_t* tile = stage + L.tile;
        const float2* stats = reinterpret_cast<const float2*>(stage + L.stats);
        mbar_wait(&full[st], (i / STAGES) & 1);
        ld.refill(i, t, t1, lane);

        float s[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<64, 0, 0>(s, kmajor<D>(ks, kk), kmajor<D>(stage, kk), kk > 0);
        wgmma_commit();
        if constexpr (KC > 0) {
#pragma unroll
            for (int kk = 0; kk < KC; ++kk)
                wgmma_ss<64, 0, 0>(dp, kmajor<CB>(vs, kk), kmajor<CB>(tile, kk), kk > 0);
        } else {
            for (int kk = 0; kk < p.c / 16; ++kk)
                wgmma_ss<64, 0, 0>(dp, kmajor<CB>(vs, kk), kmajor<CB>(tile, kk), kk > 0);
        }
        wgmma_commit();
        // the exponentials of s^T run while the dp^T product is in flight;
        // p^T goes to registers of its own, so that no accumulator of an
        // unfinished product is written (ptxas would serialise the products)
        wgmma_wait<1>();
        fence_regs(s);
        float pt[32];
        exp_scores(pt, s, stats, qd, key_ok0, key_ok1, ragged);
        wgmma_wait<0>();
        fence_regs(dp);
        // ds^T = p^T (dp^T - delta); it and p^T rounded to bf16 as the A
        // operands of dk and dv
        uint32_t ds[4][4], pa[4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float d0 = stats[8 * j + 2 * qd].y, d1 = stats[8 * j + 2 * qd + 1].y;
            dp[4 * j + 0] = pt[4 * j + 0] * (dp[4 * j + 0] - d0);
            dp[4 * j + 1] = pt[4 * j + 1] * (dp[4 * j + 1] - d1);
            dp[4 * j + 2] = pt[4 * j + 2] * (dp[4 * j + 2] - d0);
            dp[4 * j + 3] = pt[4 * j + 3] * (dp[4 * j + 3] - d1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            accum_to_a(dp, kk, ds[kk]);
            if constexpr (CF > 0) accum_to_a(pt, kk, pa[kk]);
        }
        fence_regs(dk);
        if constexpr (CF > 0) fence_regs(dv);
        wgmma_fence();
        if constexpr (CF > 0) {  // dv += p^T do
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) wgmma_rs<CF, 1>(dv, pa[kk], mnmajor<CB>(tile, kk), 1);
            wgmma_commit();
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(dk, ds[kk], mnmajor<D>(stage, kk), 1);
        wgmma_commit();
        if constexpr (CF > 0) wgmma_wait<1>();  // dv has read the do tile
        // every warp's products have read the do tile: its region takes
        // ds^T as [key][query], 128-byte rows, swizzled as TMA would
        named_barrier(WG_BARRIER, 128);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint8_t* at = tile + row0 * 128 + ((j ^ g) << 4) + 4 * qd;
            *reinterpret_cast<uint32_t*>(at) = ds[j / 2][2 * (j % 2)];
            *reinterpret_cast<uint32_t*>(at + 8 * 128) = ds[j / 2][2 * (j % 2) + 1];
        }
        fence_proxy_async();
        named_barrier(WG_BARRIER, 128);
        float dq[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss<D, 1, 1>(dq, mnmajor<64>(tile, kk), mnmajor<D>(ks, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dk);
        fence_regs(ds);
        if constexpr (CF > 0) {
            fence_regs(dv);
            fence_regs(pa);
        }
        // this warp's 16 query rows of dq, added to the scratch in one bulk op
        float* stg = reinterpret_cast<float*>(tile + DS_BYTES);
        stage_rows<D>(dq, stg, p.dp, p.dp, row0, qd);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
            const int first = t * BLK + 16 * warp, rows = min(16, p.nq - first);
            if (rows > 0) {
                bulk_reduce_add_f32(p.dq + ((size_t)b * p.nq + first) * p.dp,
                                    stg + 16 * warp * p.dp, rows * p.dp * 4);
                bulk_commit();
            }
        }
    }
    if (lane == 0) bulk_wait_read();

    // dk (and dv) of the CTA's keys: written in bf16 where the query range
    // is not split, else added to the scratch (the ring is free now)
    if (p.splits == 1) {
        store_rows_bf16<D>(dk, p.dk_out + (size_t)b * p.nk * p.dp, p.dp, p.dp, k0 + row0, p.nk,
                           qd);
        if constexpr (CF > 0)
            store_rows_bf16<CF>(dv, p.dv_out + (size_t)b * p.nk * CF, CF, CF, k0 + row0, p.nk,
                                qd);
        bulk_wait();
        return;
    }
    const int first = k0 + 16 * warp, rows = min(16, p.nk - first);
    named_barrier(WG_BARRIER, 128);
    float* stg = reinterpret_cast<float*>(sm + L.stage);
    stage_rows<D>(dk, stg, p.dp, p.dp, row0, qd);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0 && rows > 0) {
        bulk_reduce_add_f32(p.dk + ((size_t)b * p.nk + first) * p.dp, stg + 16 * warp * p.dp,
                            rows * p.dp * 4);
        bulk_commit();
        bulk_wait_read();
    }
    if constexpr (CF > 0) {
        named_barrier(WG_BARRIER, 128);
        stage_rows<CF>(dv, stg, CF, CF, row0, qd);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0 && rows > 0) {
            bulk_reduce_add_f32(p.dv + ((size_t)b * p.nk + first) * CF, stg + 16 * warp * CF,
                                rows * CF * 4);
            bulk_commit();
        }
    }
    bulk_wait();
}

// dv for a slab of CW columns of C (bf16: 16, 64 or 256; split: 16, 64 or,
// at D = 64, 128; CW divides C).  NP: planes per operand, 1 (bf16) or 3 (fp32 as split
// bf16: each product the six of split_bf16.cuh, dv added to the float32
// output, which the caller zeroes).
template <int D, int CW, int NP>
__global__ void __launch_bounds__(THREADS, NP == 1 && CW <= 64 ? 4 : 2)
flash_bwd_dv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
    using namespace hopper;
    using split::plane_a;
    using split::plane_b;
    constexpr int BW = CW < 64 ? CW : 64;  // columns of a do box
    constexpr int FIRST = split::first_product(NP);
    const Smem L = smem_layout(D, 0, BLK * CW * 2, NP);
    uint8_t* sm = smem_base();
    const int b = blockIdx.y, k0 = blockIdx.x * BLK;
    const int range = blockIdx.z / p.slabs, c0 = (blockIdx.z % p.slabs) * CW;
    int t0, t1;
    tile_range(p, range, t0, t1);
    init_barriers(sm, L);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Loader ld{&tq, &tk, nullptr, &tdo, sm, L, p.stats, p.nqp, b, k0, D, 0, c0,
                    CW / BW, BW, NP, p.batch};
    if (threadIdx.x == 0) ld.prologue(t0, t1);
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* full = bars + 1;
    const int g = lane >> 2, qd = lane & 3;
    const int row0 = 16 * warp + g;
    const bool key_ok0 = k0 + row0 < p.nk, key_ok1 = k0 + row0 + 8 < p.nk;
    const bool ragged = k0 + BLK > p.nk;  // this CTA holds keys past nk
    const uint8_t* ks = sm;
    float dv[CW / 2];
#pragma unroll
    for (int i = 0; i < CW / 2; ++i) dv[i] = 0.f;
    mbar_wait(bars, 0);  // K

    for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % STAGES;
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        const float2* stats = reinterpret_cast<const float2*>(stage + L.stats);
        mbar_wait(&full[st], (i / STAGES) & 1);
        ld.refill(i, t, t1, lane);
        float s[32];
        wgmma_fence();
#pragma unroll
        for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<64, 0, 0>(s, kmajor<D>(ks + plane_a(pr) * L.k_plane, kk),
                                   kmajor<D>(stage + plane_b(pr) * L.q_plane, kk),
                                   pr > FIRST || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        float pt[32];
        exp_scores(pt, s, stats, qd, key_ok0, key_ok1, ragged);
        uint32_t pa[NP][4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            if constexpr (NP == 1) accum_to_a(pt, kk, pa[0][kk]);
            else accum_to_a3(pt, kk, pa[0][kk], pa[1][kk], pa[2][kk]);
        }
        // bf16: dv += p^T do on the tensor core; split: this tile's in
        // fresh accumulators added to dv in float32 (as dk in the dkdq
        // kernel: the tensor core's sum over hundreds of tiles drops low
        // bits a float32 add keeps)
        if constexpr (NP == 1) {
            fence_regs(dv);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<CW, 1>(dv, pa[0][kk], mnmajor<BW>(stage + L.tile, kk), 1);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(dv);
        } else {
            // by halves of at most 64 columns (one do box), each in a fresh
            // accumulator added to its columns of dv in float32
            constexpr int HW = CW < 64 ? CW : 64;
#pragma unroll
            for (int h = 0; h < CW / HW; ++h) {
                float dvt[HW / 2];
                wgmma_fence();
#pragma unroll
                for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        wgmma_rs<HW, 1>(dvt, pa[plane_a(pr)][kk],
                                        mnmajor<BW>(stage + L.tile + plane_b(pr) * L.t_plane +
                                                        h * BLK * BW * 2,
                                                    kk),
                                        pr > FIRST || kk > 0);
                wgmma_commit();
                wgmma_wait<0>();
                fence_regs(dvt);
#pragma unroll
                for (int e = 0; e < HW / 2; ++e) dv[h * HW / 2 + e] += dvt[e];
            }
        }
        fence_regs(pa);
    }

    if (NP == 1 && p.splits == 1) {
        store_rows_bf16<CW>(dv, p.dv_out + (size_t)b * p.nk * p.c + c0, p.c, CW, k0 + row0, p.nk,
                            qd);
        return;
    }
    named_barrier(WG_BARRIER, 128);
    float* stg = reinterpret_cast<float*>(sm + L.stage);
    stage_rows<CW>(dv, stg, CW, CW, row0, qd);
    fence_proxy_async();
    __syncwarp();
    if (lane < 16) {
        const int key = k0 + 16 * warp + lane;
        if (key < p.nk) {
            bulk_reduce_add_f32(p.dv + ((size_t)b * p.nk + key) * p.c + c0,
                                stg + (16 * warp + lane) * CW, CW * 4);
            bulk_commit();
        }
    }
    bulk_wait();
}

// ---- fp32 as split bf16: dk and dq -----------------------------------------------

// The split dkdq kernel's shared memory from a 1024-byte aligned base: the
// three planes of K; two stages of (the three planes of a q tile, its rows'
// lse and delta); `cstages` stages of (the three planes of a chunk of CB
// columns of V, then of do); the three planes of ds^T; the staging rows of
// dq (and at the end dk); the mbarriers (K, q full[2], q empty[2], chunk
// full[cstages], chunk empty[cstages]).
struct SplitSmem {
    uint32_t plane, qstage, qstats, qstage_bytes, cplane, chunk, chunk_bytes, ds, stg, bars, total;
};

__host__ __device__ inline SplitSmem split_layout(int d_tile, int cb, int cstages) {
    SplitSmem s;
    s.plane = align1k(BLK * d_tile * 2);  // one plane of K or of a q tile
    s.qstage = split::PLANES * s.plane;
    s.qstats = split::PLANES * s.plane;
    s.qstage_bytes = s.qstats + align1k(STATS_BYTES);
    s.cplane = align1k(BLK * cb * 2);
    s.chunk = s.qstage + 2 * s.qstage_bytes;
    s.chunk_bytes = 2 * split::PLANES * s.cplane;
    s.ds = s.chunk + cstages * s.chunk_bytes;
    s.stg = s.ds + split::PLANES * DS_BYTES;
    s.bars = s.stg + align1k(BLK * d_tile * 4);
    s.total = s.bars + 8 * (5 + 2 * cstages);
    return s;
}

// Chunk stages of the split dkdq kernel: the most, 2 to 4, that fit one CTA
// (with 1 KB of alignment).
__host__ __device__ inline int split_chunk_stages(int d_tile, int cb) {
    for (int st = 4; st > 2; --st)
        if (split_layout(d_tile, cb, st).total + 1024 <= MAX_CTA_SMEM) return st;
    return 2;
}

int dkdq_split_smem_bytes(int d_tile, int cb) {
    return (int)split_layout(d_tile, cb, split_chunk_stages(d_tile, cb)).total + 1024;
}

// dk and dq in fp32 from split planes (dv is `flash_bwd_dv<D, CW, 3>`'s).
// Three planes of V do not fit beside the rest at C = 512 (192 KB), so V
// is not resident as in the bf16 kernel: per query tile, dp^T = v do^T runs
// over C in chunks of CB columns (64, or 16 where C is not a multiple of
// 64), each chunk's planes of v and do streamed through their own ring;
// the q tiles (with lse and delta) have a ring of two.  The exponentials of
// s^T run under the first chunk's products.  dq and dk are added to the
// float32 outputs (zeroed by the caller) by bulk reduce-adds.  NCH: the
// chunks, C / CB, where the registry's widths make it known at compile time
// (the chunk loop then unrolls: a loop that carries the dp^T accumulator
// makes ptxas serialise every wgmma of the kernel, C7515), else 0 (C / CB
// chunks at run time).
template <int D, int CB, int NCH>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdq_split(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
    using namespace hopper;
    using split::plane_a;
    using split::plane_b;
    constexpr int NP = split::PLANES;
    const int cstages = split_chunk_stages(D, CB);
    const SplitSmem L = split_layout(D, CB, cstages);
    uint8_t* sm = smem_base();
    const int b = blockIdx.y, k0 = blockIdx.x * BLK;
    int t0, t1;
    tile_range(p, blockIdx.z, t0, t1);
    const int nch = NCH > 0 ? NCH : p.c / CB, nt = t1 - t0, chunks = nt * nch;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* qfull = bars + 1;
    uint64_t* qempty = bars + 3;
    uint64_t* cfull = bars + 5;
    uint64_t* cempty = bars + 5 + cstages;
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        for (int st = 0; st < 2; ++st) {
            mbar_init(&qfull[st], 1);   // thread 0's arrival + the bytes
            mbar_init(&qempty[st], 4);  // one arrival per warp
        }
        for (int st = 0; st < cstages; ++st) {
            mbar_init(&cfull[st], 1);
            mbar_init(&cempty[st], 4);
        }
        fence_barrier_init();
    }
    __syncthreads();
    // q tile t0 + i (its planes, its rows' lse and delta) into q stage i % 2
    auto load_q = [&](int i) {
        uint8_t* st = sm + L.qstage + (i % 2) * L.qstage_bytes;
        uint64_t* f = &qfull[i % 2];
        mbar_arrive_expect_tx(f, NP * BLK * D * 2 + STATS_BYTES);
        for (int pl = 0; pl < NP; ++pl)
            tma_load_3d(st + pl * L.plane, &tq, f, 0, (t0 + i) * BLK, pl * p.batch + b);
        bulk_load(st + L.qstats, p.stats + (size_t)b * p.nqp + (t0 + i) * BLK, STATS_BYTES, f);
    };
    // chunk j: columns (j % nch) CB .. of v and of do (query tile t0 + j / nch)
    auto load_chunk = [&](int j) {
        uint8_t* st = sm + L.chunk + (j % cstages) * L.chunk_bytes;
        uint64_t* f = &cfull[j % cstages];
        const int t = t0 + j / nch, col = (j % nch) * CB;
        mbar_arrive_expect_tx(f, 2 * NP * BLK * CB * 2);
        for (int pl = 0; pl < NP; ++pl) {
            tma_load_3d(st + pl * L.cplane, &tv, f, col, k0, pl * p.batch + b);
            tma_load_3d(st + (NP + pl) * L.cplane, &tdo, f, col, t * BLK, pl * p.batch + b);
        }
    };
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // once every warp is done with chunk j, its stage takes chunk j + cstages
    auto release = [&](int j) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&cempty[j % cstages]);
        if (threadIdx.x == 0 && j + cstages < chunks) {
            mbar_wait(&cempty[j % cstages], (j / cstages) & 1);
            load_chunk(j + cstages);
        }
    };
    if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&bars[0], NP * BLK * D * 2);
        for (int pl = 0; pl < NP; ++pl)
            tma_load_3d(sm + pl * L.plane, &tk, &bars[0], 0, k0, pl * p.batch + b);
        for (int i = 0; i < 2 && i < nt; ++i) load_q(i);
        for (int j = 0; j < cstages && j < chunks; ++j) load_chunk(j);
    }
    const int g = lane >> 2, qd = lane & 3;
    const int row0 = 16 * warp + g;  // this thread's accumulator rows: row0, row0 + 8
    const bool key_ok0 = k0 + row0 < p.nk, key_ok1 = k0 + row0 + 8 < p.nk;
    const bool ragged = k0 + BLK > p.nk;  // this CTA holds keys past nk
    const uint8_t* ks = sm;
    uint8_t* dss = sm + L.ds;
    float* stg = reinterpret_cast<float*>(sm + L.stg);
    float dk[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = 0.f;
    mbar_wait(bars, 0);  // K

    for (int i = 0; i < nt; ++i) {
        const int t = t0 + i;
        const uint8_t* qs = sm + L.qstage + (i % 2) * L.qstage_bytes;
        const float2* stats = reinterpret_cast<const float2*>(qs + L.qstats);
        mbar_wait(&qfull[i % 2], (i / 2) & 1);
        // the q stage of tile i - 1 takes tile i + 1 once every warp is done
        // with it
        if (i > 0) {
            if (lane == 0) mbar_arrive(&qempty[(i - 1) % 2]);
            if (threadIdx.x == 0 && i + 1 < nt) {
                mbar_wait(&qempty[(i - 1) % 2], ((i - 1) / 2) & 1);
                load_q(i + 1);
            }
        }
        float s[32], dp[32], pt[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<64, 0, 0>(s, kmajor<D>(ks + plane_a(pr) * L.plane, kk),
                                   kmajor<D>(qs + plane_b(pr) * L.plane, kk), pr > 0 || kk > 0);
        wgmma_commit();
        // dp^T = v do^T over the chunks of C; each chunk's stage goes back
        // to the ring once the next chunk's products are issued and its own
        // are done
        auto chunk = [&](int ch) {
            const int j = i * nch + ch;
            const uint8_t* cs = sm + L.chunk + (j % cstages) * L.chunk_bytes;
            mbar_wait(&cfull[j % cstages], (j / cstages) & 1);
            wgmma_fence();
#pragma unroll
            for (int pr = 0; pr < split::PRODUCTS; ++pr)
#pragma unroll
                for (int kk = 0; kk < CB / 16; ++kk)
                    wgmma_ss<64, 0, 0>(dp, kmajor<CB>(cs + plane_a(pr) * L.cplane, kk),
                                       kmajor<CB>(cs + (NP + plane_b(pr)) * L.cplane, kk), 1);
            wgmma_commit();
            wgmma_wait<1>();
            if (ch == 0) {  // s^T is done: its exponentials run under this chunk
                fence_regs(s);
                exp_scores(pt, s, stats, qd, key_ok0, key_ok1, ragged);
            } else {
                release(j - 1);
            }
        };
        if constexpr (NCH > 0) {
#pragma unroll
            for (int ch = 0; ch < NCH; ++ch) chunk(ch);
        } else {
            for (int ch = 0; ch < nch; ++ch) chunk(ch);
        }
        wgmma_wait<0>();
        fence_regs(dp);
        release(i * nch + nch - 1);
        // ds^T = p^T (dp^T - delta), split as the A operand of dk += ds^T q
        uint32_t ds[NP][4][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float d0 = stats[8 * j + 2 * qd].y, d1 = stats[8 * j + 2 * qd + 1].y;
            dp[4 * j + 0] = pt[4 * j + 0] * (dp[4 * j + 0] - d0);
            dp[4 * j + 1] = pt[4 * j + 1] * (dp[4 * j + 1] - d1);
            dp[4 * j + 2] = pt[4 * j + 2] * (dp[4 * j + 2] - d0);
            dp[4 * j + 3] = pt[4 * j + 3] * (dp[4 * j + 3] - d1);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) accum_to_a3(dp, kk, ds[0][kk], ds[1][kk], ds[2][kk]);
        // this tile's dk += ds^T q in a fresh accumulator, added to dk in
        // float32 below: the tensor core's sum over hundreds of tiles drops
        // low bits a float32 add keeps (see the header)
        float dkt[D / 2];
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_rs<D, 1>(dkt, ds[plane_a(pr)][kk],
                               mnmajor<D>(qs + plane_b(pr) * L.plane, kk), pr > 0 || kk > 0);
        wgmma_commit();
        // every warp's dq product of the previous tile has read ds^T: it
        // takes this tile's planes as [key][query], 128-byte rows, swizzled
        // as TMA would
        named_barrier(WG_BARRIER, 128);
#pragma unroll
        for (int pl = 0; pl < NP; ++pl)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                uint8_t* at = dss + pl * DS_BYTES + row0 * 128 + ((j ^ g) << 4) + 4 * qd;
                *reinterpret_cast<uint32_t*>(at) = ds[pl][j / 2][2 * (j % 2)];
                *reinterpret_cast<uint32_t*>(at + 8 * 128) = ds[pl][j / 2][2 * (j % 2) + 1];
            }
        fence_proxy_async();
        named_barrier(WG_BARRIER, 128);
        float dq[D / 2];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) dq[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int pr = 0; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<D, 1, 1>(dq, mnmajor<64>(dss + plane_a(pr) * DS_BYTES, kk),
                                  mnmajor<D>(ks + plane_b(pr) * L.plane, kk), pr > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dkt);
        fence_regs(ds);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) dk[e] += dkt[e];
        // this warp's 16 query rows of dq, added to dq in one bulk op once
        // the previous tile's has read the staging rows
        if (lane == 0) bulk_wait_read();
        __syncwarp();
        stage_rows<D>(dq, stg, p.dp, p.dp, row0, qd);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) {
            const int first = t * BLK + 16 * warp, rows = min(16, p.nq - first);
            if (rows > 0) {
                bulk_reduce_add_f32(p.dq + ((size_t)b * p.nq + first) * p.dp,
                                    stg + 16 * warp * p.dp, rows * p.dp * 4);
                bulk_commit();
            }
        }
    }

    // dk of the CTA's keys, added to dk through the same staging rows
    if (lane == 0) bulk_wait_read();
    __syncwarp();
    stage_rows<D>(dk, stg, p.dp, p.dp, row0, qd);
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) {
        const int first = k0 + 16 * warp, rows = min(16, p.nk - first);
        if (rows > 0) {
            bulk_reduce_add_f32(p.dk + ((size_t)b * p.nk + first) * p.dp, stg + 16 * warp * p.dp,
                                rows * p.dp * 4);
            bulk_commit();
        }
        bulk_wait();
    }
}

// (lse log2(e), delta) of every query row, padded to whole tiles with
// (+inf, 0), from o and do of type T (bf16 or float32; C a multiple of 16).
template <typename T>
__global__ void __launch_bounds__(256)
bwd_row_stats(const T* __restrict__ o, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlse,
              float2* __restrict__ stats, int rows, int nq, int nqp, int c) {
    constexpr int PER = 16 / sizeof(T);  // values per 16-byte load
    const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const int bb = row / nqp, i = row - bb * nqp;
    if (i >= nq) {
        if (lane == 0) stats[row] = make_float2(INFINITY, 0.f);
        return;
    }
    const size_t src = (size_t)bb * nq + i;
    const uint4* orow = reinterpret_cast<const uint4*>(o + src * c);
    const uint4* drow = reinterpret_cast<const uint4*>(dout + src * c);
    float s = 0.f;
    for (int j = lane; j < c / PER; j += 32) {
        const uint4 a = orow[j], d = drow[j];
        if constexpr (sizeof(T) == 2) {
            const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float2 af = __bfloat1622float2(a2[e]), df = __bfloat1622float2(d2[e]);
                s = fmaf(af.x, df.x, fmaf(af.y, df.y, s));
            }
        } else {
            const float4 af = *reinterpret_cast<const float4*>(&a);
            const float4 df = *reinterpret_cast<const float4*>(&d);
            s = fmaf(af.x, df.x, fmaf(af.y, df.y, fmaf(af.z, df.z, fmaf(af.w, df.w, s))));
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
        stats[row] = make_float2(lse[src] * LOG2E, dlse == nullptr ? s : s - dlse[src]);
}

template <typename T>
int row_stats(const T* o, const T* dout, const float* lse, const float* dlse, float* stats,
              int rows, int nq, int nqp, int c, cudaStream_t stream) {
    bwd_row_stats<T><<<(rows + 7) / 8, 256, 0, stream>>>(
        o, dout, lse, dlse, reinterpret_cast<float2*>(stats), rows, nq, nqp, c);
    return (int)cudaGetLastError();
}

int dkdq_smem_bytes(int d_tile, int c) {
    return (int)smem_layout(d_tile, c, dkdq_tile_bytes(d_tile, c)).total + 1024;
}

template <int D, int CB, int CF, int KC>
int launch_dkdq(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const CUtensorMap& tdo, const BwdParams& p, int b, cudaStream_t stream) {
    const int bytes = dkdq_smem_bytes(D, p.c);
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdq<D, CB, CF, KC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.nk + BLK - 1) / BLK, b, p.splits);
    flash_bwd_dkdq<D, CB, CF, KC><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, tdo, p);
    return (int)cudaGetLastError();
}

template <int D, int CW, int NP>
int launch_dv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tdo,
              const BwdParams& p, int b, cudaStream_t stream) {
    const int bytes = (int)smem_layout(D, 0, BLK * CW * 2, NP).total + 1024;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dv<D, CW, NP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.nk + BLK - 1) / BLK, b, p.splits * p.slabs);
    flash_bwd_dv<D, CW, NP><<<grid, THREADS, bytes, stream>>>(tq, tk, tdo, p);
    return (int)cudaGetLastError();
}

// dv is the dkdq kernel's where C is 16, 32 or 64, or 128 with d <= 16
// (its accumulator, C/2 registers, then fits beside the others without
// spilling), else `flash_bwd_dv`'s.
template <int D>
int launch_bf16_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                  const CUtensorMap& tdo, BwdParams p, int b, int cw, cudaStream_t stream) {
    int err;
    switch (p.c) {
        case 16: return launch_dkdq<D, 16, 16, 1>(tq, tk, tv, tdo, p, b, stream);
        case 32: return launch_dkdq<D, 16, 32, 2>(tq, tk, tv, tdo, p, b, stream);
        case 64: return launch_dkdq<D, 64, 64, 4>(tq, tk, tv, tdo, p, b, stream);
        case 128:
            if constexpr (D == 16) return launch_dkdq<D, 64, 128, 8>(tq, tk, tv, tdo, p, b, stream);
            err = launch_dkdq<D, 64, 0, 8>(tq, tk, tv, tdo, p, b, stream);
            break;
        case 256: err = launch_dkdq<D, 64, 0, 16>(tq, tk, tv, tdo, p, b, stream); break;
        case 512: err = launch_dkdq<D, 64, 0, 32>(tq, tk, tv, tdo, p, b, stream); break;
        default:
            err = p.c % 64 == 0 ? launch_dkdq<D, 64, 0, 0>(tq, tk, tv, tdo, p, b, stream)
                                : launch_dkdq<D, 16, 0, 0>(tq, tk, tv, tdo, p, b, stream);
    }
    if (err) return err;
    p.slabs = p.c / cw;
    switch (cw) {
        case 256: return launch_dv<D, 256, 1>(tq, tk, tdo, p, b, stream);
        case 64: return launch_dv<D, 64, 1>(tq, tk, tdo, p, b, stream);
        default: return launch_dv<D, 16, 1>(tq, tk, tdo, p, b, stream);
    }
}

using DkdqSplit = void (*)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, BwdParams);

// The split dkdq instantiation for C: chunks of 64 columns where 64 divides
// C, else 16; their count unrolled at C = 64, 128, 256, 512 and 16, 32.
template <int D>
DkdqSplit dkdq_split_kernel(int c) {
    if (c % 64 == 0) {
        switch (c / 64) {
            case 1: return flash_bwd_dkdq_split<D, 64, 1>;
            case 2: return flash_bwd_dkdq_split<D, 64, 2>;
            case 4: return flash_bwd_dkdq_split<D, 64, 4>;
            case 8: return flash_bwd_dkdq_split<D, 64, 8>;
            default: return flash_bwd_dkdq_split<D, 64, 0>;
        }
    }
    switch (c / 16) {
        case 1: return flash_bwd_dkdq_split<D, 16, 1>;
        case 2: return flash_bwd_dkdq_split<D, 16, 2>;
        default: return flash_bwd_dkdq_split<D, 16, 0>;
    }
}

// The split kernels at d_tile D: dk and dq by `flash_bwd_dkdq_split` over
// chunks of cb columns of C, dv by `flash_bwd_dv<D, cw, 3>`.
template <int D>
int launch_split_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tdo, BwdParams p, int b, int cb, int cw,
                   cudaStream_t stream) {
    const DkdqSplit kernel = dkdq_split_kernel<D>(p.c);
    const int bytes = dkdq_split_smem_bytes(D, cb);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    kernel<<<dim3((p.nk + BLK - 1) / BLK, b, p.splits), THREADS, bytes, stream>>>(tq, tk, tv, tdo,
                                                                                 p);
    if ((err = (int)cudaGetLastError())) return err;
    p.slabs = p.c / cw;
    if constexpr (D == 64)
        if (cw == 128) return launch_dv<D, 128, split::PLANES>(tq, tk, tdo, p, b, stream);
    return cw == 64 ? launch_dv<D, 64, split::PLANES>(tq, tk, tdo, p, b, stream)
                    : launch_dv<D, 16, split::PLANES>(tq, tk, tdo, p, b, stream);
}

// CTAs of a kernel resident on one SM with `bytes` of dynamic shared
// memory, from the card's occupancy calculator (the split rule's model is
// held to it); -1 if it cannot say.
template <typename K>
int resident(K kernel, int bytes) {
    int n = -1;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS, bytes) != cudaSuccess)
        return -1;
    return n;
}

template <int D, int CB, int CF, int KC>
int dkdq_resident(int c) {
    return resident(flash_bwd_dkdq<D, CB, CF, KC>, dkdq_smem_bytes(D, c));
}

template <int D>
int dkdq_resident_d(int c, int dtype) {
    if (dtype == 0)
        return resident(dkdq_split_kernel<D>(c), dkdq_split_smem_bytes(D, c % 64 == 0 ? 64 : 16));
    switch (c) {
        case 16: return dkdq_resident<D, 16, 16, 1>(c);
        case 32: return dkdq_resident<D, 16, 32, 2>(c);
        case 64: return dkdq_resident<D, 64, 64, 4>(c);
        case 128:
            if constexpr (D == 16) return dkdq_resident<D, 64, 128, 8>(c);
            return dkdq_resident<D, 64, 0, 8>(c);
        case 256: return dkdq_resident<D, 64, 0, 16>(c);
        case 512: return dkdq_resident<D, 64, 0, 32>(c);
    }
    return c % 64 == 0 ? dkdq_resident<D, 64, 0, 0>(c) : dkdq_resident<D, 16, 0, 0>(c);
}

int round_all(const float* src, __nv_bfloat16* dst, size_t n, cudaStream_t stream) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    round_to_bf16<<<blocks, 256, 0, stream>>>(src, dst, n);
    return (int)cudaGetLastError();
}

int d_tile_of(int dp) { return dp <= 16 ? 16 : dp <= 32 ? 32 : 64; }

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                const float* dlse, float* stats, float* dq_acc, float* dk_acc, float* dv_acc,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk,
                int dp, int c, int splits, cudaStream_t stream) {
    const int nqt = (nq + BLK - 1) / BLK;
    if (dp % 8 || splits < 1 || splits > nqt) return (int)cudaErrorInvalidValue;
    const int d_tile = d_tile_of(dp);
    const int cb = c % 64 == 0 ? 64 : 16;
    // dv's column slab where the dkdq kernel does not take dv: 256 or 64
    // columns where they divide C, else 16 (C = 48, 80, 96, 112)
    const int cw = c % 256 == 0 ? 256 : c % 64 == 0 ? 64 : 16;
    if (splits > 1 && (dk_acc == nullptr || dv_acc == nullptr)) return (int)cudaErrorInvalidValue;
    const BwdParams p{reinterpret_cast<const float2*>(stats), dq_acc, dk_acc, dv_acc, dk, dv, nq,
                      nk, dp, c, nqt * BLK, nqt, splits, 1, b};
    int err = row_stats(o, dout, lse, dlse, stats, b * p.nqp, nq, p.nqp, c, stream);
    if (err) return err;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = hopper::make_map_bf16_3d(&tq, q, dp, nq, b, d_tile, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, k, dp, nk, b, d_tile, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, v, c, nk, b, cb, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tdo, dout, c, nq, b, cb, BLK))) return err;
    if (d_tile == 16) err = launch_bf16_d<16>(tq, tk, tv, tdo, p, b, cw, stream);
    else if (d_tile == 32) err = launch_bf16_d<32>(tq, tk, tv, tdo, p, b, cw, stream);
    else err = launch_bf16_d<64>(tq, tk, tv, tdo, p, b, cw, stream);
    if (err) return err;
    if ((err = round_all(dq_acc, dq, (size_t)b * nq * dp, stream)) || splits == 1) return err;
    if ((err = round_all(dk_acc, dk, (size_t)b * nk * dp, stream))) return err;
    return round_all(dv_acc, dv, (size_t)b * nk * c, stream);
}

// fp32: q, k, v, do split into their planes in `planes` (3 B (Nq dp +
// Nk dp + Nk C + Nq C) bf16, dp = d rounded up to 8), then the split
// kernels, which add dq [B, Nq, dp], dk [B, Nk, dp] and dv [B, Nk, C] to
// float32 outputs the caller zeroes.
int launch_split(const float* q, const float* k, const float* v, const float* o,
                 const float* dout, const float* lse, const float* dlse, float* stats, float* dq,
                 float* dk, float* dv, __nv_bfloat16* planes, int b, int nq, int nk, int d, int c,
                 int splits, cudaStream_t stream) {
    const int nqt = (nq + BLK - 1) / BLK, dp = (d + 7) / 8 * 8;
    if (splits < 1 || splits > nqt) return (int)cudaErrorInvalidValue;
    const int d_tile = d_tile_of(dp);
    const int cb = c % 64 == 0 ? 64 : 16;
    // dv's column slab: 128 columns at d_tile 64 where they divide C (one
    // CTA per SM either way; half the slabs recomputing s^T), else 64 where
    // they divide C, else 16
    const int cw = d_tile == 64 && c % 128 == 0 ? 128 : c % 64 == 0 ? 64 : 16;
    const BwdParams p{reinterpret_cast<const float2*>(stats), dq, dk, dv, nullptr, nullptr, nq,
                      nk, dp, c, nqt * BLK, nqt, splits, 1, b};
    int err = row_stats(o, dout, lse, dlse, stats, b * p.nqp, nq, p.nqp, c, stream);
    if (err) return err;
    constexpr size_t NP = split::PLANES;
    __nv_bfloat16* qp = planes;
    __nv_bfloat16* kp = qp + NP * b * nq * dp;
    __nv_bfloat16* vp = kp + NP * b * nk * dp;
    __nv_bfloat16* dop = vp + NP * b * nk * c;
    if ((err = split::split(q, qp, (long long)b * nq, d, dp, stream))) return err;
    if ((err = split::split(k, kp, (long long)b * nk, d, dp, stream))) return err;
    if ((err = split::split(v, vp, (long long)b * nk, c, c, stream))) return err;
    if ((err = split::split(dout, dop, (long long)b * nq, c, c, stream))) return err;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = hopper::make_map_bf16_3d(&tq, qp, dp, nq, NP * b, d_tile, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, kp, dp, nk, NP * b, d_tile, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, vp, c, nk, NP * b, cb, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tdo, dop, c, nq, NP * b, cb, BLK))) return err;
    if (d_tile == 16) return launch_split_d<16>(tq, tk, tv, tdo, p, b, cb, cw, stream);
    if (d_tile == 32) return launch_split_d<32>(tq, tk, tv, tdo, p, b, cb, cw, stream);
    return launch_split_d<64>(tq, tk, tv, tdo, p, b, cb, cw, stream);
}

}  // namespace

extern "C" {

int sap3d_flash_bwd_max_d() { return MAX_D; }
int sap3d_flash_bwd_max_c() { return MAX_C; }
int sap3d_flash_bwd_c_multiple() { return C_MULTIPLE; }
int sap3d_flash_bwd_wide_c_multiple() { return WIDE_C_MULTIPLE; }
int sap3d_flash_bwd_narrow_max_c() { return NARROW_MAX_C; }
int sap3d_flash_bwd_block() { return BLK; }

// CTAs of the dkdq kernel (bf16; float32: the split one) resident per SM
// at d (a multiple of 8) and C; -1 if the card cannot say.
int sap3d_flash_bwd_resident_ctas(int d, int c, int dtype) {
    if (d <= 16) return dkdq_resident_d<16>(c, dtype);
    if (d <= 32) return dkdq_resident_d<32>(c, dtype);
    return dkdq_resident_d<64>(c, dtype);
}

// dtype: 0 = float32, 1 = bfloat16.  Inputs q, k, v, o, dout (= do) in that
// dtype, lse [B, Nq] float32, and dlse [B, Nq] float32 (B4) or null (B3);
// `stats` [B, 64 ceil(Nq/64), 2] float32 scratch; `splits` query ranges per
// key tile (1 to ceil(Nq/64)).
// float32: d as it is; dq_acc, dk_acc, dv_acc are the outputs dq
// [B, Nq, dp], dk [B, Nk, dp], dv [B, Nk, C], zeroed by the caller (dp = d
// rounded up to 8); `planes` bf16 scratch of 3 B (Nq dp + Nk dp + Nk C +
// Nq C) elements; dq, dk, dv are not read.  bfloat16: d a multiple of 8;
// dq_acc [B, Nq, d] float32 scratch zeroed by the caller, and where
// `splits` > 1 also dk_acc [B, Nk, d] and dv_acc [B, Nk, C] (null where
// `splits` is 1: dk and dv are then written directly); outputs dq, dk, dv;
// `planes` is not read.  Returns a cudaError_t (0 = launched); invalid
// arguments return cudaErrorInvalidValue without launching.
int sap3d_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, const void* dlse, void* stats,
                    void* dq_acc, void* dk_acc, void* dv_acc, void* dq, void* dk, void* dv,
                    void* planes, int b, int nq, int nk, int d, int c, int splits, int dtype,
                    void* stream) {
    if (b <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D || c <= 0 || c > MAX_C ||
        c % C_MULTIPLE || (c > NARROW_MAX_C && c % WIDE_C_MULTIPLE))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_split(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<const float*>(o),
                            static_cast<const float*>(dout), static_cast<const float*>(lse),
                            static_cast<const float*>(dlse), static_cast<float*>(stats),
                            static_cast<float*>(dq_acc), static_cast<float*>(dk_acc),
                            static_cast<float*>(dv_acc), static_cast<__nv_bfloat16*>(planes), b,
                            nq, nk, d, c, splits, s);
    if (dtype == 1)
        return launch_bf16(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(o),
            static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
            static_cast<const float*>(dlse), static_cast<float*>(stats),
            static_cast<float*>(dq_acc), static_cast<float*>(dk_acc), static_cast<float*>(dv_acc),
            static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv), b, nq, nk, d, c, splits, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
