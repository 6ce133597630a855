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
// B5's backward (`flash_fwd_chunked_bwd`, ops/attention.py) runs B3 too, on
// the lse of the row-stats kernel (flash_attention_fwd.cu) and B5's saved
// output.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C], o and do [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16); lse and dlse [B, Nq]
// float32.  Outputs dq [B, Nq, d], dk [B, Nk, d], dv [B, Nk, C] in that
// dtype.  Rows of q and k come in whole 16-byte chunks (bf16: the wrapper
// pads q and k with zero columns; float32: the split pass writes the
// planes so; the wrapper drops those columns of dq and dk).  d <= 128; C a
// multiple of 16 up to 128 or of 64 up to 1024.  Per query row i and key j:
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
//   GN deconv_pool4    3136    3136  128 1024   766     462  0.7740  compute
//   x_0_1_sa (B = 2) 200704    3136    2   16    95.7    31  0.0967  compute
// At x_0_1_sa the 1.26e9 exponentials alone, at the SFU's ~16 per clock per
// SM (~4e12/s on 132 SMs), take ~0.3 ms, three times the bound.  float32:
// six times the FLOPs (x_2_2 1.161 ms, x_1_3 4.64, deconv_pool3 2.32,
// deconv_pool4 4.64).
//
// Design of the bf16 kernels (B3 and B4; float32 below).  Hopper's blocks run in parallel and in no
// order, so the TPU kernel's sequential sweep over query blocks with dk and
// dv summed in VMEM becomes one CTA per (64 keys, batch element, query
// range) that keeps its keys' sums in registers and walks its query tiles:
//   1. `bwd_row_stats` writes (lse, delta) of every query row, padded to
//      whole 64-row tiles with (+inf, 0) so that padded rows get p = 0.
//   2. `flash_bwd_dkdq` (d <= 64, C <= 512; wider, the streaming kernel
//      below), one warpgroup per CTA.  Its thread 0 loads K and V
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
// wgmma's k-steps over C are unrolled where C is 16 ... 512 (streaming:
// ... 1024) by powers of two: a loop over them makes ptxas serialise every
// wgmma of the kernel (C7515); other C count them at run time.
// The streaming dkdq kernel, `flash_bwd_dkdq_split<D, CB, NCH, NP>` (dk,
// dq): V of 64 keys and two do stages do not stay resident at C = 1024 in
// bf16 (128 KB + 256 KB) nor at three planes in float32 (192 KB of V at
// C = 512), so per query tile it streams dp^T = v do^T over chunks of 64
// (or 16) columns of C, each chunk's v and do planes through a ring of 2-4
// stages; the q tiles and their (lse, delta) have a ring of their own; ds^T
// is rounded (bf16) or split (`accum_to_a3`, float32) in registers for
// dk += ds^T q and written to shared memory for dq = ds k.  q and k tiles
// of d above 64 are two 64-column boxes.  It takes every float32 call
// (NP = 3), and bf16 calls (NP = 1) at d above 64 or C above 512.  Its
// layout (`split_config`): the planes of K, two q stages, ds^T and the
// dq staging rows apart, 4 to 2 chunk stages; where that does not fit (three
// planes at d_tile 128: 48 KB of K, 49 KB a q stage, 48 KB a chunk stage),
// one q stage and the dq staging rows laid over the ds^T region, each tile
// waiting for the previous tile's dq bulk add to have read them: 226 KB at
// GN deconv_pool4, one CTA per SM.  dv is `flash_bwd_dv<D, CW, NP>`'s, by
// slabs (bf16: 256; float32: 64, or 128 at d_tile 64, or 16).
// float32 (B3 and B4 on split bf16 planes, `launch_split`): `split_planes`
// writes the hi, mid and lo planes of q, k, v and do into one scratch
// tensor (3-D tensor maps over [3 B, N, width]); `bwd_row_stats<float>`
// as above.  dk and dv take each query tile's products in a fresh
// accumulator and add it to their sums in float32: the tensor core's own
// sum over a CTA's 392 query tiles (x_1_3) drops low bits, 1.3e-4 of dk's
// L2 norm, 1.4x the float32 limit.  At d_tile 128 and C = 1024 dp^T takes
// each chunk's products in a fresh accumulator too (two taking turns),
// added in float32: summed by the tensor core over 16 chunks, dp lost 2e-4
// of dk on the GN decoder's deconv_pool4 tensors, where dp - delta cancels.  Every product is the six of
// split_bf16.cuh; dq, dk and dv are bulk-added to float32 outputs zeroed
// here (memsets), and nothing is rounded.  One 128-thread CTA per SM at
// 64-column chunks (shared memory); the query split rule is the bf16 one
// with that residency.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "split_bf16.cuh"

namespace {

// d up to this in both dtypes (q and k tiles of up to two 64-column
// boxes), C up to MAX_C.
constexpr int MAX_D = 128;
constexpr int MAX_C = 1024;
constexpr int C_MULTIPLE = 16;
constexpr int WIDE_C_MULTIPLE = 64;  // C above NARROW_MAX_C is a multiple of this
constexpr int NARROW_MAX_C = 128;
// The widest C whose V (and two do stages) the bf16 dkdq kernel keeps
// resident; wider C, and d above 64, take the streaming kernel.
constexpr int RESIDENT_MAX_C = 512;
constexpr int RESIDENT_MAX_D = 64;

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

    // a q or k tile: d_tile / kw boxes of kw columns (kw = min(d_tile, 64))
    __device__ __forceinline__ void qk_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                            int row, int z) const {
        const int kw = d_tile < 64 ? d_tile : 64;
        for (int j = 0; j < d_tile / kw; ++j)
            hopper::tma_load_3d(dst + j * BLK * kw * 2, map, bar, j * kw, row, z);
    }

    __device__ __forceinline__ uint64_t* bars() const {
        return reinterpret_cast<uint64_t*>(sm + L.bars);
    }

    __device__ __forceinline__ void kv() const {
        using namespace hopper;
        const uint32_t box_bytes = BLK * box_cols * 2;
        mbar_arrive_expect_tx(bars(), np * (BLK * d_tile * 2 + v_boxes * box_bytes));
        for (int pl = 0; pl < np; ++pl) {
            qk_tile(sm + pl * L.k_plane, tk, bars(), k0, pl * batch + b);
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
            qk_tile(stage + pl * L.q_plane, tq, full, t * BLK, pl * batch + b);
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
// at D = 64, 128; CW divides C).  NP: planes per operand, 1 (bf16) or 3
// (fp32 as split bf16: each product the six of split_bf16.cuh, dv added to
// the float32 output, zeroed by the launcher).
template <int D, int CW, int NP>
__global__ void __launch_bounds__(THREADS, NP == 1 && CW <= 64 ? 4 : 2)
flash_bwd_dv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
    using namespace hopper;
    using split::plane_a;
    using split::plane_b;
    constexpr int BW = CW < 64 ? CW : 64;  // columns of a do box
    constexpr int KW = D < 64 ? D : 64;    // columns of a q or k box
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
                wgmma_ss<64, 0, 0>(s, kmajor<KW>(ks + plane_a(pr) * L.k_plane, kk),
                                   kmajor<KW>(stage + plane_b(pr) * L.q_plane, kk),
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

// ---- the streaming dkdq kernel: fp32 as split bf16, and bf16 at wide C or d -------

// The streaming dkdq kernel's shared memory from a 1024-byte aligned base:
// the np planes of K; `qstages` stages of (the np planes of a q tile, its
// rows' lse and delta); `cstages` stages of (the np planes of a chunk of CB
// columns of V, then of do); the np planes of ds^T; the staging rows of dq
// (and at the end dk), which share the ds^T region where the two do not
// fit apart (`unioned`); the mbarriers (K, q full[qstages], q
// empty[qstages], chunk full[cstages], chunk empty[cstages]).
struct SplitSmem {
    uint32_t plane, qstage, qstats, qstage_bytes, cplane, chunk, chunk_bytes, ds, stg, bars, total;
    int qstages, cstages, unioned;
};

__host__ __device__ constexpr SplitSmem split_layout(int d_tile, int cb, int np, int qstages,
                                                     int cstages, int unioned) {
    SplitSmem s{};
    s.qstages = qstages;
    s.cstages = cstages;
    s.unioned = unioned;
    s.plane = align1k(BLK * d_tile * 2);  // one plane of K or of a q tile
    s.qstage = np * s.plane;
    s.qstats = np * s.plane;
    s.qstage_bytes = s.qstats + align1k(STATS_BYTES);
    s.cplane = align1k(BLK * cb * 2);
    s.chunk = s.qstage + qstages * s.qstage_bytes;
    s.chunk_bytes = 2 * np * s.cplane;
    s.ds = s.chunk + cstages * s.chunk_bytes;
    const uint32_t ds_bytes = np * DS_BYTES, stg_bytes = align1k(BLK * d_tile * 4);
    s.stg = unioned ? s.ds : s.ds + ds_bytes;
    s.bars = unioned ? s.ds + (ds_bytes > stg_bytes ? ds_bytes : stg_bytes) : s.stg + stg_bytes;
    s.total = s.bars + 8 * (1 + 2 * qstages + 2 * cstages);
    return s;
}

// The streaming kernel's layout at (d_tile, cb, np): two q stages, the
// ds^T and staging regions apart and the most chunk stages, 4 down to 2,
// that fit one CTA (with 1 KB of alignment); where none fits (three planes
// at d_tile 128), one q stage and the staging rows over the ds^T region.
__host__ __device__ constexpr SplitSmem split_config(int d_tile, int cb, int np) {
    for (int q = 2; q >= 1; --q)
        for (int st = 4; st >= 2; --st) {
            const SplitSmem s = split_layout(d_tile, cb, np, q, st, q == 1);
            if (s.total + 1024 <= MAX_CTA_SMEM) return s;
        }
    return split_layout(d_tile, cb, np, 1, 2, 1);
}

int dkdq_split_smem_bytes(int d_tile, int cb, int np) {
    return (int)split_config(d_tile, cb, np).total + 1024;
}

// dk and dq streaming V and do (dv is `flash_bwd_dv<D, CW, NP>`'s): per
// query tile, dp^T = v do^T runs over C in chunks of CB columns (64, or 16
// where C is not a multiple of 64), each chunk's planes of v and do
// streamed through their own ring; the q tiles (with lse and delta) have a
// ring of their own.  NP = 3: fp32 as split bf16 (three planes of V do not
// stay resident beside the rest: 192 KB at C = 512); NP = 1: bf16 where V
// and two do stages do not fit (C above 512) or d is above 64.  The
// exponentials of s^T run under the first chunk's products.  dq and dk are
// added to float32 scratch (bf16: rounded after) or outputs (fp32) by bulk
// reduce-adds.  NCH: the chunks, C / CB, where the registry's widths make
// it known at compile time (the chunk loop then unrolls: a loop that
// carries the dp^T accumulator makes ptxas serialise every wgmma of the
// kernel, C7515), else 0 (C / CB chunks at run time).
template <int D, int CB, int NCH, int NP>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkdq_split(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
    using namespace hopper;
    using split::plane_a;
    using split::plane_b;
    constexpr int KW = D < 64 ? D : 64;  // columns of a q or k box
    constexpr int FIRST = split::first_product(NP);
    // three planes at d_tile 128 (or 16 chunks unrolled): the dk product is
    // waited for before ds^T is written, so that its accumulator and the
    // split ds^T are not live beside dq's (else 255 registers do not hold
    // the tile: 240 to 616 bytes spilled)
    constexpr bool DK_FIRST = NP != 1 && (D > 64 || NCH >= 16);
    // those of 64-column chunks fold dp chunk by chunk (see below); the
    // others keep a single dp accumulator (16-column chunks: C <= 128,
    // at most 48 products summed)
    constexpr bool DP_FOLD = DK_FIRST && CB == 64;
    constexpr SplitSmem L = split_config(D, CB, NP);
    constexpr int qstages = L.qstages, cstages = L.cstages;
    uint8_t* sm = smem_base();
    const int b = blockIdx.y, k0 = blockIdx.x * BLK;
    int t0, t1;
    tile_range(p, blockIdx.z, t0, t1);
    const int nch = NCH > 0 ? NCH : p.c / CB, nt = t1 - t0, chunks = nt * nch;
    uint64_t* bars = reinterpret_cast<uint64_t*>(sm + L.bars);
    uint64_t* qfull = bars + 1;
    uint64_t* qempty = bars + 1 + qstages;
    uint64_t* cfull = bars + 1 + 2 * qstages;
    uint64_t* cempty = bars + 1 + 2 * qstages + cstages;
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        for (int st = 0; st < qstages; ++st) {
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
    // a q or k tile's plane: D / KW boxes of KW columns
    auto load_qk = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int row, int z) {
        for (int j = 0; j < D / KW; ++j) tma_load_3d(dst + j * BLK * KW * 2, map, bar, j * KW, row, z);
    };
    // q tile t0 + i (its planes, its rows' lse and delta) into q stage i % qstages
    auto load_q = [&](int i) {
        uint8_t* st = sm + L.qstage + (i % qstages) * L.qstage_bytes;
        uint64_t* f = &qfull[i % qstages];
        mbar_arrive_expect_tx(f, NP * BLK * D * 2 + STATS_BYTES);
        for (int pl = 0; pl < NP; ++pl)
            load_qk(st + pl * L.plane, &tq, f, (t0 + i) * BLK, pl * p.batch + b);
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
    // once every warp is done with q tile i, its stage takes tile i + qstages
    auto release_q = [&](int i) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&qempty[i % qstages]);
        if (threadIdx.x == 0 && i + qstages < nt) {
            mbar_wait(&qempty[i % qstages], (i / qstages) & 1);
            load_q(i + qstages);
        }
    };
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
        for (int pl = 0; pl < NP; ++pl) load_qk(sm + pl * L.plane, &tk, &bars[0], k0, pl * p.batch + b);
        for (int i = 0; i < qstages && i < nt; ++i) load_q(i);
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
    auto add_dk = [&](const float(&t)[D / 2]) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) dk[e] += t[e];
    };
    mbar_wait(bars, 0);  // K

    for (int i = 0; i < nt; ++i) {
        const int t = t0 + i;
        const uint8_t* qs = sm + L.qstage + (i % qstages) * L.qstage_bytes;
        const float2* stats = reinterpret_cast<const float2*>(qs + L.qstats);
        mbar_wait(&qfull[i % qstages], (i / qstages) & 1);
        // two q stages: the stage of tile i - 1 takes tile i + 1 once every
        // warp is done with it (one stage: see the end of the tile)
        if (qstages > 1 && i > 0) release_q(i - 1);
        float s[32], dp[32], pt[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) dp[e] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk)
                wgmma_ss<64, 0, 0>(s, kmajor<KW>(ks + plane_a(pr) * L.plane, kk),
                                   kmajor<KW>(qs + plane_b(pr) * L.plane, kk),
                                   pr > FIRST || kk > 0);
        wgmma_commit();
        // dp^T = v do^T over the chunks of C; each chunk's stage goes back
        // to the ring once the next chunk's products have started and its own
        // are done.  One accumulator over all chunks, but in split fp32 at
        // d above 64 or C = 1024 (DP_FOLD): there each chunk's products go to
        // a fresh accumulator added to dp in float32 (two taking turns, so
        // that one chunk's products run while the other's are added; one at
        // d_tile 128, below).  The tensor core's own sum over 16 chunks of 24
        // products drops low bits (rounded toward zero), and dp - delta
        // cancels: on the GN decoder's deconv_pool4 tensors that cost 2e-4 of
        // dk (emulated: 3.6e-4 with one accumulator, 8e-6 folded per chunk).
        // The fold's loop stays rolled: unrolled, its accumulators spilled
        // (up to 4.5 KB).
        auto start = [&](int ch, float(&acc)[32]) {
            const int j = i * nch + ch;
            const uint8_t* cs = sm + L.chunk + (j % cstages) * L.chunk_bytes;
            mbar_wait(&cfull[j % cstages], (j / cstages) & 1);
            wgmma_fence();
#pragma unroll
            for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
                for (int kk = 0; kk < CB / 16; ++kk)
                    wgmma_ss<64, 0, 0>(acc, kmajor<CB>(cs + plane_a(pr) * L.cplane, kk),
                                       kmajor<CB>(cs + (NP + plane_b(pr)) * L.cplane, kk),
                                       !DP_FOLD || pr > FIRST || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();
        };
        auto after = [&](int ch) {  // the previous group of products is done
            if (ch == 0) {  // s^T is done: its exponentials run under this chunk
                fence_regs(s);
                exp_scores(pt, s, stats, qd, key_ok0, key_ok1, ragged);
            } else {
                release(i * nch + ch - 1);
            }
        };
        auto fold = [&](float(&acc)[32]) {
            fence_regs(acc);
#pragma unroll
            for (int e = 0; e < 32; ++e) dp[e] += acc[e];
        };
        if constexpr (!DP_FOLD) {
            auto chunk = [&](int ch) {
                start(ch, dp);
                after(ch);
            };
            if constexpr (NCH > 0) {
#pragma unroll
                for (int ch = 0; ch < NCH; ++ch) chunk(ch);
            } else {
                for (int ch = 0; ch < nch; ++ch) chunk(ch);
            }
            wgmma_wait<0>();
            fence_regs(dp);
        } else if constexpr (D > RESIDENT_MAX_D) {
            // d_tile 128: one chunk accumulator, each chunk waited for and
            // added before the next starts (a second one, to overlap
            // them, spilled 0.5-1 KB beside dk's 64 registers)
            float da[32];
#pragma unroll 1
            for (int ch = 0; ch < nch; ++ch) {
                start(ch, da);
                wgmma_wait<0>();
                after(ch);
                fold(da);
            }
        } else {
            float da[32], db[32];
            // chunk ch into da (even) or db (odd); once it has started, the
            // other, which the previous chunk filled, is added to dp
            auto pair = [&](int ch) {
                start(ch, da);
                if (ch > 0) fold(db);
                after(ch);
                if (ch + 1 < nch) {
                    start(ch + 1, db);
                    fold(da);
                    after(ch + 1);
                }
            };
#pragma unroll 1
            for (int ch = 0; ch < nch; ch += 2) pair(ch);
            wgmma_wait<0>();
            if (nch & 1) fold(da);
            else fold(db);
        }
        release(i * nch + nch - 1);
        // ds^T = p^T (dp^T - delta): rounded to bf16 (one plane), or split,
        // as the A operand of dk += ds^T q
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
        for (int kk = 0; kk < 4; ++kk) {
            if constexpr (NP == 1) accum_to_a(dp, kk, ds[0][kk]);
            else accum_to_a3(dp, kk, ds[0][kk], ds[1][kk], ds[2][kk]);
        }
        // dk += ds^T q: bf16 on the tensor core; split, this tile's in a
        // fresh accumulator added to dk in float32 below (the tensor core's
        // sum over hundreds of tiles drops low bits a float32 add keeps)
        float dkt[NP == 1 ? 1 : D / 2];
        if constexpr (NP == 1) fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                if constexpr (NP == 1)
                    wgmma_rs<D, 1>(dk, ds[0][kk], mnmajor<KW>(qs, kk), 1);
                else
                    wgmma_rs<D, 1>(dkt, ds[plane_a(pr)][kk],
                                   mnmajor<KW>(qs + plane_b(pr) * L.plane, kk), pr > 0 || kk > 0);
            }
        wgmma_commit();
        if constexpr (DK_FIRST) {
            wgmma_wait<0>();
            fence_regs(dkt);
            fence_regs(ds);
            add_dk(dkt);
        }
        // every warp's dq product of the previous tile has read ds^T (and,
        // where the staging rows share its region, the previous tile's dq
        // bulk add has read them): it takes this tile's planes as
        // [key][query], 128-byte rows, swizzled as TMA would
        if constexpr (L.unioned) {
            if (lane == 0) bulk_wait_read();
            __syncwarp();
        }
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
        for (int pr = FIRST; pr < split::PRODUCTS; ++pr)
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
                wgmma_ss<D, 1, 1>(dq, mnmajor<64>(dss + plane_a(pr) * DS_BYTES, kk),
                                  mnmajor<KW>(ks + plane_b(pr) * L.plane, kk),
                                  pr > FIRST || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dk);
        if constexpr (!DK_FIRST) fence_regs(ds);  // the dk product read it until now
        if constexpr (NP != 1 && !DK_FIRST) {
            fence_regs(dkt);
            add_dk(dkt);
        }
        // one q stage: it takes the next tile as soon as this tile's dk
        // product is done with it
        if (qstages == 1) release_q(i);
        // this warp's 16 query rows of dq, added to dq in one bulk op once
        // the previous tile's has read the staging rows (and, where they
        // share the ds^T region, once every warp's dq product has read it)
        if constexpr (L.unioned) named_barrier(WG_BARRIER, 128);
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
            bulk_reduce_add_f32(p.dk + ((size_t)b * p.nk + first) * p.dp,
                                stg + 16 * warp * p.dp, rows * p.dp * 4);
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

// Columns of C per chunk of the streaming kernel: 64 where 64 divides C,
// else 16.
inline int chunk_cols(int c) { return c % 64 == 0 ? 64 : 16; }

// The streaming dkdq instantiation for C: chunks of 64 columns where 64
// divides C, else 16; their count unrolled at C = 64, 128, 256, 512, 1024
// and 16, 32 (bf16 at d_tile 16 ... 64 takes it only above C = 512: C =
// 1024 unrolled).
template <int D, int NP>
DkdqSplit dkdq_split_kernel(int c) {
    if constexpr (NP == 1 && D <= RESIDENT_MAX_D) {
        return c == 1024 ? flash_bwd_dkdq_split<D, 64, 16, NP> : flash_bwd_dkdq_split<D, 64, 0, NP>;
    } else {
        if (c % 64 == 0) {
            switch (c / 64) {
                case 1: return flash_bwd_dkdq_split<D, 64, 1, NP>;
                case 2: return flash_bwd_dkdq_split<D, 64, 2, NP>;
                case 4: return flash_bwd_dkdq_split<D, 64, 4, NP>;
                case 8: return flash_bwd_dkdq_split<D, 64, 8, NP>;
                case 16: return flash_bwd_dkdq_split<D, 64, 16, NP>;
                default: return flash_bwd_dkdq_split<D, 64, 0, NP>;
            }
        }
        switch (c / 16) {
            case 1: return flash_bwd_dkdq_split<D, 16, 1, NP>;
            case 2: return flash_bwd_dkdq_split<D, 16, 2, NP>;
            default: return flash_bwd_dkdq_split<D, 16, 0, NP>;
        }
    }
}

// Whether the bf16 dkdq kernel at (d_tile, C) is the streaming one: V and
// two do stages do not stay resident above C = 512, and d above 64 takes
// q and k tiles of two boxes, which only the streaming kernel reads.
inline bool bf16_streams(int d_tile, int c) { return d_tile > RESIDENT_MAX_D || c > RESIDENT_MAX_C; }

// The streaming kernels at d_tile D: dk and dq by `flash_bwd_dkdq_split`
// over chunks of C, dv by `flash_bwd_dv<D, cw, NP>`.
template <int D, int NP>
int launch_split_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tdo, BwdParams p, int b, int cw, cudaStream_t stream) {
    const DkdqSplit kernel = dkdq_split_kernel<D, NP>(p.c);
    const int bytes = dkdq_split_smem_bytes(D, chunk_cols(p.c), NP);
    int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
    kernel<<<dim3((p.nk + BLK - 1) / BLK, b, p.splits), THREADS, bytes, stream>>>(tq, tk, tv, tdo,
                                                                                 p);
    if ((err = (int)cudaGetLastError())) return err;
    p.slabs = p.c / cw;
    if constexpr (NP == 1) {
        switch (cw) {
            case 256: return launch_dv<D, 256, 1>(tq, tk, tdo, p, b, stream);
            case 64: return launch_dv<D, 64, 1>(tq, tk, tdo, p, b, stream);
            default: return launch_dv<D, 16, 1>(tq, tk, tdo, p, b, stream);
        }
    } else {
        if constexpr (D == 64)
            if (cw == 128) return launch_dv<D, 128, NP>(tq, tk, tdo, p, b, stream);
        return cw == 64 ? launch_dv<D, 64, NP>(tq, tk, tdo, p, b, stream)
                        : launch_dv<D, 16, NP>(tq, tk, tdo, p, b, stream);
    }
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
        return resident(dkdq_split_kernel<D, split::PLANES>(c),
                        dkdq_split_smem_bytes(D, chunk_cols(c), split::PLANES));
    if (bf16_streams(D, c))
        return resident(dkdq_split_kernel<D, 1>(c), dkdq_split_smem_bytes(D, chunk_cols(c), 1));
    if constexpr (D <= RESIDENT_MAX_D) {
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
    return -1;
}

int round_all(const float* src, __nv_bfloat16* dst, size_t n, cudaStream_t stream) {
    const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
    round_to_bf16<<<blocks, 256, 0, stream>>>(src, dst, n);
    return (int)cudaGetLastError();
}

int d_tile_of(int dp) { return dp <= 16 ? 16 : dp <= 32 ? 32 : dp <= 64 ? 64 : 128; }

// n floats of `dst` set to 0 on `stream` (a memset, no kernel).
int zero(float* dst, size_t n, cudaStream_t stream) {
    return (int)cudaMemsetAsync(dst, 0, n * sizeof(float), stream);
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                const float* dlse, float* stats, float* dq_acc, float* dk_acc, float* dv_acc,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk,
                int dp, int c, int splits, cudaStream_t stream) {
    const int nqt = (nq + BLK - 1) / BLK;
    if (dp % 8 || splits < 1 || splits > nqt) return (int)cudaErrorInvalidValue;
    const int d_tile = d_tile_of(dp), kw = d_tile < 64 ? d_tile : 64;
    const int cb = chunk_cols(c);
    const bool streams = bf16_streams(d_tile, c);
    // dv's column slab where the dkdq kernel does not take dv: 256 or 64
    // columns where they divide C, else 16 (C = 48, 80, 96, 112)
    const int cw = c % 256 == 0 ? 256 : c % 64 == 0 ? 64 : 16;
    // dk goes through float32 scratch where the query range is split or the
    // streaming kernel takes it (bulk adds), dv where the range is split
    if ((splits > 1 || streams) && dk_acc == nullptr) return (int)cudaErrorInvalidValue;
    if (splits > 1 && dv_acc == nullptr) return (int)cudaErrorInvalidValue;
    const BwdParams p{reinterpret_cast<const float2*>(stats), dq_acc, dk_acc, dv_acc, dk, dv, nq,
                      nk, dp, c, nqt * BLK, nqt, splits, 1, b};
    int err;
    if ((err = zero(dq_acc, (size_t)b * nq * dp, stream))) return err;
    if ((splits > 1 || streams) && (err = zero(dk_acc, (size_t)b * nk * dp, stream))) return err;
    if (splits > 1 && (err = zero(dv_acc, (size_t)b * nk * c, stream))) return err;
    if ((err = row_stats(o, dout, lse, dlse, stats, b * p.nqp, nq, p.nqp, c, stream))) return err;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = hopper::make_map_bf16_3d(&tq, q, dp, nq, b, kw, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, k, dp, nk, b, kw, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, v, c, nk, b, cb, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tdo, dout, c, nq, b, cb, BLK))) return err;
    switch (d_tile) {
        case 16:
            err = streams ? launch_split_d<16, 1>(tq, tk, tv, tdo, p, b, cw, stream)
                          : launch_bf16_d<16>(tq, tk, tv, tdo, p, b, cw, stream);
            break;
        case 32:
            err = streams ? launch_split_d<32, 1>(tq, tk, tv, tdo, p, b, cw, stream)
                          : launch_bf16_d<32>(tq, tk, tv, tdo, p, b, cw, stream);
            break;
        case 64:
            err = streams ? launch_split_d<64, 1>(tq, tk, tv, tdo, p, b, cw, stream)
                          : launch_bf16_d<64>(tq, tk, tv, tdo, p, b, cw, stream);
            break;
        default: err = launch_split_d<128, 1>(tq, tk, tv, tdo, p, b, cw, stream);
    }
    if (err) return err;
    if ((err = round_all(dq_acc, dq, (size_t)b * nq * dp, stream))) return err;
    if ((splits > 1 || streams) && (err = round_all(dk_acc, dk, (size_t)b * nk * dp, stream)))
        return err;
    return splits > 1 ? round_all(dv_acc, dv, (size_t)b * nk * c, stream) : 0;
}

// fp32: q, k, v, do split into their planes in `planes` (3 B (Nq dp +
// Nk dp + Nk C + Nq C) bf16, dp = d rounded up to 8), then the split
// kernels, which add dq [B, Nq, dp], dk [B, Nk, dp] and dv [B, Nk, C] to
// float32 outputs zeroed here.
int launch_split(const float* q, const float* k, const float* v, const float* o,
                 const float* dout, const float* lse, const float* dlse, float* stats, float* dq,
                 float* dk, float* dv, __nv_bfloat16* planes, int b, int nq, int nk, int d, int c,
                 int splits, cudaStream_t stream) {
    const int nqt = (nq + BLK - 1) / BLK, dp = (d + 7) / 8 * 8;
    if (splits < 1 || splits > nqt) return (int)cudaErrorInvalidValue;
    const int d_tile = d_tile_of(dp), kw = d_tile < 64 ? d_tile : 64;
    const int cb = chunk_cols(c);
    // dv's column slab: 128 columns at d_tile 64 where they divide C (one
    // CTA per SM either way; half the slabs recomputing s^T), else 64 where
    // they divide C, else 16 (at d_tile 128 three planes of a 128-column
    // slab do not fit beside K and the q tiles)
    const int cw = d_tile == 64 && c % 128 == 0 ? 128 : c % 64 == 0 ? 64 : 16;
    const BwdParams p{reinterpret_cast<const float2*>(stats), dq, dk, dv, nullptr, nullptr, nq,
                      nk, dp, c, nqt * BLK, nqt, splits, 1, b};
    int err;
    if ((err = zero(dq, (size_t)b * nq * dp, stream))) return err;
    if ((err = zero(dk, (size_t)b * nk * dp, stream))) return err;
    if ((err = zero(dv, (size_t)b * nk * c, stream))) return err;
    if ((err = row_stats(o, dout, lse, dlse, stats, b * p.nqp, nq, p.nqp, c, stream))) return err;
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
    if ((err = hopper::make_map_bf16_3d(&tq, qp, dp, nq, NP * b, kw, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tk, kp, dp, nk, NP * b, kw, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tv, vp, c, nk, NP * b, cb, BLK))) return err;
    if ((err = hopper::make_map_bf16_3d(&tdo, dop, c, nq, NP * b, cb, BLK))) return err;
    switch (d_tile) {
        case 16: return launch_split_d<16, NP>(tq, tk, tv, tdo, p, b, cw, stream);
        case 32: return launch_split_d<32, NP>(tq, tk, tv, tdo, p, b, cw, stream);
        case 64: return launch_split_d<64, NP>(tq, tk, tv, tdo, p, b, cw, stream);
        default: return launch_split_d<128, NP>(tq, tk, tv, tdo, p, b, cw, stream);
    }
}

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

int sap3d_flash_bwd_max_d() { return MAX_D; }
int sap3d_flash_bwd_max_c() { return MAX_C; }
int sap3d_flash_bwd_c_multiple() { return C_MULTIPLE; }
int sap3d_flash_bwd_wide_c_multiple() { return WIDE_C_MULTIPLE; }
int sap3d_flash_bwd_narrow_max_c() { return NARROW_MAX_C; }
int sap3d_flash_bwd_block() { return BLK; }

// CTAs of the dkdq kernel (the resident bf16 one, or the streaming one in
// float32 and in bf16 at d above 64 or C above 512) resident per SM at d (a
// multiple of 8) and C; -1 if the card cannot say.
int sap3d_flash_bwd_resident_ctas(int d, int c, int dtype) {
    prepare_thread();
    if (d <= 16) return dkdq_resident_d<16>(c, dtype);
    if (d <= 32) return dkdq_resident_d<32>(c, dtype);
    if (d <= 64) return dkdq_resident_d<64>(c, dtype);
    return dkdq_resident_d<128>(c, dtype);
}

// dtype: 0 = float32, 1 = bfloat16.  Inputs q, k, v, o, dout (= do) in that
// dtype, lse [B, Nq] float32, and dlse [B, Nq] float32 (B4) or null (B3);
// `stats` [B, 64 ceil(Nq/64), 2] float32 scratch; `splits` query ranges per
// key tile (1 to ceil(Nq/64)).
// float32: d as it is; dq_acc, dk_acc, dv_acc are the outputs dq
// [B, Nq, dp], dk [B, Nk, dp], dv [B, Nk, C] (dp = d rounded up to 8);
// `planes` bf16 scratch of 3 B (Nq dp + Nk dp + Nk C + Nq C) elements; dq,
// dk, dv are not read.  bfloat16: d a multiple of 8; dq_acc [B, Nq, d]
// float32 scratch, dk_acc [B, Nk, d] float32 scratch where `splits` > 1 or
// the streaming kernel runs (d above 64 or C above 512), dv_acc [B, Nk, C]
// float32 scratch where `splits` > 1 (each null where not needed: dk and
// dv are then written directly); outputs dq, dk, dv; `planes` is not read.
// The float32 sums are zeroed here (memsets).  Returns a cudaError_t (0 =
// launched); invalid arguments return cudaErrorInvalidValue without
// launching.
int sap3d_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, const void* dlse, void* stats,
                    void* dq_acc, void* dk_acc, void* dv_acc, void* dq, void* dk, void* dv,
                    void* planes, int b, int nq, int nk, int d, int c, int splits, int dtype,
                    void* stream) {
    prepare_thread();
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
