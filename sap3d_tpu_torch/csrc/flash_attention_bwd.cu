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
// dtype.  Rows of q and k come in whole 16-byte chunks (the wrapper pads q
// and k with zero columns and drops those of dq and dk).  d <= 128 in
// float32 and d <= 64 in bf16; C a multiple of 16 up to 128 or of 64 up to
// 512.  Per query row i and key j:
//   delta_i = sum_c do_ic o_ic - dlse_i        (= sum_j dp_ij p_ij - dlse_i)
//   p_ij    = exp(q_i . k_j - lse_i)
//   dp_ij   = do_i . v_j
//   ds_ij   = p_ij (dp_ij - delta_i)
//   dq_i = sum_j ds_ij k_j,  dk_j = sum_i ds_ij q_i,  dv_j = sum_i p_ij do_i
// Precision follows the TPU kernel: scores, p, dp, ds and every accumulator
// are float32; p and ds are rounded to the operand dtype before their
// products; dk, dv and dq are accumulated in float32 and rounded once at
// the end.
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
// SM (~4e12/s on 132 SMs), take ~0.3 ms, three times the bound.
//
// Design of the bf16 kernels (B3 and B4; the fp32 kernel below is the first
// port's, on the CUDA cores).  Hopper's blocks run in parallel and in no
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
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_D = 128;
constexpr int MAX_C = 512;
constexpr int C_MULTIPLE = 16;
constexpr int WIDE_C_MULTIPLE = 64;  // C above NARROW_MAX_C is a multiple of this
constexpr int NARROW_MAX_C = 128;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

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

// ---- bf16: wgmma kernels fed by TMA ------------------------------------------

constexpr int BF16_MAX_D = 64;
constexpr int BLK = 64;                 // keys per CTA, queries per tile: wgmma's M
constexpr int STAGES = 2;               // query tiles in flight
constexpr int THREADS = 128;            // one warpgroup; its thread 0 also issues the loads
constexpr int WG_BARRIER = 1;           // the warpgroup's named barrier
constexpr uint32_t STATS_BYTES = BLK * 8;           // (lse, delta) of a tile's rows
constexpr uint32_t DS_BYTES = BLK * BLK * 2;        // ds^T of a tile, bf16

__host__ __device__ constexpr uint32_t align1k(uint32_t x) { return (x + 1023u) & ~1023u; }

// Shared memory of a CTA in bytes from a 1024-byte aligned base: K (and V),
// then the ring's stages of (q tile, a do tile or the region that dq's
// products reuse, lse and delta), then the mbarriers.
struct Smem {
    uint32_t v, stage, stage_bytes, tile, stats, bars, total;
};

__host__ __device__ inline Smem smem_layout(int d_tile, int v_cols, uint32_t tile_bytes) {
    Smem s;
    s.v = align1k(BLK * d_tile * 2);
    s.stage = s.v + align1k(BLK * v_cols * 2);
    s.tile = align1k(BLK * d_tile * 2);
    s.stats = s.tile + align1k(tile_bytes);
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
    int nq, nk, dp, c, nqp, nqt, splits, slabs;
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
// stage of the ring the q tile, the do boxes and the rows' (lse, delta).
struct Loader {
    const CUtensorMap *tq, *tk, *tv, *tdo;
    uint8_t* sm;
    Smem L;
    const float2* stats;
    int nqp, b, k0, d_tile, v_boxes, do_col0, do_boxes, box_cols;

    __device__ __forceinline__ uint64_t* bars() const {
        return reinterpret_cast<uint64_t*>(sm + L.bars);
    }

    __device__ __forceinline__ void kv() const {
        using namespace hopper;
        const uint32_t box_bytes = BLK * box_cols * 2;
        mbar_arrive_expect_tx(bars(), BLK * d_tile * 2 + v_boxes * box_bytes);
        tma_load_3d(sm, tk, bars(), 0, k0, b);
        for (int j = 0; j < v_boxes; ++j)
            tma_load_3d(sm + L.v + j * box_bytes, tv, bars(), j * box_cols, k0, b);
    }

    __device__ __forceinline__ void tile(int t, int st) const {
        using namespace hopper;
        uint64_t* full = bars() + 1 + st;
        uint8_t* stage = sm + L.stage + st * L.stage_bytes;
        const uint32_t box_bytes = BLK * box_cols * 2;
        mbar_arrive_expect_tx(full, BLK * d_tile * 2 + do_boxes * box_bytes + STATS_BYTES);
        tma_load_3d(stage, tq, full, 0, t * BLK, b);
        for (int j = 0; j < do_boxes; ++j)
            tma_load_3d(stage + L.tile + j * box_bytes, tdo, full, do_col0 + j * box_cols,
                        t * BLK, b);
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
    const Loader ld{&tq, &tk, &tv, &tdo, sm, L, p.stats, p.nqp, b, k0, D, p.c / CB, 0, p.c / CB, CB};
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

// dv for a slab of CW columns of C (16, 64 or 256; CW divides C).
template <int D, int CW>
__global__ void __launch_bounds__(THREADS, CW <= 64 ? 4 : 2)
flash_bwd_dv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tdo, const BwdParams p) {
    using namespace hopper;
    constexpr int BW = CW < 64 ? CW : 64;  // columns of a do box
    const Smem L = smem_layout(D, 0, BLK * CW * 2);
    uint8_t* sm = smem_base();
    const int b = blockIdx.y, k0 = blockIdx.x * BLK;
    const int split = blockIdx.z / p.slabs, c0 = (blockIdx.z % p.slabs) * CW;
    int t0, t1;
    tile_range(p, split, t0, t1);
    init_barriers(sm, L);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const Loader ld{&tq, &tk, nullptr, &tdo, sm, L, p.stats, p.nqp, b, k0, D, 0, c0, CW / BW, BW};
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
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<64, 0, 0>(s, kmajor<D>(ks, kk), kmajor<D>(stage, kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        float pt[32];
        exp_scores(pt, s, stats, qd, key_ok0, key_ok1, ragged);
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) accum_to_a(pt, kk, pa[kk]);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<CW, 1>(dv, pa[kk], mnmajor<BW>(stage + L.tile, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(pa);
    }

    if (p.splits == 1) {
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

// (lse log2(e), delta) of every query row, padded to whole tiles with
// (+inf, 0).
__global__ void __launch_bounds__(256)
bwd_row_stats(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dlse,
              float2* __restrict__ stats, int rows, int nq, int nqp, int c) {
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
    for (int j = lane; j < c / 8; j += 32) {  // 8 values per 16-byte load
        const uint4 a = orow[j], d = drow[j];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const float2 af = __bfloat1622float2(a2[e]), df = __bfloat1622float2(d2[e]);
            s = fmaf(af.x, df.x, fmaf(af.y, df.y, s));
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
        stats[row] = make_float2(lse[src] * LOG2E, dlse == nullptr ? s : s - dlse[src]);
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

template <int D, int CW>
int launch_dv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tdo,
              const BwdParams& p, int b, cudaStream_t stream) {
    const int bytes = (int)smem_layout(D, 0, BLK * CW * 2).total + 1024;
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dv<D, CW>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p.nk + BLK - 1) / BLK, b, p.splits * p.slabs);
    flash_bwd_dv<D, CW><<<grid, THREADS, bytes, stream>>>(tq, tk, tdo, p);
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
        case 256: return launch_dv<D, 256>(tq, tk, tdo, p, b, stream);
        case 64: return launch_dv<D, 64>(tq, tk, tdo, p, b, stream);
        default: return launch_dv<D, 16>(tq, tk, tdo, p, b, stream);
    }
}

// CTAs of the dkdq kernel resident on one SM at (d, C), from the card's
// occupancy calculator (the split rule's model is held to it).
template <int D, int CB, int CF, int KC>
int dkdq_resident(int c) {
    const int bytes = dkdq_smem_bytes(D, c);
    int n = -1;
    if (cudaFuncSetAttribute(flash_bwd_dkdq<D, CB, CF, KC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_bwd_dkdq<D, CB, CF, KC>, THREADS,
                                                      bytes) != cudaSuccess)
        return -1;
    return n;
}

template <int D>
int dkdq_resident_d(int c) {
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

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                const __nv_bfloat16* o, const __nv_bfloat16* dout, const float* lse,
                const float* dlse, float* stats, float* dq_acc, float* dk_acc, float* dv_acc,
                __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, int b, int nq, int nk,
                int dp, int c, int splits, cudaStream_t stream) {
    const int nqt = (nq + BLK - 1) / BLK;
    if (dp % 8 || dp > BF16_MAX_D || splits < 1 || splits > nqt)
        return (int)cudaErrorInvalidValue;
    const int d_tile = dp <= 16 ? 16 : dp <= 32 ? 32 : 64;
    const int cb = c % 64 == 0 ? 64 : 16;
    // dv's column slab where the dkdq kernel does not take dv: 256 or 64
    // columns where they divide C, else 16 (C = 48, 80, 96, 112)
    const int cw = c % 256 == 0 ? 256 : c % 64 == 0 ? 64 : 16;
    if (splits > 1 && (dk_acc == nullptr || dv_acc == nullptr)) return (int)cudaErrorInvalidValue;
    const BwdParams p{reinterpret_cast<const float2*>(stats), dq_acc, dk_acc, dv_acc, dk, dv, nq,
                      nk, dp, c, nqt * BLK, nqt, splits, 1};
    const int rows = b * p.nqp;
    bwd_row_stats<<<(rows + 7) / 8, 256, 0, stream>>>(o, dout, lse, dlse,
                                                      reinterpret_cast<float2*>(stats), rows, nq,
                                                      p.nqp, c);
    int err = (int)cudaGetLastError();
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

}  // namespace

extern "C" {

int sap3d_flash_bwd_max_d() { return MAX_D; }
int sap3d_flash_bwd_bf16_max_d() { return BF16_MAX_D; }
int sap3d_flash_bwd_max_c() { return MAX_C; }
int sap3d_flash_bwd_c_multiple() { return C_MULTIPLE; }
int sap3d_flash_bwd_wide_c_multiple() { return WIDE_C_MULTIPLE; }
int sap3d_flash_bwd_narrow_max_c() { return NARROW_MAX_C; }
int sap3d_flash_bwd_block() { return BLK; }

// bf16: CTAs of the dkdq kernel resident per SM at d (a multiple of 8) and
// C; -1 if the card cannot say.
int sap3d_flash_bwd_resident_ctas(int d, int c) {
    if (d <= 16) return dkdq_resident_d<16>(c);
    if (d <= 32) return dkdq_resident_d<32>(c);
    return dkdq_resident_d<64>(c);
}

// dtype: 0 = float32, 1 = bfloat16.  Inputs q, k, v, o, dout (= do) in that
// dtype, lse [B, Nq] float32, and dlse [B, Nq] float32 (B4) or null (B3).
// float32: `stats` is delta [B, Nq] float32 scratch; dq_acc is dq itself,
// zeroed by the caller; dk and dv are written; dk_acc, dv_acc, dq and
// `splits` are not read.  bfloat16: `stats` is [B, 64 ceil(Nq/64), 2]
// float32 scratch; dq_acc [B, Nq, d] float32 scratch zeroed by the
// caller, and where `splits` > 1 also dk_acc [B, Nk, d] and dv_acc
// [B, Nk, C] (null where `splits` is 1: dk and dv are then written
// directly); outputs dq, dk, dv; `splits` query ranges per key tile (1 to
// ceil(Nq/64)).  Returns a
// cudaError_t (0 = launched); invalid arguments return
// cudaErrorInvalidValue without launching.
int sap3d_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const void* lse, const void* dlse, void* stats,
                    void* dq_acc, void* dk_acc, void* dv_acc, void* dq, void* dk, void* dv, int b,
                    int nq, int nk, int d, int c, int splits, int dtype, void* stream) {
    if (b <= 0 || nq <= 0 || nk <= 0 || d <= 0 || d > MAX_D || c <= 0 || c > MAX_C ||
        c % C_MULTIPLE || (c > NARROW_MAX_C && c % WIDE_C_MULTIPLE))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                          static_cast<const float*>(v), static_cast<const float*>(o),
                          static_cast<const float*>(dout), static_cast<const float*>(lse),
                          static_cast<const float*>(dlse), static_cast<float*>(stats),
                          static_cast<float*>(dq_acc), static_cast<float*>(dk),
                          static_cast<float*>(dv), b, nq, nk, d, c, s);
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
