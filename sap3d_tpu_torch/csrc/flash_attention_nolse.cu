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
// Why not B1 alone (csrc/flash_attention_fwd.cu): B1 streams the keys once
// with an online softmax, so it rounds the unnormalised exp(s - m_running)
// to bf16 and divides by the row sum at the end; the TPU kernel rounds the
// normalised p.  The two differ within bf16 rounding, but where the
// rounding sits moves a random full-width network's bf16 results
// (PERF.md).  B6 needs each row's final m and sum before it can form p, so
// it makes two passes over the keys, both on B1's wgmma body (flash_fwd.cuh):
//   * pass 1 is `flash_row_stats<D, NP>` (built into flash_attention_fwd.cu
//     and launched through its library): each row's max m and 1/l, once
//     per row;
//   * pass 2 is this source's `flash_fwd_bf16<D, CW, NP, PRENORM = true>`:
//     B1's kernel, plan, slabs and residency, which reads the row's m and
//     1/l, forms p = 2^(s log2(e) - m log2(e)) (1/l) in fp32 (ex2.approx,
//     the instruction __expf runs after its multiply by log2(e)), rounds p
//     to bf16 (one plane) or splits it into three (float32, where "rounded
//     to v's dtype" is the identity and each P V product is the six of
//     split_bf16.cuh), and accumulates P V in fp32 with no running max, no
//     rescale and no final division; the output is rounded once.
// Both passes form S by the same wgmma sequence, so they see the same
// scores.
//
// Shapes: q [B, Nq, d], k [B, Nk, d], v [B, Nk, C] -> o [B, Nq, C], all
// contiguous and of one dtype (float32 or bfloat16); m and 1/l float32
// [B, Nq].  The limits are B1's: d <= 128 with rows of q and k in whole
// 16-byte chunks (bf16: the wrapper pads them with zero columns; float32:
// the split pass writes the planes so) and C a multiple of 16.  A ragged Nq
// is masked; a ragged Nk is masked with -inf scores.
//
// What bounds it on an H100, at the flagship's sites (batch 16, bf16):
//   x_3_1  Nq=Nk=392,   d=64, C=512:   2.8 GFLOP, 14.5 MB -> memory-bound
//   x_2_2  Nq=Nk=3136,  d=32, C=256:  91 GFLOP,  57.8 MB -> compute-bound
//   x_1_3  Nq=25088, Nk=3136, d=16, C=128: 363 GFLOP, 130 MB -> compute-bound
// counting the function's 2 B Nq Nk (d + C) FLOPs, B1's.  The design forms
// the scores twice (2 B Nq Nk d more) and takes two exponentials per score
// (one per pass), against B1's one: costs of the design, not of the
// function, so the bound does not count them.  float32: six bf16 products
// per product, as B1's split route.

#include "flash_fwd.cuh"

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

// C must be a multiple of this, and d at most the next: B1's limits.
int sap3d_flash_nolse_block_c() { return C_MULTIPLE; }
int sap3d_flash_nolse_max_d() { return MAX_D; }

// Pass 2 of B6: o from q, k, v and each row's max m and 1/l (float32
// [B, Nq], `sap3d_flash_row_stats` of the forward's library).  dtype 0 =
// float32: d as it is, `planes` bf16 scratch of 3 B (Nq dp + Nk dp + Nk C)
// elements, dp = d rounded up to 8; 1 = bfloat16: d a multiple of 8,
// `planes` not read.  Returns a cudaError_t (0 = launched); invalid
// arguments return cudaErrorInvalidValue without launching.
int sap3d_flash_nolse(const void* q, const void* k, const void* v, const void* m,
                      const void* inv, void* o, void* planes, int b, int nq, int nk, int d, int c,
                      int dtype, void* stream) {
    prepare_thread();
    if (!takes(b, nq, nk, d, c)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float *mi = static_cast<const float*>(m), *ii = static_cast<const float*>(inv);
    if (dtype == 0)
        return wg::launch_split<true>(static_cast<const float*>(q), static_cast<const float*>(k),
                                      static_cast<const float*>(v), static_cast<float*>(o),
                                      nullptr, mi, ii, static_cast<__nv_bfloat16*>(planes), b, nq,
                                      nk, d, c, s);
    if (dtype == 1)
        return wg::launch<true>(static_cast<const __nv_bfloat16*>(q),
                                static_cast<const __nv_bfloat16*>(k),
                                static_cast<const __nv_bfloat16*>(v), o, nullptr, mi, ii, b, nq,
                                nk, d, c, 1, s);
    return (int)cudaErrorInvalidValue;
}

const char* sap3d_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
