#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--json-out PATH]

Phases (each prints its lines and, at its end, its seconds since the card's
line; any failure exits non-zero and prints no result line):
  1. card: name and power limit from nvidia-smi;
  2. kernel build: the port's CUDA sources, one nvcc each, started
     together; build time and ptxas register/spill report (per kernel
     instantiation for the forward and the backward, whose wgmma kernels,
     bf16 and split fp32, must not spill); every wgmma instantiation's
     SASS (cuobjdump) must hold HGMMA (wgmma) and UTMALDG (TMA loads);
  3. kernels against their plain versions at the three flagship
     self-attention sites (batch 16), bf16 and fp32, on one set of random
     inputs: the flash forward without lse (B1), with lse (B2: o and lse)
     and the flash backward (B3: dq, dk, dv), each output under its
     module's limits (``TOLERANCE``, ``LSE_TOLERANCE``), which a planted
     fault must fail (the last key tile dropped for o, lse and dv, which is
     also held row by row; delta left out for dq and dk); with the
     kernel's, the plain version's and a PyTorch yardstick's times
     (scaled_dot_product_attention, forward or autograd backward; the port
     never calls it) beside the bound (in fp32 at the split-bf16 rate, the
     CUDA cores' beside it); for B1 and B2 the launch plan (planes,
     warpgroups per CTA, column slabs, key tile, stages, shared memory,
     CTAs), the library's own held to ``launch_plan``, and the CTAs
     resident per SM on the card, at least what the plan counts on; for
     B3 (and B4 in phase 9) also the largest excess, the query split S,
     the CTAs per launch and the dkdq kernel's CTAs resident per SM, from
     the card's occupancy calculator, held to the split rule's model
     (``resident_ctas``);
  4. full-width forward: the flagship (p3d_unetplusplus_ds) on
     [16, 16, 112, 112, 3] bf16, seeded weights, gamma nonzero and random BN
     statistics; each B1 call held against its plain version on the tensors
     the model gave it, the kernel path against the plain path end to end,
     3 launches per forward, clips/s of both (median of 6); with
     --json-out, a torch.profiler breakdown of one kernel-path forward by
     layer;
  5. predictor (the inference path): SlidingWindowPredictor.predict_video
     on a 40-frame synthetic video; launch counts zeroed just before and
     read just after;
  6. training (the train path), the same flagship in bf16, batch 16:
     (a) 3 B2 + 3 B3 launches and no B1 per make_train_step call;
     (b) with dropout 0, each B2 and B3 call held against its plain version
     on the tensors the model gave it, with its planted faults failing;
     (c) one step end to end in bf16 and in fp32 (the fp32 step's launches
     counted: the fp32 train path's B2 and B3): the loss against the
     attention Function on the plain B2 and B3, the whole gradient against
     B2 with the plain B3 (the same forward), with a B3 without delta as
     the control that fails; the gradient's distance from the plain B2 and
     B3, from the plain path and from a plain forward rounding as the
     kernel does, read beside it;
     (d) Trainer.fit on in-memory batches at dropout 0.5: launch counts
     zeroed before and read after, finite losses, a validation pass,
     checkpoints saved, restored into a second trainer and resumed;
     (e) train clips/s of both paths (plain, kernel, kernel, plain; the
     median, slowest and fastest of 6 steps each) and peak device
     memory; with --json-out, a torch.profiler breakdown of one kernel-path
     train step;
  7. the GN + CBAM SA decoder (inference_p3d_sa_decoder_block, alias
     P3D_SA_DECODER) at full width in bf16, batch 16; its three attention
     sites' (Nq, Nk, d, C) are read from the model:
     (a) eval forward: 3 B1 launches, each held against its plain version on
     the model's tensors (planted fault: the key tile with the most attention
     mass dropped; the last keys of the pool4 deconv hold the bias alone);
     kernel path against plain path in bf16 and fp32; the linear output
     neither constant nor blown up; clips/s of both paths;
     (b) kernels at the GN sites on random inputs, bf16 and fp32: B1, B2
     and B3 at all three (B3 takes d = 128, C = 1024: the streaming dkdq
     kernel), B4 at the widest (deconv_pool4), as in phases 3 and 9(c); and
     B5 (the B1 forward; a backward of the row-stats kernel's lse and B3) at
     all three: o against the plain version, dq, dk, dv against autograd
     through attend_tokens, a planted fault (the last 64 keys zeroed)
     failing, the launches of one backward (one row-stats kernel, one B3)
     and, from the profiler, no device operation but those kernels and
     memsets; times beside bounds; at the flagship's x_1_3 shape, the
     backward's peak memory under one full [B, Nq, Nk] float32 block and
     no higher than the parent's chunked recompute (PARENT_B5_PEAK_BYTES);
     (c) predictor on a 40-frame video: 3 B1 launches per batch of windows;
     (d) training: launches per step as the gate predicts from the printed
     shapes (B2 + B3 at all three sites);
     B5, which no site reaches, run through its own entry point on the
     q, k, v and cotangent the step gave the widest site (o against the
     plain version; dq, dk, dv against the plain versions of the kernels
     its backward launches on its own o, and, independently of its output,
     against the float32 gradient: in bf16 the relative L2 distance within
     B5_DISTANCE_FACTOR of B3's plain version given the float32 o rounded,
     in fp32 under B3's limits; the heaviest key tile's keys zeroed must
     fail each; its launches); one step from
     one state (dropout 0) in bf16 and fp32 against the same attention
     Functions on the plain kernels (cuDNN's deterministic algorithms for
     this comparison), with a B3 without delta as the control;
     Trainer.fit, 3 steps with a validation pass and checkpoints; train
     clips/s and peak memory, plain, kernel, kernel, plain;
  8. every registry name built on the card, one bf16 eval forward at batch
     2: shape, finite values, B1 launches as the gate gives them, no site of
     256 queries or more on plain PyTorch; then B1, B2 and B3 at batch 2 at
     the sites no earlier phase measured (the 'full' head's x_0_1_sa, d = 2,
     C = 16: the kernels' narrow instantiation), as in phase 3;
  9. long clips: the flagship on [4, 64, 112, 112, 3] bf16 with its
     attention as rings over make_time_mesh(4, devices=[cuda:0] * 4), the
     calibrated weights of phase 4:
     (a) eval forward, ring against the gather path (B1 on the whole sites):
     12 B2 launches and nothing else; mean distance under E2E_MEAN_TOL, which
     the forward without attention must exceed;
     (b) one train step (dropout 0): every B4 call held on the step's own
     tensors against its plain version, B3 in its place (the lse cotangent
     dropped) failing; the launches of one make_train_step call predicted
     (24 B2, 12 B4) and counted; in fp32 at batch 1 (its launches counted)
     the ring step's loss and
     whole gradient against the gather step (B2 + B3), with B3 in B4's place
     as the control;
     (c) B4 at the per-shard shapes on random inputs, bf16 and fp32, beside
     B3 on the same inputs, the plain version and the bound;
     (d) ms, 64-frame clips/s and peak memory of the ring and the gather
     train step, order gather, ring, ring, gather;
     (e) every layer time-sharded (``ops/time_shard.py``): the same clips
     cut from the host onto the 4 shards (``core/mesh.time_shard_batch``),
     each layer on its own shard: (i) at batch 1 (dropout 0, cuDNN's
     deterministic algorithms), the sharded eval forward and one train
     step's loss and whole gradient against the unsharded gather step (each
     sharded step's launches counted): the flagship in fp32 read beside the
     gather step's own one-ulp witness; p3d_micro_sa, calibrated alike, on
     the same clip in fp32 held under ``TS_FP32_TOL`` (the witness within
     it); the flagship in float64 held under ``TS_F64_FWD_TOL`` and
     ``TS_F64_TOL``; the two planted faults (each shard padded at its own
     ends; BN statistics per shard) fail both limits; (ii)
     bf16 at batch 4, the launches of one make_train_step call predicted (24
     B2, 12 B4, as (b)) and counted, every convolution's output time-sharded;
     (iii) ms and peak memory of that step beside the ring-only step of (d),
     order ring, sharded, sharded, ring; (iv) every registry name, one
     sharded bf16 step at batch 2 on 32 frames over 2 shards: the output's
     shape, a finite loss, its B2, B3 and B4 launches;
 10. the inference bisect (``sap3d_tpu_torch.scripts.bisect_infer``) and
     kernel B6 (the lse-free forward that rounds the normalised p, as the
     TPU kernel does):
     (a) B6 (the row-stats kernel, then B1's wgmma body on the normalised
     p) at the flagship's sites on random inputs, bf16 and fp32, against its
     plain version under ``flash_attention_nolse.TOLERANCE``, the last key
     tile dropped failing; B1 on the same inputs read against the same plain
     version, whose mean error B6's must not exceed in bf16; the row-stats
     kernel alone against its plain version (lse under LSE_TOLERANCE, the
     dropped tile failing); times of B6, its first pass, B1, the plain
     version and SDPA beside B6's bound;
     (b) the bisect's ``main()`` at full width, batch 16: the current
     forward (B1), B6 swapped in, the plain path, the x_1_3 projection
     products fused against separate; launches per forward 3 B1 / 3 B6
     (3 row-stats and 3 second passes) / 3 B1 after the swap / none on the
     plain path; every B6 call of one
     swapped forward held on the model's own tensors;
 11. the evaluator without files or cv2: (a) evaluate_prediction_batches
     with the calibrated flagship in fp32 on in-memory batches (densities
     and fixations at 1080 x 960 made from the plain path's own maps): B1
     launches, the five means against the plain path's run, the forward
     without attention failing the limit, clips scored per second; (b) the
     batched device metrics on a [32, 1080, 960] stack against the NumPy
     oracle, frames per second of both;
 12. reference TF checkpoints (``interop/tf_bundle.py``, ``interop/tf_import.py``)
     and ``bn_reference_quirk``: (a) the committed TF1 Saver fixture
     (``tests/data/tf1_saver_fixture``) read without TensorFlow, bit for bit
     against its .npz, an index with a flipped magic byte raising; (b) the
     calibrated flagship's weights in TF's names and layouts, with Adam slots
     and bookkeeping, through ``cli.model_from_tf_variables`` (the quirk model
     on the card): bit for bit the original, a dropped layout transform and
     a dropped variable failing; (c) that quirk model through
     ``SlidingWindowPredictor.export_dataset`` on a 40-frame video in bf16 (B1
     launches, the plain route, every buffer unchanged, the maps without the
     quirk different, seconds per video with and without it) and one fp32
     eval step (the split-bf16 B1, ``cli eval``'s dtype);
 13. data parallel (``core/mesh.launch``): two ranks on cuda:0 over gloo
     (and, with two cards or more, two ranks on two cards over NCCL), one
     process each, the calibrated flagship:
     (a) one float64 step (the plain path) at a global batch of 4 against
     the one-process step (dropout 0, cuDNN's deterministic algorithms):
     the loss, the whole summed gradient and every BN buffer under
     ``DP_TOL``, also on halves that differ, two one-process runs read as
     the floor, averaged gradients and per-rank BN statistics failing; one
     fp32 step at a global batch of 16 (the kernels: 3 B2 + 3 B3 launches
     per rank, no B1), each B2 and B3 call held on each rank's tensors
     against its plain version, its distance from one process read;
     (b) Trainer.fit in bf16 at a global batch of 16, 3 steps, a validation
     pass and checkpoints: finite global losses, one metrics.jsonl and the
     checkpoints written by rank 0, parameters and buffers bit-identical
     across ranks (integer checksums over all_reduce), a restore into a
     fresh data-parallel trainer;
     (c) cli eval's data-parallel route (``cli._evaluate_runs``) with
     --bn-quirk in fp32 on a 40-frame synthetic JPEG video: the five means
     against the one-device route under ``DP_EVAL_TOL``, which the route
     with per-rank statistics fails; B1 launches on each rank;
     (d) printed, not held: all-reduces counted in one bf16 step (2 per BN
     layer, one per gradient bucket, the loss), ms per step, each rank's
     bytes of parameters, gradients and Adam moments and its peak memory
     over the timed steps; gloo on one card goes through the host, so
     these measure the mechanism;
 14. multi-host training (``cli train --distributed``) on the one card, the
     flagship at full width in bf16 on a synthetic dataset at 112 px,
     dropout 0, shuffle off, a global batch of 4, 3 steps, plotting every
     step and saving every step:
     (a) two OS processes (``python chip_smoke.py --counted-cli train
     --distributed true --coordinator 127.0.0.1:<free port> --num-processes
     2 --process-id {0,1} --devices 2 ...``: ``cli.main`` with each rank's
     ``cli._train`` counting its launches and tracing step 2 through its
     ``TrainConfig``) in one working directory, one rank each on cuda:0,
     each rank reporting gloo: both exit 0, one run directory, one
     checkpoint a step, one "Training Finished!";
     (b) the same clips through ``core/mesh.launch`` of ``cli._train`` on
     [cuda:0, cuda:0] in this process, held against (a): step 1's loss (one
     forward from one state on the same clips) and every tensor of the
     checkpoint after step 1 bit for bit, but for the parameters upstream
     of the encoder's pool1 (``MH_POOL1_UPSTREAM``: its windows overlap and
     its backward, which has no deterministic version, adds in run order)
     and their Adam moments, which are held within ``MH_STEM_TOL``; the
     losses of steps 2 and 3 within ``MH_LATER_LOSS_TOL`` of their fall
     since step 1.  Two planted faults fail that hold: averaged gradients
     (step 1's Adam moments as they would make them) and (f), (b) with rank
     1 never stepping.  ``--multihost-repeats N`` runs (b) N times and
     prints every pair's readings (the limits' calibration);
     (c) each rank's B1, B2 and B3 launches (rank 0: 9 each, rank 1: 9 B2
     and 9 B3), reported back from the subprocesses and counted in the JSON
     line; ms per step and the traced step's device-busy share;
     (d) process 0 of 2 alone (``initialize_distributed`` with a 5 s
     timeout) raises at the rendezvous within a bounded time;
 15. tensor parallel (``core/sharding_rules.py``): ``make_mesh_2d(2, 2)`` on
     [cuda:0] * 4 over gloo (four processes of ``core/mesh.launch``, each
     with its data column and model row), the calibrated flagship at full
     width with its 52 kernels of 512 output features or more sharded on
     the model axis (column-parallel layers, their Adam moments sliced):
     (a) one float64 step (the plain path, dropout 0, deterministic cuDNN)
     at a global batch of 4 against two one-process steps: the loss, the
     summed gradient (slices gathered), every BN buffer and the gathered
     Adam moments under ``DP_TOL``, which both planted faults
     (``TENSOR_PARALLEL_FAULTS``: replicated gradients summed over the
     world; a column-parallel layer's input gradient not summed over its
     model row) must fail; (b) two bf16 steps at a global batch of 16,
     dropout 0.5 drawn per data index: per rank 3 B2 + 3 B3 launches a
     step and no B1, every call held on the rank's own tensors against its
     plain version; replicated tensors bit-identical on the four ranks and
     each slice on its data column (integer checksums over all_reduce);
     each local kernel half its output features; (c) printed: per-rank
     bytes of parameters, gradients and moments and peak memory beside
     phase 13's replicated ranks, the all-gathers and all-reduces of one
     step, ms per step; over NCCL when four cards are visible;
 16. the port's profiling and bench scripts (``sap3d_tpu_torch/scripts``),
     each script's ``main(argv)`` in this process at full width with 2
     timed repeats: ``profile_attention`` (B1, B2, B3 held at the flagship's
     sites), ``profile_ring_hop`` (the kernel hop, B2 + B4, against the
     chunked hop), ``profile_decoder``, ``profile_encoder`` (im2col against
     cuDNN), ``profile_step`` (legs full, no_sa, fwd, stage3_thin, then full
     again), ``profile_gn`` (full_sa_decoder, no_cbam), ``bench_eval`` (2
     videos of 20 frames; the card's means against the host's),
     ``bench_cli_eval`` (float32 B1), ``bench_export`` (1 video of 40
     frames, bf16 B1), ``bench_loader``: each script's launches counted
     from zero, its last line parsed, every time in it finite and
     positive, what it holds held again from its readings; the phase's
     seconds;
 17. K train steps per call (``train/steps.make_multi_train_step``, its
     captured path: one train step as a CUDA graph, replayed):
     (a) ``p3d_micro_sa`` on [2, 16, 32, 32, 3] in fp32, dropout 0.5,
     cuDNN's deterministic algorithms: two calls of K = 4 (a warm-up call,
     then replays) against 8 eager single steps from one state and one
     dropout generator, two more eager runs the control: the losses, the
     parameters, BN statistics, Adam moments and step counts within twice
     the control's distance plus ``MS_MICRO_FLOOR``, the generator where the eager
     run left it; two planted faults (``MULTI_STEP_FAULTS``: replays that
     skip the batch copy, one replay fewer) failing; whether fused Adam's
     ``capturable`` moves its update, read on three steps of the same
     gradients;
     (b) the calibrated flagship in fp32 at batch 16, K = 2: after a warm-up
     call the state and generator are saved and restored in place before
     each of three eager runs (two the control) and one replayed call:
     its first loss bit for bit the eager one's, its state within twice the
     control plus ``MS_FLAGSHIP_FLOOR`` (the per-tensor distances printed
     beside the controls'), the skipped batch copy breaking the bit
     equality and failing the state hold;
     (c) the flagship and the GN SA decoder in bf16 at batch 16, calls of
     K = 8, eager and captured (legs eager, captured, eager again): ms a
     step, host ms a call, peak memory, the first call's warm-up and
     capture, the idle share of one profiled call, B2/B3 launches a step
     (captured as many as eager), the hand-written kernels in one profiled
     call's trace (captured as many as eager); read, claimed as nothing;
     (d) ``cli train --steps-per-call 4 --max-steps 8`` on a synthetic
     dataset: logged, validated and saved at steps 4 and 8, by the JAX
     trainer's rule.
     The launch counters count Python calls, so a replay adds nothing to
     them and a capture's recording calls, which launch nothing, add one
     step's: every count of this phase is taken over one run, the counters
     set to 0 just before it, as the counters' less the launches captured a
     step for each capture plus them for each replay (``ms_launches``), and
     says so;
 18. a JSON line of per-kernel numbers (B1-B4 also in fp32, the split-bf16
     instantiations; launches of phase 17 counted as above), then the result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Needs torch with CUDA and nvcc; imports nothing of JAX or ``sap3d_tpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
import traceback
import warnings

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
# Operations per second that bound a kernel, per dtype: the dense bf16
# tensor-core rate; for float32, the same rate over the six bf16 products a
# float32 product takes on the kernels' split-bf16 route (csrc/split_bf16.cuh),
# the least time for fp32-accurate products on the card.  The fp32 rate of
# the CUDA cores, SDPA's in float32, is read beside it (cuda_core_bound_ms).
PEAK_OPS = {"bfloat16": 989e12,
            "float32": 989e12 / 6,
            "float32_cuda_cores": 67e12}
# The flagship's attention sites that take the kernel (batch 16):
# name -> (Nq, Nk, d, C)
SITES = {
    "x_3_1": (392, 392, 64, 512),
    "x_2_2": (3136, 3136, 32, 256),
    "x_1_3": (25088, 3136, 16, 128),
}
BATCH = 16
SIZE = 112                         # frame height and width of the model input
DEVICE = "cuda"
KEY_TILE = 64                      # keys of the planted faults' dropped tile
# Mean |kernel path - plain path| of the bf16 flagship's sigmoid output.
# The two paths differ by bf16 rounding inside attention, which the random
# 47-block network amplifies (about 3e-3 on an H100, PERF.md).  The forward
# without attention must exceed this limit for the check to count.
E2E_MEAN_TOL = 1e-2
# The same for the GN SA decoder, whose output is linear: in units of the
# fp32 output's standard deviation.
GN_E2E_MEAN_TOL = 5e-2
# Train phase (c): (relative loss, relative L2 of the whole gradient) limits
# of the kernel path against B2 with the plain B3 (the same forward, so the
# backward's own difference) on one batch (dropout 0), per dtype, from runs
# on an H100.  bf16: 3.3e-2 read, as far as the plain path's other backward
# moves the gradient (3.6e-2), while each B3 output is 3e-5 to 6e-4 from
# its plain version: the bf16 backward carries rounding far; the control, a
# B3 without delta, read 124.  fp32: 2.1e-3 read (cuDNN's backward run
# twice: 9e-4), the control 60.  The loss is the forward's: the kernel path
# against the plain B2 and B3, 2.0e-5 read in bf16 and 0 in fp32.  (The
# whole bf16 gradient against the plain B2 and B3 is 0.43 away: moving the
# forward's rounding point moves it that far; PERF.md.)
TRAIN_TOL = {"bf16": (1e-4, 1e-1), "float32": (1e-6, 1e-2)}
# The same limits for the GN SA decoder (B2 + B3 at its three sites, the
# C = 1024 one too since B3 takes d = 128 and C = 1024), from runs on an
# H100 while B5 took the third site: the whole gradient against the same
# path with the plain B3 read 1.9e-2 in bf16 and 3.0e-3 in fp32 (the plain
# path run twice: 1.9e-3 and 1.7e-3 to 2.7e-3).  Its linear output makes a
# loss (2e6) whose gradient the attention sites move little: a B3 without
# delta moves the whole gradient 2.6e-2 to 8.3e-2 (1.6e-2 to 8.1e-2 in
# fp32), too near the sound reading to be a control: the whole-gradient
# limit has no control of its own and guards against gross faults only.
# What holds the kernels in this step: for B3 at all three sites the
# gradient of the sites' f, g and h projections, which only dq, dk and dv
# feed, held to GN_PROJ_TOL; B3's control is read there; and B5, which no
# registry site reaches any more, run on the step's own q, k, v and
# cotangent at the widest site, its o, dq, dk and dv against
# ``attend_tokens`` and autograd through it (``b5_in_step``, with a
# planted fault that must fail).  The projections
# read 1.4e-4 to 2.4e-4 in bf16
# (each B3 output is about 2e-4 from its plain version), the control 0.94 to
# 3.9 in both types.  In fp32 the reading is 2.9e-7 to 2.4e-6 when cuDNN's
# backward repeats itself and was 6.9e-4 in a run where it did not (the plain
# path run twice was then 6.7e-4 from itself on these projections).  The
# comparison therefore asks cuDNN for its deterministic algorithms: the plain
# path run twice then reads 0 there.
GN_TRAIN_TOL = {"bf16": (1e-4, 5e-2), "float32": (1e-6, 1e-2)}
GN_PROJ_TOL = {"bf16": 2e-3, "float32": 1e-4}
# B5 in bf16 on the GN step's tensors, held independently of its own output:
# its dq, dk and dv no further from the float32 gradient (relative L2) than
# this many times B3's plain version given the float32 o rounded to bf16
# (which rounded o a flash backward is given moves its dq and dk on these
# tensors, where dp - delta cancels; PERF.md); read on an
# H100: 1.09x / 1.10x / 1.00x for dq / dk / dv.  In fp32 B5 is held to the
# float32 gradient under B3's own limits (excess 0.52 at most, read).
B5_DISTANCE_FACTOR = 1.5
TRAIN_STEPS = 3
THROUGHPUT_CALLS = 6               # timed calls per path and round of clips/s
GN_MODEL = "P3D_SA_DECODER"        # inference_p3d_sa_decoder_block
# B1 launches of one eval forward of each registry name at 112 px: the
# attention sites the forward gate takes (at least 256 queries, C a multiple
# of 16): none without self-attention; x_3_1, x_2_2 and x_1_3 in the UNet++
# models (x_4_0 has 49 queries; 'nl' has a non-local block at x_1_3), and the
# 'full' head's x_0_1_sa (d = 2, C = 16: the kernels' narrow instantiation);
# pool2 and pool3 in sa_concat (pool4 has 49 tokens); all three sites of the
# two other GN SA decoders.
ZOO_LAUNCHES = {
    "p3d_unet": 0, "p3d_concat": 0, "p3d_unetplusplus": 4, "p3d_unetplusplus_ds": 3,
    "p3d_unetplusplus_nonsa": 0, "p3d_unetplusplus_nl": 2, "inference_p3d": 0,
    "inference_p3d_concat": 0, "inference_p3d_sa_concat": 2, "inference_p3d_sa_concat_2": 3,
    "inference_p3d_sa_decoder_block": 3, "inference_p3d_decoder_block": 0,
    "p3d_micro": 0, "p3d_micro_sa": 3,
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of ``fn`` from CUDA events, L2 evicted before each
    call (a 256 MB write), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _bound(nbytes: int, flops: int, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int, lse: bool = False):
    """(bound_ms, bound_by) of the forward (B1; B2 with ``lse``): each input
    read once and each output written once over HBM bandwidth, against
    2*b*nq*nk*(d+c) FLOPs over the peak."""
    nbytes = b * (nq * d + nk * d + nk * c + nq * c) * itemsize + (4 * b * nq if lse else 0)
    return _bound(nbytes, 2 * b * nq * nk * (d + c), dtype_name)


def flash_bwd_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of the backward (B3): q, k, v, o, do and lse
    read, dq, dk, dv written; five products, 2*b*nq*nk*(3d + 2C) FLOPs."""
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + 2 * nq * c) * itemsize + 4 * b * nq
    return _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)


def cuda_core_bound(bound, b, nq, nk, d, c, dtype_name: str, **kw) -> dict:
    """In float32, ``bound``'s time at the fp32 rate of the CUDA cores
    (SDPA's yardstick; the kernels' own bound is the split rate)."""
    if dtype_name != "float32":
        return {}
    return {"cuda_core_bound_ms": bound(b, nq, nk, d, c, "float32_cuda_cores", 4, **kw)[0]}


def sdpa_yardstick(q, k, v, flush, do=None):
    """Time of one scaled_dot_product_attention call (scale=1.0) on the same
    inputs, with the first backend that accepts d != C; with ``do``, of
    torch.autograd.grad of its output (the forward outside the timing)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q4, k4, v4 = (t.unsqueeze(1).detach().requires_grad_(do is not None) for t in (q, k, v))
    warnings.filterwarnings("ignore", message=".*(kernel not used|attention has been "
                            "runtime disabled|Flash attention requires|Memory efficient "
                            "kernel not used|cuDNN attention).*")
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)
                if do is None:
                    call = lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=1.0)  # noqa: E731
                else:
                    do4 = do.unsqueeze(1)
                    call = lambda: torch.autograd.grad(out, (q4, k4, v4), do4,  # noqa: E731
                                                       retain_graph=True)
                call()
                torch.cuda.synchronize()
                return time_ms(call, 3, flush), backend.name
        except RuntimeError:
            continue
    return None, "none"


def drop_last_key_tile(fa, q, k, v):
    """A planted fault: what a kernel that skipped its last tile of
    ``KEY_TILE`` keys would return (the plain version on the other keys)."""
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    return fa.flash_attend_tokens_reference(q, k[:, :keep], v[:, :keep])


def heaviest_key_tile(q, k) -> slice:
    """The ``KEY_TILE``-key tile that holds the most attention mass over all
    queries."""
    import torch

    p = torch.softmax(torch.bmm(q.float(), k.float().transpose(1, 2)), dim=-1)
    mass = p.sum(dim=(0, 1))
    pad = (-mass.numel()) % KEY_TILE
    tile = int(torch.nn.functional.pad(mass, (0, pad)).view(-1, KEY_TILE).sum(-1).argmax())
    return slice(tile * KEY_TILE, (tile + 1) * KEY_TILE)


def drop_heaviest_key_tile(fa, q, k, v):
    """A planted fault for tensors whose last keys carry no weight (the GN
    decoder's pool4 deconv, stride 4 over a kernel of 1 and 3, ends in
    tokens that hold the bias alone, all alike: dropping them moves nothing):
    the plain version without the ``KEY_TILE``-key tile that holds the most
    attention mass over all queries."""
    import torch

    keep = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
    keep[heaviest_key_tile(q, k)] = False
    return fa.flash_attend_tokens_reference(q, k[:, keep], v[:, keep])


def hold(label, got, want, fault, fault_name, tolerance, row_tolerance=None):
    """Hold a kernel output against its plain version's under
    ``tolerance`` (and ``row_tolerance``), and show that the same limits
    fail a planted fault."""
    from sap3d_tpu_torch.ops.cuda.flash_attention import agreement

    sound = agreement(got, want, tolerance, row_tolerance)
    bad = agreement(fault, want, tolerance, row_tolerance)
    rtol, atol, mean_tol = tolerance[want.dtype]
    rows = "" if row_tolerance is None else \
        f", {row_tolerance[want.dtype]:g}*|want_row| per row (L2)"
    print(f"[check] {label}: max_abs_err {sound['max_abs_err']:.3e}, mean "
          f"{sound['mean_abs_err']:.3e}, rel L2 {sound['rel_l2']:.3e}, excess {sound['excess']:.3f} (limits: "
          f"{rtol:g}*|want| + {atol:g}*max|want| per element, {mean_tol:g}*mean|want| "
          f"mean{rows}); planted fault ({fault_name}): max_abs_err {bad['max_abs_err']:.3e}, "
          f"mean {bad['mean_abs_err']:.3e}, excess {bad['excess']:.3f}", flush=True)
    if not sound["finite"] or not sound["excess"] <= 1:
        raise AssertionError(f"{label}: the kernel disagrees with its plain version")
    if not bad["excess"] > 1:
        raise AssertionError(f"{label}: the limits pass the planted fault; the check is void")
    return dict(sound, fault_excess=bad["excess"], fault_max_abs_err=bad["max_abs_err"],
                fault_mean_abs_err=bad["mean_abs_err"])


_DROPPED = f"last {KEY_TILE}-key tile dropped"


def check_b1(fa, label, q, k, v, got, heaviest: bool = False):
    """B1's output on (q, k, v) against its plain version; the planted fault
    drops the last key tile, or with ``heaviest`` the one with the most
    attention mass."""
    fault = drop_heaviest_key_tile(fa, q, k, v) if heaviest else drop_last_key_tile(fa, q, k, v)
    name = f"the heaviest {KEY_TILE}-key tile dropped" if heaviest else _DROPPED
    return hold(f"B1 {label}", got, fa.flash_attend_tokens_reference(q, k, v),
                fault, name, fa.TOLERANCE)


def check_b2(fa, label, q, k, v, o, lse):
    """B2's o and lse against the plain version's."""
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    want_o, want_lse = fa.flash_forward_lse_reference(q, k, v)
    fault_o, fault_lse = fa.flash_forward_lse_reference(q, k[:, :keep], v[:, :keep])
    res = {"o": hold(f"B2 o {label}", o, want_o, fault_o, _DROPPED, fa.TOLERANCE),
           "lse": hold(f"B2 lse {label}", lse, want_lse, fault_lse, _DROPPED,
                       fa.LSE_TOLERANCE)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()))


def check_b3(fb, label, q, k, v, o, lse, do, got):
    """B3's dq, dk, dv against the plain version's.  Planted faults: delta
    left out (the plain version on o = 0) for dq and dk; the last key tile
    dropped (its dv rows left at zero) for dv, which is also held row by
    row (``DV_ROW_TOLERANCE``)."""
    import torch

    want = fb.flash_backward_reference(q, k, v, o, lse, do)
    no_delta = fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    dv_dropped = want[2].clone()
    dv_dropped[:, keep:] = 0
    faults = (no_delta[0], no_delta[1], dv_dropped)
    names = ("delta left out", "delta left out", _DROPPED)
    rows = (None, None, fb.DV_ROW_TOLERANCE)
    res = {out: hold(f"B3 {out} {label}", g, w, f, n, fb.TOLERANCE, r)
           for out, g, w, f, n, r in zip(("dq", "dk", "dv"), got, want, faults, names, rows)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()),
                excess=max(r["excess"] for r in res.values()))


def phase_kernels(torch, fa, fb, flush, sites=None, batch=BATCH):
    """Phases 3, 7(b) and 8: B1, B2 and B3 against their plain versions at
    the shapes of ``sites`` (default: the flagship's) and ``batch``, with
    their times; B2 and B3 only where the backward gate takes the shape."""
    sites = SITES if sites is None else sites
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    rows = {"B1": [], "B2": [], "B3": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in sites.items():
            # q, k with std d^-1/4: unit-variance scores, a soft softmax
            q = (torch.randn(batch, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(batch, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(batch, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(batch, nq, c, device=DEVICE, generator=gen).to(dtype)
            shape = dict(site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            label = f"{site} {dname} (random inputs)"
            heavy = nq * nk * (d + c) > 5e9  # x_1_3 and the two wider GN sites
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            plain_iters = max(iters // 4, 3)

            got = fa.flash_attend_tokens(q, k, v)
            check = check_b1(fa, label, q, k, v, got)
            del got
            row = dict(check, **shape)
            row["ms"] = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_attend_tokens_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush)
            row["bound_ms"], row["bound_by"] = flash_bound(batch, nq, nk, d, c, dname,
                                                           q.element_size())
            row.update(cuda_core_bound(flash_bound, batch, nq, nk, d, c, dname))
            row.update(forward_grid(fa, batch, nq, nk, d, c, dtype))
            rows["B1"].append(row)
            ran = ["B1"]
            if not fb.backward_viable(nq, nk, d, c, dtype):
                report_kernel_rows(rows, ran, site, dname, nq, nk, d, c, batch)
                del q, k, v, do
                torch.cuda.empty_cache()
                continue
            ran += ["B2", "B3"]

            o, lse = fa.flash_forward_lse(q, k, v)
            row = dict(check_b2(fa, label, q, k, v, o, lse), **shape)
            row["ms"] = time_ms(lambda: fa.flash_forward_lse(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: fa.flash_forward_lse_reference(q, k, v),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = rows["B1"][-1]["library_ms"], \
                rows["B1"][-1]["library_backend"]
            row["bound_ms"], row["bound_by"] = flash_bound(batch, nq, nk, d, c, dname,
                                                           q.element_size(), lse=True)
            row.update(cuda_core_bound(flash_bound, batch, nq, nk, d, c, dname, lse=True))
            row.update(forward_grid(fa, batch, nq, nk, d, c, dtype))
            rows["B2"].append(row)

            got = fb.flash_backward(q, k, v, o, lse, do)
            row = dict(check_b3(fb, label, q, k, v, o, lse, do, got), **shape)
            del got
            row["ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do), iters, flush)
            row["plain_ms"] = time_ms(lambda: fb.flash_backward_reference(q, k, v, o, lse, do),
                                      plain_iters, flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush, do=do)
            row["bound_ms"], row["bound_by"] = flash_bwd_bound(batch, nq, nk, d, c, dname,
                                                               q.element_size())
            row.update(cuda_core_bound(flash_bwd_bound, batch, nq, nk, d, c, dname))
            row.update(backward_grid(fb, batch, nq, nk, d, c, dtype))
            rows["B3"].append(row)
            report_kernel_rows(rows, ran, site, dname, nq, nk, d, c, batch)
            del q, k, v, do, o, lse
            torch.cuda.empty_cache()
    return rows


def backward_grid(fb, batch, nq, nk, d, c, dtype) -> dict:
    """The backward's query split and CTAs per launch at a shape, the dkdq
    kernel's CTAs resident per SM, from the card's occupancy calculator,
    which must be what the split rule assumed, and its dynamic shared
    memory."""
    grid = fb.launch_grid(batch, nq, nk, d, c, dtype)
    grid["resident"] = fb.card_resident_ctas(d, c, dtype)
    grid["smem_bytes"] = fb.dkdq_smem_bytes(d, c, dtype)
    if grid["resident"] != fb.resident_ctas(d, c, dtype):
        raise AssertionError(f"d={d} C={c} {dtype}: {grid['resident']} dkdq CTAs per SM on "
                             f"the card, the split rule assumes {fb.resident_ctas(d, c, dtype)}")
    return grid


def forward_grid(fa, batch, nq, nk, d, c, dtype) -> dict:
    """The forward kernel's launch plan at a shape as the library makes it,
    which must be ``launch_plan``'s (the CPU tests hold that), and its CTAs
    resident per SM from the card's occupancy calculator, which must be at
    least what the plan counts on."""
    plan = fa.card_launch_plan(batch, nq, nk, d, c, dtype)
    if plan != fa.launch_plan(batch, nq, nk, d, c, dtype):
        raise AssertionError(f"d={d} C={c} {dtype}: the library plans {plan}, launch_plan "
                             f"says {fa.launch_plan(batch, nq, nk, d, c, dtype)}")
    card = fa.card_resident_ctas(batch, nq, nk, d, c, dtype)
    if card < plan["resident"]:
        raise AssertionError(f"d={d} C={c}: {card} CTAs per SM on the card, the plan counts "
                             f"on {plan['resident']}")
    return {"plan": plan, "card_resident": card}


def describe_forward_plan(r) -> str:
    p = r["plan"]
    return (f", {p['planes']} plane(s), {p['wgs']} warpgroup(s) per CTA, {p['slabs']} slab(s) "
            f"of {p['cw']} columns, "
            f"{p['bk']}-key tiles, {p['stages']} stages, {p['smem']} B of shared memory, "
            f"{p['grid'][0] * p['grid'][1] * p['grid'][2]} CTAs, {r['card_resident']} "
            f"resident per SM (plan: {p['resident']})")


def describe_grid(r) -> str:
    more = f", {r['resident']} resident per SM, {r['smem_bytes']} B of shared memory each" \
        if "resident" in r else ""
    return f"query split S={r['split']}, {r['ctas']} CTAs per launch{more}"


def report_kernel_rows(rows, names, site, dname, nq, nk, d, c, batch=BATCH):
    for name in names:
        r = rows[name][-1]
        lib = r["library_ms"]
        grid = f", excess {r['excess']:.3f}, {describe_grid(r)}" if name == "B3" else \
            describe_forward_plan(r) if "plan" in r else ""
        cores = f", fp32 CUDA-core bound {r['cuda_core_bound_ms']:.4f} ms" \
            if "cuda_core_bound_ms" in r else ""
        print(f"[kernel] {name} {site} {dname} B={batch} Nq={nq} Nk={nk} d={d} C={c}: "
              f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"sdpa {lib if lib is None else f'{lib:.4f}'} ms "
              f"({r['library_backend']}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){cores}{grid}", flush=True)


def calibrate_and_randomize_bn(torch, model, x, gen):
    """Random BN statistics that keep the 47-block network out of
    saturation.  Scales, biases and gamma (every attention site) are drawn
    first; then one forward with pre-hooks, in network order, sets each BN's
    statistics from the batch it sees and perturbs them at random (mean +=
    0.1*std*N(0,1), var *= U(0.5, 1.5)), so that every later BN is
    calibrated against the perturbed layers before it."""
    from sap3d_tpu_torch.ops.layers import BatchNorm

    def rand(shape, lo, hi):
        return torch.rand(shape, device=DEVICE, generator=gen) * (hi - lo) + lo

    def hook(mod, args):
        a = args[0].float()
        dims = [0] + list(range(2, a.dim()))
        var = a.var(dims, unbiased=False)
        noise = torch.randn(var.shape, device=DEVICE, generator=gen)
        mod.mean.copy_(a.mean(dims) + 0.1 * var.sqrt() * noise)
        mod.var.copy_(var * rand(var.shape, 0.5, 1.5))

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    with torch.no_grad():
        for m in bns:
            m.scale.copy_(rand(m.scale.shape, 0.5, 1.5))
            m.bias.copy_(0.1 * torch.randn(m.bias.shape, device=DEVICE, generator=gen))
        for sa in model.attention_modules():
            sa.gamma.copy_(rand((1,), 0.5, 1.5))
    handles = [m.register_forward_pre_hook(hook) for m in bns]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()


def phase_forward(torch, fa, model, x):
    """Phase 4: the flagship forward, kernel path against plain path.

    fp32: the two paths agree to 1e-3 on the sigmoid output (the attention
    outputs differ at ~1e-6 relative; the limit leaves room for the decoder
    to amplify that).  bf16, the main path: each of the 3 kernel calls is
    held against its plain version on the very tensors the model gave it,
    under the kernel's own limits; end to end, the mean distance between the
    paths is held to ``E2E_MEAN_TOL``, which the forward without attention
    (gamma = 0) must exceed.  The planted fault at every site is read end to
    end too; the random network's amplification of rounding noise keeps the
    end-to-end check too coarse to be held to it (PERF.md)."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.steps import make_eval_step

    model32 = build_model("unet++", dtype="float32", device=DEVICE)
    model32.load_state_dict(model.state_dict())

    def run(m, use_kernel, launches=None, inputs=x):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        out = make_eval_step(m)(inputs)
        torch.cuda.synchronize()
        got = fa.flash_attend_tokens.launches
        want = (len(SITES) if use_kernel else 0) if launches is None else launches
        if got != want:
            raise AssertionError(f"expected {want} kernel launches per forward, got {got}")
        return out

    ref32 = run(model32, False)
    kern32 = run(model32, True)
    # the fp32 forward of the input rounded to bf16: how far the random
    # network carries one bf16 rounding
    rounded32 = run(model32, False, inputs=x.to(torch.bfloat16).float())
    with torch.no_grad():
        for sa in model32.attention_modules():
            sa.gamma.zero_()
    no_attn = run(model32, False)
    del model32

    plain16 = run(model, False)
    calls = []

    def spy(q, k, v):
        o = fa.flash_attend_tokens(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy):
        kern16 = run(model, True)
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    sites = {}
    for q, k, v, o in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        sites[name] = check_b1(fa, f"{name} bf16 (in the flagship forward)", q, k, v, o)
    del calls
    with ta.forward_kernel(lambda q, k, v: drop_last_key_tile(fa, q, k, v)):
        fault16 = run(model, True, launches=0)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
        no_attn16 = run(model, False)
        for sa, g in zip(model.attention_modules(), gammas):
            sa.gamma.copy_(g)

    tol32 = 1e-3
    err32 = (kern32 - ref32).abs().max().item()
    mean16 = (kern16 - plain16).abs().mean().item()
    fault_mean16 = (fault16 - plain16).abs().mean().item()
    no_attn_mean16 = (no_attn16 - plain16).abs().mean().item()
    attn_effect = (ref32 - no_attn).abs().max().item()
    bf16_gap = (plain16 - ref32).abs().mean().item()
    rounding_gap = (rounded32 - ref32).abs().mean().item()
    inside = float(((kern16 > 0.01) & (kern16 < 0.99)).float().mean().item())
    print(f"[forward] flagship {tuple(x.shape)} -> {tuple(kern16.shape)}, 3 B1 launches "
          f"per forward; fp32 kernel vs plain path max_abs_err {err32:.3e} (tol {tol32:g}); "
          f"bf16 kernel vs plain path mean_abs_err {mean16:.3e} (tol {E2E_MEAN_TOL:g}); "
          f"vs the plain path: no attention {no_attn_mean16:.3e}, planted fault "
          f"{fault_mean16:.3e}; fp32 attention effect max {attn_effect:.3e}; "
          f"{inside:.3f} of outputs in (0.01, 0.99)", flush=True)
    print(f"[forward] mean distance from the fp32 forward: bf16 forward {bf16_gap:.3e}, "
          f"fp32 forward of the bf16-rounded input {rounding_gap:.3e}", flush=True)
    if not bool(torch.isfinite(kern16).all().item()) or kern16.shape != (*x.shape[:4],):
        raise AssertionError("flagship forward: non-finite output or wrong shape")
    if not err32 <= tol32 or not mean16 <= E2E_MEAN_TOL:
        raise AssertionError("flagship forward: kernel path disagrees with plain path")
    if not attn_effect > 10 * tol32 or not no_attn_mean16 > E2E_MEAN_TOL:
        raise AssertionError("the forward's checks pass a model with broken attention; "
                             "they are void")
    return dict(fp32_max_abs_err=err32, tol_fp32=tol32, bf16_mean_abs_err=mean16,
                bf16_fault_mean_abs_err=fault_mean16, tol_bf16_mean=E2E_MEAN_TOL,
                bf16_no_attention_mean_abs_err=no_attn_mean16,
                sites=sites, attention_effect=attn_effect, bf16_vs_fp32_mean=bf16_gap,
                rounded_input_vs_fp32_mean=rounding_gap, unsaturated_share=inside)


def describe_rates(res: dict) -> str:
    """'kernel m [lo, hi] / m [lo, hi], plain ...' of ``rate_summary``s."""
    def one(r):
        return f"{r['clips_per_s']:.2f} [{r['slowest']:.2f}, {r['fastest']:.2f}]"
    return (f"kernel {one(res['kernel'])} / {one(res['kernel2'])}, plain "
            f"{one(res['plain'])} / {one(res['plain2'])}")


def phase_throughput(torch, model, x, card):
    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    res = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        for m in model.attention_modules():
            m.use_kernel = use_kernel
        res[label] = rate_summary(step_times(torch, lambda: step(x), THROUGHPUT_CALLS))
    for m in model.attention_modules():
        m.use_kernel = True
    print(f"[forward] clips/s (batch {BATCH}, bf16; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} forwards each, order plain, kernel, kernel, plain): "
          f"{describe_rates(res)}  [{card}]", flush=True)
    return res


# Device kernels by name -> layer of PERF.md, first match wins.
_KERNEL_GROUPS = (
    ("B3/B4 flash_attention_bwd", ("flash_bwd", "bwd_delta", "bwd_row_stats", "round_to_bf16")),
    ("B1/B2 flash_attention_fwd", ("flash_fwd",)),
    ("row statistics (B6's pass 1, B5's lse)", ("flash_row_stats",)),
    ("group norm", ("groupnorm", "group_norm", "rowwisemoments", "computeinternalgradients",
                    "computefusedparams", "gammabeta")),
    ("convolution (cuDNN, with its layout transforms)",
     ("conv", "cudnn", "xmma", "implicit_gemm", "dgrad", "wgrad", "cutlass")),
    ("attention plain path at x_4_0 (bmm, softmax)", ("softmax", "gemm", "bmm")),
    ("batch norm", ("batch_norm", "batchnorm")),
    ("pooling", ("pool",)),
    ("optimizer (Adam)", ("multi_tensor", "adam")),
    ("copy / cast / pad / cat", ("copy", "pad", "cat", "transpose", "index")),
    ("other elementwise (relu, add, sigmoid, ...)", ("elementwise", "vectorized", "unrolled")),
)


def profile_device_time(torch, fn, label: str, batch: int | None = None):
    """Where one call of ``fn`` spends device time (torch.profiler): device
    time by layer group and the top kernels, against the host wall time of
    the same call (inflated by the tracing itself)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us / 1e3, e.count, e.key))
    device_ms = sum(r[0] for r in rows)
    if not rows:
        print("[profile] the profiler saw no device time; no breakdown", flush=True)
        return None
    groups: dict[str, float] = {}
    for ms, _, name in rows:
        low = name.lower()
        group = next((g for g, keys in _KERNEL_GROUPS if any(k in low for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[profile] {label} (batch {BATCH if batch is None else batch}, bf16): device busy "
          f"{device_ms:.3f} ms of {wall_ms:.3f} ms wall (idle share "
          f"{max(0.0, 1 - device_ms / wall_ms):.3f})", flush=True)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {ms:9.3f} ms  {100 * ms / device_ms:5.1f}%  {group}", flush=True)
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        print(f"[profile]   top {ms:9.3f} ms x{count:<4d} {name[:110]}", flush=True)
    return dict(device_ms=device_ms, wall_ms=wall_ms, groups=groups,
                top=[(ms, count, name) for ms, count, name in sorted(rows, reverse=True)[:25]])


def phase_profile(torch, model, x):
    """One kernel-path eval forward, profiled."""
    from sap3d_tpu_torch.train.steps import make_eval_step

    step = make_eval_step(model)
    return profile_device_time(torch, lambda: step(x), "one kernel-path forward")


def phase_predictor(torch, fa, model):
    """Phase 5, the main path: the sliding-window predictor on 40 frames."""
    import numpy as np

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

    size = SIZE
    frames = (np.random.default_rng(SEED).normal(size=(40, size, size, 3)) * 0.3
              ).astype(np.float32)
    with SlidingWindowPredictor(make_eval_step(model), batch_windows=BATCH,
                                image_size=size, device=DEVICE) as pred:
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        maps = pred.predict_video(frames=frames)
        dt = time.perf_counter() - t0
        launches = fa.flash_attend_tokens.launches
    ok = (maps.shape == (40, size, size) and np.isfinite(maps).all()
          and maps.min() >= 0.0 and maps.max() <= 1.0)
    print(f"[predictor] 40 frames -> {maps.shape}, range [{maps.min():.4f}, "
          f"{maps.max():.4f}], {dt:.3f} s, B1 launches {launches}", flush=True)
    if not ok:
        raise AssertionError("predictor output has the wrong shape or values")
    want = -(-25 // BATCH) * len(SITES)  # 25 windows in batches of 16, a launch per site
    if launches != want:
        raise AssertionError(f"expected {want} B1 launches in the predictor run, got {launches}")
    return launches


B1_B4 = ("B1", "B2", "B3", "B4")
B1_B5 = (*B1_B4, "B5")


def launch_counts(*names: str) -> dict[str, int]:
    """``ops.cuda.launch_counts``, imported when called."""
    from sap3d_tpu_torch.ops import cuda

    return cuda.launch_counts(*names)


def reset_launch_counts(*names: str) -> None:
    """``ops.cuda.reset_launch_counts``, imported when called."""
    from sap3d_tpu_torch.ops import cuda

    cuda.reset_launch_counts(*names)


@contextlib.contextmanager
def function_calls(forward=None, backward=None):
    """Route the attention Function's forward through ``forward(q, k, v)
    -> (o, lse)`` and its backward through ``backward(q, k, v, o, lse, do)``
    for the duration (None: as is)."""
    from sap3d_tpu_torch.ops import attention

    orig = attention.flash_forward_lse, attention.flash_backward
    attention.flash_forward_lse = forward or orig[0]
    attention.flash_backward = backward or orig[1]
    try:
        yield
    finally:
        attention.flash_forward_lse, attention.flash_backward = orig


def forward_rounded_as_kernel(q, k, v):
    """A diagnostic: the plain B2 with the kernel's rounding point: p =
    exp(s - m) (m the row's largest score) rounded to v's dtype before the
    product, whose float32 sum is divided by l after it, where the plain B2
    rounds the normalized softmax."""
    import torch

    s = torch.bmm(q.float(), k.float().transpose(1, 2))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    o = (torch.bmm(e.to(v.dtype).float(), v.float()) / l).to(v.dtype)
    return o, (m + l.log()).squeeze(-1)


def step_times(torch, fn, n: int) -> list[float]:
    """Host seconds of each of ``n`` calls of ``fn``, each ended by a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def rate_summary(times: list[float], clips: int | None = None) -> dict:
    """clips/s from the median, fastest and slowest call of ``times``, each
    call ``clips`` clips (default ``BATCH``)."""
    import statistics

    clips = BATCH if clips is None else clips
    return dict(clips_per_s=clips / statistics.median(times), fastest=clips / min(times),
                slowest=clips / max(times), calls=len(times))


def phase_train(torch, fa, fb, model, card, profile: bool = False):
    """Phase 6, the train path, on the calibrated flagship of phase 4; with
    ``profile``, one kernel-path train step is profiled as well."""
    import os
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step
    from sap3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(SEED)

    def batch():
        frames = (rng.normal(size=(BATCH, 16, SIZE, SIZE, 3)) * 0.3).astype(np.float32)
        targets = rng.uniform(size=(BATCH, 16, SIZE, SIZE)).astype(np.float32)
        return frames, targets

    def put(b):
        return tuple(torch.from_numpy(a).to(DEVICE) for a in b)

    def set_kernel(use_kernel):
        for sa in model.attention_modules():
            sa.use_kernel = use_kernel

    x, y = put(batch())
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    res = {}

    # (b), (c): one forward and backward, dropout 0, from one state
    from sap3d_tpu_torch.models.registry import build_model

    model.decoder.dropout_rate = 0.0

    def grads(m, use_kernel, forward=None, backward=None):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        m.train()
        m.zero_grad(set_to_none=True)
        with function_calls(forward, backward):
            loss = loss_fn_saliency(m(x), y)
            loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat

    fwd_calls, calls = [], []

    def spy_forward(q, k, v):
        o, lse = fa.flash_forward_lse(q, k, v)
        fwd_calls.append((q, k, v, o, lse))
        return o, lse

    def spy(q, k, v, o, lse, do):
        out = fb.flash_backward(q, k, v, o, lse, do)
        calls.append((q, k, v, o, lse, do, out))
        return out

    loss_k, g_k = grads(model, True, forward=spy_forward, backward=spy)
    res["b2_in_step"], res["b3_in_step"] = {}, {}
    for q, k, v, o, lse in fwd_calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        res["b2_in_step"][name] = check_b2(fa, f"{name} bf16 (in the flagship train step)",
                                           q, k, v, o, lse)
    for q, k, v, o, lse, do, out in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        res["b3_in_step"][name] = check_b3(fb, f"{name} bf16 (in the flagship train step)",
                                           q, k, v, o, lse, do, out)
    for kernel in ("b2_in_step", "b3_in_step"):
        if sorted(res[kernel]) != sorted(SITES):
            raise AssertionError(f"{kernel}: ran at {sorted(res[kernel])}, not at every site")
    del calls, fwd_calls

    def no_delta(q, k, v, o, lse, do):
        return fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    def one_step(m, bf16: bool) -> dict:
        """The kernel path against three other paths.  Held: against B2 with
        the plain B3 (the same forward; the backward's own difference), with
        a B3 without delta as the control.  Read beside it: the reference,
        the autograd Function on the plain B2 and B3, which rounds where the
        kernels do and shares no code with them (run twice: the floor), the
        plain path (autograd of softmax attention), and the reference with a
        plain forward that rounds where the kernel does."""
        ref = fb.flash_backward_reference
        reset_launch_counts(*B1_B4)  # the float32 step's kernel path: one main-path run
        loss_k_, g_k_ = (loss_k, g_k) if bf16 else grads(m, True)
        launches = launch_counts(*B1_B4)
        loss_s, g_s = grads(m, True, backward=ref)
        _, g_f = grads(m, True, backward=no_delta)
        loss_r, g_r = grads(m, True, forward=fa.flash_forward_lse_reference, backward=ref)
        _, g_r2 = grads(m, True, forward=fa.flash_forward_lse_reference, backward=ref)
        _, g_o = grads(m, True, forward=forward_rounded_as_kernel, backward=ref)
        loss_p, g_p = grads(m, False)
        return dict(loss_kernel=loss_k_, loss_reference=loss_r, loss_plain=loss_p,
                    loss_rel=abs(loss_k_ - loss_r) / abs(loss_r), grad_rel_l2=rel(g_k_, g_s),
                    fault_grad_rel_l2=rel(g_f, g_s), kernel_vs_reference=rel(g_k_, g_r),
                    reference_again=rel(g_r2, g_r), b2_forward_vs_reference=rel(g_s, g_r),
                    kernel_rounding_forward_vs_reference=rel(g_o, g_r),
                    plain_vs_reference=rel(g_p, g_r), kernel_vs_plain=rel(g_k_, g_p),
                    same_forward_loss_rel=abs(loss_k_ - loss_s) / abs(loss_s),
                    **({} if bf16 else {"launches": launches}))

    e2e = {"bf16": one_step(model, True)}
    del g_k
    model32 = build_model("unet++", dtype="float32", device=DEVICE, dropout_rate=0.0)
    model32.load_state_dict(model.state_dict())
    e2e["float32"] = one_step(model32, False)
    del model32
    torch.cuda.empty_cache()
    for dname, r in e2e.items():
        loss_tol, grad_tol = TRAIN_TOL[dname]
        r.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol)
        print(f"[train] one step, {dname}, dropout 0: loss kernel path {r['loss_kernel']:.6f}, "
              f"reference {r['loss_reference']:.6f} (relative {r['loss_rel']:.3e}, limit "
              f"{loss_tol:g}); whole-gradient relative L2 of the kernel path against B2 with "
              f"the plain B3 {r['grad_rel_l2']:.3e} (limit {grad_tol:g}), control (B3 without "
              f"delta) {r['fault_grad_rel_l2']:.3e}", flush=True)
        print(f"[train]   {dname}, whole-gradient relative L2 against the reference (the "
              f"Function on the plain B2 and B3): the reference again "
              f"{r['reference_again']:.3e}, the kernel path {r['kernel_vs_reference']:.3e}, B2 "
              f"with the plain B3 {r['b2_forward_vs_reference']:.3e}, a plain forward rounding "
              f"as the kernel does {r['kernel_rounding_forward_vs_reference']:.3e}, the plain "
              f"path {r['plain_vs_reference']:.3e} (kernel path against the plain path "
              f"{r['kernel_vs_plain']:.3e})", flush=True)
    res["end_to_end"] = e2e

    # (a) launches per make_train_step call; (e) train clips/s and peak memory
    state = create_train_state(model, lr=1e-4)
    step = make_train_step(state)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    for use_kernel in (True, False):
        set_kernel(use_kernel)
        reset_launch_counts(*B1_B4)
        loss = step(x, y, gen)
        torch.cuda.synchronize()
        got = launch_counts(*B1_B4)
        want = {"B1": 0, "B2": len(SITES) if use_kernel else 0,
                "B3": len(SITES) if use_kernel else 0, "B4": 0}
        path = "kernel" if use_kernel else "plain"
        print(f"[train] launches in one make_train_step call ({path} path): {got}, "
              f"loss {loss.item():.4f}", flush=True)
        if got != want or not np.isfinite(loss.item()):
            raise AssertionError(f"expected {want} launches and a finite loss, got {got}")
    model.decoder.dropout_rate = 0.5
    thr = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        set_kernel(use_kernel)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        thr[label] = dict(rate_summary(step_times(torch, lambda: step(x, y, gen),
                                                  THROUGHPUT_CALLS)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    set_kernel(True)
    if profile:
        res["profile"] = profile_device_time(torch, lambda: step(x, y, gen),
                                             "one kernel-path train step")
    res["train_clips_per_s"] = thr
    print(f"[train] clips/s (batch {BATCH}, bf16, dropout 0.5; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} steps each, order plain, kernel, kernel, plain): "
          f"{describe_rates(thr)}; peak memory kernel {thr['kernel']['peak_gib']:.2f} GiB, "
          f"plain {thr['plain']['peak_gib']:.2f} GiB  [{card}]", flush=True)
    del state, step

    # (d) Trainer.fit on in-memory batches, a checkpoint restored and resumed
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_train")
    shutil.rmtree(root, ignore_errors=True)
    cfg = Config(model=ModelConfig(name="unet++", dtype="bfloat16", dropout=0.5),
                 train=TrainConfig(batch_size=BATCH, lr=1e-4, valid_iter=2, save_iter=2,
                                   max_steps=TRAIN_STEPS, seed=SEED, info="smoke",
                                   model_dir=os.path.join(root, "model"),
                                   logs_dir=os.path.join(root, "logs")))
    try:
        trainer = Trainer(cfg, run="smoke", device=DEVICE)
        trainer.model.load_state_dict(model.state_dict())  # calibrated BN, gamma
        train_batches = [batch() for _ in range(TRAIN_STEPS)]
        valid = [batch()]
        reset_launch_counts(*B1_B4)
        t0 = time.perf_counter()
        trainer.fit(iter(train_batches), lambda: iter(valid))
        trainer.ckpt.wait_until_finished()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = launch_counts(*B1_B4)
        trainer.close()
        with open(os.path.join(trainer.logs_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["loss"] for r in records if "loss" in r]
        valid_rec = [r for r in records if "cc" in r]
        steps = checkpoint_steps(trainer.model_dir)
        # side dumps at every logged step (steps < 10) and one validation
        # batch run the eval forward, B1
        want = {"B1": len(SITES) * (TRAIN_STEPS + 1), "B2": len(SITES) * TRAIN_STEPS,
                "B3": len(SITES) * TRAIN_STEPS, "B4": 0}
        print(f"[train] Trainer.fit: {TRAIN_STEPS} steps in {fit_s:.2f} s, losses "
              f"{[round(v, 3) for v in losses]}, launches {fit_launches}, validation "
              f"{valid_rec}, checkpoints at steps {steps}", flush=True)
        if fit_launches != want:
            raise AssertionError(f"Trainer.fit: expected launches {want}, got {fit_launches}")
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError("Trainer.fit: missing or non-finite losses")
        if len(valid_rec) != 1 or not all(np.isfinite(valid_rec[0][k])
                                          for k in ("cc", "sim", "kld", "auc_judd")):
            raise AssertionError("Trainer.fit: no validation pass with finite metrics")
        if steps != [2, TRAIN_STEPS]:
            raise AssertionError(f"Trainer.fit: checkpoints at {steps}")
        final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
        del trainer
        torch.cuda.empty_cache()

        resumed = Trainer(cfg.replace(train=dataclasses.replace(
            cfg.train, pretrain="smoke", max_steps=TRAIN_STEPS + 1)), run="smoke",
            device=DEVICE)
        same = all(torch.equal(resumed.model.state_dict()[k], v) for k, v in final.items())
        if resumed.state.step != TRAIN_STEPS or not same:
            raise AssertionError("the restored state is not the saved one")
        resumed.fit(iter([batch()]))
        resumed.close()
        steps = checkpoint_steps(resumed.model_dir)
        print(f"[train] restored step {TRAIN_STEPS} exactly into a second trainer and "
              f"resumed to step {resumed.state.step}; checkpoints at steps {steps}", flush=True)
        if resumed.state.step != TRAIN_STEPS + 1 or steps[-1] != TRAIN_STEPS + 1:
            raise AssertionError("the resumed trainer did not step on")
        del resumed, final
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    res["fit"] = dict(steps=TRAIN_STEPS, seconds=fit_s, losses=losses, launches=fit_launches,
                      validation=valid_rec[0])
    # (c)'s limits, held after the phase's other readings are taken
    for dname, r in e2e.items():
        if not (r["loss_rel"] <= r["tol_loss_rel"] and r["grad_rel_l2"] <= r["tol_grad_rel_l2"]):
            raise AssertionError(f"train step, {dname}: the kernel path disagrees with its "
                                 "plain versions")
        if not r["fault_grad_rel_l2"] > r["tol_grad_rel_l2"]:
            raise AssertionError("the train-step limits pass a B3 without delta; void")
    return res


# ---- phase 7: the GN + CBAM SA decoder ---------------------------------------


@contextlib.contextmanager
def attention_sites(model):
    """Yields a dict that fills, for the duration, with name -> ((Nq, Nk, d,
    C), route) of the latest gated call of each self-attention module of
    ``model``'s decoder: what each module asked of ``attention_route`` and
    what it was told."""
    from sap3d_tpu_torch.ops import attention

    sites, running = {}, []
    orig = attention.attention_route

    def spy(nq, nk, d, c, dtype, train):
        route = orig(nq, nk, d, c, dtype, train)
        sites[running[-1]] = ((nq, nk, d, c), route)
        return route

    def leave(_module, _args, _output) -> None:
        running.pop()

    handles = []
    for name, m in model.decoder.named_modules():
        if isinstance(m, attention.SelfAttention3D):
            handles.append(m.register_forward_pre_hook(
                lambda _m, _args, name=name: running.append(name)))
            handles.append(m.register_forward_hook(leave))
    attention.attention_route = spy
    try:
        yield sites
    finally:
        attention.attention_route = orig
        for h in handles:
            h.remove()


def build_gn_model(torch, dtype: str, gen=None, like=None, dropout_rate: float = 0.5):
    """The GN SA decoder at full width; gamma drawn from [0.5, 1.5] (at its
    init, 0, a dead attention kernel passes every end-to-end check), or the
    weights of ``like``."""
    from sap3d_tpu_torch.models.registry import build_model

    model = build_model(GN_MODEL, dtype=dtype, device=DEVICE, seed=SEED,
                        dropout_rate=dropout_rate)
    if like is not None:
        model.load_state_dict(like.state_dict())
    else:
        with torch.no_grad():
            for sa in model.attention_modules():
                sa.gamma.copy_(torch.rand(1, device=DEVICE, generator=gen) + 0.5)
    return model


def phase_gn_forward(torch, fa, model, x, card):
    """Phase 7(a): the GN SA decoder's eval forward."""
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.steps import make_eval_step

    def run(m, use_kernel, want_launches):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        out = make_eval_step(m)(x)
        torch.cuda.synchronize()
        if fa.flash_attend_tokens.launches != want_launches:
            raise AssertionError(f"GN forward: expected {want_launches} B1 launches, got "
                                 f"{fa.flash_attend_tokens.launches}")
        return out

    calls = []

    def spy(q, k, v):
        o = fa.flash_attend_tokens(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy), attention_sites(model) as sites:
        kern16 = run(model, True, 3)
    for name, (shape, route) in sites.items():
        print(f"[gn] site {name}: (Nq, Nk, d, C) = {shape}, eval route {route}", flush=True)
    if len(sites) != 3 or any(route != "flash" for _, route in sites.values()):
        raise AssertionError(f"GN forward: expected three sites on the kernel, got {sites}")
    by_shape = {shape: name for name, (shape, _) in sites.items()}
    held = {}
    for q, k, v, o in calls:
        name = by_shape[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        held[name] = check_b1(fa, f"{name} bf16 (in the GN forward)", q, k, v, o,
                              heaviest=True)
    if sorted(held) != sorted(sites):
        raise AssertionError(f"B1 ran at {sorted(held)}, not at every GN site")
    del calls
    plain16 = run(model, False, 0)
    with ta.forward_kernel(lambda q, k, v: drop_heaviest_key_tile(fa, q, k, v)):
        fault16 = run(model, True, 0)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
        no_attn16 = run(model, False, 0)
        for sa, g in zip(model.attention_modules(), gammas):
            sa.gamma.copy_(g)

    model32 = build_gn_model(torch, "float32", like=model)
    ref32 = run(model32, False, 0)
    kern32 = run(model32, True, 3)
    del model32
    torch.cuda.empty_cache()

    # The output is linear: distances are read against its spread.
    scale = ref32.std().item()
    err32 = (kern32 - ref32).abs().max().item() / scale
    mean16 = (kern16 - plain16).abs().mean().item() / scale
    fault16_mean = (fault16 - plain16).abs().mean().item() / scale
    no_attn_mean = (no_attn16 - plain16).abs().mean().item() / scale
    bf16_gap = (plain16 - ref32).abs().mean().item() / scale
    tol32 = 1e-3
    print(f"[gn] forward {tuple(x.shape)} -> {tuple(kern16.shape)}, 3 B1 launches; linear "
          f"output mean {kern16.mean().item():.4f}, std {kern16.std().item():.4f}, range "
          f"[{kern16.min().item():.4f}, {kern16.max().item():.4f}]; in units of the fp32 "
          f"output's std {scale:.4f}: fp32 kernel vs plain path max {err32:.3e} (tol "
          f"{tol32:g}); bf16 kernel vs plain path mean {mean16:.3e} (tol {GN_E2E_MEAN_TOL:g}), "
          f"no attention {no_attn_mean:.3e}, planted fault {fault16_mean:.3e}; bf16 vs fp32 "
          f"forward mean {bf16_gap:.3e}", flush=True)
    if not bool(torch.isfinite(kern16).all().item()) or kern16.shape != (*x.shape[:4],):
        raise AssertionError("GN forward: non-finite output or wrong shape")
    # neither constant nor blown up: GroupNorm keeps the activations O(1)
    if not (1e-3 < kern16.std().item() < 1e3 and kern16.abs().max().item() < 1e4):
        raise AssertionError("GN forward: the output is constant or blown up")
    if not err32 <= tol32 or not mean16 <= GN_E2E_MEAN_TOL:
        raise AssertionError("GN forward: kernel path disagrees with plain path")
    if not no_attn_mean > GN_E2E_MEAN_TOL:
        raise AssertionError("GN forward: the checks pass a model without attention; void")

    step = make_eval_step(model)
    thr = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        for m in model.attention_modules():
            m.use_kernel = use_kernel
        thr[label] = rate_summary(step_times(torch, lambda: step(x), THROUGHPUT_CALLS))
    for m in model.attention_modules():
        m.use_kernel = True
    print(f"[gn] forward clips/s (batch {BATCH}, bf16; median [slowest, fastest] of "
          f"{THROUGHPUT_CALLS} forwards each, order plain, kernel, kernel, plain): "
          f"{describe_rates(thr)}  [{card}]", flush=True)
    return dict(sites={n: dict(shape=s_, route=r) for n, (s_, r) in sites.items()}, held=held,
                fp32_max_err_over_std=err32, bf16_mean_err_over_std=mean16,
                bf16_fault_over_std=fault16_mean, bf16_no_attention_over_std=no_attn_mean,
                bf16_vs_fp32_over_std=bf16_gap, output_std=scale, clips_per_s=thr)


def b5_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of B5's forward plus backward: the forward's
    bound (B1's), and for the backward q, k, v and do read and dq, dk, dv
    written, against the five products that dq, dk and dv of (q, k, v, do)
    need, 2*b*nq*nk*(3d + 2C) FLOPs as for B3 (o is not needed: delta =
    rowsum(p * dp)).  The bound is the function's: the p v product of the
    implementation's recompute is not counted."""
    fwd_ms, _ = flash_bound(b, nq, nk, d, c, dtype_name, itemsize)
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + nq * c) * itemsize
    bwd_ms, bwd_by = _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)
    return fwd_ms + bwd_ms, bwd_by, fwd_ms, bwd_ms


# The hand-written kernels B5's backward launches on the card (the row
# statistics, then B3: its row-stats pass, the dk and dq and the dv
# kernels, the bf16 rounding, the fp32 split pass); memsets are not kernels.
B5_BACKWARD_KERNELS = ("flash_row_stats", "bwd_row_stats", "flash_bwd_dkdq", "flash_bwd_dv",
                       "round_to_bf16", "split_planes")
# B5's backward peak above what its forward holds, at x_1_3's shape (batch
# 16, bf16), read on an H100 80GB HBM3 at 700 W when its backward was the
# chunked PyTorch recompute: 3365928960 bytes.  The kernels' may not exceed
# it.
PARENT_B5_PEAK_BYTES = 3365928960


def device_kernels(torch, fn) -> list[str]:
    """The names of the device operations (kernels, memsets) one call of
    ``fn`` runs, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def b5_backward_launches(torch, fa, fb, ta, q, k, v, do, label):
    """One B5 backward on the card (after a forward outside the count): the
    launches its wrappers count (one row-stats kernel, one B3, no forward
    kernel) and, from the profiler, that every device operation it runs is
    one of the hand-written kernels (``B5_BACKWARD_KERNELS``) or a memset."""
    def counts():
        return launch_counts(*B1_B5, "RS")

    out = ta.flash_fwd_chunked_bwd(q, k, v)
    torch.cuda.synchronize()
    before = counts()
    names = device_kernels(torch, lambda: torch.autograd.grad(out, (q, k, v), do))
    launches = {key: n - before[key] for key, n in counts().items()}
    foreign = [n for n in names if not n.startswith("Memset")
               and not any(key in n for key in B5_BACKWARD_KERNELS)]
    short = sorted({next((key for key in B5_BACKWARD_KERNELS if key in n), n.split(" (")[0])
                    for n in names})
    print(f"[kernel] B5 backward {label}: launches {launches}; device operations {short}",
          flush=True)
    if launches != dict(RS=1, B3=1, B4=0, B1=0, B2=0, B5=0):
        raise AssertionError(f"B5's backward launched {launches}, not one row-stats kernel "
                             "and one B3")
    if foreign or not names:
        raise AssertionError(f"B5's backward ran device operations that are not its "
                             f"kernels: {foreign or 'none seen'}")
    return dict(launches=launches, device_operations=short)


def phase_b5(torch, fa, fb, ta, flush, sites):
    """Phase 7(b), kernel B5 at the GN sites on random inputs: o against the
    plain version under B1's limits; dq, dk, dv against autograd through
    ``attend_tokens`` on the same inputs under B3's limits; the planted
    fault is the same computation on a k whose last 64 keys are zeroed; the
    launches and device operations of one backward (the row statistics and
    B3 only)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in sites.items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
            q, k, v = (t.requires_grad_() for t in (q, k, v))
            label = f"{site} {dname} (random inputs)"

            before = ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches
            out = ta.flash_fwd_chunked_bwd(q, k, v)
            if (ta.flash_fwd_chunked_bwd.launches, fa.flash_attend_tokens.launches) != \
                    (before[0] + 1, before[1]):
                raise AssertionError("B5 counts one launch of its own per call and none of B1's")
            got = torch.autograd.grad(out, (q, k, v), do)
            plain_out = ta.attend_tokens(q, k, v)
            want = torch.autograd.grad(plain_out, (q, k, v), do)
            kz = k.detach().clone()
            kz[:, -KEY_TILE:] = 0
            kz.requires_grad_()
            fault_out = ta.flash_fwd_chunked_bwd(q, kz, v)
            fault = torch.autograd.grad(fault_out, (q, kz, v), do)
            zeroed = f"last {KEY_TILE} keys zeroed"
            res = {"o": hold(f"B5 o {label}", out.detach(), plain_out.detach(),
                             fault_out.detach(), zeroed, fa.TOLERANCE)}
            for name, g, w, f in zip(("dq", "dk", "dv"), got, want, fault):
                res[name] = hold(f"B5 {name} {label}", g, w, f, zeroed, fb.TOLERANCE)
            row = dict(res, site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c,
                       max_abs_err=max(r["max_abs_err"] for r in res.values()))
            row["backward"] = b5_backward_launches(torch, fa, fb, ta, q, k, v, do,
                                                   f"{site} {dname}")
            del out, plain_out, fault_out, got, want, fault, kz

            iters = 3 if dtype == torch.float32 else 5
            out = ta.flash_fwd_chunked_bwd(q, k, v)
            row["fwd_ms"] = time_ms(lambda: ta.flash_fwd_chunked_bwd(q, k, v), iters, flush)
            row["bwd_ms"] = time_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                                                retain_graph=True), iters, flush)
            del out
            plain_out = ta.attend_tokens(q, k, v)
            row["plain_fwd_ms"] = time_ms(lambda: ta.attend_tokens(q, k, v), iters, flush)
            row["plain_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
                plain_out, (q, k, v), do, retain_graph=True), iters, flush)
            del plain_out
            row["ms"] = row["fwd_ms"] + row["bwd_ms"]
            row["plain_ms"] = row["plain_fwd_ms"] + row["plain_bwd_ms"]
            qd, kd, vd = (t.detach() for t in (q, k, v))
            lib_f, backend = sdpa_yardstick(qd, kd, vd, flush)
            lib_b, _ = sdpa_yardstick(qd, kd, vd, flush, do=do)
            row["library_ms"] = None if None in (lib_f, lib_b) else lib_f + lib_b
            row["library_backend"] = backend
            row["bound_ms"], row["bound_by"], row["bound_fwd_ms"], row["bound_bwd_ms"] = \
                b5_bound(BATCH, nq, nk, d, c, dname, q.element_size())
            lib = row["library_ms"]
            print(f"[kernel] B5 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: forward "
                  f"{row['fwd_ms']:.4f} + backward {row['bwd_ms']:.4f} = {row['ms']:.4f} ms, "
                  f"plain {row['plain_fwd_ms']:.4f} + {row['plain_bwd_ms']:.4f} = "
                  f"{row['plain_ms']:.4f} ms, sdpa forward + backward "
                  f"{lib if lib is None else f'{lib:.4f}'} ms ({backend}), bound "
                  f"{row['bound_fwd_ms']:.4f} + {row['bound_bwd_ms']:.4f} = "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
            rows.append(row)
            del q, k, v, do, qd, kd, vd
            torch.cuda.empty_cache()

    # Memory at the flagship's x_1_3 shape: the backward's peak stays under
    # one full [B, Nq, Nk] float32 block and under the parent's (the chunked
    # recompute, 7 chunks of 4096 queries); saving o keeps nothing alive
    # that the caller does not hold.
    nq, nk, d, c = SITES["x_1_3"]
    dtype = torch.bfloat16
    q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
    k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
    v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
    do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def backward_peak(fn):
        out = fn(q, k, v)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        return grads, held, torch.cuda.max_memory_allocated() - held

    got, held_b5, peak_b5 = backward_peak(ta.flash_fwd_chunked_bwd)
    want, held_plain, peak_plain = backward_peak(ta.attend_tokens)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        check = fa.agreement(g, w, fb.TOLERANCE)
        print(f"[check] B5 {name} x_1_3 bf16: max_abs_err "
              f"{check['max_abs_err']:.3e}, excess {check['excess']:.3f}", flush=True)
        if not check["finite"] or not check["excess"] <= 1:
            raise AssertionError(f"B5 {name} at x_1_3 disagrees with attend_tokens")
    full_block = BATCH * nq * nk * 4
    gib = 2.0 ** 30
    inputs = sum(t.numel() * t.element_size() for t in (q, k, v))
    print(f"[kernel] B5 backward at x_1_3 (B={BATCH}, Nq={nq}, Nk={nk}): peak "
          f"{peak_b5 / gib:.3f} GiB above the {held_b5 / gib:.3f} GiB held after its forward "
          f"(q, k, v {inputs / gib:.3f} GiB and the output the caller holds; the parent, "
          f"which saved q, k, v and recomputed in 7 chunks: peak "
          f"{PARENT_B5_PEAK_BYTES / gib:.3f} GiB above 1.935 GiB held); one full [B, Nq, Nk] "
          f"fp32 block is {full_block / gib:.3f} GiB; autograd through attend_tokens holds "
          f"{held_plain / gib:.3f} GiB after its forward and peaks {peak_plain / gib:.3f} GiB "
          f"above that", flush=True)
    if not peak_b5 < full_block:
        raise AssertionError("B5's backward peaks above one full score block")
    if not peak_b5 <= PARENT_B5_PEAK_BYTES:
        raise AssertionError("B5's backward peaks above the parent's")
    del got, want, q, k, v, do
    torch.cuda.empty_cache()
    return rows, dict(peak_b5_bytes=peak_b5, held_b5_bytes=held_b5, full_block_bytes=full_block,
                      peak_plain_bytes=peak_plain, held_plain_bytes=held_plain)


def phase_gn_predictor(torch, fa, model):
    """Phase 7(c), the GN inference path: the predictor on 40 frames."""
    import numpy as np

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.train.steps import make_eval_step

    frames = (np.random.default_rng(SEED).normal(size=(40, SIZE, SIZE, 3)) * 0.3
              ).astype(np.float32)
    with SlidingWindowPredictor(make_eval_step(model), batch_windows=BATCH,
                                image_size=SIZE, device=DEVICE) as pred:
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        maps = pred.predict_video(frames=frames)
        dt = time.perf_counter() - t0
        launches = fa.flash_attend_tokens.launches
    print(f"[gn] predictor: 40 frames -> {maps.shape}, linear maps mean {maps.mean():.4f}, "
          f"std {maps.std():.4f}, range [{maps.min():.4f}, {maps.max():.4f}], {dt:.3f} s, "
          f"B1 launches {launches}", flush=True)
    if maps.shape != (40, SIZE, SIZE) or not np.isfinite(maps).all() \
            or not 1e-3 < maps.std() < 1e3:
        raise AssertionError("GN predictor: wrong shape, non-finite or constant maps")
    want = -(-25 // BATCH) * 3  # 25 windows in batches of 16, a launch per site
    if launches != want:
        raise AssertionError(f"expected {want} B1 launches in the GN predictor run, got "
                             f"{launches}")
    return launches


def phase_gn_train(torch, fa, fb, ta, model, sites, card, profile: bool = False):
    """Phase 7(d), the GN train path: B2 + B3 at its three sites; B5 held on
    the step's own tensors."""
    import os
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from sap3d_tpu_torch.ops import attention
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step
    from sap3d_tpu_torch.train.trainer import Trainer

    rng = np.random.default_rng(SEED + 7)

    def batch():
        frames = (rng.normal(size=(BATCH, 16, SIZE, SIZE, 3)) * 0.3).astype(np.float32)
        targets = rng.uniform(size=(BATCH, 16, SIZE, SIZE)).astype(np.float32)
        return frames, targets

    x, y = (torch.from_numpy(a).to(DEVICE) for a in batch())

    # what the gate predicts from the shapes the model printed
    routes = [ta.attention_route(*shape, torch.bfloat16, train=True)
              for shape, _ in sites.values()]
    want_step = {"B1": 0, "B2": routes.count("flash"), "B3": routes.count("flash"), "B4": 0,
                 "B5": 0}
    print(f"[gn] launches per train step as the gate predicts: {want_step}", flush=True)
    # B3 takes d <= 128 and C <= 1024: every GN site, deconv_pool4 too, trains
    # on B2 + B3
    if want_step["B2"] != 3:
        raise AssertionError("the gate does not route the GN sites as B3's limits say")
    res = {"predicted_launches": want_step}

    def set_kernel(m, use_kernel):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel

    @contextlib.contextmanager
    def plain_kernels(b3=None, everything=False):
        """B3 replaced by ``b3`` and, with ``everything``, B2 and B5's
        forward by their plain versions too."""
        orig = attention.launch_forward
        if everything:
            attention.launch_forward = \
                lambda q, k, v, want_lse: (fa.flash_attend_tokens_reference(q, k, v), None)
        try:
            with function_calls(fa.flash_forward_lse_reference if everything else None, b3):
                yield
        finally:
            attention.launch_forward = orig

    def grads(m, use_kernel, **patch):
        """(loss, the whole gradient, the gradient of the attention sites'
        f, g and h projections), flattened."""
        set_kernel(m, use_kernel)
        m.train()
        m.zero_grad(set_to_none=True)
        with plain_kernels(**patch):
            loss = loss_fn_saliency(m(x), y)
            loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        proj = torch.cat([p.grad.float().flatten() for sa in m.attention_modules()
                          for conv in (sa.f, sa.g, sa.h) for p in conv.parameters()])
        m.zero_grad(set_to_none=True)
        return loss.item(), flat, proj

    def b5_in_step(m, dname: str) -> dict:
        """Kernel B5 on the train step's own tensors: the q, k, v and the
        cotangent do of the widest site (deconv_pool4, which the step now
        trains on B2 + B3) captured in one step, then B5
        (``flash_fwd_chunked_bwd``, its own entry point) run on them, and
        its launches (one B5 forward; one row-stats kernel and one B3 in
        the backward).  Its o is held against ``attend_tokens``; the dq, dk
        and dv its backward gives against the plain versions of the kernels
        that backward launches (the row statistics' lse, then B3's plain
        version on B5's own o), under B3's limits.  The same o matters: on
        this site's tensors delta = rowsum(do o) cancels against dp, and a
        backward given the plain forward's o (both o within bf16 rounding of
        each other, 1.5e-3 apart) lands 1.6e-2 away in dq, 2.3x B3's limits
        (read on an H100); autograd through ``attend_tokens`` (bf16, which
        rounds dp where B3 rounds p and ds) as far.  Held independently of
        B5's output: dq, dk, dv against autograd through ``attend_tokens``
        in float32 on the same tensors, in fp32 under B3's limits, in bf16
        by the relative L2 distance, within ``B5_DISTANCE_FACTOR`` of the
        distance of B3's plain version given the float32 o rounded to bf16
        (bf16 autograd's distance read beside it).  Planted fault, failing
        every check: the plain computation on a k whose heaviest tile of
        keys is zeroed (the last keys of this site hold the bias alone)."""
        widest = max(shape for shape, _ in sites.values())
        orig, calls = attention.flash_attend, []

        def spy(q, k, v):
            o = orig(q, k, v)
            if (q.shape[1], k.shape[1], q.shape[2], v.shape[2]) == widest:
                rec = dict(q=q.detach(), k=k.detach(), v=v.detach())
                o.register_hook(lambda g: rec.__setitem__("do", g.to(v.dtype)))
                calls.append(rec)
            return o

        attention.flash_attend = spy
        try:
            grads(m, True)
        finally:
            attention.flash_attend = orig
        if len(calls) != 1 or "do" not in calls[0]:
            raise AssertionError(f"the step reached the widest site {len(calls)} times")
        rec = calls[0]
        name = next(n for n, (shape, _) in sites.items() if shape == widest)
        label = f"{name} {dname} (on the GN train step's tensors)"
        q, k, v = (rec[n].clone().requires_grad_() for n in "qkv")
        before = launch_counts(*B1_B5), fa.flash_row_stats.launches
        out = ta.flash_fwd_chunked_bwd(q, k, v)
        got = torch.autograd.grad(out, (q, k, v), rec["do"])
        torch.cuda.synchronize()
        after = launch_counts(*B1_B5), fa.flash_row_stats.launches
        launches = {key: n - before[0][key] for key, n in after[0].items()}
        launches["RS"] = after[1] - before[1]
        if launches != {"B1": 0, "B2": 0, "B3": 1, "B4": 0, "B5": 1, "RS": 1}:
            raise AssertionError(f"B5 on the step's tensors launched {launches}")
        qd, kd, vd, do = rec["q"], rec["k"], rec["v"], rec["do"]

        def plain_backward(k_, o_):
            """B5's backward from the plain versions of its kernels, on o_."""
            lse = fa.row_stats_reference(qd, k_, lse=True)
            return fb.flash_backward_reference(qd, k_, vd, o_, lse, do)

        want = plain_backward(kd, out.detach())
        kz = kd.clone()
        kz[:, heaviest_key_tile(qd, kd)] = 0
        fault_o = fa.flash_attend_tokens_reference(qd, kz, vd)
        fault = plain_backward(kz, fault_o)
        zeroed = f"the heaviest {KEY_TILE}-key tile's keys zeroed"
        res_ = {"o": hold(f"B5 o {label}", out.detach(), ta.attend_tokens(qd, kd, vd), fault_o,
                          zeroed, fa.TOLERANCE)}
        for out_name, g, w, f_ in zip(("dq", "dk", "dv"), got, want, fault):
            res_[out_name] = hold(f"B5 {out_name} {label}", g, w, f_, zeroed, fb.TOLERANCE)

        def rel(a, b):
            return ((a.float() - b).norm() / b.norm()).item()

        # held independently of B5's output: against the float32 gradient
        q32, k32, v32 = (t.float().requires_grad_() for t in (qd, kd, vd))
        o32 = ta.attend_tokens(q32, k32, v32)
        exact = torch.autograd.grad(o32, (q32, k32, v32), do.float())
        lse = fa.row_stats_reference(qd, kd, lse=True)
        names = ("dq", "dk", "dv")
        if dname == "float32":
            # under B3's own limits: the plain float32 backward is 1e-6 from it
            for n, g, e, f_ in zip(names, got, exact, fault):
                res_[f"{n}_vs_float32"] = hold(f"B5 {n} {label} against float32 autograd", g, e,
                                               f_, zeroed, fb.TOLERANCE)
            return {name: dict(res_, launches=launches,
                               max_abs_err=max(r["max_abs_err"] for r in res_.values()))}
        # bf16: a flash backward forms delta = rowsum(do o) from a rounded o,
        # and on these tensors dp - delta cancels, so any such backward is
        # about 1e-2 from the float32 gradient in dq and dk (bf16 autograd,
        # which never forms delta, about 2e-3).  The yardstick: B3's plain
        # version given the float32 o rounded to bf16, the best o a bf16
        # flash backward can be given; B5 within B5_DISTANCE_FACTOR of it
        yard = fb.flash_backward_reference(qd, kd, vd, o32.detach().to(qd.dtype), lse, do)
        q16, k16, v16 = (t.clone().requires_grad_() for t in (qd, kd, vd))
        autograd16 = torch.autograd.grad(ta.attend_tokens(q16, k16, v16), (q16, k16, v16), do)
        dist = {n: {"b5": rel(g, e), "yardstick": rel(y_, e),
                    "limit": B5_DISTANCE_FACTOR * rel(y_, e), "fault": rel(f_, e),
                    "autograd": rel(a, e)}
                for n, g, y_, f_, a, e in zip(names, got, yard, fault, autograd16, exact)}
        print(f"[gn] B5 {label}: relative L2 from autograd through attend_tokens in float32 "
              f"on the same tensors, B5 (limit {B5_DISTANCE_FACTOR:g} x the yardstick, B3's "
              f"plain version given the float32 o rounded) / yardstick / planted fault "
              f"({zeroed}) / bf16 autograd (read): "
              + ", ".join(f"{n} {v['b5']:.3e} / {v['yardstick']:.3e} / {v['fault']:.3e} / "
                          f"{v['autograd']:.3e}" for n, v in dist.items()),
              flush=True)
        for n, v in dist.items():
            if not v["b5"] <= v["limit"]:
                raise AssertionError(f"B5 {n} {label}: {v['b5']:.3e} from the float32 gradient, "
                                     f"above {v['limit']:.3e}")
            if not v["fault"] > v["limit"]:
                raise AssertionError(f"B5 {n} {label}: the distance limit passes the planted "
                                     f"fault; the check is void")
        return {name: dict(res_, launches=launches, distance_from_float32=dist,
                           max_abs_err=max(r["max_abs_err"] for r in res_.values()))}

    def no_delta(q, k, v, o, lse, do):
        return fb.flash_backward_reference(q, k, v, torch.zeros_like(o), lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    def one_step(m) -> dict:
        """The kernel path (B2 + B3 at the three sites) against:
        the same with the plain B3 (held: the same forward, the backward's
        own difference), on the whole gradient and on the gradient of the
        sites' f, g and h projections, which dq, dk and dv alone feed;
        control: a B3 without delta, read on the projections (this model's
        linear output makes a loss whose gradient the attention sites move
        little: on the whole gradient the control is within 1.5x of the sound
        reading); the same Functions on the plain B2, B3 and B1 (the loss is
        held against it); the plain path (attend_tokens at every site), run
        twice for the floor."""
        ref = fb.flash_backward_reference
        loss_k, g_k, a_k = grads(m, True)
        loss_s, g_s, a_s = grads(m, True, b3=ref)
        _, g_f, a_f = grads(m, True, b3=no_delta)
        loss_r, g_r, _ = grads(m, True, b3=ref, everything=True)
        loss_p, g_p, a_p = grads(m, False)
        _, g_p2, a_p2 = grads(m, False)
        return dict(loss_kernel=loss_k, loss_reference=loss_r, loss_plain=loss_p,
                    loss_rel=abs(loss_k - loss_r) / abs(loss_r), grad_rel_l2=rel(g_k, g_s),
                    proj_grad_rel_l2=rel(a_k, a_s), fault_grad_rel_l2=rel(g_f, g_s),
                    fault_proj_grad_rel_l2=rel(a_f, a_s), kernel_vs_reference=rel(g_k, g_r),
                    kernel_vs_plain=rel(g_k, g_p), plain_again=rel(g_p2, g_p),
                    proj_kernel_vs_plain=rel(a_k, a_p), proj_plain_again=rel(a_p2, a_p),
                    same_forward_loss_rel=abs(loss_k - loss_s) / abs(loss_s))

    model.decoder.dropout_rate = 0.0
    # deterministic cuDNN algorithms for the comparison alone: what is
    # left between two runs is the kernels' own (B3's atomic dq sums)
    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res["b5_in_step"] = {"bf16": b5_in_step(model, "bf16")}
        e2e = {"bf16": one_step(model)}
        model32 = build_gn_model(torch, "float32", like=model, dropout_rate=0.0)
        res["b5_in_step"]["float32"] = b5_in_step(model32, "float32")
        e2e["float32"] = one_step(model32)
        del model32
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    torch.cuda.empty_cache()
    for dname, r in e2e.items():
        loss_tol, grad_tol = GN_TRAIN_TOL[dname]
        proj_tol = GN_PROJ_TOL[dname]
        r.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol, tol_proj_rel_l2=proj_tol)
        print(f"[gn] one step, {dname}, dropout 0: loss kernel path "
              f"{r['loss_kernel']:.6f}, the same Functions on the plain kernels "
              f"{r['loss_reference']:.6f} (relative {r['loss_rel']:.3e}, limit "
              f"{loss_tol:g}), plain path {r['loss_plain']:.6f}; whole-gradient relative "
              f"L2 of the kernel path against the same with the plain B3 "
              f"{r['grad_rel_l2']:.3e} (limit {grad_tol:g}), of the sites' f/g/h projections "
              f"{r['proj_grad_rel_l2']:.3e} (limit {proj_tol:g}), control (B3 without "
              f"delta) {r['fault_grad_rel_l2']:.3e} and {r['fault_proj_grad_rel_l2']:.3e}; "
              f"whole gradient against the plain kernels {r['kernel_vs_reference']:.3e}, "
              f"against the plain path {r['kernel_vs_plain']:.3e} (the plain path again "
              f"{r['plain_again']:.3e}); projections against the plain path "
              f"{r['proj_kernel_vs_plain']:.3e} (again {r['proj_plain_again']:.3e})",
              flush=True)
    res["end_to_end"] = e2e

    # launches per make_train_step call
    state = create_train_state(model, lr=1e-4)
    step = make_train_step(state)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    set_kernel(model, True)
    reset_launch_counts(*B1_B5)
    with attention_sites(model) as seen:
        loss = step(x, y, gen)
    torch.cuda.synchronize()
    got = launch_counts(*B1_B5)
    routes = {n: r for n, (_, r) in seen.items()}
    print(f"[gn] launches in one make_train_step call: {got}, routes {routes}, loss "
          f"{loss.item():.4f}", flush=True)
    if got != want_step or not np.isfinite(loss.item()):
        raise AssertionError(f"expected {want_step} launches and a finite loss, got {got}")

    # train clips/s and peak memory: plain, kernel, kernel, plain
    model.decoder.dropout_rate = 0.5
    thr = {}
    for label, use_kernel in (("plain", False), ("kernel", True), ("kernel2", True),
                              ("plain2", False)):
        set_kernel(model, use_kernel)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        thr[label] = dict(
            rate_summary(step_times(torch, lambda: step(x, y, gen), THROUGHPUT_CALLS)),
            peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print(f"[gn] train clips/s (batch {BATCH}, bf16, dropout 0.5; median [slowest, "
          f"fastest] of {THROUGHPUT_CALLS} steps each, order plain, kernel, kernel, plain): "
          f"{describe_rates(thr)}; peak memory kernel {thr['kernel']['peak_gib']:.2f} GiB, "
          f"plain {thr['plain']['peak_gib']:.2f} GiB  [{card}]", flush=True)
    set_kernel(model, True)
    res["train_clips_per_s"] = thr
    if profile:
        res["profile"] = profile_device_time(
            torch, lambda: step(x, y, gen), "one GN train step")
    del state, step

    # Trainer.fit: 3 steps, side dumps, one validation pass, checkpoints
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_train_gn")
    shutil.rmtree(root, ignore_errors=True)
    cfg = Config(model=ModelConfig(name=GN_MODEL, dtype="bfloat16", dropout=0.5),
                 train=TrainConfig(batch_size=BATCH, lr=1e-4, valid_iter=2, save_iter=2,
                                   max_steps=TRAIN_STEPS, seed=SEED, info="smoke",
                                   model_dir=os.path.join(root, "model"),
                                   logs_dir=os.path.join(root, "logs")))
    try:
        trainer = Trainer(cfg, run="smoke", device=DEVICE)
        trainer.model.load_state_dict(model.state_dict())  # gamma nonzero
        train_batches = [batch() for _ in range(TRAIN_STEPS)]
        valid = [batch()]
        reset_launch_counts(*B1_B5)
        t0 = time.perf_counter()
        trainer.fit(iter(train_batches), lambda: iter(valid))
        trainer.ckpt.wait_until_finished()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = launch_counts(*B1_B5)
        trainer.close()
        with open(os.path.join(trainer.logs_dir, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["loss"] for r in records if "loss" in r]
        valid_rec = [r for r in records if "cc" in r]
        steps = checkpoint_steps(trainer.model_dir)
        no_stats = not any(key.endswith((".mean", ".var"))
                           for key in trainer.model.state_dict())
        del trainer
    finally:
        shutil.rmtree(root, ignore_errors=True)
        torch.cuda.empty_cache()
    # side dumps at every logged step (steps < 10) and one validation batch
    # run the eval forward: B1 at the three sites
    want = {"B1": 3 * (TRAIN_STEPS + 1), "B2": want_step["B2"] * TRAIN_STEPS,
            "B3": want_step["B3"] * TRAIN_STEPS, "B4": 0, "B5": 0}
    falling = losses[-1] < losses[0]
    trend = "falling" if falling else "not falling: each step sees another random batch"
    print(f"[gn] Trainer.fit: {TRAIN_STEPS} steps in {fit_s:.2f} s, losses "
          f"{[round(v, 3) for v in losses]} ({trend}), launches {fit_launches}, "
          f"validation {valid_rec}, checkpoints at steps {steps}", flush=True)
    if fit_launches != want:
        raise AssertionError(f"GN Trainer.fit: expected launches {want}, got {fit_launches}")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError("GN Trainer.fit: missing or non-finite losses")
    # KLD of a linear output with negative values is NaN (the log of a
    # negative ratio, in both packages); the other three must be finite
    if len(valid_rec) != 1 or not all(np.isfinite(valid_rec[0][key])
                                      for key in ("cc", "sim", "auc_judd")):
        raise AssertionError("GN Trainer.fit: no validation pass with finite metrics")
    if steps != [2, TRAIN_STEPS] or not no_stats:
        raise AssertionError(f"GN Trainer.fit: checkpoints at {steps}, BN statistics in a "
                             "GN model")
    res["fit"] = dict(steps=TRAIN_STEPS, seconds=fit_s, losses=losses, launches=fit_launches,
                      validation=valid_rec[0], falling=falling)
    for dname, r in e2e.items():
        if not (r["loss_rel"] <= r["tol_loss_rel"] and r["grad_rel_l2"] <= r["tol_grad_rel_l2"]
                and r["proj_grad_rel_l2"] <= r["tol_proj_rel_l2"]):
            raise AssertionError(f"GN train step, {dname}: the kernel path disagrees with its "
                                 "plain versions")
        if not r["fault_proj_grad_rel_l2"] > r["tol_proj_rel_l2"]:
            raise AssertionError("the GN train-step limits pass a B3 without delta; void")
    return res


def phase_zoo(torch, fa, measured):
    """Phase 8: every registry name on the card, one bf16 eval forward at
    batch 2.  No site of at least one query block may run plain PyTorch.
    Returns the (Nq, Nk, d, C) of each site of at least one query block
    whose shape is not in ``measured`` (the 'full' head's x_0_1_sa, d = 2,
    C = 16), by site name, for ``phase_kernels`` at batch 2."""
    from sap3d_tpu_torch.models.registry import LINEAR_OUTPUT, MODEL_REGISTRY, build_model

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    x = torch.randn(2, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    res, new_sites = {}, {}
    for name in MODEL_REGISTRY:
        model = build_model(name, dtype="bfloat16", device=DEVICE, seed=SEED)
        # gamma nonzero, and BN statistics calibrated on the batch: at their
        # init (0, 1) nothing normalizes the 47 blocks, and the non-local
        # blocks (cubic in their input) then overflow
        calibrate_and_randomize_bn(torch, model, x, gen)
        fa.flash_attend_tokens.launches = 0
        with torch.inference_mode(), attention_sites(model) as sites:
            out = model(x)
        torch.cuda.synchronize()
        launches = fa.flash_attend_tokens.launches
        gated = sum(route == "flash" for _, route in sites.values())
        lo, hi = out.min().item(), out.max().item()
        print(f"[zoo] {name}: {tuple(out.shape)}, range [{lo:.4f}, {hi:.4f}], B1 launches "
              f"{launches}, sites {({n: s_ for n, (s_, _) in sites.items()})}", flush=True)
        if tuple(out.shape) != (2, 16, SIZE, SIZE, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: wrong shape or non-finite output")
        if name not in LINEAR_OUTPUT and not (0.0 <= lo and hi <= 1.0):
            raise AssertionError(f"{name}: a sigmoid output outside [0, 1]")
        if not launches == gated == ZOO_LAUNCHES[name]:
            raise AssertionError(f"{name}: {launches} B1 launches, the gate gives {gated}, "
                                 f"expected {ZOO_LAUNCHES[name]}")
        res[name] = dict(launches=launches, min=lo, max=hi)
        for site, (shape, route) in sites.items():
            if route == "plain" and shape[0] >= fa.BLOCK_Q:
                raise AssertionError(f"{name} site {site} {shape}: plain PyTorch on the card")
            if shape[0] >= fa.BLOCK_Q and shape not in measured:
                new_sites[site] = shape
        del model, out
        torch.cuda.empty_cache()
    if len(res) != 14:
        raise AssertionError(f"the registry holds {len(res)} names, not 14")
    return res, new_sites


# ---- phase 9: long clips, ring attention over a time mesh ------------------


def check_b4(fb, label, q, k, v, o, lse, do, dlse, got):
    """B4's dq, dk, dv against the plain version's (with ``dlse``).  Planted
    faults: B3 in B4's place, the lse cotangent dropped (the B3 kernel on the
    same inputs), for dq and dk; dv, which dlse does not reach, with its last
    key tile dropped, held row by row too (``DV_ROW_TOLERANCE``)."""
    want = fb.flash_backward_reference(q, k, v, o, lse, do, dlse)
    b3 = fb.flash_backward(q, k, v, o, lse, do)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    dv_dropped = want[2].clone()
    dv_dropped[:, keep:] = 0
    faults = (b3[0], b3[1], dv_dropped)
    names = ("B3 in its place, dlse dropped",) * 2 + (_DROPPED,)
    rows = (None, None, fb.DV_ROW_TOLERANCE)
    res = {out: hold(f"B4 {out} {label}", g, w, f, n, fb.TOLERANCE, r)
           for out, g, w, f, n, r in zip(("dq", "dk", "dv"), got, want, faults, names, rows)}
    return dict(res, max_abs_err=max(r["max_abs_err"] for r in res.values()),
                excess=max(r["excess"] for r in res.values()))


def b4_bound(b, nq, nk, d, c, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of B4: B3's, and the [b, nq] float32 dlse read."""
    nbytes = b * (2 * (nq * d + nk * d + nk * c) + 2 * nq * c) * itemsize + 8 * b * nq
    return _bound(nbytes, 2 * b * nq * nk * (3 * d + 2 * c), dtype_name)


def phase_b4(torch, fa, fb, flush, sites=None):
    """Phase 9(c): B4 at the ring's per-shard shapes (the flagship's SITES:
    the 4 shards of a batch of 4 stack into one batch-16 launch per hop), or
    at ``sites`` (phase 7(b): GN deconv_pool4, the widest shape B3 and B4
    take), on random inputs, bf16 and fp32, against its plain version, with
    B3's time on the same inputs beside it."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in (SITES if sites is None else sites).items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            do = torch.randn(BATCH, nq, c, device=DEVICE, generator=gen).to(dtype)
            dlse = torch.randn(BATCH, nq, device=DEVICE, generator=gen)
            o, lse = fa.flash_forward_lse(q, k, v)
            got = fb.flash_backward(q, k, v, o, lse, do, dlse=dlse)
            row = dict(check_b4(fb, f"{site} {dname} (random inputs)", q, k, v, o, lse, do,
                                dlse, got), site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            del got
            heavy = nq * nk * (d + c) > 5e9
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            row["ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do, dlse=dlse),
                                iters, flush)
            row["b3_ms"] = time_ms(lambda: fb.flash_backward(q, k, v, o, lse, do), iters, flush)
            row["plain_ms"] = time_ms(
                lambda: fb.flash_backward_reference(q, k, v, o, lse, do, dlse),
                max(iters // 4, 3), flush)
            row["library_ms"], row["library_backend"] = None, "none"
            row["bound_ms"], row["bound_by"] = b4_bound(BATCH, nq, nk, d, c, dname,
                                                        q.element_size())
            row.update(backward_grid(fb, BATCH, nq, nk, d, c, dtype))
            print(f"[kernel] B4 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: kernel "
                  f"{row['ms']:.4f} ms, B3 on the same inputs {row['b3_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, no library call returns an lse gradient, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}), excess {row['excess']:.3f}, "
                  f"{describe_grid(row)}", flush=True)
            rows.append(row)
            del q, k, v, do, dlse, o, lse
            torch.cuda.empty_cache()
    return rows


RING_SHARDS = 4
# [4, 64, 112, 112, 3]: the activation volume of phase 6's batch of 16
# 16-frame clips.  The per-shard sites of the flagship at 64 frames are
# SITES (and x_4_0 at 49 queries, the chunked hop); the 4 shards of one
# site share the card and run each hop as one batch-16 launch.
RING_BATCH, RING_FRAMES = 4, 64
RING_SITES = dict(SITES, x_4_0=(49, 49, 128, 1024))
# Mean |ring - gather| of the bf16 eval forward (sigmoid output).  At 64
# frames the random network carries bf16 rounding further than at 16
# (E2E_MEAN_TOL): on an H100 the plain path read 4.5e-2 from the gather
# path's kernels, the ring 3.1e-2, the forward without attention 0.50.  The
# tight check of the forward is in float32 (RING_FP32_FWD_TOL).
RING_E2E_MEAN_TOL = 0.1
# fp32 eval forward at batch 1, ring against gather: mean |diff| of the
# sigmoid output; the forward without attention must exceed it.  On an H100
# the ring read 8.0e-6, the plain path 8.2e-6 from the gather path's
# kernels, no attention 0.50.  The largest element is read, not held: 6.2e-2
# for the ring and 2.4e-2 for the plain path (no attention 0.99).  The
# random network amplifies any disturbance of the attention outputs: the
# gather path with B1's o moved at random by the ring op's own relative
# distance (2.2e-6, ``perturbed``) reads mean 4.3e-5 and max 0.29.
RING_FP32_FWD_TOL = 1e-4
# The fp32 train step, ring against gather, at batch 1 (dropout 0, cuDNN's
# deterministic algorithms): (relative loss, relative L2 of the whole
# gradient) limits.  On an H100 the loss read 2.1e-7 and the gradient
# 2.05e-3, where the gather step run twice reads 1.0e-5 (B3's atomic dq),
# the plain path 1.05e-3, the gather path with B2's o moved at random by the
# ring op's own distance 1.6e-2, and the control, B3 in B4's place (the lse
# cotangent dropped), 0.65.  The ring op alone is within 6.2e-6 of the gather
# path at every site (RING_OP_TOL): the gap is the network's amplification
# of float32 reordering, which BN on its running statistics makes larger
# (ring 3.8e-2, moved o 0.20), not smaller.
RING_FP32_BATCH = 1
RING_FP32_TOL = (1e-5, 1e-2)
# The ring op alone in float32 at each kernel-hop site's whole shape, against
# the gather path's B2 + B3 on the same random inputs: relative L2 limits of
# (o, and each of dq, dk, dv).  The ring's hops and merge reorder float32
# sums (on an H100: o 7.6e-7 to 2.2e-6, gradients 7.4e-7 to 6.2e-6); the
# limits are the CPU tests' (1e-5 values, 1e-4 gradients), which B3 in B4's
# place exceeds in dq and dk (2.7e-2 to 9.5e-2).
RING_OP_TOL = (1e-5, 1e-4)


def phase_ring(torch, fa, fb, calibrated, flush, card, profile: bool = False):
    """Phase 9: the flagship's long-clip mode on one card, 4 time shards
    (``make_time_mesh(4, devices=[cuda:0] * 4)``), bf16, the calibrated
    weights of phase 4; with ``profile``, one ring and one gather train step
    are profiled as well."""
    import numpy as np

    from sap3d_tpu_torch.core.mesh import make_time_mesh
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_eval_step, make_train_step

    dev = torch.empty(0, device=DEVICE).device
    mesh = make_time_mesh(RING_SHARDS, devices=[dev] * RING_SHARDS)

    def twin(dtype, ring, dropout_rate=0.0):
        m = build_model("unet++", dtype=dtype, device=DEVICE, seed=SEED,
                        dropout_rate=dropout_rate, ring_mesh=mesh if ring else None)
        m.load_state_dict(calibrated)
        return m

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    x = torch.randn(RING_BATCH, RING_FRAMES, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    y = torch.rand(RING_BATCH, RING_FRAMES, SIZE, SIZE, device=DEVICE, generator=gen)
    ring, gather = twin("bfloat16", True), twin("bfloat16", False)
    # the kernel hop where the backward gate takes the per-shard shape; B1
    # on the gather path where the forward gate takes the whole site
    kernel_sites = {name: shape for name, shape in RING_SITES.items()
                    if fb.backward_viable(*shape, torch.bfloat16)}
    n_kernel, n_gather = len(kernel_sites), sum(
        fa.forward_viable(nq * RING_SHARDS, nk * RING_SHARDS, d, c, torch.bfloat16)
        for nq, nk, d, c in RING_SITES.values())
    want_fwd = {"B1": 0, "B2": n_kernel * RING_SHARDS, "B3": 0, "B4": 0}
    want_step = {"B1": 0, "B2": 2 * n_kernel * RING_SHARDS, "B3": 0,
                 "B4": n_kernel * RING_SHARDS}
    print(f"[ring] flagship [{RING_BATCH}, {RING_FRAMES}, {SIZE}, {SIZE}, 3] bf16 on "
          f"{RING_SHARDS} time shards of one card; per-shard sites {RING_SITES}; the kernel "
          f"hop at {n_kernel} of them; predicted launches per ring forward {want_fwd}, per "
          f"ring train step {want_step} (forward, checkpoint recompute, backward)", flush=True)
    res = {"predicted": {"forward": want_fwd, "step": want_step}}

    # (a) eval forward: the ring against the gather path (B1 on the whole sites)
    def forward(m, use_kernel=True):
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel
        reset_launch_counts(*B1_B4)
        out = make_eval_step(m)(x)
        torch.cuda.synchronize()
        return out, launch_counts(*B1_B4)

    out_g, n_g = forward(gather)
    out_r, n_r = forward(ring)  # the main path: counts zeroed just before, read just after
    out_p, _ = forward(gather, use_kernel=False)
    with torch.no_grad():
        for sa in gather.attention_modules():
            sa.gamma.zero_()
        no_attn, _ = forward(gather, use_kernel=False)
    gather.load_state_dict(calibrated)
    for sa in gather.attention_modules():
        sa.use_kernel = True
    mean_rg = (out_r - out_g).abs().mean().item()
    mean_pg = (out_p - out_g).abs().mean().item()
    mean_na = (no_attn - out_g).abs().mean().item()
    print(f"[ring] eval forward: launches ring {n_r}, gather {n_g}; mean |ring - gather| "
          f"{mean_rg:.3e} (limit {RING_E2E_MEAN_TOL:g}), plain path - gather {mean_pg:.3e}, no "
          f"attention - gather {mean_na:.3e}; output {tuple(out_r.shape)}", flush=True)
    if n_r != want_fwd or n_g != {"B1": n_gather, "B2": 0, "B3": 0, "B4": 0}:
        raise AssertionError(f"ring forward launches {n_r}, gather {n_g}")
    if not bool(torch.isfinite(out_r).all()) or out_r.shape != (*x.shape[:4],):
        raise AssertionError("ring forward: non-finite output or wrong shape")
    if not mean_rg <= RING_E2E_MEAN_TOL:
        raise AssertionError("ring forward disagrees with the gather path")
    if not mean_na > RING_E2E_MEAN_TOL:
        raise AssertionError("the ring forward's limit passes a model without attention; void")
    res["forward"] = dict(launches=n_r, gather_launches=n_g, ring_vs_gather_mean=mean_rg,
                          plain_vs_gather_mean=mean_pg, no_attention_vs_gather_mean=mean_na)
    del out_g, out_r, out_p, no_attn

    # (b) one ring train step: every B4 call held on the step's own tensors
    calls = []

    def spy_b4(q, k, v, o, lse, do, dlse=None):
        out = fb.flash_backward(q, k, v, o, lse, do, dlse=dlse)
        calls.append((q, k, v, o, lse, do, dlse, out))
        return out

    ring.train()
    ring.zero_grad(set_to_none=True)
    with function_calls(backward=spy_b4):
        loss_fn_saliency(ring(x), y).backward()
    torch.cuda.synchronize()
    ring.zero_grad(set_to_none=True)
    names = {shape: name for name, shape in kernel_sites.items()}
    held = {}
    for i, (q, k, v, o, lse, do, dlse, out) in enumerate(calls):
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        if dlse is None or q.shape[0] != RING_SHARDS * RING_BATCH:
            raise AssertionError(f"a ring hop's backward at {name} ran without dlse or "
                                 f"unstacked (batch {q.shape[0]})")
        held.setdefault(name, []).append(check_b4(
            fb, f"{name} call {len(held.get(name, [])) + 1} bf16 (in the ring train step)",
            q, k, v, o, lse, do, dlse, out))
    del calls
    torch.cuda.empty_cache()
    if sorted(held) != sorted(kernel_sites) or any(len(h) != RING_SHARDS
                                                   for h in held.values()):
        raise AssertionError(f"B4 ran {({n: len(h) for n, h in held.items()})} times by site, "
                             f"not {RING_SHARDS} at each of {sorted(kernel_sites)}")
    res["b4_in_step"] = held

    state = create_train_state(ring, lr=1e-4)
    step = make_train_step(state)
    step_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    reset_launch_counts(*B1_B4)  # the main path: one make_train_step call
    loss = step(x, y, step_gen)
    torch.cuda.synchronize()
    n_step = launch_counts(*B1_B4)
    print(f"[ring] launches in one ring make_train_step call: predicted {want_step}, counted "
          f"{n_step}, loss {loss.item():.4f}", flush=True)
    if n_step != want_step or not np.isfinite(loss.item()):
        raise AssertionError(f"ring train step: launches {n_step}, predicted {want_step}")
    res["launches"] = {"forward": n_r, "step": n_step}

    # fp32 at batch 1: the ring step against the gather step (B2 + B3)
    xs, ys = x[:RING_FP32_BATCH].float(), y[:RING_FP32_BATCH]

    def b3_in_place(q, k, v, o, lse, do, dlse=None):
        return fb.flash_backward(q, k, v, o, lse, do)

    def grads(m, forward=None, backward=None, train=True):
        m.train(train)
        m.zero_grad(set_to_none=True)
        with function_calls(forward=forward, backward=backward):
            loss_ = loss_fn_saliency(m(xs), ys)
            loss_.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.float().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        m.load_state_dict(calibrated)  # BN's running statistics as they were
        return loss_.item(), flat

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        op = ring_op_check(torch, fb, mesh)
        # the yardstick of a forward disturbance: the ring op's own relative
        # distance from the gather path's kernels
        eps = max(r["o"] for r in op.values())
        ring32, gather32 = twin("float32", True), twin("float32", False)
        fwd_r, fwd_g = make_eval_step(ring32)(xs), make_eval_step(gather32)(xs)
        b1 = ta.flash_attend_tokens
        ta.flash_attend_tokens = perturbed(torch, b1, eps)
        try:
            fwd_n = make_eval_step(gather32)(xs)
        finally:
            ta.flash_attend_tokens = b1
        for sa in gather32.attention_modules():
            sa.use_kernel = False
        fwd_p = make_eval_step(gather32)(xs)
        with torch.no_grad():
            for sa in gather32.attention_modules():
                sa.gamma.zero_()
        fwd_na = make_eval_step(gather32)(xs)
        gather32.load_state_dict(calibrated)
        for sa in gather32.attention_modules():
            sa.use_kernel = True
        fwd32 = {f"{name}_{stat}": getattr((out - fwd_g).abs(), stat)().item()
                 for name, out in (("ring", fwd_r), ("plain", fwd_p), ("perturbed", fwd_n),
                                   ("no_attention", fwd_na))
                 for stat in ("mean", "max")}
        fwd32["tol_mean"] = RING_FP32_FWD_TOL
        print(f"[ring] eval forward, float32, batch {RING_FP32_BATCH}: |ring - gather| mean "
              f"{fwd32['ring_mean']:.3e} (limit {RING_FP32_FWD_TOL:g}), max "
              f"{fwd32['ring_max']:.3e}; plain path - gather mean {fwd32['plain_mean']:.3e}, "
              f"max {fwd32['plain_max']:.3e}; gather with B1's o moved by {eps:.2e} - gather "
              f"mean {fwd32['perturbed_mean']:.3e}, max {fwd32['perturbed_max']:.3e}; no "
              f"attention - gather mean "
              f"{fwd32['no_attention_mean']:.3e}, max {fwd32['no_attention_max']:.3e}",
              flush=True)
        res["fp32_forward"] = fwd32
        del fwd_r, fwd_g, fwd_n, fwd_p, fwd_na
        loss_g, g_g = grads(gather32)
        _, g_g2 = grads(gather32)
        reset_launch_counts(*B1_B4)  # the float32 ring step: one main-path run
        loss_r, g_r = grads(ring32)
        res["launches"]["fp32_step"] = launch_counts(*B1_B4)
        _, g_f = grads(ring32, backward=b3_in_place)
        # yardsticks: another float32 order of the same sums (the plain
        # path), and the gather path with its B2 outputs moved at random by
        # the ring op's own relative distance from them
        for sa in gather32.attention_modules():
            sa.use_kernel = False
        _, g_p = grads(gather32)
        for sa in gather32.attention_modules():
            sa.use_kernel = True
        _, g_n = grads(gather32, forward=perturbed(torch, fa.flash_forward_lse, eps))
        fp32 = dict(loss_ring=loss_r, loss_gather=loss_g,
                    loss_rel=abs(loss_r - loss_g) / abs(loss_g), grad_rel_l2=rel(g_r, g_g),
                    gather_again=rel(g_g2, g_g), plain_grad_rel_l2=rel(g_p, g_g),
                    perturbed_eps=eps, perturbed_grad_rel_l2=rel(g_n, g_g),
                    fault_grad_rel_l2=rel(g_f, g_g))
        del g_g, g_g2, g_r, g_f, g_p, g_n
        # the same with BN on its running statistics (eval mode; the sites
        # are differentiated, so they route as in training)
        _, g_g = grads(gather32, train=False)
        _, g_g2 = grads(gather32, train=False)
        _, g_r = grads(ring32, train=False)
        _, g_n = grads(gather32, forward=perturbed(torch, fa.flash_forward_lse, eps),
                       train=False)
        fp32.update(bn_running_grad_rel_l2=rel(g_r, g_g), bn_running_gather_again=rel(g_g2, g_g),
                    bn_running_perturbed_grad_rel_l2=rel(g_n, g_g))
        del ring32, gather32, g_g, g_g2, g_r, g_n
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    torch.cuda.empty_cache()
    loss_tol, grad_tol = RING_FP32_TOL
    fp32.update(tol_loss_rel=loss_tol, tol_grad_rel_l2=grad_tol)
    print(f"[ring] one train step, float32, batch {RING_FP32_BATCH}, dropout 0: loss ring "
          f"{loss_r:.6f}, gather {loss_g:.6f} (relative {fp32['loss_rel']:.3e}, limit "
          f"{loss_tol:g}); whole-gradient relative L2 ring against gather "
          f"{fp32['grad_rel_l2']:.3e} (limit {grad_tol:g}), the gather step again "
          f"{fp32['gather_again']:.3e}, the plain path against gather "
          f"{fp32['plain_grad_rel_l2']:.3e}, gather with B2's o moved by {eps:.2e} "
          f"{fp32['perturbed_grad_rel_l2']:.3e}, control (B3 in B4's place) "
          f"{fp32['fault_grad_rel_l2']:.3e}; with BN on its running statistics: ring against "
          f"gather {fp32['bn_running_grad_rel_l2']:.3e}, the gather step again "
          f"{fp32['bn_running_gather_again']:.3e}, gather with o moved "
          f"{fp32['bn_running_perturbed_grad_rel_l2']:.3e}", flush=True)
    res["fp32_step"] = fp32
    res["fp32_op"] = op

    # (c) B4's kernel times beside B3's
    rows = phase_b4(torch, fa, fb, flush)

    # (d) step times: gather, ring, ring, gather (dropout 0.5)
    steps = {}
    for label, m in (("gather", gather), ("ring", ring)):
        m.decoder.dropout_rate = 0.5
        steps[label] = make_train_step(create_train_state(m, lr=1e-4)) if m is gather else step
    thr = {}
    for label in ("gather", "ring", "ring2", "gather2"):
        fn = steps[label.rstrip("2")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = step_times(torch, lambda: fn(x, y, step_gen), THROUGHPUT_CALLS)
        thr[label] = dict(rate_summary(times, RING_BATCH),
                          ms=1e3 * float(np.median(times)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    res["train_clips_per_s"] = thr
    if profile:
        res["profile"] = {label: profile_device_time(
            torch, lambda fn=fn: fn(x, y, step_gen), f"one {label} train step, 64-frame clips",
            RING_BATCH)
            for label, fn in steps.items()}

    def one(r):
        return (f"{r['ms']:.2f} ms, {r['clips_per_s']:.2f} [{r['slowest']:.2f}, "
                f"{r['fastest']:.2f}] clips/s, peak {r['peak_gib']:.2f} GiB")
    print(f"[ring] train step, {RING_FRAMES}-frame clips, batch {RING_BATCH}, bf16, dropout "
          f"0.5 (median [slowest, fastest] of {THROUGHPUT_CALLS} steps each, order gather, "
          f"ring, ring, gather): gather {one(thr['gather'])}; ring {one(thr['ring'])}; ring "
          f"{one(thr['ring2'])}; gather {one(thr['gather2'])}  [{card}]", flush=True)
    del steps, step, state, ring, gather
    torch.cuda.empty_cache()
    # (a)'s and (b)'s fp32 limits, held after the phase's other readings are taken
    if not fwd32["ring_mean"] <= RING_FP32_FWD_TOL:
        raise AssertionError("ring forward, float32: the ring disagrees with the gather path")
    if not fwd32["no_attention_mean"] > RING_FP32_FWD_TOL:
        raise AssertionError("the ring's float32 forward limit passes no attention; void")
    if not (fp32["loss_rel"] <= loss_tol and fp32["grad_rel_l2"] <= grad_tol):
        raise AssertionError("ring train step, float32: the ring disagrees with the gather path")
    if not fp32["fault_grad_rel_l2"] > grad_tol:
        raise AssertionError("the ring train-step limit passes B3 in B4's place; void")
    for site, r in op.items():
        if not all(r[out] <= tol for out, tol in zip(("o", "dq", "dk", "dv"), RING_OP_TOL)):
            raise AssertionError(f"the ring op at {site}, float32, disagrees with the gather path")
        if not min(r["fault_dq"], r["fault_dk"]) > RING_OP_TOL[1]:
            raise AssertionError(f"the ring op's limit at {site} passes B3 in B4's place; void")
    return res, rows


def perturbed(torch, forward, eps):
    """``forward`` (B1, or B2 and its lse) with o moved by a relative ``eps``
    at random (o (1 + eps z), z ~ N(0, 1) from a fixed seed): a forward
    disturbance of a given size at the gather path's sites, the yardstick
    for the ring's."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 12)

    def moved(q, k, v):
        out = forward(q, k, v)
        o = out[0] if isinstance(out, tuple) else out
        z = torch.randn(o.shape, device=o.device, generator=gen, dtype=torch.float32)
        o = (o.float() * (1 + eps * z)).to(o.dtype)
        return (o,) + out[1:] if isinstance(out, tuple) else o
    return moved


def ring_op_check(torch, fb, mesh):
    """The ring op alone at each kernel-hop site's whole shape (batch 1,
    float32, random inputs and cotangent): o, dq, dk and dv of
    ``ring_attend_sharded`` on ``mesh`` against the gather path's Function
    (``flash_attend``: B2 + B3), as relative L2 distances; the control runs
    the ring with B3 in B4's place (the merge's lse cotangent dropped)."""
    from sap3d_tpu_torch.ops.attention import flash_attend
    from sap3d_tpu_torch.ops.ring_attention import ring_attend_sharded

    def b3_in_place(q, k, v, o, lse, do, dlse=None):
        return fb.flash_backward(q, k, v, o, lse, do)

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    res = {}
    for site, (nq, nk, d, c) in RING_SITES.items():
        if not fb.backward_viable(nq, nk, d, c, torch.float32):
            continue
        nq, nk = nq * RING_SHARDS, nk * RING_SHARDS
        q = (torch.randn(1, nq, d, device=DEVICE, generator=gen) * d ** -0.25).requires_grad_()
        k = (torch.randn(1, nk, d, device=DEVICE, generator=gen) * d ** -0.25).requires_grad_()
        v = torch.randn(1, nk, c, device=DEVICE, generator=gen).requires_grad_()
        do = torch.randn(1, nq, c, device=DEVICE, generator=gen)

        def run(fn, backward=None):
            with function_calls(backward=backward):
                out = fn(q, k, v)
                return (out.detach(),) + torch.autograd.grad(out, (q, k, v), do)

        def ring(*a):
            return ring_attend_sharded(mesh, *a)

        want, got, fault = run(flash_attend), run(ring), run(ring, b3_in_place)
        r = {out: rel(g, w) for out, g, w in zip(("o", "dq", "dk", "dv"), got, want)}
        r.update(fault_dq=rel(fault[1], want[1]), fault_dk=rel(fault[2], want[2]))
        print(f"[ring] the ring op alone at {site} (whole site {(nq, nk, d, c)}, batch 1, "
              f"float32), relative L2 against the gather path: o {r['o']:.3e} (limit "
              f"{RING_OP_TOL[0]:g}), dq {r['dq']:.3e}, dk {r['dk']:.3e}, dv {r['dv']:.3e} "
              f"(limit {RING_OP_TOL[1]:g}); control (B3 in B4's place) dq {r['fault_dq']:.3e}, "
              f"dk {r['fault_dk']:.3e}", flush=True)
        res[site] = r
        del q, k, v, do, want, got, fault
    return res


# ---- phase 9(e): the whole network time-sharded (ops/time_shard.py) ---------

# (i) The sharded step at batch 1 (dropout 0, cuDNN's deterministic
# algorithms) against the unsharded gather step, beside RING_FP32_TOL.
# Every convolution of the sharded path takes a halo-padded input of
# another shape, so cuDNN adds its products in another order, and every
# train-mode BN adds its statistics in another order: the two steps differ
# by float32 rounding.  The calibrated flagship carries that rounding to an
# O(1) change: its attention logits spread far beyond unit scale (1.5e5 at
# x_4_0, 4e2 at the others, so each softmax is nearly an argmax), and a
# one-ulp move of the gather step's own input moves it as far.  So the
# flagship is read in float32, with that witness beside it (an NVIDIA H100
# 80GB HBM3, 700.00 W: eval forward max |diff| 1.0 and whole gradient 2.57
# under the one-ulp move, the sharded step 1.0 and 0.73; PERF.md),
# and held in float32 at a condition where rounding stays small: the micro
# SA model (the flagship's four ring sites, at the same token counts and
# micro widths), calibrated as phase 4 calibrates the flagship, on the
# same full-size clip [1, 64, 112, 112, 3].  TS_FP32_TOL holds its eval
# forward (mean and largest |diff| of the sigmoid output), loss (relative)
# and whole gradient (relative L2); the gather step's own one-ulp witness
# must lie within it, the eval forward with every shard padded at its own
# ends must exceed the forward's, and both planted faults (every shard
# padded at its own ends, BN statistics per shard) the gradient's.  Read
# on the same H100: forward 8.3e-6 and 2.1e-4, loss 0, gradient 6.0e-3;
# the witness 1.6e-5, 4.0e-4, 3.9e-7, 1.07e-2; the faults 1.37 and 1.31.
TS_FP32_TOL = {"forward_mean": 1e-4, "forward_max": 1e-2, "loss": 1e-5, "grad": 5e-2}
# The flagship is held in float64 as well (the plain path: no kernel takes
# float64; the ring's chunked hop), where only the head's float32 output
# rounds: the eval forward's largest |diff|, then (relative loss, relative
# L2 of the whole gradient), the same faults exceeding them.  Read on the
# same H100: the forward 1.19e-7 (one float32 ulp of the sigmoid output),
# the loss 1.04e-7, the gradient 4.5e-9; the faults 1.006 and 1.160.
TS_F64_FWD_TOL = 1e-6
TS_F64_TOL = (1e-6, 1e-6)
TS_TIMED_STEPS = 3             # (iii): steps per round, 4 rounds
TS_ZOO_SHARDS, TS_ZOO_BATCH, TS_ZOO_FRAMES = 2, 2, 32


TIME_SHARD_FAULTS = ("own_ends", "per_shard_statistics")


@contextlib.contextmanager
def planted_time_shard_fault(fault: str):
    """One of the planted faults of the time-sharded path for the duration
    (``TIME_SHARD_FAULTS``; phase 9(e) and the tests of
    ``ops/time_shard.py`` hold their limits against both): "own_ends",
    every shard padded at its own ends, as if it were a clip (no halo
    frames: each is the fill value); "per_shard_statistics", each shard
    normalized with its own batch statistics."""
    import torch

    from sap3d_tpu_torch.ops import layers
    from sap3d_tpu_torch.ops import time_shard as ts

    def own_ends(x, lo, hi, fill=0.0):
        pad = [0, 0] * (x.parts[0].dim() - 1 - x.time_dim) + [lo, hi]
        return [torch.nn.functional.pad(p, pad, value=fill) for p in x.parts]

    def per_shard(self, x):
        outs = [layers.BatchNorm.forward(self, x.shard(j)) for j in range(x.n)]
        return x.with_parts([torch.cat([outs[j] for j in idx]) for _, idx in x.groups])

    owner, attr, fake = {"own_ends": (ts, "halo", own_ends),
                         "per_shard_statistics": (layers.BatchNorm, "_sharded", per_shard)}[fault]
    orig = getattr(owner, attr)
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


@contextlib.contextmanager
def conv_outputs(torch, model):
    """Each convolution's output: the number of time shards it was cut into
    (0: a whole tensor) and their devices, by module name."""
    from sap3d_tpu_torch.ops import layers
    from sap3d_tpu_torch.ops import time_shard as ts

    seen = {}

    def hook(mod, args, out, name):
        if isinstance(out, ts.Shards):
            seen.setdefault(name, set()).add((out.n, tuple(str(p.device) for p in out.parts)))
        else:
            seen.setdefault(name, set()).add((0, (str(out.device),)))

    handles = [m.register_forward_hook(lambda mod, a, o, name=name: hook(mod, a, o, name))
               for name, m in model.named_modules()
               if isinstance(m, (layers.Conv3d, layers.ConvTranspose3d))]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def time_shard_traffic():
    """Counts of what crosses shards while the block runs (forward; the
    backward sends the same frames back): halo frames (``ops/time_shard.
    halo``: lo + hi per shard per call) and their bytes, and the reductions
    over shards (``sum_to``, ``clip_amax``, ``shard_sums``, and the BN calls
    with batch statistics on one device's stacked shards, which reduce them
    in one call)."""
    from sap3d_tpu_torch.ops import layers
    from sap3d_tpu_torch.ops import time_shard as ts

    counts = {"halo_calls": 0, "halo_frames": 0, "halo_bytes": 0, "reductions": 0}
    orig = {name: getattr(ts, name) for name in ("halo", "sum_to", "clip_amax", "shard_sums")}
    orig_bn = layers.BatchNorm._sharded

    def halo(x, lo, hi, fill=0.0):
        counts["halo_calls"] += bool(lo or hi)
        counts["halo_frames"] += (lo + hi) * x.n
        counts["halo_bytes"] += (lo + hi) * x.n * x.shard(0).select(x.time_dim, 0).numel() \
            * x.parts[0].element_size()
        return orig["halo"](x, lo, hi, fill)

    def reducing(fn):
        def counted(*args, **kw):
            counts["reductions"] += 1
            return fn(*args, **kw)
        return counted

    def bn(self, x):
        if (self.training or self.batch_stats_at_eval) and len(x.parts) == 1:
            counts["reductions"] += 1
        return orig_bn(self, x)

    ts.halo = halo
    for name in ("sum_to", "clip_amax", "shard_sums"):
        setattr(ts, name, reducing(orig[name]))
    layers.BatchNorm._sharded = bn
    try:
        yield counts
    finally:
        for name, fn in orig.items():
            setattr(ts, name, fn)
        layers.BatchNorm._sharded = orig_bn


def phase_time_shard(torch, fa, fb, calibrated, card):
    """Phase 9(e): the flagship with every layer time-sharded over
    ``make_time_mesh(4, devices=[cuda:0] * 4)`` (the calibrated weights of
    phase 4), then every registry name over 2 shards."""
    import numpy as np

    from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
    from sap3d_tpu_torch.models.registry import MODEL_REGISTRY, build_model
    from sap3d_tpu_torch.ops import time_shard as ts
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_eval_step, make_train_step

    t_phase = time.perf_counter()
    dev = torch.empty(0, device=DEVICE).device
    mesh = make_time_mesh(RING_SHARDS, devices=[dev] * RING_SHARDS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)  # phase 9's clips
    x = torch.randn(RING_BATCH, RING_FRAMES, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    y = torch.rand(RING_BATCH, RING_FRAMES, SIZE, SIZE, device=DEVICE, generator=gen)
    x_host, y_host = x.cpu().numpy(), y.cpu().numpy()
    del x, y

    def twin(dtype, ring, dropout_rate=0.0):
        m = build_model("unet++", dtype=dtype, device=DEVICE, seed=SEED,
                        dropout_rate=dropout_rate, ring_mesh=mesh if ring else None)
        m.load_state_dict(calibrated)
        return m

    def whole(out):
        return ts.gather(out) if isinstance(out, ts.Shards) else out

    def rel(a, b):
        return (a - b).norm().item() / b.norm().item()

    # (i) batch 1: sharded against the unsharded gather step (each sharded
    # step's launches counted: a main path), in float32 with the gather
    # step's own one-ulp witness
    xs, ys = x_host[:RING_FP32_BATCH], y_host[:RING_FP32_BATCH]

    def grads(m, weights, inp, tgt):
        m.train()
        m.zero_grad(set_to_none=True)
        loss_ = loss_fn_saliency(m(inp), tgt)
        loss_.backward()
        torch.cuda.synchronize()
        flat = torch.cat([p.grad.double().flatten() for p in m.parameters()])
        m.zero_grad(set_to_none=True)
        m.load_state_dict(weights)  # BN's running statistics as they were
        return loss_.item(), flat

    def compare(name, dtype, weights, held: bool):
        """Distances from the gather step: the eval forward's (mean, largest
        |diff|), the loss's (relative) and the whole gradient's (relative
        L2), of the sharded step; in float32 of the gather step at its input
        moved by one ulp; where ``held``, of the planted faults."""
        sh, g = (build_model(name, dtype=dtype, device=DEVICE, seed=SEED, dropout_rate=0.0,
                             ring_mesh=mesh if ring else None) for ring in (True, False))
        for m in (sh, g):
            m.load_state_dict(weights)
            if dtype == torch.float64:
                m.double()
        xs_sh, ys_sh = time_shard_batch(mesh, (xs, ys))  # the model casts to its dtype
        xs_d, ys_d = torch.from_numpy(xs).to(DEVICE, dtype), torch.from_numpy(ys).to(DEVICE)
        moved = torch.nextafter(xs_d, torch.full_like(xs_d, math.inf))
        fwd_g = make_eval_step(g)(xs_d)

        def dist(o):
            d = (o - fwd_g).abs()
            return d.mean().item(), d.max().item()

        fwd = {"sharded": dist(whole(make_eval_step(sh)(xs_sh)))}
        if dtype == torch.float32:
            fwd["one_ulp"] = dist(make_eval_step(g)(moved))
        if held:
            with planted_time_shard_fault("own_ends"):
                fwd["own_ends"] = dist(whole(make_eval_step(sh)(xs_sh)))
        loss_g, g_g = grads(g, weights, xs_d, ys_d)
        reset_launch_counts(*B1_B4)
        steps = {"sharded": grads(sh, weights, xs_sh, ys_sh)}
        launches = launch_counts(*B1_B4)
        if dtype == torch.float32:
            steps["one_ulp"] = grads(g, weights, moved, ys_d)
        for fault in TIME_SHARD_FAULTS if held else ():
            with planted_time_shard_fault(fault):
                steps[fault] = grads(sh, weights, xs_sh, ys_sh)
        out = dict(forward=fwd, launches=launches,
                   loss={k: abs(v - loss_g) / abs(loss_g) for k, (v, _) in steps.items()},
                   grad={k: rel(v, g_g) for k, (_, v) in steps.items()})
        readings = []
        for k in dict.fromkeys([*fwd, *steps]):
            bits = [f"eval forward |diff| mean {fwd[k][0]:.3e}, max {fwd[k][1]:.3e}"] \
                if k in fwd else []
            if k in steps:
                bits.append(f"loss {out['loss'][k]:.3e}, gradient {out['grad'][k]:.3e}")
            readings.append(f"{k}: " + ", ".join(bits))
        print(f"[time-shard] {name}, {str(dtype)[6:]}, batch {RING_FP32_BATCH}, dropout 0, "
              f"{RING_SHARDS} shards, against the gather step (loss {loss_g:.6f}): "
              + "; ".join(readings) + f"; launches of the sharded step {launches}", flush=True)
        del sh, g
        torch.cuda.empty_cache()
        return out

    def micro_weights():
        """p3d_micro_sa calibrated as phase 4 calibrates the flagship."""
        m = build_model("p3d_micro_sa", dtype="float32", device=DEVICE, seed=SEED)
        mgen = torch.Generator(device=DEVICE).manual_seed(SEED)
        mx = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=mgen) * 0.3
        calibrate_and_randomize_bn(torch, m, mx, mgen)
        return {k: v.detach().clone() for k, v in m.state_dict().items()}

    was_deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fp32 = compare("unet++", torch.float32, calibrated, held=False)
        micro = compare("p3d_micro_sa", torch.float32, micro_weights(), held=True)
        f64 = compare("unet++", torch.float64, calibrated, held=True)
    finally:
        torch.backends.cudnn.deterministic = was_deterministic
    loss_tol, grad_tol = TS_F64_TOL
    print(f"[time-shard] limits: p3d_micro_sa float32 {TS_FP32_TOL}; the flagship float64: "
          f"eval forward largest |diff| {TS_F64_FWD_TOL:g}, loss {loss_tol:g}, whole gradient "
          f"{grad_tol:g}", flush=True)

    # (ii) bf16 at batch 4: one make_train_step call, launches predicted and counted
    sharded = twin("bfloat16", True)
    kernel_sites = [shape for shape in RING_SITES.values()
                    if fb.backward_viable(*shape, torch.bfloat16)]
    want = {"B1": 0, "B2": 2 * len(kernel_sites) * RING_SHARDS, "B3": 0,
            "B4": len(kernel_sites) * RING_SHARDS}
    print(f"[time-shard] bf16 [{RING_BATCH}, {RING_FRAMES}, {SIZE}, {SIZE}, 3]: predicted "
          f"launches per sharded make_train_step call {want} (the rings of (b), now on "
          "shards that stay where they are)", flush=True)
    xb, yb = time_shard_batch(mesh, (x_host, y_host))
    step_gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    state = create_train_state(sharded, lr=1e-4)
    step = make_train_step(state)
    with conv_outputs(torch, sharded) as seen, time_shard_traffic() as traffic:
        reset_launch_counts(*B1_B4)  # the main path: one sharded make_train_step call
        loss = step(xb, yb, step_gen)
        torch.cuda.synchronize()
        n_step = launch_counts(*B1_B4)
    whole_convs = sorted(name for name, kinds in seen.items()
                         if any(n != RING_SHARDS for n, _ in kinds))
    print(f"[time-shard] launches in one sharded make_train_step call: counted {n_step}, "
          f"loss {loss.item():.4f}; {len(seen)} convolutions, each output in "
          f"{sorted({n for kinds in seen.values() for n, _ in kinds})} shards; across shards in "
          f"the forward: {traffic['halo_frames']} halo frames in {traffic['halo_calls']} halo "
          f"calls ({traffic['halo_bytes'] / 2 ** 20:.1f} MiB), {traffic['reductions']} "
          "reductions", flush=True)
    if n_step != want or not np.isfinite(loss.item()):
        raise AssertionError(f"sharded train step: launches {n_step}, predicted {want}")
    if whole_convs or not seen:
        raise AssertionError(f"convolutions that ran on the whole clip: {whole_convs}")

    # (iii) ms and peak memory: ring-only (the whole clip, rings at the
    # sites, as (d)) and sharded, order ring, sharded, sharded, ring
    ring = twin("bfloat16", True, dropout_rate=0.5)
    sharded.decoder.dropout_rate = 0.5
    x_d, y_d = torch.from_numpy(x_host).to(DEVICE), torch.from_numpy(y_host).to(DEVICE)
    runs = {"ring": (make_train_step(create_train_state(ring, lr=1e-4)), x_d, y_d),
            "sharded": (step, xb, yb)}
    thr = {}
    for label in ("ring", "sharded", "sharded2", "ring2"):
        fn, a, b = runs[label.rstrip("2")]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = step_times(torch, lambda: fn(a, b, step_gen), TS_TIMED_STEPS)
        thr[label] = dict(rate_summary(times, RING_BATCH), ms=1e3 * float(np.median(times)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)

    def one(r):
        return (f"{r['ms']:.2f} ms, {r['clips_per_s']:.2f} [{r['slowest']:.2f}, "
                f"{r['fastest']:.2f}] clips/s, peak {r['peak_gib']:.2f} GiB")
    print(f"[time-shard] train step, {RING_FRAMES}-frame clips, batch {RING_BATCH}, bf16, "
          f"dropout 0.5 (median [slowest, fastest] of {TS_TIMED_STEPS} steps each, order ring, "
          f"sharded, sharded, ring): ring {one(thr['ring'])}; sharded {one(thr['sharded'])}; "
          f"sharded {one(thr['sharded2'])}; ring {one(thr['ring2'])}  [{card}]", flush=True)
    del runs, step, state, sharded, ring, xb, yb, x_d, y_d
    torch.cuda.empty_cache()

    # (iv) every registry name: one sharded bf16 step at batch 2 on 32 frames
    mesh2 = make_time_mesh(TS_ZOO_SHARDS, devices=[dev] * TS_ZOO_SHARDS)
    zgen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    zx = torch.randn(TS_ZOO_BATCH, TS_ZOO_FRAMES, SIZE, SIZE, 3, device=DEVICE,
                     generator=zgen) * 0.3
    zy = torch.rand(TS_ZOO_BATCH, TS_ZOO_FRAMES, SIZE, SIZE, device=DEVICE, generator=zgen)
    zx_sh, zy_sh = time_shard_batch(mesh2, (zx.cpu().numpy(), zy.cpu().numpy()))
    zoo = {}
    for name in MODEL_REGISTRY:
        model = build_model(name, dtype="bfloat16", device=DEVICE, seed=SEED, dropout_rate=0.0,
                            ring_mesh=mesh2)
        calibrate_and_randomize_bn(torch, model, zx, zgen)
        shapes = []
        handle = model.register_forward_hook(lambda m, a, out: shapes.append(out.shape))
        zstep = make_train_step(create_train_state(model, lr=1e-4))
        reset_launch_counts(*B1_B4)
        zloss = zstep(zx_sh, zy_sh).item()
        torch.cuda.synchronize()
        counts = launch_counts(*B1_B4)
        handle.remove()
        rings, sites = len(model.ring_sites()), len(model.attention_modules())
        print(f"[time-shard] {name}: output {shapes[0]} over {TS_ZOO_SHARDS} shards, loss "
              f"{zloss:.4f}, launches {counts}; {rings} ring sites of {sites}", flush=True)
        if shapes[0] != (TS_ZOO_BATCH, TS_ZOO_FRAMES, SIZE, SIZE, 1) or not np.isfinite(zloss):
            raise AssertionError(f"{name}: sharded step output {shapes[0]}, loss {zloss}")
        if counts["B1"] or (rings and (not counts["B4"] or counts["B3"])) \
                or (sites > rings and not counts["B3"]) or (not sites and any(counts.values())):
            raise AssertionError(f"{name}: launches {counts} do not match its {rings} ring and "
                                 f"{sites - rings} gathered sites")
        zoo[name] = dict(loss=zloss, launches=counts)
        del model, zstep
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[time-shard] phase 9(e) took {seconds:.1f} s", flush=True)

    # (i)'s limits, held after the phase's other readings are taken
    tol = TS_FP32_TOL

    def forward_within(k):
        mean, top = micro["forward"][k]
        return mean <= tol["forward_mean"] and top <= tol["forward_max"]

    if not all(forward_within(k) and micro["loss"][k] <= tol["loss"]
               and micro["grad"][k] <= tol["grad"] for k in ("sharded", "one_ulp")):
        raise AssertionError("p3d_micro_sa, float32: the sharded step, or the gather step's "
                             "one-ulp witness, is outside TS_FP32_TOL")
    if forward_within("own_ends") or not all(micro["grad"][f] > tol["grad"]
                                             for f in TIME_SHARD_FAULTS):
        raise AssertionError("p3d_micro_sa, float32: TS_FP32_TOL passes a planted fault")
    if not f64["forward"]["sharded"][1] <= TS_F64_FWD_TOL < f64["forward"]["own_ends"][1]:
        raise AssertionError("sharded forward, float64: disagrees with the gather path, or the "
                             "limit passes the planted fault own_ends")
    if not (f64["loss"]["sharded"] <= loss_tol and f64["grad"]["sharded"] <= grad_tol):
        raise AssertionError("sharded train step, float64: disagrees with the gather step")
    for fault in TIME_SHARD_FAULTS:
        if not f64["grad"][fault] > grad_tol:
            raise AssertionError(f"the sharded step's limit passes the planted fault {fault}")
    return dict(fp32=fp32, fp32_micro=micro, float64=f64, want=want, launches=n_step,
                traffic=traffic, train=thr, zoo=zoo, seconds=seconds)


# ---- phase 10: the inference bisect and kernel B6 ----------------------------


def check_row_stats(fa, label, q, k):
    """The row-stats kernel (B6's first pass) on (q, k) against its plain
    version: lse = m + log l under ``LSE_TOLERANCE`` (B2's lse limits), the
    last key tile dropped failing; m and 1/l through it."""
    import torch

    m, inv = fa.flash_row_stats(q, k)
    want = fa.row_stats_reference(q, k, lse=True)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    fault = fa.row_stats_reference(q, k[:, :keep], lse=True)
    res = hold(f"row stats lse {label}", m - torch.log(inv), want, fault, _DROPPED,
               fa.LSE_TOLERANCE)
    return res


def check_b6(fa, nolse, label, q, k, v, got):
    """B6's output against its plain version under ``nolse.TOLERANCE``, the
    last key tile dropped failing; B1 on the same inputs read against the
    same plain version (the TPU kernel's rounding point) beside it."""
    import torch

    want = nolse.flash_nolse_reference(q, k, v)
    keep = KEY_TILE * ((k.shape[1] - 1) // KEY_TILE)
    res = hold(f"B6 {label}", got, want, nolse.flash_nolse_reference(q, k[:, :keep], v[:, :keep]),
               _DROPPED, nolse.TOLERANCE)
    b1 = fa.agreement(fa.flash_attend_tokens(q, k, v), want, nolse.TOLERANCE)
    print(f"[check] B1 on the same inputs against B6's plain version: max_abs_err "
          f"{b1['max_abs_err']:.3e}, mean {b1['mean_abs_err']:.3e}, excess under B6's limits "
          f"{b1['excess']:.3f}", flush=True)
    res.update(b1_max_abs_err=b1["max_abs_err"], b1_mean_abs_err=b1["mean_abs_err"],
               b1_excess=b1["excess"])
    if q.dtype == torch.bfloat16 and not res["mean_abs_err"] <= res["b1_mean_abs_err"]:
        raise AssertionError(f"B6 {label}: its mean error exceeds B1's; it does not round "
                             "where the TPU kernel rounds")
    return res


def row_stats_bound(b, nq, nk, d, dtype_name: str, itemsize: int):
    """(bound_ms, bound_by) of the row statistics: q and k read, m and 1/l
    written (float32), against the 2*b*nq*nk*d FLOPs of q k^T."""
    nbytes = b * (nq * d + nk * d) * itemsize + 8 * b * nq
    return _bound(nbytes, 2 * b * nq * nk * d, dtype_name)


def phase_b6(torch, fa, nolse, flush):
    """Phase 10(a): B6 at the flagship's sites on random inputs, bf16 and
    fp32, against its plain version, with B1's errors and time on the same
    inputs beside it; its first pass, the row-stats kernel, held against
    its plain version and timed alone."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    rows, stats_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for site, (nq, nk, d, c) in SITES.items():
            q = (torch.randn(BATCH, nq, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            k = (torch.randn(BATCH, nk, d, device=DEVICE, generator=gen) * d ** -0.25).to(dtype)
            v = torch.randn(BATCH, nk, c, device=DEVICE, generator=gen).to(dtype)
            got = nolse.flash_nolse(q, k, v)
            label = f"{site} {dname} (random inputs)"
            row = dict(check_b6(fa, nolse, label, q, k, v, got),
                       site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            stats = check_row_stats(fa, label, q, k)
            del got
            heavy = nq * nk * (d + c) > 5e9
            iters = (3 if dtype == torch.float32 else 5) if heavy else 20
            row["ms"] = time_ms(lambda: nolse.flash_nolse(q, k, v), iters, flush)
            stats_row = dict(stats, site=site, dtype=dname, nq=nq, nk=nk, d=d, c=c)
            stats_row["ms"] = time_ms(lambda: fa.flash_row_stats(q, k), iters, flush)
            stats_row["plain_ms"] = time_ms(lambda: fa.row_stats_reference(q, k),
                                            max(iters // 4, 3), flush)
            stats_row["library_ms"], stats_row["library_backend"] = None, "none"
            stats_row["bound_ms"], stats_row["bound_by"] = row_stats_bound(
                BATCH, nq, nk, d, dname, q.element_size())
            stats_rows.append(stats_row)
            row["b1_ms"] = time_ms(lambda: fa.flash_attend_tokens(q, k, v), iters, flush)
            row["plain_ms"] = time_ms(lambda: nolse.flash_nolse_reference(q, k, v),
                                      max(iters // 4, 3), flush)
            row["library_ms"], row["library_backend"] = sdpa_yardstick(q, k, v, flush)
            # B1's function: the second QK^T pass is this kernel's design,
            # not work the function needs, and is not counted
            row["bound_ms"], row["bound_by"] = flash_bound(BATCH, nq, nk, d, c, dname,
                                                           q.element_size())
            print(f"[kernel] B6 {site} {dname} B={BATCH} Nq={nq} Nk={nk} d={d} C={c}: kernel "
                  f"{row['ms']:.4f} ms (of which the row statistics {stats_row['ms']:.4f} ms, "
                  f"bound {stats_row['bound_ms']:.4f} ms, plain {stats_row['plain_ms']:.4f} "
                  f"ms), B1 on the same inputs {row['b1_ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']} ms "
                  f"({row['library_backend']}), bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})", flush=True)
            rows.append(row)
            del q, k, v
            torch.cuda.empty_cache()
    return rows, stats_rows


def phase_bisect(torch, fa, nolse, ta, card):
    """Phase 10(b): the bisect (``scripts/bisect_infer.main``) at full width,
    batch 16: its four readings and each variant's launches per forward
    (current 3 B1, swapped 3 B6, B1 again after the swap, plain none); then
    every B6 call of one swapped forward held on the model's own tensors,
    with B1 on them beside it."""
    from sap3d_tpu_torch.scripts import bisect_infer
    from sap3d_tpu_torch.train.steps import make_eval_step

    res = bisect_infer.main(DEVICE, BATCH)
    n = len(SITES)
    want = {"current": {"B1": n, "RS": 0, "B6": 0}, "nolse": {"B1": 0, "RS": n, "B6": n},
            "after": {"B1": n, "RS": 0, "B6": 0}, "plain": {"B1": 0, "RS": 0, "B6": 0}}
    print(f"[bisect] {card}: launches per forward {res['launches']} (want {want})", flush=True)
    if res["launches"] != want:
        raise AssertionError("the bisect's forwards did not launch the kernels of their route")
    model, frames = bisect_infer.flagship(BATCH, DEVICE)
    calls = []

    def spy(q, k, v):
        o = nolse.flash_nolse(q, k, v)
        calls.append((q, k, v, o))
        return o

    with ta.forward_kernel(spy):
        make_eval_step(model)(frames)
    torch.cuda.synchronize()
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    held = {}
    for q, k, v, o in calls:
        name = names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]
        held[name] = check_b6(fa, nolse, f"{name} bf16 (in the bisect's swapped forward)",
                              q, k, v, o)
    if sorted(held) != sorted(SITES):
        raise AssertionError(f"the swapped forward reached B6 at {sorted(held)}")
    del calls, model, frames
    torch.cuda.empty_cache()
    return dict(res, held=held)


# ---- phase 11: the evaluator on the card, without files or cv2 --------------


EVAL_BATCHES = 3   # batches of 4 clips through evaluate_prediction_batches
EVAL_CLIPS = 4
# The five means of the kernel path against the plain path: |difference| <=
# EVAL_MEAN_TOL * max(1, |plain value|).  fp32, where B1 and the plain path
# differ by float32 reordering (~1e-6 of an attention output) and phase 4
# holds the whole forward to 1e-3; the ground truth is made from the plain
# path's own maps, so the metrics sit near their best values and a small
# change of the maps moves them.  The forward without attention must exceed
# it.
EVAL_MEAN_TOL = 1e-3
# The batched device metrics against the NumPy oracle on the same maps: cc,
# sim and nss to 1e-4 (float32 against float64 sums); AUC-Judd to 1e-3 (its
# tie-breaking jitter is 1e-4 on the device and 1e-7 on the host, which
# moves a fixation's rank among 10^6 pixels spread over [0, 1] by about
# 1e-4 of them); the sampled AUCs (AUC-Borji, shuffled) draw other
# negatives, 100 repetitions of n_fix draws each: their Monte-Carlo spread
# per map is about 0.3 / sqrt(100 n_fix), 2.4e-3 at the 150 fixations
# drawn here, held to 0.02.
METRIC_TOL = {"cc": 1e-4, "sim": 1e-4, "nss": 1e-4, "auc_judd": 1e-3,
              "auc_borji": 0.02, "auc_shuffled": 0.02}


def eval_truth(torch, maps, gen):
    """Densities and fixations at (1080, 960) made from ``maps`` [B, T, 112,
    112] (the plain path's own last frames): the bilinear resize plus noise,
    and the top 0.02% of each density's pixels as fixations."""
    from sap3d_tpu_torch.eval.evaluator import resize_bilinear

    b, t = maps.shape[:2]
    dens = resize_bilinear(maps.reshape(b * t, *maps.shape[2:]), (960, 1080))
    dens = (dens + 0.05 * torch.rand(dens.shape, device=DEVICE, generator=gen)).clamp(0, 1)
    cut = torch.quantile(dens[:, ::8, ::8].reshape(b * t, -1), 0.9998, dim=1)
    fix = (dens >= cut[:, None, None]).float()
    shape = (b, t, 1080, 960)
    return dens.reshape(shape).cpu().numpy(), fix.reshape(shape).cpu().numpy()


def phase_eval(torch, fa, calibrated, card):
    """Phase 11: (a) ``evaluate_prediction_batches`` with the calibrated
    flagship in fp32 (``cli eval``'s dtype) on in-memory batches: B1
    launches, the five means against the plain path's run and the forward
    without attention as the control, scored clips per second; (b) the
    batched device metrics (``score_density``, ``score_fixations``) on a
    [32, 1080, 960] stack against the NumPy oracle, frames per second of
    both."""
    import numpy as np

    from sap3d_tpu_torch.eval import metrics_np as M
    from sap3d_tpu_torch.eval.evaluator import (
        evaluate_prediction_batches,
        score_density,
        score_fixations,
    )
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    model = build_model("unet++", dtype="float32", device=DEVICE, seed=SEED)
    model.load_state_dict(calibrated)
    ev = make_eval_step(model)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    frames = [torch.randn(EVAL_CLIPS, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
              for _ in range(EVAL_BATCHES)]
    for sa in model.attention_modules():
        sa.use_kernel = False
    truth = [eval_truth(torch, ev(f)[:, -1:], gen) for f in frames]
    batches = [(f.cpu().numpy(), np.broadcast_to(d, (EVAL_CLIPS, 16, *d.shape[2:])),
                np.broadcast_to(x, (EVAL_CLIPS, 16, *x.shape[2:])))
               for f, (d, x) in zip(frames, truth)]

    def run(use_kernel):
        for sa in model.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        t0 = time.perf_counter()
        out = evaluate_prediction_batches(
            batches, lambda f: ev(torch.from_numpy(f).to(DEVICE)),
            rng=np.random.default_rng(SEED))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, fa.flash_attend_tokens.launches

    plain, plain_s, plain_launches = run(False)
    kern, kern_s, launches = run(True)
    gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
    with torch.no_grad():
        for sa in model.attention_modules():
            sa.gamma.zero_()
    no_attn, _, _ = run(False)
    del model, ev, frames, batches, truth
    torch.cuda.empty_cache()
    names = ("cc", "sim", "nss", "auc_judd", "auc_borji")
    diff = {m: abs(kern[m] - plain[m]) / max(1.0, abs(plain[m])) for m in names}
    control = {m: abs(no_attn[m] - plain[m]) / max(1.0, abs(plain[m])) for m in names}
    n_clips = EVAL_BATCHES * EVAL_CLIPS
    print(f"[eval] evaluate_prediction_batches, flagship fp32, {n_clips} clips scored at "
          f"(1080, 960): kernel path {kern}, plain path {plain}; B1 launches {launches} "
          f"(plain path {plain_launches}); scaled |kernel - plain| "
          f"{ {m: f'{v:.2e}' for m, v in diff.items()} } (limit {EVAL_MEAN_TOL:g}); no "
          f"attention {no_attn}; {n_clips / kern_s:.2f} clips/s scored (plain path "
          f"{n_clips / plain_s:.2f})  [{card}]", flush=True)
    if launches != EVAL_BATCHES * len(SITES) or plain_launches:
        raise AssertionError(f"evaluate_prediction_batches launched B1 {launches} times")
    if not all(v <= EVAL_MEAN_TOL for v in diff.values()):
        raise AssertionError("evaluation: the kernel path's means disagree with the plain path's")
    if not max(control.values()) > EVAL_MEAN_TOL:
        raise AssertionError("evaluation: the limit passes the forward without attention; void")
    res = dict(kernel=kern, plain=plain, no_attention=no_attn, scaled_diff=diff,
               clips_per_s=n_clips / kern_s, plain_clips_per_s=n_clips / plain_s,
               b1_launches=launches)

    # (b) the batched device metrics against the NumPy oracle
    rng = np.random.default_rng(SEED + 15)
    n, h, w = 32, 1080, 960
    lo = rng.random((n, h // 40, w // 40))
    pred = torch.nn.functional.interpolate(torch.from_numpy(lo)[:, None], size=(h, w),
                                           mode="bilinear")[:, 0].numpy().astype(np.float32)
    pred += 0.01 * rng.random(pred.shape, dtype=np.float32)
    gt = np.clip(pred + 0.3 * rng.random(pred.shape, dtype=np.float32), 0, None)
    fix = np.zeros((n, h, w), np.float32)
    for i in range(n):
        fix[i].flat[rng.choice(h * w, 150, replace=False)] = 1.0
    other = np.zeros((h, w), bool)
    other.flat[rng.choice(h * w, 3000, replace=False)] = True
    pool = np.flatnonzero(other)
    dev_metrics = ("cc", "sim", "nss", "auc_judd", "auc_borji", "auc_shuffled")
    generator = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = score_density(dev_metrics, pred, gt, DEVICE)
    got.update(score_fixations(dev_metrics, pred, fix, np.ones(n, bool), generator, rng,
                               DEVICE, pool=pool))
    dev_s = time.perf_counter() - t0
    host_rng = np.random.default_rng(SEED + 17)
    t0 = time.perf_counter()
    want = {"cc": [M.CC(p, g) for p, g in zip(pred, gt)],
            "sim": [M.SIM(p, g) for p, g in zip(pred, gt)],
            "nss": [M.NSS(p, f) for p, f in zip(pred, fix)],
            "auc_judd": [M.AUC_Judd(p, f, rng=host_rng) for p, f in zip(pred, fix)],
            "auc_borji": [M.AUC_Borji(p, f, rng=host_rng) for p, f in zip(pred, fix)],
            "auc_shuffled": [M.AUC_shuffled(p, f, other, rng=host_rng)
                             for p, f in zip(pred, fix)]}
    host_s = time.perf_counter() - t0
    err = {m: float(np.max(np.abs(np.asarray(got[m]) - np.asarray(want[m])))) for m in want}
    print(f"[eval] device metrics on [{n}, {h}, {w}] against the NumPy oracle, largest "
          f"|difference| per metric {({m: f'{v:.2e}' for m, v in err.items()})} (limits "
          f"{METRIC_TOL}); {n / dev_s:.2f} frames/s on the device, {n / host_s:.2f} frames/s "
          f"on the host  [{card}]", flush=True)
    if not all(err[m] <= METRIC_TOL[m] for m in want):
        raise AssertionError("the device metrics disagree with the NumPy oracle")
    return dict(res, metric_err=err, device_frames_per_s=n / dev_s,
                host_frames_per_s=n / host_s)


# ---- phase 12: reference TF checkpoints (interop/), bn_reference_quirk ------

# a TF1 Saver checkpoint and its .npz, in the checkout beside this script
TF_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                          "tf1_saver_fixture")
FLAGSHIP = "p3d_unetplusplus_ds"              # unet++
QUIRK_FRAMES = 40                             # 25 windows: the last batch of 16 is padded


def tf_named(state_dict, name: str) -> dict:
    """The TF-named dict of the port's ``state_dict`` for ``name``: the
    inverse of ``interop/tf_import``'s mapping and the flax bridge.  A torch
    conv or transposed-conv kernel ``[a, b, kd, kh, kw]`` is TF's
    ``[kd, kh, kw, b, a]``, a dense kernel transposed, the rest as is."""
    from sap3d_tpu_torch.interop.tf_import import variable_mapping

    out = {}
    for e in variable_mapping(name):
        t = state_dict[".".join(e.path)].detach().float().cpu().numpy()
        out[e.tf_name] = t.transpose(2, 3, 4, 1, 0) if t.ndim == 5 else t.T
    return out


def with_training_variables(tf_vars: dict) -> dict:
    """What a reference training checkpoint holds beside the weights: two
    Adam slots per variable, ``beta1_power``, ``beta2_power``,
    ``global_step``."""
    import numpy as np

    out = dict(tf_vars)
    for n, a in tf_vars.items():
        out[f"{n}/Adam"], out[f"{n}/Adam_1"] = np.zeros_like(a), np.ones_like(a)
    out.update(beta1_power=np.float32(0.9), beta2_power=np.float32(0.999),
               global_step=np.int64(1000))
    return out


def phase_tf_reader():
    """Phase 12(a): the committed TF1 Saver fixture read without TensorFlow,
    every tensor bit for bit against its .npz; a copy of the index with one
    magic byte flipped must raise."""
    import shutil
    import tempfile

    import numpy as np

    from sap3d_tpu_torch.interop import tf_bundle

    want = dict(np.load(os.path.join(TF_FIXTURE, "values.npz")))
    got = tf_bundle.read_checkpoint(TF_FIXTURE)
    bad = sorted(n for n in want if n not in got or got[n].dtype != want[n].dtype
                 or got[n].shape != want[n].shape or got[n].tobytes() != want[n].tobytes())
    with tempfile.TemporaryDirectory() as tmp:
        for f in os.listdir(TF_FIXTURE):
            if f.startswith("model.ckpt."):
                shutil.copy(os.path.join(TF_FIXTURE, f), tmp)
        with open(os.path.join(tmp, "model.ckpt.index"), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)[0]
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last ^ 0x01]))
        try:
            tf_bundle.read_checkpoint(os.path.join(tmp, "model.ckpt"))
            corrupt = "read without error"
        except tf_bundle.CheckpointFormatError as e:
            corrupt = f"raised: {e}"
    print(f"[tf_import] (a) {TF_FIXTURE}: {len(got)} tensors read without TensorFlow "
          f"({sorted({str(a.dtype) for a in got.values()})}), {len(want) - len(bad)} of "
          f"{len(want)} bit for bit against values.npz; the index with a magic byte "
          f"flipped {corrupt}", flush=True)
    if bad or sorted(got) != sorted(want):
        raise AssertionError(f"the TF reader disagrees with the fixture at {bad}")
    if not corrupt.startswith("raised"):
        raise AssertionError("the TF reader read an index with a bad magic")
    return dict(tensors=len(got), corrupt=corrupt)


def phase_tf_mapping(torch, calibrated):
    """Phase 12(b): the calibrated flagship's weights as a reference training
    checkpoint holds them (TF names and layouts, Adam slots, bookkeeping),
    through ``cli.model_from_tf_variables`` (the map half of
    ``--tf-checkpoint``: the quirk model on the card, mapped, validated,
    loaded strictly): every key bit for bit the original.  Planted faults,
    each of which must fail: a transposed conv's layout transform left out,
    a variable dropped."""
    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.interop import tf_import

    tf_vars = with_training_variables(tf_named(calibrated, FLAGSHIP))
    t0 = time.perf_counter()
    model = cli.model_from_tf_variables("unet++", tf_vars, "bfloat16", DEVICE)
    torch.cuda.synchronize()
    map_s = time.perf_counter() - t0
    got = model.state_dict()
    bad = sorted(k for k in calibrated if not torch.equal(got[k], calibrated[k]))
    if sorted(got) != sorted(calibrated):
        bad.append("keys")

    def fault(label, entries=None, drop=None):
        """``label``'s fault loaded: (what happened, whether it failed)."""
        mapping = tf_import.variable_mapping
        if entries is not None:
            tf_import.variable_mapping = lambda name: entries
        try:
            m = cli.model_from_tf_variables(
                "unet++", {n: a for n, a in tf_vars.items() if n != drop}, "bfloat16",
                DEVICE)
            differ = [k for k in calibrated if not torch.equal(m.state_dict()[k], calibrated[k])]
            return f"{label}: loaded, {len(differ)} keys differ", bool(differ)
        except (KeyError, ValueError) as e:
            return f"{label}: {type(e).__name__}: {str(e)[:100]}", True
        finally:
            tf_import.variable_mapping = mapping

    entries = tf_import.variable_mapping(FLAGSHIP)
    i = next(i for i, e in enumerate(entries) if e.transform == "tconv")
    no_flip = list(entries)
    no_flip[i] = dataclasses.replace(entries[i], transform="id")
    faults = [fault(f"{entries[i].tf_name} without its transform", entries=no_flip),
              fault(f"{entries[-1].tf_name} dropped", drop=entries[-1].tf_name)]
    print(f"[tf_import] (b) {FLAGSHIP} at full width: {len(entries)} TF variables (+"
          f"{len(tf_vars) - len(entries)} Adam slots and bookkeeping) -> {len(got)} tensors "
          f"in {map_s:.2f} s (map, validate, load on the card), "
          f"{len(calibrated) - len(bad)} of {len(calibrated)} bit for bit the original; "
          f"planted faults: {[f for f, _ in faults]}", flush=True)
    if bad:
        raise AssertionError(f"TF mapping round trip differs at {bad[:5]}")
    if not all(failed for _, failed in faults):
        raise AssertionError(f"a planted mapping fault passed: {faults}")
    return model, dict(variables=len(tf_vars), tensors=len(got), seconds=map_s,
                       faults=[f for f, _ in faults])


def phase_tf_quirk(torch, fa, model, calibrated, card):
    """Phase 12(c): the quirk model of (b) on the card.  (1) bf16:
    ``SlidingWindowPredictor.export_dataset`` on a 40-frame synthetic video
    (25 windows in batches of 16, the last one padded; JPEGs in and out):
    B1 launches counted (zeroed just before, read just after), each B1 call
    held on the tensors the model gave it (the last key tile dropped
    failing), the maps against the same model on the plain attention route
    (mean |difference| under ``E2E_MEAN_TOL``, phase 4's bf16 limit, which
    the maps without attention must exceed), every buffer and weight bit for
    bit the original after the runs, the maps without the quirk (the same
    weights) further than 1e-3 max|out| from them; seconds per video with
    and without the quirk, in the order quirk, without, without, quirk, and
    the eval step's ms at batch 16 (medians of 6) beside them.  (2) fp32,
    ``cli eval``'s dtype (the split-bf16 B1): one eval step of 2 clips
    (``cli eval``'s batch), 3 B1 launches, against the plain attention route
    under phase 4's fp32 limit."""
    import tempfile

    import numpy as np

    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops import attention as ta
    from sap3d_tpu_torch.train.steps import make_eval_step

    plain_bn = build_model("unet++", dtype="bfloat16", device=DEVICE, seed=SEED)
    plain_bn.load_state_dict(calibrated)

    def export(m, use_kernel, root, out, calls=None):
        """(maps, seconds, B1 launches) of ``export_dataset`` with ``m``;
        each B1 call's (q, k, v, o) appended to ``calls``."""
        for sa in m.attention_modules():
            sa.use_kernel = use_kernel

        def record(q, k, v):
            o = fa.flash_attend_tokens(q, k, v)
            calls.append((q, k, v, o))
            return o

        maps = []
        with SlidingWindowPredictor(make_eval_step(m), batch_windows=BATCH, image_size=SIZE,
                                    device=DEVICE) as pred, \
                (contextlib.nullcontext() if calls is None else ta.forward_kernel(record)):
            predict = pred.predict_video
            pred.predict_video = lambda *a, **kw: maps.append(predict(*a, **kw)) or maps[-1]
            fa.flash_attend_tokens.launches = 0
            t0 = time.perf_counter()
            n = pred.export_dataset(root, out)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = fa.flash_attend_tokens.launches
        if n != 1 or len(os.listdir(os.path.join(out, "video000"))) != QUIRK_FRAMES:
            raise AssertionError(f"export_dataset wrote {n} videos")
        return maps[0], dt, launches

    calls = []
    with tempfile.TemporaryDirectory() as tmp:
        roots = make_synthetic_dataset(os.path.join(tmp, "data"), num_videos=1,
                                       frames_per_video=QUIRK_FRAMES, size=(320, 240))
        runs = {}
        for i, (label, m) in enumerate([("quirk", model), ("without", plain_bn),
                                        ("without2", plain_bn), ("quirk2", model)]):
            runs[label] = export(m, True, roots["frame_dirs"], os.path.join(tmp, f"out{i}"),
                                 calls if i == 0 else None)
        quirk_plain, _, plain_launches = export(model, False, roots["frame_dirs"],
                                                os.path.join(tmp, "plain_route"))
        gammas = [sa.gamma.detach().clone() for sa in model.attention_modules()]
        with torch.no_grad():
            for sa in model.attention_modules():
                sa.gamma.zero_()
        no_attn = export(model, False, roots["frame_dirs"], os.path.join(tmp, "no_attn"))[0]
        with torch.no_grad():
            for sa, g in zip(model.attention_modules(), gammas):
                sa.gamma.copy_(g)
    for sa in model.attention_modules():
        sa.use_kernel = True
    names = {(nq, nk, d, c): name for name, (nq, nk, d, c) in SITES.items()}
    held = [check_b1(fa, f"{names[(q.shape[1], k.shape[1], q.shape[2], v.shape[2])]} bf16 "
                         f"(quirk predictor, call {i})", q, k, v, o)
            for i, (q, k, v, o) in enumerate(calls)]
    del calls
    x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(SEED + 19)) * 0.3
    step_ms = {label: 1e3 * float(np.median(step_times(torch, lambda: make_eval_step(m)(x),
                                                       THROUGHPUT_CALLS)))
               for label, m in (("quirk", model), ("without", plain_bn),
                                ("without2", plain_bn), ("quirk2", model))}
    del x
    quirk, _, launches = runs["quirk"]
    want_launches = -(-(QUIRK_FRAMES - 15) // BATCH) * len(SITES)
    mean16 = float(np.abs(quirk - quirk_plain).mean())
    no_attn16 = float(np.abs(no_attn - quirk_plain).mean())
    live = float(np.abs(quirk - runs["without"][0]).max())
    scale = float(np.abs(quirk).max())
    state = model.state_dict()
    same = [k for k in calibrated if torch.equal(state[k], calibrated[k])]
    secs = {label: r[1] for label, r in runs.items()}
    print(f"[tf_import] (c) quirk predictor, {QUIRK_FRAMES} frames -> {quirk.shape}, range "
          f"[{quirk.min():.4f}, {quirk.max():.4f}], B1 launches {launches} (plain route "
          f"{plain_launches}), each held on the model's tensors (excess "
          f"{max(h['excess'] for h in held):.3f} at most); kernel vs plain route mean "
          f"|diff| {mean16:.3e} (tol {E2E_MEAN_TOL:g}; no attention {no_attn16:.3e}); vs "
          f"no quirk max |diff| {live:.3e} (must exceed {1e-3 * scale:.3e}); {len(same)} of "
          f"{len(calibrated)} tensors unchanged after the runs; seconds per video, quirk "
          f"{secs['quirk']:.3f} / {secs['quirk2']:.3f}, without {secs['without']:.3f} / "
          f"{secs['without2']:.3f}; eval step ms at batch {BATCH} (median of "
          f"{THROUGHPUT_CALLS}), quirk {step_ms['quirk']:.2f} / {step_ms['quirk2']:.2f}, "
          f"without {step_ms['without']:.2f} / {step_ms['without2']:.2f}  [{card}]",
          flush=True)
    if not (quirk.shape == (QUIRK_FRAMES, SIZE, SIZE) and np.isfinite(quirk).all()):
        raise AssertionError("quirk predictor: wrong shape or non-finite maps")
    if launches != want_launches or runs["quirk2"][2] != want_launches or plain_launches \
            or len(held) != want_launches:
        raise AssertionError(f"expected {want_launches} B1 launches in the quirk predictor "
                             f"run, got {launches}")
    if not mean16 <= E2E_MEAN_TOL:
        raise AssertionError("quirk predictor: kernel route disagrees with the plain route")
    if not no_attn16 > E2E_MEAN_TOL:
        raise AssertionError("quirk predictor: the limit passes the maps without attention; "
                             "the check is void")
    if len(same) != len(calibrated):
        raise AssertionError("the quirk forward moved a buffer or a weight")
    if not live > 1e-3 * scale:
        raise AssertionError("the quirk's maps equal the maps without it: the quirk is dead")
    del plain_bn
    torch.cuda.empty_cache()

    # (2) fp32, cli eval's dtype and batch
    model32 = cli.model_from_tf_variables("unet++", tf_named(calibrated, FLAGSHIP),
                                          "float32", DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    x = torch.randn(2, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
    ev = make_eval_step(model32)
    outs, counts = {}, {}
    for use_kernel in (False, True):
        for sa in model32.attention_modules():
            sa.use_kernel = use_kernel
        fa.flash_attend_tokens.launches = 0
        outs[use_kernel] = ev(x)
        torch.cuda.synchronize()
        counts[use_kernel] = fa.flash_attend_tokens.launches
    err32 = (outs[True] - outs[False]).abs().max().item()
    print(f"[tf_import] (c) quirk eval step fp32, 2 clips: B1 launches {counts[True]} (plain "
          f"route {counts[False]}); kernel vs plain route max |diff| {err32:.3e} "
          f"(tol 1e-3)", flush=True)
    if counts[True] != len(SITES) or counts[False] or not err32 <= 1e-3:
        raise AssertionError("fp32 quirk eval step: launches or kernel route off")
    del model32, ev, outs
    torch.cuda.empty_cache()
    return dict(b1_launches=launches, b1_launches_fp32=counts[True], held=held,
                mean_abs_err=mean16, no_attention_mean_abs_err=no_attn16,
                no_quirk_max_abs_diff=live, fp32_max_abs_err=err32, seconds_per_video=secs,
                eval_step_ms=step_ms)


# ---- phase 13: data parallel over a data mesh (core/mesh.launch) -------------

# (a) one step at a global batch of 16 in fp32 (8 rows a rank) and of 4 in
# float64 (2 rows a rank); (b) Trainer.fit in bf16 at a global batch of 16;
# (c) cli eval's route at 4 clips a batch
DP_STEP_BATCH = {"float32": 16, "float64": 4}
DP_FIT_BATCH = 16
DP_EVAL_BATCH = 4
DP_EVAL_FRAMES = 40           # one synthetic JPEG video: 14 clips, 3 batches of 4
DP_TIMED_STEPS = 3
# (a)'s limits of the float64 data-parallel step (the plain path: no kernel
# takes float64) against the one-process step at the global batch of 4
# (dropout 0, cuDNN's deterministic algorithms): the loss (relative), the
# whole summed gradient (relative L2), each BN buffer (largest |difference|
# over the tensor's largest value).  The two differ in summation order only
# (the ranks' BN statistics are flax's sums of x and x^2, one process takes
# the batch-norm call's; each rank convolves its own rows; the gradient is
# summed over ranks) and in the head's float32 output, whose rounding flips
# where the sums differ: the gradient read 1.1e-6 on an H100 (PERF.md, PR
# 11).  Averaged gradients, and per-rank BN statistics on halves that
# differ (rank 1's frames x3 + 1), must fail.  The same comparison in fp32
# is read, not held: the random 47-block network in train mode carries a
# forward difference at float32 rounding to an O(1) change of the gradient
# (the data-parallel fp32 gradient read 1.28 from one process's at a batch
# of 16, the one-process fp32 gradient 0.82 from the float64 one at 4, two
# one-process runs 6e-6 apart).  The fp32 step holds instead each B2 and B3
# call on each rank's own tensors against the plain versions, as phase 6(b).
DP_TOL = {"loss": 1e-7, "grad": 1e-4, "buffer": 1e-7}
# (c)'s limit on the five means of cli eval's data-parallel route against the
# one-device route (|difference| scaled as phase 11's): the quirk's statistics
# over 4 clips are summed in another order on each route, and the forward
# carries that into the maps: 1.09e-3 read on an H100 (AUC-Borji), where the
# route with per-rank statistics read 7.46e-3 (CC).
DP_EVAL_TOL = 3e-3


def dp_site_name(names: dict, q, k, v) -> str:
    """A site's name from its (Nq, Nk, d, C), or the shape itself."""
    shape = (q.shape[1], k.shape[1], q.shape[2], v.shape[2])
    return names.get(shape, "x".join(map(str, shape)))


def dp_flat_grad(torch, model):
    return torch.cat([p.grad.flatten() for p in model.parameters()])


def dp_bn_buffers(model) -> dict:
    from sap3d_tpu_torch.ops.layers import BatchNorm

    return {f"{n}.{b}": getattr(m, b).detach().clone()
            for n, m in model.named_modules() if isinstance(m, BatchNorm)
            for b in ("mean", "var")}


def bit_sums(torch, tensors):
    """Two integer sums of the bits of each tensor (plain, and weighted by
    position), stacked."""
    sums = []
    for t in tensors:
        bits = t.detach().contiguous().flatten()
        bits = bits.view({8: torch.int64, 4: torch.int32, 2: torch.int16}[
            bits.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 8191 + 1
        sums += [bits.sum(), (bits * weight).sum()]
    return torch.stack(sums)


def agree_bitwise(torch, group, tensors) -> tuple[bool, list[int]]:
    """``bit_sums`` all-reduced over ``group``: equal to its size times
    this rank's own on every rank exactly when the ranks agree bit for bit.
    Returns (agree, this rank's sums)."""
    own = bit_sums(torch, tensors)
    total = group.all_reduce(own.clone())
    return bool(torch.equal(total, own * group.world_size)), own.tolist()


@contextlib.contextmanager
def counted_all_reduces(counts: list):
    """Count ``torch.distributed.all_reduce`` calls (the DataGroup's) into
    ``counts[0]`` for the duration."""
    import torch.distributed as dist

    orig = dist.all_reduce

    def counting(*args, **kwargs):
        counts[0] += 1
        return orig(*args, **kwargs)

    dist.all_reduce = counting
    try:
        yield
    finally:
        dist.all_reduce = orig


def state_bytes(state) -> int:
    """Bytes of a train state's parameters, their gradients and their Adam
    moments, as this rank holds them."""
    total = 0
    for p in state.model.parameters():
        held = [p] + ([p.grad] if p.grad is not None else []) + [
            v for k, v in state.optimizer.state.get(p, {}).items() if k != "step"]
        total += sum(t.numel() * t.element_size() for t in held)
    return total


def dp_rank(group, spec: dict) -> dict:
    """One rank of phase 13 (the spec names the model, the files the parent
    wrote and the sizes).  (a) the fp32 data-parallel step, on rank 0 beside
    the one-process step at the global batch; (b) Trainer.fit in bf16, the
    bit-identity of the ranks and a restore; (d) collectives and ms per
    step; (c) cli eval's data-parallel route, rank 0 beside the
    one-device route."""
    import argparse

    import numpy as np
    import torch

    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.core.config import Config, DataConfig, ModelConfig, TrainConfig
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
    from sap3d_tpu_torch.ops.layers import BatchNorm, set_data_group
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import gradient_buckets, make_train_step
    from sap3d_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, main = group.device, group.is_main
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    out = {"rank": group.rank, "device": str(dev), "backend": group.backend}
    weights = torch.load(spec["weights"], map_location=dev, weights_only=True)
    data = np.load(spec["inputs"])
    frames, targets, skewed = data["frames"], data["targets"], data["skewed"]

    # (a) one step in fp32 and in float64: data parallel, and on rank 0 one
    # process at the global batch
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def step_once(dtype, x, parallel=True, global_bn=True):
        m = build_model(spec["model"], dtype=dtype, device=dev, dropout_rate=0.0)
        m.load_state_dict(weights)
        if dtype == torch.float64:
            m.double()
        step = make_train_step(create_train_state(m, lr=1e-4), group if parallel else None)
        if not global_bn:
            set_data_group(m, None)
        b = x.shape[0] // group.world_size if parallel else x.shape[0]
        rows = slice(group.rank * b, (group.rank + 1) * b) if parallel else slice(None)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev, dtype)

        reset_launch_counts(*B1_B4)
        loss = step(put(x), put(targets[:x.shape[0]]))
        sync()
        res = dict(loss=loss.item(), grad=dp_flat_grad(torch, m), buffers=dp_bn_buffers(m),
                   launches=launch_counts(*B1_B4))
        del m
        return res

    def rel(a, b_):
        return (a.double() - b_.double()).norm().item() / b_.double().norm().item()

    def buffer_excess(got, want):
        return max(((got[k].double() - w.double()).abs().max() / w.double().abs().max()).item()
                   for k, w in want.items())

    def compare(dp, ref):
        return dict(loss=dp["loss"], one_process_loss=ref["loss"],
                    loss_rel=abs(dp["loss"] - ref["loss"]) / abs(ref["loss"]),
                    grad_rel_l2=rel(dp["grad"], ref["grad"]),
                    buffer_excess=buffer_excess(dp["buffers"], ref["buffers"]),
                    control_averaged_grad_rel_l2=rel(dp["grad"] / group.world_size,
                                                     ref["grad"]))

    f32 = frames[:spec["step_batch"]["float32"]]
    f64 = frames[:spec["step_batch"]["float64"]]
    calls = {"B2": [], "B3": []}

    def spy_forward(q, k, v):
        o, lse = fa.flash_forward_lse(q, k, v)
        calls["B2"].append((q, k, v, o, lse))
        return o, lse

    def spy_backward(q, k, v, o, lse, do):
        out = fb.flash_backward(q, k, v, o, lse, do)
        calls["B3"].append((q, k, v, o, lse, do, out))
        return out

    with function_calls(spy_forward, spy_backward):
        dp32 = step_once(torch.float32, f32)
    out["step_launches"] = dp32["launches"]
    # each rank in turn holds its step's kernel calls on its own tensors
    names = {shape: name for name, shape in SITES.items()}
    held = {}
    for r in range(group.world_size):
        if r == group.rank:
            for q, k, v, o, lse in calls["B2"]:
                site = dp_site_name(names, q, k, v)
                held[f"B2 {site}"] = check_b2(
                    fa, f"{site} fp32 (rank {r} of the data-parallel step)",
                    q, k, v, o, lse)["max_abs_err"]
            for q, k, v, o, lse, do, got in calls["B3"]:
                site = dp_site_name(names, q, k, v)
                held[f"B3 {site}"] = check_b3(
                    fb, f"{site} fp32 (rank {r} of the data-parallel step)",
                    q, k, v, o, lse, do, got)["max_abs_err"]
            calls.clear()
            if on_card:
                torch.cuda.empty_cache()
        group.barrier()
    out["held"] = held
    dp64 = step_once(torch.float64, f64)
    dp64_skewed = step_once(torch.float64, skewed)
    per_rank_bn = step_once(torch.float64, skewed, global_bn=False)
    if main:
        ones = [step_once(torch.float32, f32, parallel=False) for _ in range(2)]
        out["a32"] = dict(compare(dp32, ones[0]), floor_grad_rel_l2=rel(ones[1]["grad"],
                                                                        ones[0]["grad"]),
                          one_process_launches=ones[0]["launches"])
        del ones
        ones = [step_once(torch.float64, f64, parallel=False) for _ in range(2)]
        one_skewed = step_once(torch.float64, skewed, parallel=False)
        one32_small = step_once(torch.float32, f64, parallel=False)
        skew = compare(dp64_skewed, one_skewed)
        out["a64"] = dict(
            compare(dp64, ones[0]), floor_grad_rel_l2=rel(ones[1]["grad"], ones[0]["grad"]),
            skewed_grad_rel_l2=skew["grad_rel_l2"], skewed_loss_rel=skew["loss_rel"],
            skewed_buffer_excess=skew["buffer_excess"],
            control_per_rank_bn_grad_rel_l2=rel(per_rank_bn["grad"], one_skewed["grad"]),
            fp32_one_process_vs_float64=rel(one32_small["grad"], ones[0]["grad"]))
        del ones, one_skewed, one32_small
    del dp32, dp64, dp64_skewed, per_rank_bn
    torch.backends.cudnn.deterministic = False
    group.barrier()
    if on_card:
        torch.cuda.empty_cache()

    # (b) Trainer.fit in bf16, 3 steps, a validation pass and checkpoints
    rng = np.random.default_rng(SEED + 30)
    shape = (spec["fit_batch"], 16, spec["size"], spec["size"], 3)

    def global_batch():
        return ((rng.normal(size=shape) * 0.3).astype(np.float32),
                rng.uniform(size=shape[:4]).astype(np.float32))

    train = [global_batch() for _ in range(TRAIN_STEPS)]
    valid = [global_batch()]
    fit_rows = slice(group.rank * shape[0] // group.world_size,
                    (group.rank + 1) * shape[0] // group.world_size)
    mine = [(f[fit_rows], t[fit_rows]) for f, t in train]
    mine_valid = [(f[fit_rows], t[fit_rows]) for f, t in valid]
    cfg = Config(model=ModelConfig(name=spec["model"], dtype="bfloat16", dropout=0.5),
                 train=TrainConfig(batch_size=shape[0], lr=1e-4, valid_iter=2, save_iter=2,
                                   max_steps=TRAIN_STEPS, seed=SEED, info="smoke_dp",
                                   num_devices=group.world_size,
                                   model_dir=os.path.join(spec["root"], "model"),
                                   logs_dir=os.path.join(spec["root"], "logs")))
    trainer = Trainer(cfg, run="smoke_dp", group=group)
    trainer.model.load_state_dict(weights)  # calibrated BN, gamma; the same on every rank
    reset_launch_counts(*B1_B4)
    t0 = time.perf_counter()
    trainer.fit(iter(mine), lambda: iter(mine_valid))
    if main:
        trainer.ckpt.wait_until_finished()
    sync()
    group.barrier()
    fit_s = time.perf_counter() - t0
    fit_launches = launch_counts(*B1_B4)
    agree, sums = agree_bitwise(torch, group, trainer.model.state_dict().values())
    final = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.close()
    del trainer
    resumed = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, pretrain="smoke_dp",
                                                            max_steps=TRAIN_STEPS + 1)),
                      run="smoke_dp", group=group)
    restored = resumed.state.step == TRAIN_STEPS and all(
        torch.equal(resumed.model.state_dict()[k], v) for k, v in final.items())
    out["b"] = dict(seconds=fit_s, launches=fit_launches, checksums_agree=agree,
                    checksums=sums, restored=restored,
                    checkpoints=checkpoint_steps(resumed.model_dir) if main else None)
    del final

    # (d) collectives per step and ms per step (bf16, this rank's rows)
    f, t = (torch.from_numpy(a).to(dev) for a in mine[0])
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    resumed.train_step(f, t, gen)
    counts, ran = [0], []
    hooks = [m.register_forward_hook(lambda mod, i, o: ran.append(mod))
             for m in resumed.model.modules() if isinstance(m, BatchNorm)]
    with counted_all_reduces(counts):
        resumed.train_step(f, t, gen)
        sync()
    for h in hooks:
        h.remove()
    times = []
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(DP_TIMED_STEPS):
        group.barrier()
        t0 = time.perf_counter()
        resumed.train_step(f, t, gen)
        sync()
        times.append(time.perf_counter() - t0)
    out["d"] = dict(all_reduces=counts[0], bn_layers=len(ran),
                    bn_modules=sum(isinstance(m, BatchNorm) for m in resumed.model.modules()),
                    gradient_buckets=len(gradient_buckets(resumed.model.parameters())),
                    parameters=sum(p.numel() for p in resumed.model.parameters()),
                    state_bytes=state_bytes(resumed.state),
                    peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else None,
                    step_ms=[1e3 * s for s in times])
    resumed.close()
    del resumed, f, t
    if on_card:
        torch.cuda.empty_cache()
    group.barrier()

    # (c) cli eval's data-parallel route with --bn-quirk, fp32; the control:
    # the same route with each rank's statistics its own
    from sap3d_tpu_torch.ops import layers

    args = argparse.Namespace(structure=spec["model"], dtype="float32", bn_quirk=True,
                              batch=spec["eval_batch"], model_dir=spec["root"])
    data_cfg = DataConfig(image_size=spec["size"], num_threads=4)
    runs = [(os.path.basename(spec["weights"]), None)]
    fa.flash_attend_tokens.launches = 0
    got = cli._evaluate_runs(group, args, data_cfg, spec["clips"], runs, None)
    sync()
    out["c_launches"] = fa.flash_attend_tokens.launches
    keep, layers.set_data_group = layers.set_data_group, lambda model, group: None
    try:
        per_rank = cli._evaluate_runs(group, args, data_cfg, spec["clips"], runs, None)
    finally:
        layers.set_data_group = keep
    if main:
        fa.flash_attend_tokens.launches = 0
        want = cli._evaluate_runs(None, args, data_cfg, spec["clips"], runs, dev)
        out["c"] = dict(data_parallel=got[0][runs[0][0]], one_device=want[0][runs[0][0]],
                        per_rank_statistics=per_rank[0][runs[0][0]],
                        one_device_launches=fa.flash_attend_tokens.launches)
    group.barrier()
    return out


def phase_data_parallel(torch, calibrated, card, mesh=None, model="unet++"):
    """Phase 13: two ranks of a data mesh (default: cuda:0 twice, over
    gloo) through ``core/mesh.launch``, each running ``dp_rank``; the
    parent writes the calibrated weights, the step's inputs and a
    synthetic JPEG video, then holds what the ranks read."""
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.mesh import data_backend, launch, make_mesh
    from sap3d_tpu_torch.data.indexer import ClipIndex
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    mesh = mesh or make_mesh(2, devices=[DEVICE] * 2)
    backend = data_backend(mesh)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_dp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        weights = os.path.join(root, f"{model}_calibrated.pt")
        torch.save({k: v.cpu() for k, v in calibrated.items()}, weights)
        rng = np.random.default_rng(SEED + 29)
        shape = (max(DP_STEP_BATCH.values()), 16, SIZE, SIZE, 3)
        frames = (rng.normal(size=shape) * 0.3).astype(np.float32)
        n64 = DP_STEP_BATCH["float64"]
        skewed = frames[:n64].copy()
        skewed[n64 // 2:] = 3.0 * skewed[n64 // 2:] + 1.0  # rank 1's rows
        inputs = os.path.join(root, "inputs.npz")
        np.savez(inputs, frames=frames, skewed=skewed,
                 targets=rng.uniform(size=shape[:4]).astype(np.float32))
        video = make_synthetic_dataset(os.path.join(root, "data"), num_videos=1,
                                       frames_per_video=DP_EVAL_FRAMES, with_fixations=True)
        clips = ClipIndex([video["frame_dirs"]], [video["density_dirs"]],
                          fixation_dir=video["fixation_dir"]).setup(
            overlap=15, training_props=0.0).valid_clips(with_fixations=True)
        spec = dict(model=model, size=SIZE, weights=weights, inputs=inputs, clips=clips,
                    root=root, step_batch=DP_STEP_BATCH, fit_batch=DP_FIT_BATCH,
                    eval_batch=DP_EVAL_BATCH)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(mesh, dp_rank, spec)
        launch_s = time.perf_counter() - t0
        with open(os.path.join(root, "logs", "smoke_dp", "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        logs = sorted(os.listdir(os.path.join(root, "logs")))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    r0 = ranks[0]
    a32, a64, b0, c, d = r0["a32"], r0["a64"], r0["b"], r0["c"], r0["d"]
    where = f"2 ranks on {', '.join(str(x) for x in mesh.devices)} over {backend}"
    print(f"[dp] {where}: one launch in {launch_s:.2f} s (spawn, the phases and the "
          f"teardown)  [{card}]", flush=True)
    tol = DP_TOL
    print(f"[dp] (a) one float64 step at a global batch of {DP_STEP_BATCH['float64']} against "
          f"one process: loss {a64['loss']:.6f} vs {a64['one_process_loss']:.6f} (relative "
          f"{a64['loss_rel']:.3e}, limit {tol['loss']:g}); summed gradient relative L2 "
          f"{a64['grad_rel_l2']:.3e} (limit {tol['grad']:g}; two one-process runs "
          f"{a64['floor_grad_rel_l2']:.3e}); BN buffers {a64['buffer_excess']:.3e} (limit "
          f"{tol['buffer']:g}); halves that differ (rank 1's frames x3 + 1): loss "
          f"{a64['skewed_loss_rel']:.3e}, gradient {a64['skewed_grad_rel_l2']:.3e}, buffers "
          f"{a64['skewed_buffer_excess']:.3e}; controls: averaged gradients "
          f"{a64['control_averaged_grad_rel_l2']:.3e}, per-rank BN statistics "
          f"{a64['control_per_rank_bn_grad_rel_l2']:.3e}", flush=True)
    print(f"[dp] (a) one fp32 step at a global batch of {DP_STEP_BATCH['float32']}: B2 and B3 "
          f"held on each rank's tensors, max |err| "
          f"{[{k: f'{v:.2e}' for k, v in r['held'].items()} for r in ranks]}; launches per "
          f"rank {[r['step_launches'] for r in ranks]} (one process "
          f"{a32['one_process_launches']}); read, not held: against one process, loss "
          f"{a32['loss_rel']:.3e}, gradient {a32['grad_rel_l2']:.3e} (two one-process runs "
          f"{a32['floor_grad_rel_l2']:.3e}), buffers {a32['buffer_excess']:.3e}; the "
          f"one-process fp32 gradient at {DP_STEP_BATCH['float64']} against the float64 one "
          f"{a64['fp32_one_process_vs_float64']:.3e}", flush=True)
    losses = [r["loss"] for r in records if "loss" in r]
    valid = [r for r in records if "cc" in r]
    print(f"[dp] (b) Trainer.fit bf16 at a global batch of {DP_FIT_BATCH}: {TRAIN_STEPS} steps "
          f"in {b0['seconds']:.2f} s, global losses {[round(v, 3) for v in losses]}, "
          f"validation {valid}, log directories {logs}, checkpoints {b0['checkpoints']}; "
          f"launches per rank {[r['b']['launches'] for r in ranks]}; parameters and buffers "
          f"bit-identical across ranks (checksums over all_reduce): "
          f"{[r['b']['checksums_agree'] for r in ranks]}; restored exactly into a fresh "
          f"data-parallel trainer: {[r['b']['restored'] for r in ranks]}", flush=True)
    names = ("cc", "sim", "nss", "auc_judd", "auc_borji")

    def scaled(route):
        return {m: abs(c[route][m] - c["one_device"][m]) / max(1.0, abs(c["one_device"][m]))
                for m in names}

    diff, control = scaled("data_parallel"), scaled("per_rank_statistics")
    print(f"[dp] (c) cli eval's data-parallel route, --bn-quirk, fp32, {DP_EVAL_BATCH} clips a "
          f"batch: {c['data_parallel']} against one device {c['one_device']}; scaled "
          f"|difference| { {m: f'{v:.2e}' for m, v in diff.items()} } (limit "
          f"{DP_EVAL_TOL:g}); control, per-rank statistics "
          f"{ {m: f'{v:.2e}' for m, v in control.items()} }; B1 launches per rank "
          f"{[r['c_launches'] for r in ranks]} (one device {c['one_device_launches']})",
          flush=True)
    expected = 2 * d["bn_layers"] + d["gradient_buckets"] + 1
    print(f"[dp] (d) one bf16 step of {DP_FIT_BATCH // len(ranks)} rows a rank: "
          f"{d['all_reduces']} all-reduces counted ({d['bn_layers']} BN layers ran, of "
          f"{d['bn_modules']}, forward and backward, {d['gradient_buckets']} gradient buckets "
          f"of {d['parameters']} "
          f"parameters, the loss: {expected}); ms per step "
          f"{[round(v, 2) for v in d['step_ms']]}, median "
          f"{sorted(d['step_ms'])[len(d['step_ms']) // 2]:.2f}; per rank "
          f"{d['state_bytes'] / 1e9:.3f} GB of parameters, gradients and Adam moments, peak "
          f"{d['peak_gib']} GiB.  Over {backend}"
          + (" on one card every reduction goes through the host: these times measure the "
             "mechanism, not the scaling" if backend == "gloo" else "") + f"  [{card}]",
          flush=True)

    on_card = all(x.type == "cuda" for x in mesh.devices)
    n_sites = len(SITES)
    if not (a64["loss_rel"] <= tol["loss"] and a64["grad_rel_l2"] <= tol["grad"]
            and a64["buffer_excess"] <= tol["buffer"] and a64["skewed_loss_rel"] <= tol["loss"]
            and a64["skewed_grad_rel_l2"] <= tol["grad"]
            and a64["skewed_buffer_excess"] <= tol["buffer"]):
        raise AssertionError("the data-parallel float64 step disagrees with one process")
    if not (a64["control_averaged_grad_rel_l2"] > tol["grad"]
            and a64["control_per_rank_bn_grad_rel_l2"] > tol["grad"]):
        raise AssertionError("the data-parallel limits pass a control; void")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)) or len(valid) != 1 \
            or logs != ["smoke_dp"] or b0["checkpoints"] != [2, TRAIN_STEPS]:
        raise AssertionError("Trainer.fit on the data mesh: losses, validation, logs or "
                             "checkpoints off")
    if not all(r["b"]["checksums_agree"] and r["b"]["restored"] for r in ranks) \
            or len({tuple(r["b"]["checksums"]) for r in ranks}) != 1:
        raise AssertionError("the ranks' states differ, or the restore is not exact")
    if not all(v <= DP_EVAL_TOL for v in diff.values()) or c["data_parallel"]["n"] != \
            c["one_device"]["n"]:
        raise AssertionError("cli eval's data-parallel route disagrees with one device")
    if not max(control.values()) > DP_EVAL_TOL:
        raise AssertionError("cli eval's limit passes per-rank statistics; void")
    if d["all_reduces"] != expected:
        raise AssertionError(f"{d['all_reduces']} all-reduces in a step, not {expected}")
    if on_card:
        step = {"B1": 0, "B2": n_sites, "B3": n_sites, "B4": 0}
        if not all(r["step_launches"] == step for r in ranks) \
                or a32["one_process_launches"] != step:
            raise AssertionError(f"launches per data-parallel step: expected {step}")
        if not all(len(r["held"]) == 2 * n_sites for r in ranks):
            raise AssertionError("not every B2 and B3 call of the data-parallel step was held")
        if not all(r["b"]["launches"]["B2"] == n_sites * TRAIN_STEPS
                   and r["b"]["launches"]["B3"] == n_sites * TRAIN_STEPS for r in ranks):
            raise AssertionError("Trainer.fit on the data mesh: B2/B3 launches off")
        if not (c["one_device_launches"] > 0
                and all(r["c_launches"] == c["one_device_launches"] for r in ranks)):
            raise AssertionError("cli eval's data-parallel route: B1 launches off")
    return dict(backend=backend, devices=[str(x) for x in mesh.devices], a32=a32, a64=a64,
                fit=dict(b0, losses=losses, validation=valid[0],
                         launches=[r["b"]["launches"] for r in ranks]),
                evaluation=dict(c, scaled_diff=diff, control_scaled_diff=control,
                                launches=[r["c_launches"] for r in ranks]),
                collectives=d, step_launches=[r["step_launches"] for r in ranks],
                held=[r["held"] for r in ranks],
                seconds=launch_s)


# ---- phase 14: multi-host training on one card (cli train --distributed) ----

MH_MODEL = "unet++"          # the flagship, p3d_unetplusplus_ds
MH_BATCH = 4                 # the global batch: 2 clips a rank
MH_STEPS = 3
MH_PROFILE_STEP = 2          # the step (a) traces
MH_FAULT_TIMEOUT_S = 5.0     # (d)'s rendezvous timeout
MH_RUN_TIMEOUT_S = 600       # each process of (a)
# The parameters upstream of the encoder's pool1, max_pool3d over (2, 3, 3)
# windows at stride (2, 2, 2): its windows overlap, so its backward adds
# several gradients into one input element in the order the threads run
# (it has no deterministic version).  Two runs of one step agree bit for bit
# everywhere else (4 runs of (a) and (b) on an H100); these parameters'
# gradients, and Adam's moments of them, may differ.
MH_POOL1_UPSTREAM = ("encoder.stem.", "encoder.stem_norm.")
# Two sound runs, held after step 1 on each tensor of MH_POOL1_UPSTREAM
# (relative L2: the pool1 backward's order) and at each later step on the
# loss (|difference| over the loss's fall since step 1: from step 2 every
# parameter follows the stem's difference).  Three runs of (b) and (a) on
# an H100 read at most 1.684e-3 and 2.490e-3 in their six pairs (PERF.md,
# PR 12); averaged gradients fail the first (Adam's moments of the stem
# half and quarter: 0.75), a rank that never steps the second (0.55).
MH_STEM_TOL = 1e-2
MH_LATER_LOSS_TOL = 2e-2
# Where ``mh_counted_train`` writes its rank's launch counts and backend,
# and the directory it traces step MH_PROFILE_STEP into when set
# (environment variables, which the ranks a launcher spawns inherit).
MH_COUNTS_ENV = "CHIP_SMOKE_LAUNCH_COUNTS"
MH_TRACE_ENV = "CHIP_SMOKE_TRACE_DIR"
# Device events of a torch.profiler Chrome trace.
DEVICE_EVENTS = ("kernel", "gpu_memcpy", "gpu_memset")


def mh_counted_train(group, cfg, *args) -> None:
    """``cli._train`` as one rank of a data mesh, its B1-B4 launch counts
    set to 0 just before and written just after, with the backend its group
    took, to ``$CHIP_SMOKE_LAUNCH_COUNTS/rank<r>.json`` (a counter in a
    child process is invisible to the process that started it); with
    ``$CHIP_SMOKE_TRACE_DIR``, step ``MH_PROFILE_STEP`` traced there
    (``TrainConfig.profile_dir``)."""
    import torch

    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb

    if os.environ.get(MH_TRACE_ENV):
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, profile_dir=os.environ[MH_TRACE_ENV], profile_start=MH_PROFILE_STEP,
            profile_steps=1))
    reset_launch_counts(*B1_B4)
    cli._train(group, cfg, *args)
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)
    with open(os.path.join(os.environ[MH_COUNTS_ENV], f"rank{group.rank}.json"), "w") as f:
        json.dump(dict(launches=launch_counts(*B1_B4), backend=group.backend,
                       world_size=group.world_size), f)


def mh_stalled_train(group, *args) -> None:
    """``mh_counted_train`` with a planted fault: rank 1 never applies an
    update (Adam's step does nothing in its process), so its state stays
    the initial one while rank 0's, and rank 0's checkpoints, are right."""
    import torch

    if group.rank == 1:
        torch.optim.Adam.step = lambda self, closure=None: None
    mh_counted_train(group, *args)


def counted_cli(argv) -> int:
    """``python -m sap3d_tpu_torch.cli <argv>`` with each rank's launches
    counted (``mh_counted_train`` in place of ``cli._train``, pickled to the
    ranks by this script's path)."""
    from sap3d_tpu_torch import cli

    cli._train = mh_counted_train
    return cli.main(argv)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def device_busy(trace_path: str) -> dict:
    """The device-busy share of a rank's Chrome trace: the union of its
    kernels, copies and sets over the whole traced window, and over the
    ``train_step`` range (its start to the end of the last device event
    that starts inside it)."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if "dur" in e and "ts" in e]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in DEVICE_EVENTS)
    (step,) = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name", "").startswith("train_step ")]

    def busy(lo, hi):
        total, end = 0.0, lo
        for a, b in device:
            a, b = max(a, end), min(b, hi)
            if b > a:
                total, end = total + b - a, b
        return total

    window = (min(e["ts"] for e in events), max(e["ts"] + e["dur"] for e in events))
    s0 = step["ts"]
    s1 = max([s0 + step["dur"], *(b for a, b in device if s0 <= a <= s0 + step["dur"])])
    return dict(kernels=len(device), window_ms=(window[1] - window[0]) / 1e3,
                window_busy=busy(*window) / (window[1] - window[0]),
                step_ms=(s1 - s0) / 1e3, step_busy=busy(s0, s1) / (s1 - s0))


def checkpoint_tensors(torch, tree, prefix: str = "") -> dict:
    """Every tensor of a checkpoint (model, Adam state) by its path."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else \
        enumerate(tree) if isinstance(tree, (list, tuple)) else ()
    return {k: v for key, sub in items
            for k, v in checkpoint_tensors(torch, sub, f"{prefix}/{key}").items()}


def mh_run(torch, workdir: str, counts_dir: str) -> dict:
    """A finished run: its global losses by step and clips/s (rank 0's
    metrics.jsonl), its run, log and checkpoint names, the tensors by path
    of its first checkpoint (after step 1) and of its last, and each rank's
    launch counts and backend."""
    runs = sorted(os.listdir(os.path.join(workdir, "model")))
    logs = sorted(os.listdir(os.path.join(workdir, "logs")))
    with open(os.path.join(workdir, "logs", logs[0], "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f if '"loss"' in line]
    ckpts = sorted(os.listdir(os.path.join(workdir, "model", runs[0])),
                   key=lambda c: int(c[len("ckpt_"):-len(".pt")]))

    def tensors(ckpt):
        return checkpoint_tensors(torch, torch.load(
            os.path.join(workdir, "model", runs[0], ckpt), map_location="cpu",
            weights_only=False))

    ranks = []
    for r in range(2):
        with open(os.path.join(counts_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return dict(runs=runs, logs=logs, checkpoints=ckpts,
                counts=[r["launches"] for r in ranks],
                backends=[(r["backend"], r["world_size"]) for r in ranks],
                first=tensors(ckpts[0]), tensors=tensors(ckpts[-1]),
                losses=[(r["step"], r["loss"]) for r in records],
                clips_per_sec={r["step"]: r["clips_per_sec"] for r in records})


def mh_upstream(torch, tensors: dict) -> set:
    """The paths of a checkpoint's tensors that belong to the parameters
    upstream of pool1 (``MH_POOL1_UPSTREAM``: the parameter, its buffers,
    Adam's state of it).  Adam's state is indexed by parameter in the
    model's order (one parameter group: ``--weight-decay`` 0)."""
    from sap3d_tpu_torch.models.registry import build_model

    names = [n for n, _ in build_model(MH_MODEL, dtype="bfloat16",
                                       device="meta").named_parameters()]
    upstream = {n for n in tensors if n.startswith("/model/")
                and n[len("/model/"):].startswith(MH_POOL1_UPSTREAM)}
    return upstream | {n for n in tensors if n.startswith("/optimizer/state/")
                       and names[int(n.split("/")[3])].startswith(MH_POOL1_UPSTREAM)}


def averaged_gradients(torch, tensors: dict) -> dict:
    """A checkpoint after step 1 as averaged gradients (the sum over the 2
    ranks halved) would have made it: Adam's first moments are linear in the
    gradient and halve, its second quadratic and quarter, exactly (powers of
    2); the parameters move as before (Adam's update is scale-free)."""
    scale = {"exp_avg": 0.5, "exp_avg_sq": 0.25}
    return {n: t * scale[n.rsplit("/", 1)[1]]
            if n.startswith("/optimizer/state/") and n.rsplit("/", 1)[1] in scale else t
            for n, t in tensors.items()}


def mh_hold(torch, x: dict, y: dict, upstream: set, first=None) -> dict:
    """Run ``x`` against run ``y`` (``mh_run``), with ``first`` in place of
    ``x``'s checkpoint after step 1 if given: step 1's loss bit for bit;
    the tensors after step 1 that are not bit for bit equal, outside
    ``upstream`` and in it; the largest relative L2 of an ``upstream``
    tensor; each later loss's |difference| over ``y``'s fall since step 1;
    after the last step, the parameters' relative L2 and the largest
    |difference| of any tensor; whether it is held (``MH_STEM_TOL``,
    ``MH_LATER_LOSS_TOL``, bit for bit elsewhere)."""
    first = x["first"] if first is None else first
    differ = [n for n, t in first.items() if not torch.equal(t, y["first"][n])]
    stem = {n: ((first[n].double() - y["first"][n].double()).norm()
                / y["first"][n].double().norm()).item() for n in upstream}
    worst = max(stem, key=stem.get)
    (_, y1), *y_later = y["losses"]
    later = [abs(a - b) / abs(y1 - b) for (_, a), (_, b) in zip(x["losses"][1:], y_later)]
    params = [n for n in x["tensors"] if n.startswith("/model/")]
    num = sum(((x["tensors"][n].double() - y["tensors"][n].double()) ** 2).sum()
              for n in params)
    den = sum((y["tensors"][n].double() ** 2).sum() for n in params)
    diffs = {n: (t.double() - y["tensors"][n].double()).abs().max().item()
             for n, t in x["tensors"].items()}
    last = max(diffs, key=diffs.get)
    out = dict(step1_loss_equal=x["losses"][0] == y["losses"][0],
               elsewhere=[n for n in differ if n not in upstream],
               upstream=[n for n in differ if n in upstream],
               stem=(stem[worst], worst), later=later,
               param_rel_l2=(num / den).sqrt().item(), largest=(diffs[last], last))
    out["held"] = (out["step1_loss_equal"] and not out["elsewhere"]
                   and stem[worst] <= MH_STEM_TOL and len(later) == MH_STEPS - 1
                   and max(later) <= MH_LATER_LOSS_TOL)
    return out


def describe_hold(h: dict) -> str:
    return (f"step 1: loss bit for bit {h['step1_loss_equal']}, {len(h['elsewhere'])} tensors "
            f"differ outside the stem {h['elsewhere'][:6]}, {len(h['upstream'])} in it, its "
            f"largest relative L2 {h['stem'][0]:.3e} ({h['stem'][1]}; limit {MH_STEM_TOL:g}); "
            f"later losses' |difference| over the fall since step 1 "
            f"{[f'{v:.3e}' for v in h['later']]} (limit {MH_LATER_LOSS_TOL:g}); after step "
            f"{MH_STEPS}: parameters relative L2 {h['param_rel_l2']:.3e}, largest |difference| "
            f"{h['largest'][0]:.3e} ({h['largest'][1]}); held {h['held']}")


def phase_multihost(torch, card, repeats: int = 1):
    """Phase 14: (a) two processes of ``cli train --distributed`` (through
    ``counted_cli``) on cuda:0, one rank each over gloo, the flagship at
    full width in bf16 on a synthetic dataset, step 2 traced, a checkpoint
    every step; (b) the same clips through ``core/mesh.launch`` of
    ``cli._train`` on [cuda:0, cuda:0] in this process (``repeats`` times;
    the first is held, the others' readings printed): (a) held against (b)
    by ``mh_hold``, and averaged gradients (``averaged_gradients``) and
    (f), (b) with rank 1 never stepping (``mh_stalled_train``), failing
    it; (c) every rank's backend, B1-B3 launches, ms per step and the
    traced step's device-busy share; (d) process 0 of 2 alone raising at
    the rendezvous."""
    import shutil

    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.core.mesh import initialize_distributed, launch, make_mesh
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_mh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    mesh = make_mesh(2, devices=[DEVICE] * 2)
    try:
        data = make_synthetic_dataset(os.path.join(root, "data"), num_videos=2,
                                      frames_per_video=40, size=(SIZE, SIZE))
        argv = ["--structure", MH_MODEL, "--dtype", "bfloat16",
                "--frames", data["frame_dirs"], "--densities", data["density_dirs"],
                "--imagesize", str(SIZE), "--batch", str(MH_BATCH), "--epoch", "4",
                "--max-steps", str(MH_STEPS), "--dropout", "0", "--shuffle", "false",
                "--plotiter", "1", "--validiter", "100000", "--saveiter", "1",
                "--info", "mh", "--threads", "4", "--device", DEVICE, "--devices", "2"]

        # (a) two OS processes in one working directory
        workdir, counts = os.path.join(root, "a"), os.path.join(root, "counts_a")
        os.makedirs(workdir)
        os.makedirs(counts)
        coordinator = f"127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--counted-cli", "train", *argv,
             "--distributed", "true", "--coordinator", coordinator, "--num-processes", "2",
             "--process-id", str(i)],
            cwd=workdir, env=dict(os.environ, **{MH_COUNTS_ENV: counts,
                                                 MH_TRACE_ENV: os.path.join(workdir, "trace")}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for i in (0, 1)]
        outs = []
        for proc in procs:
            try:
                outs.append(proc.communicate(timeout=MH_RUN_TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise AssertionError("a cli train --distributed process did not end within "
                                     f"{MH_RUN_TIMEOUT_S} s")
        a_s = time.perf_counter() - t0
        codes = [proc.returncode for proc in procs]
        if codes != [0, 0]:
            for i, out in enumerate(outs):
                print(f"[mh] process {i} exit {codes[i]}:\n{out[-3000:]}", flush=True)
            raise AssertionError(f"cli train --distributed exit codes {codes}")
        trace = os.path.join(workdir, "trace")
        traces = sorted(os.listdir(trace))
        busy = [device_busy(os.path.join(trace, t)) for t in traces]
        a = mh_run(torch, workdir, counts)

        # (b) core/mesh.launch in this process, on the same clips; (f) the same
        # with a planted fault
        cfg = cli._train_config(cli._train_parser().parse_args(argv))
        idx = cli._clip_index(cfg)

        def launched(tag, fn):
            workdir, counts = os.path.join(root, tag), os.path.join(root, f"counts_{tag}")
            os.makedirs(counts)
            run_cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, model_dir=os.path.join(workdir, "model"),
                logs_dir=os.path.join(workdir, "logs")))
            os.environ.update({MH_COUNTS_ENV: counts,
                               MH_TRACE_ENV: os.path.join(workdir, "trace")})
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                launch(mesh, fn, run_cfg, a["runs"][0], None, idx.train_clips(),
                       idx.valid_clips(), MH_BATCH // 2, False)
            finally:
                del os.environ[MH_COUNTS_ENV], os.environ[MH_TRACE_ENV]
            return mh_run(torch, workdir, counts), time.perf_counter() - t0

        bs = [launched(f"b{i}", mh_counted_train) for i in range(repeats)]
        (b, b_s) = bs[0]
        f, f_s = launched("f", mh_stalled_train)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    upstream = mh_upstream(torch, a["first"])
    held = mh_hold(torch, a, b, upstream)
    averaged = mh_hold(torch, a, b, upstream, first=averaged_gradients(torch, a["first"]))
    stalled = mh_hold(torch, f, b, upstream)
    repeated = {f"b{i} against b{j}": mh_hold(torch, bs[i][0], bs[j][0], upstream)
                for i in range(repeats) for j in range(i)}
    repeated.update({f"a against b{i}": mh_hold(torch, a, bs[i][0], upstream)
                     for i in range(1, repeats)})

    # (d) process 0 of 2 alone: the rendezvous raises, nothing trains
    t0 = time.perf_counter()
    try:
        initialize_distributed(f"127.0.0.1:{free_port()}", 2, 0, timeout=MH_FAULT_TIMEOUT_S)
    except RuntimeError as e:
        fault = dict(raised=str(e), seconds=time.perf_counter() - t0)
    else:
        raise AssertionError("process 0 of 2 alone passed the rendezvous")

    n_sites = len(SITES)
    finished = sum(out.count("Training Finished!") for out in outs)
    print(f"[mh] (a) 2 processes of cli train --distributed, one rank each on {DEVICE}, the "
          f"ranks' (backend, world size) {a['backends']}: exit codes {codes} in {a_s:.2f} s; "
          f"run directories {a['runs']}, log directories {a['logs']}, checkpoints "
          f"{a['checkpoints']}; 'Training Finished!' printed {finished} time(s); global "
          f"losses {a['losses']}  [{card}]", flush=True)
    print(f"[mh] (b) core/mesh.launch of cli._train on [{DEVICE}, {DEVICE}] in one process, "
          f"the ranks' {b['backends']}, {b_s:.2f} s: losses {b['losses']}; (a) against (b): "
          f"{describe_hold(held)}", flush=True)
    for name, h in repeated.items():
        print(f"[mh] (b) repeated, {name}: {describe_hold(h)}", flush=True)
    print(f"[mh] planted faults: averaged gradients (a's checkpoint after step 1 as they "
          f"would make it) against (b): {describe_hold(averaged)}; (f) rank 1 never "
          f"stepping, {f_s:.2f} s, losses {f['losses']}, against (b): {describe_hold(stalled)}",
          flush=True)
    ms = {s: 1e3 * MH_BATCH / c for s, c in a["clips_per_sec"].items()}
    print(f"[mh] (c) launches per rank, (a) {a['counts']}, (b) {b['counts']}; ms per step "
          f"(rank 0's clips/s, the global batch of {MH_BATCH}) "
          f"{ {s: round(v, 1) for s, v in ms.items()} }; step {MH_PROFILE_STEP} traced, per "
          f"rank: {traces}, " + "; ".join(
              f"{u['kernels']} device events, busy {100 * u['window_busy']:.1f}% of the "
              f"{u['window_ms']:.1f} ms window, {100 * u['step_busy']:.1f}% of the "
              f"{u['step_ms']:.1f} ms train_step range" for u in busy) + f"  [{card}]",
          flush=True)
    print(f"[mh] (d) process 0 of 2 alone, timeout {MH_FAULT_TIMEOUT_S:g} s: raised after "
          f"{fault['seconds']:.2f} s: {fault['raised']}", flush=True)

    if finished != 1 or len(a["runs"]) != 1 or len(a["logs"]) != 1 \
            or a["checkpoints"] != [f"ckpt_{s}.pt" for s in range(1, MH_STEPS + 1)]:
        raise AssertionError("cli train --distributed: not one run, one log and one "
                             "checkpoint a step")
    if [s for s, _ in a["losses"]] != list(range(1, MH_STEPS + 1)) \
            or not all(math.isfinite(v) for _, v in a["losses"]):
        raise AssertionError("cli train --distributed: losses missing or not finite")
    if a["backends"] != [("gloo", 2)] * 2 or b["backends"] != [("gloo", 2)] * 2:
        raise AssertionError("the ranks did not run as 2 ranks over gloo")
    if not held["held"]:
        raise AssertionError("the two processes and one process's launcher differ: "
                             + describe_hold(held))
    if averaged["held"] or stalled["held"]:
        raise AssertionError("a planted fault passed the hold of (a) against (b)")
    want = [{"B1": n_sites * MH_STEPS, "B2": n_sites * MH_STEPS, "B3": n_sites * MH_STEPS,
             "B4": 0}, {"B1": 0, "B2": n_sites * MH_STEPS, "B3": n_sites * MH_STEPS, "B4": 0}]
    if DEVICE != "cpu" and (a["counts"] != want or b["counts"] != want):
        raise AssertionError(f"launches per rank: expected {want}")
    if traces != [f"rank{r}_steps_{MH_PROFILE_STEP}-{MH_PROFILE_STEP}.pt.trace.json"
                  for r in (0, 1)] or not all(u["kernels"] > 0 or DEVICE == "cpu" for u in busy):
        raise AssertionError("a rank wrote no trace of the profiled step, or one without "
                             "device events")
    if not fault["seconds"] < 5 * MH_FAULT_TIMEOUT_S:
        raise AssertionError("the lost peer's rendezvous took too long to fail")
    return dict(a_seconds=a_s, b_seconds=b_s, f_seconds=f_s, losses=a["losses"],
                losses_b=b["losses"], losses_f=f["losses"], launches=a["counts"],
                launches_b=b["counts"], ms_per_step=ms, device_busy=busy, fault=fault,
                held=held, averaged=averaged, stalled=stalled, repeated=repeated)


# Per source of phase 2: the kernels ptxas reports on (a longer name before
# its prefix), and those of them that must not spill (the wgmma kernels,
# bf16 and split fp32, which the gates reach at every instantiation, and
# the split prep).
# ---- phase 15: tensor parallel over a data x model mesh (core/sharding_rules) -

TP_SHAPE = (2, 2)            # data x model: four ranks, by default all on cuda:0 (gloo)
TP_MODEL = "unet++"          # the flagship, p3d_unetplusplus_ds
TP_MIN_FEATURES = 512        # the JAX package's default: the flagship shards 52 kernels
TP_F64_BATCH = 4             # (a): the global batch, 2 rows a data index
TP_BF16_BATCH = 16           # (b): 8 rows a data index
TP_BF16_STEPS = 2
TP_DROPOUT = 0.5             # (b): masks drawn from a generator seeded by the data index


TENSOR_PARALLEL_FAULTS = ("world_summed_replicated", "input_gradient_not_reduced")


@contextlib.contextmanager
def planted_tensor_parallel_fault(fault: str):
    """One of the planted faults of the tensor-parallel step for the
    duration (``TENSOR_PARALLEL_FAULTS``; phase 15 and
    ``tests/test_torch_tensor_parallel.py`` hold their limits against
    both): "world_summed_replicated", the replicated parameters' gradients
    summed over the world (each counted ``n_model`` times);
    "input_gradient_not_reduced", a column-parallel layer's input gradient
    left as this rank's share (no sum over the model row)."""
    from sap3d_tpu_torch.ops import layers
    from sap3d_tpu_torch.train import steps

    def world_summed(sharded, replicated, group):
        steps.all_reduce_gradients(sharded, group.data)
        steps.all_reduce_gradients(replicated, group)

    owner, attr, fake = {
        "world_summed_replicated": (steps, "reduce_grid_gradients", world_summed),
        "input_gradient_not_reduced": (layers, "copy_to_model_row", lambda x, group: x),
    }[fault]
    orig = getattr(owner, attr)
    setattr(owner, attr, fake)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def tp_checksums(torch, group, state) -> dict:
    """Whether the ranks agree bit for bit where the rules say they must
    (``agree_bitwise``): every replicated parameter, buffer and Adam state
    over the world, the kernel slices and their moments over the data
    column."""
    from sap3d_tpu_torch.core.sharding_rules import sharded_layers

    model, opt = state.model, state.optimizer
    sliced = {id(layer.kernel) for layer, _ in sharded_layers(model).values()}
    tensors = {True: [], False: list(model.buffers())}
    for p in model.parameters():
        tensors[id(p) in sliced] += [p] + [v for k, v in opt.state[p].items() if k != "step"]
    return {"replicated": agree_bitwise(torch, group, tensors[False])[0],
            "slices": agree_bitwise(torch, group.data, tensors[True])[0]}


def tp_rank(group, spec: dict) -> dict:
    """One rank of phase 15 (a data x model group; the spec names the
    model, the files the parent wrote and the sizes): (a) the float64
    tensor-parallel step, sound and with each planted fault, on rank 0
    beside two one-process steps at the global batch; (b) two bf16 steps
    with the kernels, every B2 and B3 call held on the rank's own tensors,
    the ranks' bit identity, the local kernels' widths; (c) bytes, peak
    memory, collectives and ms per step."""
    import numpy as np
    import torch

    from sap3d_tpu_torch.core import mesh as mesh_lib
    from sap3d_tpu_torch.core.sharding_rules import (
        gather_state,
        gather_tensors,
        make_mesh_2d,
        sharded_layers,
        state_shardings,
    )
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, main = group.device, group.is_main
    on_card = dev.type == "cuda"
    n_data, n_model = group.data.world_size, group.model.world_size
    mesh = make_mesh_2d(n_data, n_model, devices=[dev] * group.world_size)

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    out = {"rank": group.rank, "coords": (group.data.rank, group.model.rank),
           "backend": group.backend}
    weights = torch.load(spec["weights"], map_location=dev, weights_only=True)
    data = np.load(spec["inputs"])
    frames, targets = data["frames"], data["targets"]

    def model_of(dtype, dropout):
        m = build_model(spec["model"], dtype=dtype, device=dev, dropout_rate=dropout)
        m.load_state_dict(weights)
        return m.double() if dtype == torch.float64 else m

    def put(a, n, dtype, parallel=True):
        b = n // n_data if parallel else n
        rows = slice(group.data.rank * b, (group.data.rank + 1) * b) if parallel else \
            slice(0, n)
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev, dtype)

    def flat(tensors: dict):
        return torch.cat([t.detach().flatten() for t in tensors.values()])

    def rel(a, b_):
        return (a.double() - b_.double()).norm().item() / b_.double().norm().item()

    # (a) float64, the plain path; rank 0 first takes two one-process steps
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    n64 = spec["f64_batch"]
    x64, t64 = put(frames, n64, torch.float64), put(targets, n64, torch.float64)
    ref = None
    if main:
        ones = []
        for _ in range(2):
            m = model_of(torch.float64, 0.0)
            state = create_train_state(m, lr=1e-4)
            loss = make_train_step(state)(put(frames, n64, torch.float64, False),
                                          put(targets, n64, torch.float64, False))
            opt = state.optimizer
            ones.append(dict(
                loss=loss.item(), grad=flat({n: p.grad for n, p in m.named_parameters()}),
                buffers=dp_bn_buffers(m),
                moments={k: flat({n: opt.state[p][k] for n, p in m.named_parameters()})
                         for k in ("exp_avg", "exp_avg_sq")}))
            del m, state, opt
        ref = ones[0]
        out["floor_grad_rel_l2"] = rel(ones[1]["grad"], ref["grad"])
        del ones
        if on_card:
            torch.cuda.empty_cache()
    group.barrier()

    def step64(fault=None):
        m = model_of(torch.float64, 0.0)
        state = create_train_state(m, lr=1e-4)
        step = make_train_step(state, group, state_shardings(state, mesh, spec["min_features"]))
        with planted_tensor_parallel_fault(fault) if fault else contextlib.nullcontext():
            loss = step(x64, t64)
        sync()
        grad = flat(gather_tensors(m, {n: p.grad for n, p in m.named_parameters()}))
        res = None
        if fault is None:
            whole = gather_state(state)["optimizer"]
            moments = {k: flat({n: e[k] for n, e in whole.items()})
                       for k in ("exp_avg", "exp_avg_sq")}
        if main:
            res = dict(loss_rel=abs(loss.item() - ref["loss"]) / abs(ref["loss"]),
                       grad_rel_l2=rel(grad, ref["grad"]))
            if fault is None:
                res.update(
                    loss=loss.item(), one_process_loss=ref["loss"],
                    buffer_excess=max(
                        ((b.double() - ref["buffers"][k].double()).abs().max()
                         / ref["buffers"][k].double().abs().max()).item()
                        for k, b in dp_bn_buffers(m).items()),
                    moments_rel_l2={k: rel(v, ref["moments"][k]) for k, v in moments.items()})
        del m, state, step, grad
        return res

    a = {"sound": step64()}
    for fault in TENSOR_PARALLEL_FAULTS:
        a[fault] = step64(fault)
    if main:
        out["a"] = a
    del ref, x64, t64
    torch.backends.cudnn.deterministic = False
    if on_card:
        torch.cuda.empty_cache()
    group.barrier()

    # (b) two bf16 steps with the kernels, dropout drawn per data index
    m = model_of("bfloat16", spec["dropout"])
    full_parameters = sum(p.numel() for p in m.parameters())
    state = create_train_state(m, lr=1e-4)
    step = make_train_step(state, group, state_shardings(state, mesh, spec["min_features"]))
    nb = spec["bf16_batch"]
    x, t = put(frames, nb, torch.float32), put(targets, nb, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED + 40 + group.data.rank)
    calls = {"B2": [], "B3": []}

    def spy_forward(q, k, v):
        o, lse = fa.flash_forward_lse(q, k, v)
        calls["B2"].append((q, k, v, o, lse))
        return o, lse

    def spy_backward(q, k, v, o, lse, do):
        res = fb.flash_backward(q, k, v, o, lse, do)
        calls["B3"].append((q, k, v, o, lse, do, res))
        return res

    counts = {"all_reduce": 0, "all_gather": 0}
    orig_reduce, orig_gather = torch.distributed.all_reduce, mesh_lib.DataGroup.all_gather

    def counting_reduce(*args, **kwargs):
        counts["all_reduce"] += 1
        return orig_reduce(*args, **kwargs)

    def counting_gather(self, tensor, dim):
        counts["all_gather"] += 1
        return orig_gather(self, tensor, dim)

    losses, times = [], []
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts(*B1_B4)
    with function_calls(spy_forward, spy_backward):
        for i in range(spec["bf16_steps"]):
            counted = i == spec["bf16_steps"] - 1
            if counted:
                torch.distributed.all_reduce = counting_reduce
                mesh_lib.DataGroup.all_gather = counting_gather
            group.barrier()
            t0 = time.perf_counter()
            try:
                losses.append(step(x, t, gen).item())
                sync()
            finally:
                torch.distributed.all_reduce = orig_reduce
                mesh_lib.DataGroup.all_gather = orig_gather
            times.append(time.perf_counter() - t0)
    launches = launch_counts(*B1_B4)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else None
    layers = sharded_layers(m)
    widths = {n: (tuple(layer.kernel.shape), tuple(weights[n].shape), dim)
              for n, (layer, dim) in layers.items()}
    out["b"] = dict(losses=losses, launches=launches, agree=tp_checksums(torch, group, state),
                    widths=widths, sharded=len(layers), state_bytes=state_bytes(state),
                    full_parameters=full_parameters,
                    peak_gib=peak, step_ms=[1e3 * s for s in times], collectives=counts,
                    bn_layers=sum(1 for _ in dp_bn_buffers(m)) // 2)
    del m, state, step, x, t
    # each rank in turn holds its steps' kernel calls on its own tensors
    names = {shape: name for name, shape in SITES.items()}
    held = {"B2": [], "B3": []}
    for r in range(group.world_size):
        if r == group.rank:
            for q, k, v, o, lse in calls["B2"]:
                site = dp_site_name(names, q, k, v)
                held["B2"].append((site, check_b2(
                    fa, f"{site} bf16 (rank {r} of the tensor-parallel step)",
                    q, k, v, o, lse)["max_abs_err"]))
            for q, k, v, o, lse, do, got in calls["B3"]:
                site = dp_site_name(names, q, k, v)
                held["B3"].append((site, check_b3(
                    fb, f"{site} bf16 (rank {r} of the tensor-parallel step)",
                    q, k, v, o, lse, do, got)["max_abs_err"]))
            calls.clear()
            if on_card:
                torch.cuda.empty_cache()
        group.barrier()
    out["held"] = held
    return out


def phase_tensor_parallel(torch, calibrated, card, mesh=None, dp=None):
    """Phase 15: a data x model mesh (default: cuda:0 four times, over
    gloo) through ``core/mesh.launch``, each rank running ``tp_rank``;
    the parent writes the calibrated weights and the steps' inputs, then
    holds what the ranks read.  ``dp``: phase 13's result, whose replicated
    ranks' bytes and peak stand beside this phase's."""
    import shutil

    import numpy as np

    from sap3d_tpu_torch.core.mesh import data_backend, launch
    from sap3d_tpu_torch.core.sharding_rules import make_mesh_2d

    t_phase = time.perf_counter()
    n_data, n_model = TP_SHAPE
    mesh = mesh or make_mesh_2d(n_data, n_model, devices=[DEVICE] * (n_data * n_model))
    backend = data_backend(mesh)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_tp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        weights = os.path.join(root, f"{TP_MODEL}_calibrated.pt")
        torch.save({k: v.cpu() for k, v in calibrated.items()}, weights)
        rng = np.random.default_rng(SEED + 39)
        shape = (max(TP_F64_BATCH, TP_BF16_BATCH), 16, SIZE, SIZE, 3)
        inputs = os.path.join(root, "inputs.npz")
        np.savez(inputs, frames=(rng.normal(size=shape) * 0.3).astype(np.float32),
                 targets=rng.uniform(size=shape[:4]).astype(np.float32))
        spec = dict(model=TP_MODEL, weights=weights, inputs=inputs, min_features=TP_MIN_FEATURES,
                    f64_batch=TP_F64_BATCH, bf16_batch=TP_BF16_BATCH,
                    bf16_steps=TP_BF16_STEPS, dropout=TP_DROPOUT)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = launch(mesh, tp_rank, spec)
        launch_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    a, tol = ranks[0]["a"], DP_TOL
    sound = a["sound"]
    where = (f"{n_data} x {n_model} ranks (data x model) on "
             f"{', '.join(str(x) for x in mesh.devices)} over {backend}")
    print(f"[tp] {where}: one launch in {launch_s:.2f} s (spawn, the phases and the "
          f"teardown); ranks at {[r['coords'] for r in ranks]}  [{card}]", flush=True)
    print(f"[tp] (a) one float64 step at a global batch of {TP_F64_BATCH} against one process "
          f"({ranks[0]['b']['sharded']} kernels sharded at min_features {TP_MIN_FEATURES}): loss "
          f"{sound['loss']:.6f} vs {sound['one_process_loss']:.6f} (relative "
          f"{sound['loss_rel']:.3e}, limit {tol['loss']:g}); summed gradient (slices gathered) "
          f"relative L2 {sound['grad_rel_l2']:.3e} (limit {tol['grad']:g}; two one-process runs "
          f"{ranks[0]['floor_grad_rel_l2']:.3e}); BN buffers {sound['buffer_excess']:.3e} "
          f"(limit {tol['buffer']:g}); Adam moments (gathered) relative L2 "
          f"{ {k: f'{v:.3e}' for k, v in sound['moments_rel_l2'].items()} } (limit "
          f"{tol['grad']:g}); planted faults: "
          + ", ".join(f"{f} gradient {a[f]['grad_rel_l2']:.3e}, loss {a[f]['loss_rel']:.3e}"
                      for f in TENSOR_PARALLEL_FAULTS), flush=True)
    b = [r["b"] for r in ranks]
    print(f"[tp] (b) {TP_BF16_STEPS} bf16 steps at a global batch of {TP_BF16_BATCH} "
          f"({TP_BF16_BATCH // n_data} rows a data index, dropout {TP_DROPOUT} drawn per data "
          f"index): losses per rank {[r['losses'] for r in b]}; launches per rank "
          f"{[r['launches'] for r in b]}; B2 and B3 held on each rank's tensors, max |err| "
          f"{[{k: [f'{s_} {e:.2e}' for s_, e in v] for k, v in r['held'].items()} for r in ranks]}"
          f"; bit-identical (checksums over all_reduce): replicated tensors across the "
          f"{len(ranks)} ranks {[r['agree']['replicated'] for r in b]}, slices across each data "
          f"column {[r['agree']['slices'] for r in b]}", flush=True)
    dp_d = dp["collectives"] if dp else None
    replicated_bytes = b[0]["full_parameters"] * 16  # float32 parameter, gradient, 2 moments
    coll = b[0]["collectives"]
    print(f"[tp] (c) per rank {[round(r['state_bytes'] / 1e9, 3) for r in b]} GB of parameters, "
          f"gradients and Adam moments (all replicated: {replicated_bytes / 1e9:.3f} GB; phase "
          f"13's ranks {round(dp_d['state_bytes'] / 1e9, 3) if dp_d else 'not run'} GB); peak "
          f"memory per rank {[round(r['peak_gib'], 2) if r['peak_gib'] else None for r in b]} "
          f"GiB (phase 13's at its 8 rows a rank "
          f"{round(dp_d['peak_gib'], 2) if dp_d and dp_d['peak_gib'] else 'not read'} GiB); one "
          f"bf16 step on rank 0: {coll['all_gather']} all-gathers of output slices, "
          f"{coll['all_reduce']} all-reduces counted ({b[0]['bn_layers']} BN layers forward and "
          f"backward, the input gradients of the {b[0]['sharded']} column-parallel layers, the "
          f"gradient buckets and the loss"
          + (", and over gloo each all-gather is one of them" if backend == "gloo" else "")
          + f"); ms per step {[[round(v, 2) for v in r['step_ms']] for r in b]}.  Over "
          f"{backend}" + (" on one card every collective goes through the host: these times "
                          "measure the mechanism, not the scaling" if backend == "gloo" else "")
          + f"  [{card}]", flush=True)

    on_card = all(x.type == "cuda" for x in mesh.devices)
    if not (sound["loss_rel"] <= tol["loss"] and sound["grad_rel_l2"] <= tol["grad"]
            and sound["buffer_excess"] <= tol["buffer"]
            and all(v <= tol["grad"] for v in sound["moments_rel_l2"].values())):
        raise AssertionError("the tensor-parallel float64 step disagrees with one process")
    if not all(a[f]["grad_rel_l2"] > tol["grad"] for f in TENSOR_PARALLEL_FAULTS):
        raise AssertionError("the tensor-parallel limits pass a planted fault; void")
    if not all(r["agree"]["replicated"] and r["agree"]["slices"] for r in b):
        raise AssertionError("the tensor-parallel ranks differ where the rules say they agree")
    if not all(np.isfinite(r["losses"]).all() and len(r["losses"]) == TP_BF16_STEPS for r in b):
        raise AssertionError("the bf16 tensor-parallel steps' losses are not finite")
    for r in b:
        for name, (local, full, dim) in r["widths"].items():
            want = list(full)
            want[dim] //= n_model
            if list(local) != want:
                raise AssertionError(f"{name}: a local kernel of {local}, not {n_model} slices "
                                     f"of {full}")
    if on_card:
        n_sites = len(SITES)
        step_calls = {"B1": 0, "B2": n_sites * TP_BF16_STEPS, "B3": n_sites * TP_BF16_STEPS,
                      "B4": 0}
        if not all(r["launches"] == step_calls for r in b):
            raise AssertionError(f"launches per rank of the tensor-parallel steps: expected "
                                 f"{step_calls}")
        if not all(len(r["held"]["B2"]) == len(r["held"]["B3"]) == n_sites * TP_BF16_STEPS
                   for r in ranks):
            raise AssertionError("not every B2 and B3 call of the tensor-parallel steps was held")
        if b[0]["sharded"] != 52:
            raise AssertionError(f"{b[0]['sharded']} kernels sharded, not the flagship's 52")
    seconds = time.perf_counter() - t_phase
    print(f"[tp] phase 15 in {seconds:.2f} s", flush=True)
    return dict(backend=backend, devices=[str(x) for x in mesh.devices], a=a,
                floor_grad_rel_l2=ranks[0]["floor_grad_rel_l2"],
                steps=[{k: v for k, v in r.items() if k != "widths"} for r in b],
                held=[r["held"] for r in ranks], launches=[r["launches"] for r in b],
                seconds=seconds, launch_seconds=launch_s)


# Phase 16: the port's profiling and bench scripts (sap3d_tpu_torch/scripts),
# each script's main(argv) in this process at full width, with fewer timed
# repeats and the reduced runs below; every other script whole.
SCRIPT_REPEATS = ["--repeats", "2"]
SCRIPT_RUNS = (
    ("profile_attention", SCRIPT_REPEATS),
    ("profile_ring_hop", SCRIPT_REPEATS),
    ("profile_decoder", SCRIPT_REPEATS),
    ("profile_encoder", SCRIPT_REPEATS),
    ("profile_step", ["full", "no_sa", "fwd", "stage3_thin"] + SCRIPT_REPEATS),
    ("profile_gn", ["full_sa_decoder", "no_cbam"] + SCRIPT_REPEATS),
    ("bench_eval", ["--videos", "2", "--frames", "20"]),
    ("bench_cli_eval", []),
    ("bench_export", []),
    ("bench_loader", []),
)
# bench_export's dataset (its environment variables): 1 video of 40 frames
SCRIPT_ENV = {"bench_export": {"BENCH_EXPORT_VIDEOS": "1", "BENCH_EXPORT_FRAMES": "40"}}
# Kernels each script's run must launch on the card (at least once)
SCRIPT_KERNELS = {"profile_attention": ("B1", "B2", "B3"), "profile_ring_hop": ("B2", "B4"),
                  "profile_step": ("B2", "B3"), "profile_gn": ("B2", "B3"),
                  "bench_cli_eval": ("B1",), "bench_export": ("B1",)}
# Attention sites on the kernel route per step of a profile_step or
# profile_gn leg: the flagship's three (x_4_0 has 49 queries, below a query
# block), the GN SA decoder's three, none without self-attention
SCRIPT_LEG_SITES = {"full": 3, "no_sa": 0, "no_dropout": 3, "no_opt": 3, "fwd": 3,
                    "stage1_thin": 3, "stage2_thin": 3, "stage3_thin": 3, "full_again": 3,
                    "full_sa_decoder": 3, "no_cbam": 3, "bn_backbone": 3, "decoder_nosa": 0,
                    "easy_full": 0}


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        import io

        self.out, self.copy = out, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def script_holds(name: str, res: dict) -> None:
    """What phase 16 holds of a script's printed readings, beside what the
    script holds itself (and raises on)."""
    from sap3d_tpu_torch.scripts.bench_eval import MEAN_TOLERANCE

    def within(label, value, limit=1.0):
        if not value <= limit:
            raise AssertionError(f"[scripts] {name}: {label} {value} exceeds {limit}")

    if name == "profile_attention":
        held = [(site, label, h) for site, row in res["sites"].items()
                for label, h in row.get("holds", {}).items()]
        if len(held) != 18:  # B1 o, B2 o and lse, B3 dq, dk, dv at three sites
            raise AssertionError(f"[scripts] profile_attention held {len(held)} outputs")
        for site, label, h in held:
            within(f"{site} {label} excess", h["excess"])
    elif name == "profile_ring_hop":
        within("max|xla - pallas| excess", res["check"]["excess"])
        if not all(res["check"]["grads_finite"].values()):
            raise AssertionError(f"[scripts] {name}: a hop's gradient is not finite")
    elif name == "profile_encoder":
        within("im2col excess", res["micro"]["im2col_check"]["excess"])
    elif name in ("profile_step", "profile_gn"):
        for leg, row in res["legs"].items():
            n = SCRIPT_LEG_SITES[leg]
            want = {"B1": n, "B2": 0, "B3": 0} if row["mode"] == "forward" else \
                {"B1": 0, "B2": n, "B3": n}
            got = {k: row["launches_per_step"][k] for k in want}
            if row["kernel_sites"] != n or got != want:
                raise AssertionError(f"[scripts] {name} {leg}: {row['kernel_sites']} kernel "
                                     f"sites, launches per step {got}; want {n}, {want}")
        if name == "profile_gn" and res["failed"]:
            raise AssertionError(f"[scripts] profile_gn: legs failed: {res['failed']}")
    elif name == "bench_eval":
        for check, diffs in res["card_minus_host"].items():
            for metric, d in diffs.items():
                within(f"{check} |card - host| {metric}", d, MEAN_TOLERANCE[metric])
    elif name == "bench_cli_eval" and not res["clips_scored"] > 0:
        raise AssertionError("[scripts] bench_cli_eval scored no clip")


def phase_scripts(torch, card):
    """Phase 16: each of ``SCRIPT_RUNS``'s scripts through its ``main(argv)``
    on the card: its launch counts zeroed just before and read just after,
    its last printed line parsed as JSON and equal to what it returned, its
    card the one of ``card``, every time in it finite and positive
    (``_timing.finite_times``), its kernels launched (``SCRIPT_KERNELS``),
    and what it holds held again from its readings (``script_holds``)."""
    import contextlib
    import importlib

    from sap3d_tpu_torch.ops.cuda import flash_attention as fa
    from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
    from sap3d_tpu_torch.scripts import _timing

    t_phase = time.perf_counter()
    out = {}
    for name, argv in SCRIPT_RUNS:
        mod = importlib.import_module(f"sap3d_tpu_torch.scripts.{name}")
        argv = list(argv) + ["--device", DEVICE]
        env = SCRIPT_ENV.get(name, {})
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        reset_launch_counts(*B1_B4)
        try:
            with contextlib.redirect_stdout(tee):
                res = mod.main(argv)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        launches = launch_counts(*B1_B4)
        seconds = time.perf_counter() - t0
        last = json.loads(tee.copy.getvalue().strip().splitlines()[-1])
        if last != json.loads(json.dumps(res)):
            raise AssertionError(f"[scripts] {name}: its last line is not what it returned")
        if last["card"]["name"] not in card:
            raise AssertionError(f"[scripts] {name}: card {last['card']} is not {card!r}")
        _timing.finite_times(last, f"{name}.")
        missing = [k for k in SCRIPT_KERNELS.get(name, ()) if not launches[k] > 0]
        if missing:
            raise AssertionError(f"[scripts] {name} launched no {missing}: {launches}")
        script_holds(name, last)
        print(f"[scripts] {name} {' '.join(argv)}: {seconds:.1f} s, launches {launches}; last "
              "line parsed, every time finite and positive", flush=True)
        out[name] = dict(result=last, launches=launches, seconds=seconds)
        torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"[scripts] phase 16 in {seconds:.2f} s", flush=True)
    return dict(scripts=out, seconds=seconds)


# ---- phase 17: K train steps per call (train/steps.make_multi_train_step) ----

MS_MICRO = "p3d_micro_sa"
MS_MICRO_SHAPE = (2, 16, 32, 32, 3)  # (a): x_2_2 (Nq 256) and x_1_3 (2048) on the fp32 kernels
MS_MICRO_K = 4                       # (a): two calls of 4 against 8 eager steps
MS_FLAGSHIP_K = 2                    # (b): a warm-up call, then one replayed call
MS_TIMED_K = 8                       # (c): the JAX benchmark's K (bench.py)
MS_TIMED_CALLS = 2                   # (c): timed calls a leg, after one
MS_CLI_K = 4                         # (d)
# (a), (b): a captured run is held to an eager run group by group (the
# losses' largest relative difference; the relative L2 distance of all
# parameters, BN statistics, Adam moments, step counts) within twice the
# larger of what two more eager runs from the same start move (pool1's
# max-pool backward and B3's dq reduce-adds add in run order on the card,
# and fp32 training carries the difference on) plus a floor.  How far two
# runs part depends on where their reduce-adds first land in another order
# and on how far training carries that, up to a ceiling, so two eager
# reruns can both set a control far below it: twice the control alone
# failed an eager run in the captured run's place in 24 of 180 choices of
# (a)'s runs and 107 of 840 of (b)'s, on an H100.  Each group's floor is
# that ceiling, the largest distance of any pair of many runs from one
# start (``--multi-step-spread``; PERF.md).  (a), 8 micro steps from
# one start, in two readings of 8 eager and 8 captured runs: parameters
# 4.07e-4, statistics 5.99e-5, moments 5.87e-2, losses 1.08e-4.  (b), two
# flagship steps from a snapshot taken after the warm-up call, whose own
# run order moves the ceiling from one run of the smoke to the next (two
# readings: parameters 5.41e-4 and 5.77e-4, statistics 1.75e-5 and
# 1.65e-5, moments 1.87e-1 and 3.73e-1, losses 8.4e-6 and 1.9e-5): the
# moments' floor is twice their larger ceiling.  Step counts must agree
# (``MS_FLOOR_DEFAULT``).  The planted faults read 30 to 1e5 times the
# limits.
MS_MICRO_FLOOR = {"parameters": 4.1e-4, "statistics": 6e-5, "moments": 5.9e-2,
                  "losses": 2e-4}
MS_FLAGSHIP_FLOOR = {"parameters": 6e-4, "statistics": 1.8e-5, "moments": 7.5e-1,
                     "losses": 2e-4}
MS_FLOOR_DEFAULT = 1e-6
MULTI_STEP_FAULTS = ("skip_copy", "replay_short")
# the hand-written kernels' names in a trace (ms_device_busy)
MS_HAND_KERNELS = ("flash_", "bwd_row_stats", "round_to_bf16")


def ms_launches(counted: dict, multi, replays: int, captures: int) -> dict:
    """The launches a run of the multi-step ``multi`` made on the card:
    ``counted``, the counters set to 0 just before the run and read just
    after it, less ``multi.captured_launches`` for each of the run's
    ``captures`` (a capture's recording calls launch nothing) and plus
    them for each of its ``replays``."""
    return {key: n + multi.captured_launches.get(key, 0) * (replays - captures)
            for key, n in counted.items()}


@contextlib.contextmanager
def planted_multi_step_fault(fault: str):
    """``train/steps.py``'s multi-step wrong in one way for the duration:
    ``step0_batch``, every step of a call on the call's first batch (both
    paths); ``skip_copy``, replays that skip the copy of their batch into
    the graph's static inputs (each replay then runs on the batch last
    copied there: the capture's, the first call's first); ``replay_short``,
    one replay fewer a call."""
    from sap3d_tpu_torch.train import steps

    cls = steps.CapturedMultiStep
    if fault == "step0_batch":
        target, name, orig = steps, "micro_batch", steps.micro_batch

        def patched(frames, targets, i):
            return orig(frames, targets, 0)
    elif fault == "skip_copy":
        target, name = cls, "_load"

        def patched(self, frames, targets, i):
            return None
    elif fault == "replay_short":
        target, name, orig = cls, "_replay", cls._replay

        def patched(self, i, frames, targets, losses):
            if i < self.k - 1:
                orig(self, i, frames, targets, losses)
    else:
        raise ValueError(f"no planted multi-step fault {fault!r}")
    saved = getattr(target, name)
    setattr(target, name, patched)
    try:
        yield
    finally:
        setattr(target, name, saved)


def ms_live(state) -> dict:
    """The tensors a train step moves, by (group, name): parameters, BN
    statistics, Adam moments and Adam step counts."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    out = {("parameters", n): p for n, p in state.model.named_parameters()}
    out.update({("statistics", n): b for n, b in state.model.named_buffers()})
    for p, entry in state.optimizer.state.items():
        for k, t in entry.items():
            out[("steps" if k == "step" else "moments", f"{names[id(p)]}.{k}")] = t
    return out


def ms_tensors(state) -> dict:
    return {key: t.detach().clone() for key, t in ms_live(state).items()}


def ms_distance(got: dict, want: dict, got_losses, want_losses) -> dict:
    """Per group of ``ms_live``, the relative L2 distance of ``got``'s
    tensors from ``want``'s, taken over the whole group (a tensor that is
    rounding noise, as the gradient of a bias ahead of a train-mode BN, does
    not decide it), and the losses' largest relative difference; NaN reads
    as infinity."""
    if got.keys() != want.keys():
        return {"tensors": math.inf}
    sums: dict[str, list[float]] = {}
    for (group, name), w in want.items():
        w, g = w.double(), got[(group, name)].double()
        acc = sums.setdefault(group, [0.0, 0.0])
        acc[0] += (g - w).square().sum().item()
        acc[1] += w.square().sum().item()
    out = {group: math.sqrt(d / max(n, 1e-300)) for group, (d, n) in sums.items()}
    out["losses"] = ((got_losses.double() - want_losses.double()).abs()
                     / want_losses.double().abs()).max().item()
    return {g: v if math.isfinite(v) else math.inf for g, v in out.items()}


def ms_control(*distances: dict) -> dict:
    """The control: group by group, the largest of the eager reruns'
    distances."""
    return {g: max(d[g] for d in distances) for g in distances[0]}


def ms_hold(got: dict, control: dict, floor: dict) -> dict:
    """``got`` within twice ``control`` plus its floor (``floor``, else
    ``MS_FLOOR_DEFAULT``), group by group."""
    limit = {g: 2 * control[g] + floor.get(g, MS_FLOOR_DEFAULT) for g in control}
    ok = got.keys() == control.keys() and all(got[g] <= limit[g] for g in limit)
    excess = max((got.get(g, math.inf) / limit[g] for g in limit), default=math.inf)
    return dict(distance=got, control=control, limit=limit, excess=excess, ok=ok)


def ms_describe(h: dict) -> str:
    return ", ".join(f"{g} {h['distance'].get(g, math.inf):.3e} (control {h['control'][g]:.3e})"
                     for g in h["control"]) + f"; excess {h['excess']:.3g}"


def ms_worst_tensors(got: dict, want: dict, *controls: dict, n: int = 3) -> dict:
    """Per group of ``ms_live``, the ``n`` tensors of ``got`` farthest from
    ``want`` by relative L2 distance (absolute where ``want`` is 0): (name,
    distance, each control's distance from ``want``, the tensor's share of
    its group's norm)."""
    def rel(a, w):
        d, norm = (a.double() - w.double()).norm().item(), w.double().norm().item()
        return d / norm if norm > 0 else d

    norms: dict[str, float] = {}
    for (group, _), w in want.items():
        norms[group] = norms.get(group, 0.0) + w.double().square().sum().item()
    out: dict[str, list] = {}
    for (group, name), w in want.items():
        share = w.double().norm().item() / math.sqrt(norms[group]) if norms[group] else 0.0
        out.setdefault(group, []).append(
            (name, rel(got[(group, name)], w),
             *(rel(c[(group, name)], w) for c in controls), share))
    return {group: sorted(rows, key=lambda row: -row[1])[:n] for group, rows in out.items()}


def adam_capturable_same(torch, tensors: dict) -> bool:
    """Whether ``capturable`` moves fused Adam at all: three steps of
    ``train/state.make_optimizer``'s optimizer on copies of ``tensors``
    (floating ones, as parameters) with the same random gradients, once
    capturable and once not; True if parameters and moments agree bit for
    bit (the update is elementwise and deterministic)."""
    from sap3d_tpu_torch.train.state import make_optimizer

    grads = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    shapes = [t.shape for t in tensors.values() if t.is_floating_point()]
    g = [[torch.randn(s, device=DEVICE, generator=grads) for s in shapes] for _ in range(3)]
    out = []
    for capturable in (True, False):
        model = torch.nn.Module()
        model.kernel = torch.nn.ParameterList(
            torch.nn.Parameter(t.detach().clone().to(DEVICE))
            for t in tensors.values() if t.is_floating_point())
        opt = make_optimizer(model, 1e-4)
        for group in opt.param_groups:
            group["capturable"] &= capturable
        for step in g:
            for p, gi in zip(model.kernel, step):
                p.grad = gi.clone()
            opt.step()
        out.append([p.detach() for p in model.kernel]
                   + [t for s in opt.state.values() for t in s.values()])
    return all(torch.equal(a, b) for a, b in zip(*out))


@contextlib.contextmanager
def cudnn_deterministic(torch):
    """cuDNN's deterministic algorithms for the duration."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def ms_micro_runner(torch):
    """(a)'s runs: ``MS_MICRO`` at ``MS_MICRO_SHAPE`` in fp32, dropout 0.5, 8
    steps from one state and one dropout generator.  Returns ``run(captured,
    fault=None)`` (8 eager single steps, or two calls of the captured
    multi-step at K = ``MS_MICRO_K``, ``fault`` planted in the second;
    the counters set to 0 just before) and the start's state dict."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import (
        CapturedMultiStep,
        make_multi_train_step,
        make_train_step,
    )

    k, n = MS_MICRO_K, 2 * MS_MICRO_K
    data = torch.Generator(device=DEVICE).manual_seed(SEED)
    frames = torch.randn((n, *MS_MICRO_SHAPE), device=DEVICE, generator=data) * 0.5
    targets = torch.rand((n, *MS_MICRO_SHAPE[:4]), device=DEVICE, generator=data)
    start = build_model(MS_MICRO, dtype="float32", device=DEVICE, seed=SEED).state_dict()

    def run(captured: bool, fault=None) -> dict:
        model = build_model(MS_MICRO, dtype="float32", device=DEVICE, seed=SEED,
                            dropout_rate=0.5)
        model.load_state_dict(start)
        state = create_train_state(model, lr=1e-4)
        drop = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
        ms = None
        reset_launch_counts(*B1_B4)  # the run below is the main path's
        if captured:
            ms = make_multi_train_step(state, k)
            if not isinstance(ms, CapturedMultiStep):
                raise AssertionError(f"a CUDA model's multi-step is {type(ms).__name__}")
            first = ms(frames[:k], targets[:k], drop)
            with planted_multi_step_fault(fault) if fault else contextlib.nullcontext():
                second = ms(frames[k:], targets[k:], drop)
            losses = torch.cat([first, second])
        else:
            step = make_train_step(state)
            losses = torch.stack([step(frames[i], targets[i], drop) for i in range(n)])
        torch.cuda.synchronize()
        counted = launch_counts(*B1_B4)
        return dict(losses=losses.clone(), tensors=ms_tensors(state), step=state.step,
                    generator=drop.get_state(), ms=ms, counted=counted,
                    launches=None if ms is None else ms_launches(counted, ms, ms.replays,
                                                                 ms.captures))

    return run, start


def multi_step_micro_hold(torch, faults=MULTI_STEP_FAULTS) -> dict:
    """Phase 17(a), and the card test ``-k multi_step``: ``ms_micro_runner``'s
    runs with cuDNN's deterministic algorithms, the captured multi-step's
    against 8 eager single steps, two more eager runs the control
    (``ms_control``, ``ms_hold`` with ``MS_MICRO_FLOOR``); the generator's
    state after the run the eager one's; every planted fault of ``faults``
    (in the second call) failing the hold.  Also read: whether fused
    Adam's ``capturable`` moves its update (``adam_capturable_same``).
    Returns the readings; raises where a hold fails."""
    k, n = MS_MICRO_K, 2 * MS_MICRO_K
    with cudnn_deterministic(torch):
        run, start = ms_micro_runner(torch)
        e1, e2, e3, c = run(False), run(False), run(False), run(True)
        faulty = {f: run(True, f) for f in faults}
        capturable_same = adam_capturable_same(torch, start)
    control = ms_control(*(ms_distance(e["tensors"], e1["tensors"], e["losses"], e1["losses"])
                           for e in (e2, e3)))
    hold = ms_hold(ms_distance(c["tensors"], e1["tensors"], c["losses"], e1["losses"]),
                   control, MS_MICRO_FLOOR)
    fault_holds = {f: ms_hold(ms_distance(r["tensors"], e1["tensors"], r["losses"],
                                          e1["losses"]), control, MS_MICRO_FLOOR)
                   for f, r in faulty.items()}
    ms, launches = c["ms"], c["launches"]
    same_generator = torch.equal(c["generator"], e1["generator"])
    print(f"[ms] (a) {MS_MICRO} {list(MS_MICRO_SHAPE)} fp32, dropout 0.5, deterministic "
          f"cuDNN: 2 calls of {k} (warm-up and capture {ms.capture_s:.3f} s, then {ms.replays} "
          f"replays) against {n} eager steps: {ms_describe(hold)}; generator as the eager "
          f"run's: {same_generator}; losses captured "
          f"{[round(v, 4) for v in c['losses'].tolist()]}, eager "
          f"{[round(v, 4) for v in e1['losses'].tolist()]}", flush=True)
    print(f"[ms]   launches captured a step {ms.captured_launches}; the run's counted "
          f"(Python calls, the capture's recording one step among them) {c['counted']} + "
          f"captured x ({ms.replays} replays - {ms.captures} capture) = {launches}", flush=True)
    print("[ms]   planted faults: " + "; ".join(
        f"{f} excess {h['excess']:.3g} ({'passes: void' if h['ok'] else 'fails'})"
        for f, h in fault_holds.items()), flush=True)
    print(f"[ms]   fused Adam, capturable against not, three steps on the same gradients: "
          f"parameters and moments bit for bit {capturable_same}", flush=True)
    if not hold["ok"] or not same_generator or c["step"] != n:
        raise AssertionError(f"(a) the captured steps are not the eager ones: {hold}, "
                             f"generator {same_generator}, step {c['step']}")
    passed = [f for f, h in fault_holds.items() if h["ok"]]
    if passed:
        raise AssertionError(f"(a) the hold passes the planted faults {passed}: void")
    if not (ms.replays > 0 and ms.captured_launches["B2"] > 0
            and ms.captured_launches["B3"] > 0):
        raise AssertionError(f"(a) no replay of the fp32 kernels: {ms.captured_launches}, "
                             f"{ms.replays} replays")
    return dict(hold=hold, faults=fault_holds, capturable_same=capturable_same,
                capture_s=ms.capture_s, replays=ms.replays,
                captured_launches=ms.captured_launches, launches=launches,
                losses=c["losses"].tolist())


def ms_flagship_runner(torch, calibrated):
    """(b)'s runs: the calibrated flagship in fp32 at batch ``BATCH``,
    dropout 0.5, K = ``MS_FLAGSHIP_K``, its multi-step's warm-up call run
    (the counters set to 0 just before it) and the state (parameters,
    buffers, moments, step counts) and the generator saved after it.
    Returns ``run(kind)``, which restores that state in place and runs K
    eager steps (``"eager"``), one replayed call (``"replayed"``; the
    counters set to 0 just before it) or one with a planted fault, and the
    multi-step and its warm-up call's launches and seconds."""
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import make_multi_train_step, make_train_step

    k = MS_FLAGSHIP_K
    model = build_model("unet++", dtype="float32", device=DEVICE, dropout_rate=0.5)
    model.load_state_dict(calibrated)
    state = create_train_state(model, lr=1e-4)
    data = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    frames = torch.randn((2 * k, BATCH, 16, SIZE, SIZE, 3), device=DEVICE,
                         generator=data) * 0.3
    targets = torch.rand((2 * k, BATCH, 16, SIZE, SIZE), device=DEVICE, generator=data)
    drop = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    multi = make_multi_train_step(state, k)
    reset_launch_counts(*B1_B4)  # the warm-up call: K eager steps and the capture
    t0 = time.perf_counter()
    multi(frames[:k], targets[:k], drop)
    torch.cuda.synchronize()
    warm = dict(seconds=time.perf_counter() - t0,
                launches=ms_launches(launch_counts(*B1_B4), multi, multi.replays,
                                     multi.captures))
    saved, saved_gen, saved_step = ms_tensors(state), drop.get_state(), state.step
    live = ms_live(state)
    mf, mt = frames[k:], targets[k:]
    eager = make_train_step(state)

    def run(kind: str) -> dict:
        with torch.no_grad():
            for key, t in live.items():
                t.copy_(saved[key])
        drop.set_state(saved_gen)
        state.step = saved_step
        out = {}
        if kind == "eager":
            losses = torch.stack([eager(mf[i], mt[i], drop) for i in range(k)])
        elif kind == "replayed":
            reset_launch_counts(*B1_B4)  # the replayed call, the main path's run
            replays = multi.replays
            losses = multi(mf, mt, drop)
            torch.cuda.synchronize()
            out["counted"] = launch_counts(*B1_B4)
            out["launches"] = ms_launches(out["counted"], multi, multi.replays - replays, 0)
        else:
            with planted_multi_step_fault(kind):
                losses = multi(mf, mt, drop)
        torch.cuda.synchronize()
        return dict(out, losses=losses.clone(), tensors=ms_tensors(state))

    return run, multi, warm


def ms_flagship_hold(torch, calibrated, card) -> dict:
    """Phase 17(b): ``ms_flagship_runner``'s runs with cuDNN's
    deterministic algorithms: three eager runs (the second and third the
    control), one replayed call and one with ``skip_copy``.  Held: the
    replayed call's first loss bit for bit the eager one's (the forward is
    deterministic: the two eager runs' first losses agree bit for bit), its
    state within ``ms_hold`` (``MS_FLAGSHIP_FLOOR``) of the eager run's,
    and ``skip_copy`` breaking the bit equality and failing the state
    hold."""
    k = MS_FLAGSHIP_K
    with cudnn_deterministic(torch):
        run, multi, warm = ms_flagship_runner(torch, calibrated)
        runs = {name: run(kind) for name, kind in (
            ("eager", "eager"), ("control", "eager"), ("control2", "eager"),
            ("replayed", "replayed"), ("skip_copy", "skip_copy"))}
    warm_s = warm["seconds"]
    warm, replayed, counted = warm["launches"], runs["replayed"]["launches"], \
        runs["replayed"]["counted"]
    e, ctl, ctl2, r, f = (runs[n] for n in ("eager", "control", "control2", "replayed",
                                            "skip_copy"))
    control = ms_control(*(ms_distance(c["tensors"], e["tensors"], c["losses"], e["losses"])
                           for c in (ctl, ctl2)))
    hold = ms_hold(ms_distance(r["tensors"], e["tensors"], r["losses"], e["losses"]), control,
                   MS_FLAGSHIP_FLOOR)
    fault_hold = ms_hold(ms_distance(f["tensors"], e["tensors"], f["losses"], e["losses"]),
                         control, MS_FLAGSHIP_FLOOR)
    worst = ms_worst_tensors(r["tensors"], e["tensors"], ctl["tensors"], ctl2["tensors"])
    first_equal = torch.equal(r["losses"][0], e["losses"][0])
    control_equal = all(torch.equal(c["losses"][0], e["losses"][0]) for c in (ctl, ctl2))
    fault_equal = torch.equal(f["losses"][0], e["losses"][0])
    launches = {key: n + replayed[key] for key, n in warm.items()}
    print(f"[ms] (b) the flagship fp32, batch {BATCH}, dropout 0.5, deterministic cuDNN, K = "
          f"{k}: warm-up call and capture {warm_s:.2f} s (capture {multi.capture_s:.3f} s); "
          f"first loss replayed {r['losses'][0].item()!r}, eager {e['losses'][0].item()!r}, "
          f"control {ctl['losses'][0].item()!r}: bit for bit {first_equal} (control "
          f"{control_equal}); the state after the call against the eager run: "
          f"{ms_describe(hold)}; skip_copy's first loss {f['losses'][0].item()!r} (bit for bit "
          f"{fault_equal}), its state {ms_describe(fault_hold)} "
          f"({'passes: void' if fault_hold['ok'] else 'fails'}); launches captured a step "
          f"{multi.captured_launches}; the warm-up call (K eager steps and the capture, counted "
          f"less the recording) {warm}, the replayed call (counted {counted} + captured x "
          f"{k} replays) {replayed}; together {launches}  [{card}]", flush=True)
    print("[ms] (b) per tensor, the replayed call's largest relative L2 distances from the "
          "eager run (the two controls' beside, and the tensor's share of its group's norm): "
          + "; ".join(f"{group}: " + ", ".join(
              f"{name} {d:.3e} (controls {c1:.3e}, {c2:.3e}; share {share:.2e})"
              for name, d, c1, c2, share in rows) for group, rows in worst.items()), flush=True)
    if not (first_equal and control_equal and hold["ok"]):
        raise AssertionError(f"(b) the replayed call is not the eager steps: first loss "
                             f"{first_equal} (control {control_equal}), {hold}")
    if fault_equal or fault_hold["ok"]:
        raise AssertionError(f"(b) skip_copy keeps the first loss bit for bit ({fault_equal}) "
                             f"or passes the state hold ({fault_hold['ok']}): void")
    res = dict(hold=hold, fault_hold=fault_hold, worst_tensors=worst,
               first_loss_bitwise=first_equal, warm_s=warm_s, capture_s=multi.capture_s,
               replays=k, captured_launches=multi.captured_launches,
               launches_warm_up=warm, launches_replayed=replayed, launches=launches)
    del multi, run, runs
    torch.cuda.empty_cache()
    return res


def ms_spread_of(runs: list, n_eager: int, floor: dict) -> dict:
    """What a hold of ``ms_hold`` stands on, from ``runs`` from one start,
    the first ``n_eager`` eager and the rest captured: per group, the range
    of the distances of eager pairs and of captured-eager pairs (their
    largest, the ceiling, is what ``floor`` should be), and over every
    choice of an eager reference and two eager controls, how often twice
    the control alone and the hold with ``floor`` fail a captured run, or
    another eager run, in the captured run's place."""
    d = {(a, b): ms_distance(runs[a]["tensors"], runs[b]["tensors"], runs[a]["losses"],
                             runs[b]["losses"])
         for a in range(len(runs)) for b in range(n_eager) if a != b}
    pairs = {"eager": [key for key in d if key[0] < key[1]],
             "captured": [key for key in d if key[0] >= n_eager]}
    ranges = {g: {kind: (min(d[key][g] for key in keys), max(d[key][g] for key in keys))
                  for kind, keys in pairs.items()} for g in d[pairs["eager"][0]]}
    holds = {}
    for kind, cands in (("captured", range(n_eager, len(runs))), ("eager", range(n_eager))):
        count = dict(choices=0, bare_fail=0, floor_fail=0, worst_excess=0.0)
        for i, j, m in itertools.permutations(range(n_eager), 3):
            if j > m:
                continue
            control = ms_control(d[j, i], d[m, i])
            for c in (c for c in cands if c not in (i, j, m)):
                bare, held = ms_hold(d[c, i], control, {}), ms_hold(d[c, i], control, floor)
                count["choices"] += 1
                count["bare_fail"] += not bare["ok"]
                count["floor_fail"] += not held["ok"]
                count["worst_excess"] = max(count["worst_excess"], held["excess"])
        holds[kind] = count
    return dict(ranges=ranges, holds=holds)


def ms_spread(torch, card, n: int) -> dict:
    """``chip_smoke.py --multi-step-spread N``: what phase 17's holds stand
    on.  ``n`` eager runs and ``n`` captured runs of (a)
    (``ms_micro_runner``), and ``n`` eager runs and ``n`` replayed calls of
    (b) from one snapshot (``ms_flagship_runner``), each read by
    ``ms_spread_of`` against its floor."""
    from sap3d_tpu_torch.models.registry import build_model

    out = {}
    with cudnn_deterministic(torch):
        run, _ = ms_micro_runner(torch)
        runs = [run(captured) for captured in [False] * n + [True] * n]
        out["a"] = ms_spread_of(runs, n, MS_MICRO_FLOOR)
        out["a"]["first_differing_step"] = [
            next((i for i in range(len(r["losses"]))
                  if not torch.equal(r["losses"][i], runs[0]["losses"][i])), None)
            for r in runs[1:]]
        del run, runs
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        model = build_model("unet++", dtype="bfloat16", device=DEVICE, seed=SEED)
        x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
        calibrate_and_randomize_bn(torch, model, x, gen)
        calibrated = {k: v.detach().clone() for k, v in model.state_dict().items()}
        del model, x
        torch.cuda.empty_cache()
        run, multi, _ = ms_flagship_runner(torch, calibrated)
        runs = [run(kind) for kind in ["eager"] * n + ["replayed"] * n]
        out["b"] = ms_spread_of(runs, n, MS_FLAGSHIP_FLOOR)
        out["b"]["first_losses"] = sorted({r["losses"][0].item() for r in runs})
        del run, multi, runs
    torch.cuda.empty_cache()
    for part, res in out.items():
        for g, r in res["ranges"].items():
            print(f"[spread] ({part}) {g}: eager pairs {r['eager'][0]:.3e} to "
                  f"{r['eager'][1]:.3e}, captured-eager pairs {r['captured'][0]:.3e} to "
                  f"{r['captured'][1]:.3e}", flush=True)
        for kind, h in res["holds"].items():
            print(f"[spread] ({part}) a {kind} run in the captured run's place: twice the "
                  f"control alone fails {h['bare_fail']} of {h['choices']} choices, the hold "
                  f"with its floor {h['floor_fail']} (worst excess {h['worst_excess']:.3g})  "
                  f"[{card}]", flush=True)
    print(f"[spread] (a) first differing step from the first eager run (0-based; eager "
          f"runs, then captured): {out['a']['first_differing_step']}; (b) first losses "
          f"{out['b']['first_losses']}", flush=True)
    return out


def ms_device_busy(torch, fn) -> dict | None:
    """The device time of one call of ``fn`` (torch.profiler, the card's
    activity alone: kernels, copies and memsets) against its wall time,
    and the hand-written kernels the card ran (``MS_HAND_KERNELS`` in a
    device event's name), or None where the profiler saw no device time.
    Without the host's activity the trace costs the call little and reads
    in seconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the raw events: key_averages() would build every event's tree first
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.duration_ns() for e in events) / 1e6
    hand = sum(any(key in e.name() for key in MS_HAND_KERNELS) for e in events)
    return dict(device_ms=device_ms, wall_ms=wall_ms, hand_kernels=hand) if device_ms > 0 \
        else None


def ms_readings(torch, label: str, model, card) -> dict:
    """Phase 17(c) for ``model`` (bf16, batch ``BATCH``, its dropout): calls of
    ``MS_TIMED_K`` steps, eager single steps and the captured multi-step, in
    legs eager, captured, eager again (the control), ``MS_TIMED_CALLS``
    timed calls each (``_timing.step_times``; ms a step, the median,
    fastest and slowest); host ms a call (until the call returns); peak
    memory allocated and reserved (a graph's private pool is reserved, not
    allocated, between replays); the captured leg's first call (warm-up
    and capture) apart; one profiled call of each (``ms_device_busy``); B2
    and B3 launches a step, captured against eager; the hand-written
    kernels in the two profiled calls' traces, which must agree.  Claims
    nothing."""
    import statistics

    from sap3d_tpu_torch.scripts import _timing
    from sap3d_tpu_torch.train.state import create_train_state
    from sap3d_tpu_torch.train.steps import make_multi_train_step, make_train_step

    k, device = MS_TIMED_K, torch.device(DEVICE)
    state = create_train_state(model, lr=1e-4)
    data = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    frames = torch.randn((k, BATCH, 16, SIZE, SIZE, 3), device=DEVICE, generator=data) * 0.3
    targets = torch.rand((k, BATCH, 16, SIZE, SIZE), device=DEVICE, generator=data)
    drop = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    step = make_train_step(state)
    multi = make_multi_train_step(state, k)
    out = {}

    def eager():
        return torch.stack([step(frames[i], targets[i], drop) for i in range(k)])

    def captured():
        out["losses"] = multi(frames, targets, drop)

    def leg(fn, warmup: int) -> dict:
        host = []

        def timed():
            t0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - t0)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = _timing.step_times(timed, MS_TIMED_CALLS, device, warmup=warmup)
        return dict(_timing.step_summary([t / k for t in times], clips=BATCH),
                    host_ms_per_call=statistics.median(host[warmup:]) * 1e3,
                    peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                    reserved_gib=torch.cuda.max_memory_reserved() / 2 ** 30)

    reset_launch_counts(*B1_B4)
    out["eager"] = leg(eager, 1)
    eager_per_step = {key: n / ((1 + MS_TIMED_CALLS) * k)
                      for key, n in launch_counts(*B1_B4).items()}
    reset_launch_counts(*B1_B4)  # the captured leg, its first call included
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    losses = out.pop("losses")
    out["captured"] = leg(captured, 0)
    counted, replays = launch_counts(*B1_B4), multi.replays
    launches = ms_launches(counted, multi, replays, multi.captures)
    losses = torch.cat([losses, out.pop("losses")])
    out["eager_again"] = leg(eager, 0)
    prof = {name: ms_device_busy(torch, fn) for name, fn in (("eager", eager),
                                                             ("captured", captured))}
    out.pop("losses")
    idle = {name: None if p is None else max(0.0, 1 - p["device_ms"] / p["wall_ms"])
            for name, p in prof.items()}
    finite = bool(torch.isfinite(losses).all())
    hand = {name: None if p is None else p["hand_kernels"] for name, p in prof.items()}
    out.update(first_call_s=first_s, capture_s=multi.capture_s, replays=replays,
               captured_launches=multi.captured_launches, eager_launches_per_step=eager_per_step,
               launches=launches, idle_share=idle, profile=prof, hand_kernels=hand,
               losses_finite=finite)
    legs = "; ".join(
        f"{name} {r['ms']:.2f} ms a step [{r['fastest_ms']:.2f}, {r['slowest_ms']:.2f}], "
        f"{r['clips_per_s']:.1f} clips/s, host {r['host_ms_per_call']:.1f} ms a call, peak "
        f"{r['peak_gib']:.2f} GiB allocated, {r['reserved_gib']:.2f} GiB reserved (the "
        "graph's pool among it)" for name, r in
        ((n, out[n]) for n in ("eager", "captured", "eager_again")))
    print(f"[ms] (c) {label}, bf16, batch {BATCH}, calls of {k} steps ({MS_TIMED_CALLS} timed "
          f"a leg): {legs}; the captured leg's first call (warm-up and capture) "
          f"{first_s:.2f} s, capture {multi.capture_s:.3f} s; idle share "
          + ", ".join(f"{n} {'not measured' if v is None else f'{v:.3f}'}"
                      for n, v in idle.items())
          + f"; B2/B3 a step captured {multi.captured_launches['B2']}/"
          f"{multi.captured_launches['B3']}, eager {eager_per_step['B2']:g}/"
          f"{eager_per_step['B3']:g}; the captured leg's launches counted {counted} + "
          f"captured x ({replays} replays - {multi.captures} capture) = {launches}; "
          f"hand-written kernels in one profiled call's trace, eager "
          f"{hand['eager']}, captured {hand['captured']}  [{card}]", flush=True)
    want = {key: eager_per_step[key] for key in ("B2", "B3")}
    got = {key: multi.captured_launches[key] for key in ("B2", "B3")}
    if got != want or not want["B2"] > 0 or not finite:
        raise AssertionError(f"(c) {label}: launches a step captured {got}, eager {want}; "
                             f"finite losses {finite}")
    if None not in hand.values() and not hand["captured"] == hand["eager"] > 0:
        raise AssertionError(f"(c) {label}: the replayed call ran {hand['captured']} "
                             f"hand-written kernels, the eager one {hand['eager']}")
    del multi, step, state, frames, targets
    torch.cuda.empty_cache()
    return out


def ms_cli(torch, card) -> dict:
    """Phase 17(d): ``cli train --steps-per-call MS_CLI_K`` once, the
    flagship in bf16 on a synthetic dataset, max-steps 8: calls end at steps
    4 and 8, and the JAX rule logs at 4 and 8 (below 10 + K), validates and
    saves at 4 and 8 (validiter and saveiter 3: ``step % 3 < K``; single
    steps would have validated and saved at 3 and 6)."""
    import shutil

    import numpy as np

    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset
    from sap3d_tpu_torch.train import trainer as trainer_module
    from sap3d_tpu_torch.train.checkpoint import checkpoint_steps

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "smoke_ms")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    made = []
    orig = trainer_module.make_multi_train_step

    def spy(*args, **kw):
        made.append(orig(*args, **kw))
        return made[-1]

    cwd = os.getcwd()
    try:
        data = make_synthetic_dataset(os.path.join(root, "data"), num_videos=2,
                                      frames_per_video=40, size=(SIZE, SIZE))
        argv = ["train", "--structure", "unet++", "--dtype", "bfloat16",
                "--frames", data["frame_dirs"], "--densities", data["density_dirs"],
                "--imagesize", str(SIZE), "--batch", "2", "--epoch", "4", "--max-steps", "8",
                "--steps-per-call", str(MS_CLI_K), "--plotiter", "1000", "--validiter", "3",
                "--saveiter", "3", "--info", "ms", "--threads", "4", "--device", DEVICE]
        os.chdir(root)
        trainer_module.make_multi_train_step = spy
        reset_launch_counts(*B1_B4)
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counted = launch_counts(*B1_B4)
        (run,) = os.listdir(os.path.join(root, "model"))
        with open(os.path.join(root, "logs", run, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        ckpts = checkpoint_steps(os.path.join(root, "model", run))
    finally:
        trainer_module.make_multi_train_step = orig
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
    (multi,) = made
    launches = ms_launches(counted, multi, multi.replays, multi.captures)
    logged = [r["step"] for r in records if "loss" in r]
    validated = [r["step"] for r in records if "cc" in r]
    saved = [r["step"] for r in records if "save_dispatch_s" in r]
    losses = [r["loss"] for r in records if "loss" in r]
    print(f"[ms] (d) cli train --steps-per-call {MS_CLI_K} --max-steps 8 (the flagship, bf16, "
          f"batch 2): exit {rc} in {seconds:.1f} s; logged at {logged} (losses "
          f"{[round(v, 3) for v in losses]}), validated at {validated}, saved at {saved}, "
          f"checkpoints {ckpts}; {type(multi).__name__}, {multi.replays} replays; launches "
          f"counted {counted} + captured x ({multi.replays} replays - {multi.captures} "
          f"capture) = {launches}  [{card}]", flush=True)
    if rc != 0 or logged != [4, 8] or validated != [4, 8] or saved != [4, 8] \
            or ckpts != [4, 8] or not all(np.isfinite(losses)) or multi.replays != MS_CLI_K:
        raise AssertionError("(d) cli train --steps-per-call did not follow the JAX rule")
    return dict(seconds=seconds, logged=logged, validated=validated, saved=saved,
                checkpoints=ckpts, replays=multi.replays, launches=launches)


def phase_multi_step(torch, calibrated, card) -> dict:
    """Phase 17: K train steps per call (``make_multi_train_step``)."""
    from sap3d_tpu_torch.models.registry import build_model

    t0 = time.perf_counter()
    seconds = {}

    def part(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.empty_cache()
        seconds[name] = time.perf_counter() - t
        return out

    def readings(label, build):
        return ms_readings(torch, label, build(), card)

    def flagship():
        model = build_model("unet++", dtype="bfloat16", device=DEVICE, dropout_rate=0.5)
        model.load_state_dict(calibrated)
        return model

    res = dict(micro=part("a", lambda: multi_step_micro_hold(torch)),
               flagship=part("b", lambda: ms_flagship_hold(torch, calibrated, card)))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    res["readings"] = {
        "flagship": part("c flagship", lambda: readings("the flagship", flagship)),
        "gn": part("c GN", lambda: readings("the GN SA decoder",
                                            lambda: build_gn_model(torch, "bfloat16", gen=gen))),
    }
    res["cli"] = part("d", lambda: ms_cli(torch, card))
    res["seconds"] = time.perf_counter() - t0
    print(f"[ms] phase 17 in {res['seconds']:.2f} s ("
          + ", ".join(f"({n}) {v:.1f} s" for n, v in seconds.items()) + ")", flush=True)
    return res


BUILD_KERNELS = {
    "flash_attention_fwd": (("flash_fwd_bf16", "flash_row_stats", "split_planes"),
                            ("flash_fwd_bf16", "flash_row_stats", "split_planes")),
    "flash_attention_nolse": (("flash_fwd_bf16", "split_planes"),
                              ("flash_fwd_bf16", "split_planes")),
    "flash_attention_bwd": (("flash_bwd_dkdq_split", "flash_bwd_dkdq", "flash_bwd_dv",
                             "bwd_row_stats", "round_to_bf16", "split_planes"),
                            ("flash_bwd_dkdq", "flash_bwd_dv", "split_planes")),
}
# The wgmma kernels of each source whose SASS must hold HGMMA and UTMALDG
# (phase 2); the forward's instantiations (B1 and B2 in the forward's
# library, B6's second pass in flash_attention_nolse.cu's) are
# ``INSTANTIATIONS``'s, the row-stats kernel's one per (d tile, planes), the
# backward's follow its dispatch on C.
SASS_KERNELS = {"flash_attention_fwd": "flash_row_stats|flash_fwd_bf16",
                "flash_attention_nolse": "flash_fwd_bf16",
                "flash_attention_bwd": "flash_bwd_dkdq_split|flash_bwd_dkdq|flash_bwd_dv"}


def report_build(source: str, log: str) -> None:
    """Phase 2 for a source of ``BUILD_KERNELS``: registers, spills and
    static shared memory of each kernel instantiation from ptxas (the wgmma
    kernels' shared memory is dynamic: phase 3 prints it per shape), and
    ptxas's warnings that it serialised a kernel's wgmma (C7514, C7515,
    C7508); a kernel that must not spill and does fails the run."""
    import re

    names, no_spill = BUILD_KERNELS[source]
    kernel, spill = None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"({'|'.join(names)})(I((?:L[ib]\d+E)+))?", line)
            args = re.findall(r"L[ib](\d+)E", m.group(2) or "") if m else []
            kernel = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else "?"
        elif kernel and "spill stores" in line:
            spill = sum(int(n) for n in re.findall(r"(\d+) bytes spill", line))
        elif kernel and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            print(f"[build]   {kernel}: {regs} registers, {spill} bytes spilled, "
                  f"{smem.group(1) if smem else 0} bytes of static shared memory", flush=True)
            if spill and kernel.startswith(no_spill):
                raise AssertionError(f"{kernel} spills {spill} bytes")
            kernel, spill = None, None
        elif "C7515" in line or "C7514" in line or "C7508" in line:
            m = re.search(rf"({'|'.join(names)})I((?:L[ib]\d+E)+)", line)
            code = re.search(r"C75\d\d", line).group(0)
            if m:
                args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))
                where = f"{m.group(1)}<{args}>"
            else:
                where = line.strip()[-120:]
            print(f"[build]   {code}: wgmma serialized in {where}", flush=True)


def check_sass(build, source: str) -> dict:
    """Phase 2: the wgmma kernels of ``source`` (``SASS_KERNELS``; bf16 and
    split fp32) issue wgmma and take their tiles by TMA: cuobjdump's SASS of
    every instantiation holds HGMMA and UTMALDG instructions.  Returns their
    counts per instantiation."""
    import os
    import re

    names = SASS_KERNELS[source]
    tool = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build._library_path(source)[1]],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(rf"({names})I((?:L[ib]\d+E)+)", line)
            args = ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) if m else ""
            kernel = f"{m.group(1)}<{args}>" if m else None
            if kernel:
                counts[kernel] = {"HGMMA": 0, "UTMALDG": 0}
        elif kernel:
            for op in ("HGMMA", "UTMALDG"):
                counts[kernel][op] += op in line
    missing = [k for k, n in counts.items() if not (n["HGMMA"] and n["UTMALDG"])]
    print(f"[build]   SASS of {len(counts)} wgmma instantiations of {source}.cu: HGMMA "
          f"{min(n['HGMMA'] for n in counts.values())}-{max(n['HGMMA'] for n in counts.values())}"
          f", UTMALDG {min(n['UTMALDG'] for n in counts.values())}-"
          f"{max(n['UTMALDG'] for n in counts.values())} per kernel", flush=True)
    if missing or not counts:
        raise AssertionError(f"{source}: wgmma kernels without HGMMA or UTMALDG: {missing} "
                             f"({len(counts)} found)")
    return counts


def kernel_entry(name, source, replaces, launches, rows, extra_err=(), more_rows=(),
                 dtype="bfloat16"):
    """One kernel's entry of the JSON line: times summed over the ``dtype``
    site calls of ``rows`` (one batch-16 step of the model whose sites they
    are); bound_by is the term that holds most of the summed bound.
    ``more_rows`` (the same kernel at another model's sites) count towards
    max_abs_err."""
    main_rows = [r for r in rows if r["dtype"] == dtype]
    total = {key: sum(r[key] for r in main_rows) for key in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in main_rows]
    t_ops = sum(r["bound_ms"] for r in main_rows if r["bound_by"] == "operations")
    return {
        "name": name, "route": "cuda", "source": f"sap3d_tpu_torch/csrc/{source}.cu",
        "replaces": replaces, "launches": launches,
        "max_abs_err": max([r["max_abs_err"] for r in list(rows) + list(more_rows)]
                           + list(extra_err)),
        "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
        "bound_by": "operations" if t_ops >= total["bound_ms"] / 2 else "bytes",
        "library_ms": None if None in lib else sum(lib),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json-out", default=None,
                   help="also profile one forward and one train step by layer and "
                        "write the details here")
    p.add_argument("--multi-step-spread", type=int, default=0, metavar="N",
                   help="only read what phase 17's holds stand on, from N eager and N "
                        "captured runs of (a) and of (b), after the build")
    p.add_argument("--multihost-repeats", type=int, default=1,
                   help="run phase 14's (b) this many times and print every pair's "
                        "readings")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU",
              file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"[card] {card}", flush=True)
        t_start = time.perf_counter()

        def phase_ended(n: int) -> None:
            print(f"[time] phase {n} ended {time.perf_counter() - t_start:.1f} s after the "
                  "card's line", flush=True)
        # float32 references in full float32: no TF32 in products or in cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        from concurrent.futures import ThreadPoolExecutor

        from sap3d_tpu_torch.models.registry import build_model
        from sap3d_tpu_torch.ops import attention as ta
        from sap3d_tpu_torch.ops.cuda import build
        from sap3d_tpu_torch.ops.cuda import flash_attention as fa
        from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
        from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse

        def timed_build(source):
            t0 = time.perf_counter()
            return build.build(source), time.perf_counter() - t0

        sources = (fa.SOURCE, fb.SOURCE, nolse.SOURCE)
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
            builds = dict(zip(sources, pool.map(timed_build, sources)))
        for source, (log, secs) in builds.items():
            print(f"[build] {source}.cu built in {secs:.2f} s", flush=True)
            report_build(source, log)
        sass = {source: check_sass(build, source) for source in SASS_KERNELS}
        for source in (fa.SOURCE, nolse.SOURCE):
            n = sum(name.startswith("flash_fwd_bf16") for name in sass[source])
            if n != len(fa.INSTANTIATIONS):
                raise AssertionError(f"{n} forward instantiations compiled in {source}.cu, "
                                     f"launch_plan names {len(fa.INSTANTIATIONS)}")
        n_stats = sum(name.startswith("flash_row_stats") for name in sass[fa.SOURCE])
        if n_stats != 4 * len(set(fa.PLANES.values())):
            raise AssertionError(f"{n_stats} row-stats instantiations compiled, not one per "
                                 "(d tile, planes)")

        phase_ended(2)
        if args.multi_step_spread:
            spread = ms_spread(torch, card, args.multi_step_spread)
            print(json.dumps({"multi_step_spread": spread}), flush=True)
            return 0
        flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
        rows = phase_kernels(torch, fa, fb, flush)
        phase_ended(3)

        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        model = build_model("unet++", dtype="bfloat16", device=DEVICE, seed=SEED)
        x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
        calibrate_and_randomize_bn(torch, model, x, gen)
        calibrated = {k: v.detach().clone() for k, v in model.state_dict().items()}
        fwd = phase_forward(torch, fa, model, x)
        thr = phase_throughput(torch, model, x, card)
        prof = phase_profile(torch, model, x) if args.json_out else None
        phase_ended(4)
        launches = phase_predictor(torch, fa, model)
        phase_ended(5)
        del x
        train = phase_train(torch, fa, fb, model, card, profile=bool(args.json_out))
        phase_ended(6)
        del model
        torch.cuda.empty_cache()

        gn_model = build_gn_model(torch, "bfloat16", gen=gen)
        x = torch.randn(BATCH, 16, SIZE, SIZE, 3, device=DEVICE, generator=gen) * 0.3
        gn_fwd = phase_gn_forward(torch, fa, gn_model, x, card)
        gn_prof = None
        if args.json_out:
            from sap3d_tpu_torch.train.steps import make_eval_step

            gn_prof = profile_device_time(torch, lambda: make_eval_step(gn_model)(x),
                                          "one GN kernel-path forward")
        del x
        gn_sites = {name: tuple(site["shape"]) for name, site in gn_fwd["sites"].items()}
        gn_rows = phase_kernels(torch, fa, fb, flush, gn_sites)
        # B4 at the widest site B3 and B4 take (deconv_pool4: d = 128, C = 1024)
        wide = {n: s_ for n, s_ in gn_sites.items() if s_[2] > fb.RESIDENT_MAX_D}
        if not wide:
            raise AssertionError(f"no GN site of d above {fb.RESIDENT_MAX_D}: {gn_sites}")
        gn_b4_rows = phase_b4(torch, fa, fb, flush, wide)
        b5_rows, b5_memory = phase_b5(torch, fa, fb, ta, flush, gn_sites)
        gn_launches = phase_gn_predictor(torch, fa, gn_model)
        gn_train = phase_gn_train(torch, fa, fb, ta, gn_model,
                                  {n: (tuple(s_["shape"]), s_["route"])
                                   for n, s_ in gn_fwd["sites"].items()},
                                  card, profile=bool(args.json_out))
        del gn_model
        torch.cuda.empty_cache()
        phase_ended(7)
        zoo, zoo_sites = phase_zoo(torch, fa, set(SITES.values()) | set(gn_sites.values()))
        # B1, B2 and B3 at the sites no earlier phase measured (the 'full'
        # head's x_0_1_sa), at the zoo's batch of 2
        print(f"[zoo] sites of at least {fa.BLOCK_Q} queries no earlier phase measured: "
              f"{zoo_sites}", flush=True)
        if "x_0_1_sa" not in zoo_sites:
            raise AssertionError("the 'full' head's x_0_1_sa did not reach a kernel")
        zoo_rows = phase_kernels(torch, fa, fb, flush, zoo_sites, batch=2)
        if not all(len(zoo_rows[n]) == 2 * len(zoo_sites) for n in ("B1", "B2", "B3")):
            raise AssertionError("B1, B2 and B3 were not all held at the zoo's new sites")

        phase_ended(8)
        ring, b4_rows = phase_ring(torch, fa, fb, calibrated, flush, card,
                                   profile=bool(args.json_out))
        torch.cuda.empty_cache()
        tshard = phase_time_shard(torch, fa, fb, calibrated, card)
        phase_ended(9)
        b6_rows, stats_rows = phase_b6(torch, fa, nolse, flush)
        bisect = phase_bisect(torch, fa, nolse, ta, card)
        phase_ended(10)
        evaluation = phase_eval(torch, fa, calibrated, card)
        phase_ended(11)
        tf_reader = phase_tf_reader()
        quirk_model, tf_mapping = phase_tf_mapping(torch, calibrated)
        tf_quirk = phase_tf_quirk(torch, fa, quirk_model, calibrated, card)
        del quirk_model
        torch.cuda.empty_cache()
        phase_ended(12)
        dp = [phase_data_parallel(torch, calibrated, card)]
        if torch.cuda.device_count() >= 2:
            from sap3d_tpu_torch.core.mesh import make_mesh

            dp.append(phase_data_parallel(torch, calibrated, card, mesh=make_mesh(2)))
        else:
            print(f"[dp] over NCCL on two cards: not run ({torch.cuda.device_count()} card "
                  "visible); gloo on cuda:0 twice ran", flush=True)
        torch.cuda.empty_cache()
        phase_ended(13)
        mh = phase_multihost(torch, card, repeats=args.multihost_repeats)
        phase_ended(14)
        from sap3d_tpu_torch.core.sharding_rules import make_mesh_2d

        tp = [phase_tensor_parallel(torch, calibrated, card, dp=dp[0])]
        if torch.cuda.device_count() >= 4:
            tp.append(phase_tensor_parallel(torch, calibrated, card, mesh=make_mesh_2d(2, 2),
                                            dp=dp[0]))
        else:
            print(f"[tp] over NCCL on four cards: not run ({torch.cuda.device_count()} card(s) "
                  "visible); gloo on cuda:0 four times ran", flush=True)
        torch.cuda.empty_cache()
        phase_ended(15)
        scripts = phase_scripts(torch, card)
        phase_ended(16)
        multi = phase_multi_step(torch, calibrated, card)
        phase_ended(17)
        del calibrated
        torch.cuda.empty_cache()

        fit, gn_fit = train["fit"]["launches"], gn_train["fit"]["launches"]
        ring_fwd, ring_step = ring["launches"]["forward"], ring["launches"]["step"]
        b6_launches = bisect["launches"]["nolse"]["B6"]
        rs_launches = bisect["launches"]["nolse"]["RS"]
        # B5: no registry route reaches it (B3 takes every GN site); its
        # launches are its own entry point's, on the GN train step's tensors
        b5_launches = sum(r["launches"]["B5"] for r in gn_train["b5_in_step"]["bf16"].values())
        fit32 = train["end_to_end"]["float32"]["launches"]
        ring32 = ring["launches"]["fp32_step"]
        # phase 9(e): the sharded bf16 step, the sharded fp32 steps (the
        # flagship and p3d_micro_sa) and every registry name's sharded step
        ts_step = tshard["launches"]
        ts32 = {k: tshard["fp32"]["launches"][k] + tshard["fp32_micro"]["launches"][k]
                for k in ("B2", "B4")}
        ts_zoo = {k: sum(z["launches"][k] for z in tshard["zoo"].values())
                  for k in ("B2", "B3", "B4")}
        # the data-parallel paths, summed over their ranks: Trainer.fit (bf16),
        # the fp32 step and cli eval's fp32 route
        dp_fit = {k: sum(n[k] for r in dp for n in r["fit"]["launches"]) for k in ("B2", "B3")}
        dp_step32 = {k: sum(s_[k] for r in dp for s_ in r["step_launches"]) for k in ("B2", "B3")}
        dp_eval32 = sum(n for r in dp for n in r["evaluation"]["launches"])
        # multi-host: cli train --distributed's two processes, over their ranks
        mh_fit = {k: sum(r[k] for r in mh["launches"]) for k in ("B1", "B2", "B3")}
        # tensor parallel: the bf16 steps, over the ranks
        tp_steps = {k: sum(n[k] for r in tp for n in r["launches"]) for k in ("B2", "B3")}
        # phase 16: the scripts' runs (bench_cli_eval's forward is float32)
        sc = {name: r["launches"] for name, r in scripts["scripts"].items()}
        sc_bf16 = {k: sum(n[k] for name, n in sc.items() if name != "bench_cli_eval")
                   for k in ("B1", "B2", "B3", "B4")}
        sc_fp32 = sc["bench_cli_eval"]
        # phase 17: the captured multi-step's runs, each counted and then
        # captured launches x replays added: bf16, (c)'s captured legs and
        # (d)'s cli train; fp32, (a) and (b)
        ms_bf16 = {k: sum(r["launches"][k] for r in multi["readings"].values())
                   + multi["cli"]["launches"][k] for k in ("B1", "B2", "B3")}
        ms_fp32 = {k: multi["micro"]["launches"][k] + multi["flagship"]["launches"][k]
                   for k in ("B2", "B3")}
        # every main path launched every kernel the gate gives it
        if not (launches > 0 and fit["B2"] > 0 and fit["B3"] > 0 and gn_launches > 0
                and gn_fit["B2"] > 0 and gn_fit["B3"] > 0 and b5_launches > 0
                and ring_fwd["B2"] > 0 and ring_step["B2"] > 0 and ring_step["B4"] > 0
                and b6_launches > 0 and rs_launches > 0 and evaluation["b1_launches"] > 0
                and fit32["B2"] > 0 and fit32["B3"] > 0 and ring32["B2"] > 0
                and ring32["B4"] > 0 and tf_quirk["b1_launches"] > 0
                and tf_quirk["b1_launches_fp32"] > 0 and dp_fit["B2"] > 0 and dp_fit["B3"] > 0
                and dp_step32["B2"] > 0 and dp_step32["B3"] > 0 and dp_eval32 > 0
                and mh_fit["B1"] > 0 and mh_fit["B2"] > 0 and mh_fit["B3"] > 0
                and ts_step["B2"] > 0 and ts_step["B4"] > 0 and ts32["B2"] > 0
                and ts32["B4"] > 0 and ts_zoo["B2"] > 0 and ts_zoo["B3"] > 0
                and ts_zoo["B4"] > 0 and tp_steps["B2"] > 0 and tp_steps["B3"] > 0
                and all(sc_bf16[k] > 0 for k in ("B1", "B2", "B3", "B4"))
                and sc_fp32["B1"] > 0 and ms_bf16["B2"] > 0 and ms_bf16["B3"] > 0
                and ms_fp32["B2"] > 0 and ms_fp32["B3"] > 0):
            raise AssertionError("a kernel of a main path was never launched")
        print(f"[launches] flagship predictor B1 {launches}; flagship Trainer.fit {fit}; GN "
              f"predictor B1 {gn_launches}; GN Trainer.fit {gn_fit}; B5 on the GN step's "
              f"tensors {b5_launches}; ring eval "
              f"forward {ring_fwd}; ring train step {ring_step}; the bisect's swapped forward "
              f"{bisect['launches']['nolse']}; evaluate_prediction_batches B1 "
              f"{evaluation['b1_launches']} (float32); the float32 train step {fit32}; the "
              f"float32 ring step {ring32}; the TF checkpoint's quirk predictor B1 "
              f"{tf_quirk['b1_launches']}, its float32 eval step B1 "
              f"{tf_quirk['b1_launches_fp32']}; data parallel, over the ranks: Trainer.fit "
              f"{dp_fit}, the float32 step {dp_step32}, cli eval's float32 route B1 "
              f"{dp_eval32}; cli train --distributed, over both processes' ranks {mh_fit}; "
              f"the time-sharded step {ts_step}, float32 {ts32}, every registry name's "
              f"{ts_zoo}; the tensor-parallel bf16 steps, over the ranks {tp_steps}; the scripts "
              f"(phase 16) {sc}; the captured multi-step (phase 17; counted, plus captured "
              f"launches x replays) bf16 {ms_bf16}, float32 {ms_fp32}", flush=True)
        in_step = {k: [r["max_abs_err"] for r in train[f"{k}_in_step"].values()]
                   for k in ("b2", "b3")}
        kernels = [
            # B1 to B3: times at the flagship's sites, as in earlier runs;
            # launches summed over the flagship's and the GN model's main paths
            kernel_entry("flash_attention_fwd", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         launches + gn_launches + evaluation["b1_launches"]
                         + tf_quirk["b1_launches"] + mh_fit["B1"] + sc_bf16["B1"]
                         + ms_bf16["B1"],
                         rows["B1"], [r["max_abs_err"] for r in gn_fwd["held"].values()],
                         gn_rows["B1"] + zoo_rows["B1"]),
            kernel_entry("flash_attention_fwd_lse", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         fit["B2"] + gn_fit["B2"] + ring_fwd["B2"] + ring_step["B2"]
                         + dp_fit["B2"] + mh_fit["B2"] + ts_step["B2"] + ts_zoo["B2"]
                         + tp_steps["B2"] + sc_bf16["B2"] + ms_bf16["B2"],
                         rows["B2"], in_step["b2"], gn_rows["B2"] + zoo_rows["B2"]),
            kernel_entry("flash_attention_bwd", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274",
                         fit["B3"] + gn_fit["B3"] + dp_fit["B3"] + mh_fit["B3"] + ts_zoo["B3"]
                         + tp_steps["B3"] + sc_bf16["B3"] + ms_bf16["B3"],
                         rows["B3"], in_step["b3"], gn_rows["B3"] + zoo_rows["B3"]),
            # B4: the ring train steps' backward (ring-only and time-sharded),
            # times at the per-shard shapes
            kernel_entry("flash_attention_bwd_lse", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274",
                         ring_step["B4"] + ts_step["B4"] + ts_zoo["B4"] + sc_bf16["B4"],
                         b4_rows, [r["max_abs_err"] for by_site in ring["b4_in_step"].values()
                                   for r in by_site], gn_b4_rows),
            # B5: forward + backward (the row statistics and B3) at the three
            # GN sites
            kernel_entry("flash_fwd_chunked_bwd", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:374", b5_launches, b5_rows,
                         [r["max_abs_err"] for by_site in gn_train["b5_in_step"].values()
                          for r in by_site.values()]),
            # B6: the bisect's swapped forward, times at the flagship's sites
            # (both passes); its first pass, the row-stats kernel, alone
            kernel_entry("flash_attention_nolse", nolse.SOURCE, "scripts/bisect_infer.py:96",
                         b6_launches, b6_rows,
                         [r["max_abs_err"] for r in bisect["held"].values()]),
            kernel_entry("flash_row_stats", fa.SOURCE, "scripts/bisect_infer.py:96",
                         rs_launches, stats_rows),
            # B1 to B4 in float32, the split-bf16 instantiations: times at
            # the flagship's sites (B4 at the ring's per-shard shapes);
            # launches of the float32 main paths: cli eval's forward (phase
            # 11), the float32 train step (phase 6(c)) and ring step (9(b))
            kernel_entry("flash_attention_fwd_split_f32", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         evaluation["b1_launches"] + tf_quirk["b1_launches_fp32"] + dp_eval32
                         + sc_fp32["B1"],
                         rows["B1"], (),
                         gn_rows["B1"] + zoo_rows["B1"], dtype="float32"),
            kernel_entry("flash_attention_fwd_lse_split_f32", fa.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:141",
                         fit32["B2"] + ring32["B2"] + dp_step32["B2"] + ts32["B2"]
                         + ms_fp32["B2"], rows["B2"], (),
                         gn_rows["B2"] + zoo_rows["B2"], dtype="float32"),
            kernel_entry("flash_attention_bwd_split_f32", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274",
                         fit32["B3"] + dp_step32["B3"] + ms_fp32["B3"], rows["B3"], (),
                         gn_rows["B3"] + zoo_rows["B3"], dtype="float32"),
            kernel_entry("flash_attention_bwd_lse_split_f32", fb.SOURCE,
                         "sap3d_tpu/ops/pallas/flash_attention.py:274", ring32["B4"] + ts32["B4"],
                         b4_rows, dtype="float32"),
        ]
        if args.json_out:
            import os

            os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
            with open(args.json_out, "w") as f:
                json.dump(dict(card=card, kernel_rows=rows, forward=fwd, clips_per_s=thr,
                               profile=prof, train=train, gn_forward=gn_fwd,
                               gn_profile=gn_prof, gn_kernel_rows=gn_rows, b5_rows=b5_rows,
                               b5_memory=b5_memory, gn_train=gn_train, zoo=zoo,
                               zoo_kernel_rows=zoo_rows, ring=ring, time_shard=tshard,
                               b4_rows=b4_rows,
                               gn_b4_rows=gn_b4_rows, b6_rows=b6_rows,
                               row_stats_rows=stats_rows, bisect=bisect, evaluation=evaluation,
                               tf_import=dict(reader=tf_reader, mapping=tf_mapping,
                                              quirk=tf_quirk),
                               data_parallel=dp, multihost=mh, tensor_parallel=tp,
                               scripts=scripts, multi_step=multi, kernels=kernels), f,
                          indent=1)
        print(json.dumps({"kernels": kernels}), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted-cli"]:
        sys.exit(counted_cli(sys.argv[2:]))
    sys.exit(main())
