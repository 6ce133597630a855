"""The GN + CBAM family's train step on the card, taken apart by ablation.

Counterpart of ``scripts/profile_gn.py``.

    python sap3d_tpu_torch/scripts/profile_gn.py [leg ...] [--device cuda]
        [--root <checkout>] [--repeats 10]

The legs (default: all of ``LEGS``), each a registry name with overrides,
built at the production configuration: bf16, and the GN trainer's coupled
L2 of 5e-4 on conv kernels (``GN_WD``, ``train/state.make_optimizer``):

  full_sa_decoder  inference_p3d_sa_decoder_block: GN, CBAM in all 47
                   bottlenecks, the SA decoder
  no_cbam          the same without CBAM in the backbone: (full - no_cbam)
                   is CBAM's cost inside the step
  bn_backbone      the same with BN for GN
  decoder_nosa     inference_p3d_decoder_block: the GN decoder without SA
  easy_full        inference_p3d (the GN easy decoder, wide pool4)

Each leg is timed as ``profile_step`` times one (``profile_step.time_leg``:
batch 16, the median, fastest and slowest of ``--repeats`` train steps
after a warm-up, clips/s, launches per step held to the routes) and prints
its parameter count.  A leg that fails prints its error and the next leg
runs; the script then raises (a non-zero exit) naming every failed leg.
Prints one line per leg and a last JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import traceback

import torch

try:
    from . import _timing, profile_step
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing
    import profile_step

GN_WD = 5e-4  # the reference GN trainer's l2_reg on conv kernels
LEGS = {
    "full_sa_decoder": ("inference_p3d_sa_decoder_block", {}),
    "no_cbam": ("inference_p3d_sa_decoder_block", dict(backbone_cbam=False)),
    "bn_backbone": ("inference_p3d_sa_decoder_block", dict(norm_mode="bn")),
    "decoder_nosa": ("inference_p3d_decoder_block", {}),
    "easy_full": ("inference_p3d", {}),
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("legs", nargs="*", choices=list(LEGS), help="default: every leg")
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    batch_data = profile_step.data(device)
    before = _timing.launch_counts()
    legs, failed = {}, {}
    for name in args.legs or list(LEGS):
        # one failing leg (out of memory, a configuration error) must not
        # keep the others from running
        try:
            legs[name] = profile_step.time_leg(
                name, profile_step.model_config(*LEGS[name]), device, args.repeats,
                batch_data, weight_decay=GN_WD)
        except Exception as e:  # noqa: BLE001 - reported, and raised below
            traceback.print_exc()
            failed[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
            print(f"{name:22s} FAILED {failed[name]}", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out = _timing.emit("profile_gn", device, dict(
        batch=profile_step.BATCH, dtype="bfloat16", weight_decay=GN_WD, repeats=args.repeats,
        legs=legs, failed=failed, launches=_timing.launches_since(before)))
    if failed:
        raise RuntimeError(f"profile_gn: legs failed: {failed}")
    return out


if __name__ == "__main__":
    main()
