"""The flagship's train step on the card, taken apart by ablation.

Counterpart of ``scripts/profile_step.py``.

    python sap3d_tpu_torch/scripts/profile_step.py [leg ...] [--device cuda]
        [--root <checkout>] [--repeats 10]

Each leg (default: all of ``LEGS``) times whole train steps of the port
(``train/state.create_train_state``, ``train/steps.make_train_step``) at
batch 16 in bf16 on clips drawn as the JAX script draws them (numpy seed
0), so that the difference between two legs is a component's cost inside
the step, fusion and overlap included:

  full         the flagship (p3d_unetplusplus_ds): forward, loss, backward,
               Adam, BN statistics
  no_sa        p3d_unetplusplus_nonsa: the four attention sites removed
  no_dropout   the flagship with dropout 0
  no_opt       the flagship's loss and gradient, no Adam step (no
               parameter changes)
  fwd          the flagship's train-mode forward alone, without autograd
  stage1_thin  encoder stage 1 at 1 bottleneck instead of 3 (every feature
               shape unchanged: each stage keeps its entry block)
  stage2_thin  stage 2 at 2 instead of 8
  stage3_thin  stage 3 at 12 instead of 36

With more than one leg, ``full`` (when asked for) runs again last, as a
control of drift over the run.  Per leg: the median, fastest and slowest
of ``--repeats`` steps after one warm-up step (host clock, each step ended
by a synchronize), clips/s of the median, and the attention kernels'
launches per step, held to the routes the warm-up step took
(``ops/attention.attention_route``): per site on the kernel route one B2
and one B3 (one B1 in ``fwd``), none on ``no_sa``; a leg whose launches
differ raises.  The models are built in the port's own initialisation
from seed 0.  Prints one line per leg and a last JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

try:
    from . import _timing
except ImportError:  # run by its path: this file's directory is on sys.path
    import _timing

BATCH = 16
FRAMES, SIZE = 16, 112
SA_DS = dict(decoder="unetpp", decoder_kwargs=dict(attention="sa", head="ds"))
# leg -> (registry name or None, P3DSaliency keywords over the name's)
LEGS = {
    "full": ("p3d_unetplusplus_ds", {}),
    "no_sa": ("p3d_unetplusplus_nonsa", {}),
    "no_dropout": (None, dict(SA_DS, dropout_rate=0.0)),
    "no_opt": ("p3d_unetplusplus_ds", {}),
    "fwd": ("p3d_unetplusplus_ds", {}),
    "stage1_thin": (None, dict(SA_DS, stages=((64, 1), (128, 8), (256, 36)))),
    "stage2_thin": (None, dict(SA_DS, stages=((64, 3), (128, 2), (256, 36)))),
    "stage3_thin": (None, dict(SA_DS, stages=((64, 3), (128, 8), (256, 12)))),
}
# How a leg steps: "train" (make_train_step), "no_optimizer" (loss and
# backward) or "forward" (train mode, no autograd)
MODES = {"no_opt": "no_optimizer", "fwd": "forward"}


def model_config(name: str | None, overrides: dict) -> dict:
    """``P3DSaliency``'s keywords: the registry name's, then
    ``overrides``."""
    from sap3d_tpu_torch.models.registry import MODEL_REGISTRY

    return {**(MODEL_REGISTRY[name] if name else {}), **overrides}


def build(config: dict, device: torch.device, dtype=torch.bfloat16, seed: int = 0):
    """``P3DSaliency(**config)`` in ``dtype`` on ``device``, its parameters
    from ``seed`` (the port's initialisation)."""
    from sap3d_tpu_torch.models.p3d import P3DSaliency

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = P3DSaliency(**config, dtype=dtype)
    return model.to(device)


def data(device: torch.device):
    """[BATCH, FRAMES, SIZE, SIZE, 3] frames normal times 0.3 and uniform
    targets, from numpy seed 0 as the JAX script draws them."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(BATCH, FRAMES, SIZE, SIZE, 3)).astype(np.float32) * 0.3
    y = rng.uniform(size=(BATCH, FRAMES, SIZE, SIZE)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def make_step(state, mode: str = "train"):
    """One step of ``state``'s model on (frames, targets, generator):
    ``make_train_step``'s; with ``mode="no_optimizer"`` its loss and
    backward alone (every gradient computed, no parameter moved); with
    ``"forward"`` the train-mode forward without autograd."""
    from sap3d_tpu_torch.train.steps import loss_fn_saliency, make_train_step

    model = state.model
    if mode == "train":
        return make_train_step(state)

    def step(frames, targets, generator=None):
        model.train()
        if mode == "forward":
            with torch.no_grad():
                return model(frames, generator)
        loss = loss_fn_saliency(model(frames, generator), targets)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        return loss.detach()

    return step


def expected_launches(routes: list[str], mode: str, device: torch.device) -> dict[str, int]:
    """B1-B4 launches of one step whose attention sites took ``routes``
    (none on the CPU, where the wrappers run their plain versions)."""
    n = routes.count("flash") if device.type == "cuda" else 0
    if mode == "forward":
        return {"B1": n, "B2": 0, "B3": 0, "B4": 0}
    return {"B1": 0, "B2": n, "B3": n, "B4": 0}


def time_leg(label: str, config: dict, device: torch.device, repeats: int, batch_data,
             mode: str = "train", weight_decay: float = 0.0) -> dict:
    """Build the leg's model, take one warm-up step (recording its routes),
    then ``repeats`` timed steps; their times and launches per step, held
    to the routes."""
    from sap3d_tpu_torch.train.state import create_train_state

    model = build(config, device)
    state = create_train_state(model, weight_decay=weight_decay)
    gen = torch.Generator(device=device).manual_seed(1)
    step = make_step(state, mode)
    frames, targets = batch_data
    with _timing.recorded_routes() as routes:
        step(frames, targets, gen)
    before = _timing.launch_counts()
    times = _timing.step_times(lambda: step(frames, targets, gen), repeats, device, warmup=0)
    counted = _timing.launches_since(before)
    per_step = {k: n / repeats for k, n in counted.items()}
    want = expected_launches(routes, mode, device)
    row = dict(_timing.step_summary(times, frames.shape[0]), mode=mode,
               n_params=sum(p.numel() for p in model.parameters()),
               kernel_sites=routes.count("flash"), launches_per_step=per_step)
    print(f"{label:22s} {row['ms']:8.2f} ms/step   {row['clips_per_s']:6.1f} clips/s   "
          f"(fastest {row['fastest_ms']:.2f}, slowest {row['slowest_ms']:.2f}; B2/B3 per step "
          f"{per_step['B2']:g}/{per_step['B3']:g}, B1 {per_step['B1']:g}; "
          f"{row['n_params'] / 1e6:.1f}M params)", flush=True)
    if per_step != {k: float(n) for k, n in want.items()}:
        raise AssertionError(f"{label}: launches per step {per_step}, the routes "
                             f"{routes} give {want}")
    return row


def run_legs(legs: list[str], device: torch.device, repeats: int) -> dict:
    """``time_leg`` of each of ``legs``; with more than one leg, ``full``
    again last when it ran (the drift control)."""
    batch_data = data(device)
    order = list(legs) + (["full"] if "full" in legs and len(legs) > 1 else [])
    out = {}
    for i, leg in enumerate(order):
        key = leg if i < len(legs) else "full_again"
        out[key] = time_leg(key, model_config(*LEGS[leg]), device, repeats, batch_data,
                            MODES.get(leg, "train"))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("legs", nargs="*", choices=list(LEGS), help="default: every leg")
    _timing.add_common_args(p, repeats=10)
    args = p.parse_args(argv)
    device = _timing.setup(args)
    before = _timing.launch_counts()
    legs = run_legs(args.legs or list(LEGS), device, args.repeats)
    return _timing.emit("profile_step", device, dict(
        batch=BATCH, dtype="bfloat16", repeats=args.repeats, legs=legs,
        launches=_timing.launches_since(before)))


if __name__ == "__main__":
    main()
