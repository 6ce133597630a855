"""Command-line interface of the port.

Counterpart of ``sap3d_tpu/cli.py``: ``train``, ``eval``, ``predict``,
``make-video``, ``eval-dirs``, ``inspect`` and ``plot``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain path) where a
subcommand runs on a device.

    python -m sap3d_tpu_torch.cli train --structure unet++ \\
        --frames <frames root> --densities <density root> [--device cuda]
    python -m sap3d_tpu_torch.cli predict --checkpoint <run or weights.pt> \\
        --data <frames root> --out <output root> [--device cuda]
    python -m sap3d_tpu_torch.cli eval --checkpoint <run or glob> \\
        --frames <root> --densities <root> --fixations <root> [--device cuda]
    python -m sap3d_tpu_torch.cli eval-dirs --pred <maps root> \\
        --density <root> [--fixation <root>] [--device cuda|cpu|host|true|false]
    python -m sap3d_tpu_torch.cli make-video --results <maps root> --out <dir>
    python -m sap3d_tpu_torch.cli inspect <run dir or weights.pt> [filter]
    python -m sap3d_tpu_torch.cli plot <logs dir>

``train`` writes ``./model/<run>/ckpt_<step>.pt`` checkpoints and
``./logs/<run>/metrics.jsonl``.  ``predict --checkpoint`` and ``eval
--checkpoint`` take such a run directory (its latest checkpoint) or a
weights file (``torch.save`` of the model's ``state_dict``;
``interop/flax_bridge.py`` makes one from flax weights), under
``--model-dir`` or as a path; ``eval`` also takes globs under
``--model-dir`` and scores every match, each with the structure its run
name starts with.  ``eval-dirs --device`` is a torch device on which the
batched metrics run (``cuda``, the default, ``cuda:N`` or ``cpu``), or
``host`` for the per-frame NumPy metrics on a thread pool; it also takes the
JAX package's bool spellings (``parse_bool``): true means ``cuda``, false
``host`` (the JAX package's default).  ``train --time-shards N`` (long clips,
``--videolength`` a multiple of 16 N) runs the UNet++ SA decoder's
attention as rings over N devices: the visible cards (N more than them
raises, as in the JAX package), or the CPU N times with ``--device cpu``.
Multi-device and multi-host runs (``--devices`` > 1, ``--distributed``)
port with ROADMAP A.11, ``--tf-checkpoint`` and ``--bn-quirk`` with A.12.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from sap3d_tpu_torch.core.config import (
    DATASET_ROOTS,
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    parse_bool,
)


def _add_common_model_flags(p: argparse.ArgumentParser, dtype: str = "bfloat16"):
    p.add_argument("--structure", type=str, default="unet++",
                   help="model name or alias (unet++, unet++nonsa, p3d_micro_sa, ...)")
    p.add_argument("--dtype", type=str, default=dtype,
                   help=f"compute dtype: bfloat16/float32 (default {dtype})")
    p.add_argument("--normalization", type=str, default=None,
                   help="ignored; BN/GN is keyed by the model variant "
                        "(kept for reference CLI compat)")
    p.add_argument("--SA", type=parse_bool, default=True,
                   help="kept for reference CLI compat (variant-keyed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda; cpu runs the plain path)")


def _add_data_flags(p: argparse.ArgumentParser):
    p.add_argument("--dataset", type=str, default=None,
                   help="named dataset (svsd/dhf1k/svsdndhf1k)")
    p.add_argument("--frames", type=str, nargs="*", default=None,
                   help="frame root dirs (override --dataset)")
    p.add_argument("--densities", type=str, nargs="*", default=None)
    p.add_argument("--fixations", type=str, default=None)
    p.add_argument("--videolength", type=int, default=16)
    p.add_argument("--overlap", type=int, default=15)
    p.add_argument("--trainingprops", type=float, default=0.9)
    p.add_argument("--imagesize", type=int, default=112)
    p.add_argument("--threads", type=int, default=16)


def _data_config(args) -> DataConfig:
    frame_dirs, density_dirs, fixation_dir = args.frames, args.densities, args.fixations
    if args.dataset:
        roots = DATASET_ROOTS[args.dataset]
        frame_dirs = frame_dirs or roots["frame_dirs"]
        density_dirs = density_dirs or roots["density_dirs"]
        fixation_dir = fixation_dir or roots.get("fixation_dir")
    return DataConfig(
        frame_dirs=frame_dirs or (), density_dirs=density_dirs or (),
        fixation_dir=fixation_dir, video_length=args.videolength,
        overlap=args.overlap, training_props=args.trainingprops,
        image_size=args.imagesize, num_threads=args.threads)


def cmd_train(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch train")
    _add_common_model_flags(p)
    _add_data_flags(p)
    p.add_argument("--plotiter", type=int, default=1000)
    p.add_argument("--validiter", type=int, default=160000)
    p.add_argument("--saveiter", type=int, default=4000)
    p.add_argument("--pretrain", type=str, default=None,
                   help="run dir under ./model to resume from (its latest checkpoint)")
    p.add_argument("--epoch", type=int, default=4)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--info", type=str, default="")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel devices; more than one is not ported yet "
                        "(ROADMAP A.11)")
    p.add_argument("--sync-bn", type=parse_bool, default=False,
                   help="no effect: one device sees the whole batch")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="no effect: accepted for the JAX command line; each "
                        "call is one train step (train/steps.py)")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="coupled L2 on conv kernels")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--distributed", type=parse_bool, default=False,
                   help="multi-host training: not ported yet (ROADMAP A.11)")
    p.add_argument("--coordinator", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dropout", type=float, default=0.5,
                   help="decoder dropout rate (0 disables)")
    p.add_argument("--shuffle", type=parse_bool, default=True,
                   help="per-epoch clip shuffle")
    p.add_argument("--time-shards", type=int, default=0,
                   help="long clips: run the SA sites as ring attention over N "
                        "devices (--videolength a multiple of 16*N; the other "
                        "layers run unsharded)")
    p.add_argument("--ring-attention", type=parse_bool, default=True,
                   help="with --time-shards on an SA variant: ring attention "
                        "across shards instead of attention over the whole clip")
    args = p.parse_args(argv)
    if args.distributed:
        raise NotImplementedError("--distributed is not ported yet "
                                  "(ROADMAP A.11, multi-device training)")

    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.data.indexer import ClipIndex
    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.train.trainer import Trainer

    device = resolve_device(args.device)
    cfg = Config(
        model=ModelConfig(name=args.structure, dtype=args.dtype, dropout=args.dropout),
        data=_data_config(args),
        train=TrainConfig(
            batch_size=args.batch, lr=args.lr, epochs=args.epoch,
            plot_iter=args.plotiter, valid_iter=args.validiter,
            save_iter=args.saveiter, pretrain=args.pretrain,
            num_devices=args.devices, info=args.info, sync_bn=args.sync_bn,
            steps_per_call=args.steps_per_call, weight_decay=args.weight_decay,
            max_steps=args.max_steps, time_shards=args.time_shards,
            ring_attention=args.ring_attention),
    )
    idx = ClipIndex(cfg.data.frame_dirs, cfg.data.density_dirs,
                    fixation_dir=cfg.data.fixation_dir,
                    video_length=cfg.data.video_length).setup(
        overlap=cfg.data.overlap, training_props=cfg.data.training_props,
        skip_head=cfg.data.skip_head, seed=cfg.data.shuffle_seed)
    print(idx.summary())
    if not idx.train_clips():
        print("no training clips found: check --dataset/--frames/--densities",
              file=sys.stderr)
        return 2
    trainer = Trainer(cfg, device=device)
    train_loader = ClipLoader(
        idx.train_clips(), args.batch, size=cfg.data.image_size,
        num_threads=cfg.data.num_threads, epochs=cfg.train.epochs,
        cache_frames=cfg.data.cache_frames, shuffle=args.shuffle)
    valid_fn = lambda: ClipLoader(  # noqa: E731
        idx.valid_clips(), args.batch, size=cfg.data.image_size,
        num_threads=cfg.data.num_threads, shuffle=False)
    try:
        with train_loader:
            trainer.fit(iter(train_loader), valid_fn)
    finally:
        trainer.close()
    return 0


def _model_weights(checkpoint: str, model_dir: str, device: str) -> dict:
    """The model ``state_dict`` named by ``--checkpoint``: a run directory's
    latest checkpoint, or a weights file; under ``model_dir`` or a path."""
    import torch

    from sap3d_tpu_torch.train.checkpoint import load_checkpoint

    under = os.path.join(model_dir, checkpoint)
    path = under if os.path.exists(under) else checkpoint
    if os.path.isdir(path):
        return load_checkpoint(path, map_location=device)["model"]
    if not os.path.isfile(path):
        raise FileNotFoundError(f"checkpoint missing: {path}")
    return torch.load(path, map_location=device, weights_only=True)


def cmd_predict(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch predict")
    _add_common_model_flags(p)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a port run directory (its latest checkpoint) or weights "
                        "file (torch.save of the state_dict), under --model-dir "
                        "or a path")
    p.add_argument("--model-dir", type=str, default="./model")
    p.add_argument("--tf-checkpoint", type=str, default=None,
                   help="not ported yet (ROADMAP A.12, TF interop)")
    p.add_argument("--data", type=str, required=True, help="video frames root")
    p.add_argument("--out", type=str, required=True, help="output root")
    p.add_argument("--batch-windows", type=int, default=16,
                   help="windows per device step")
    p.add_argument("--imagesize", type=int, default=112,
                   help="network input resolution")
    args = p.parse_args(argv)
    if (args.checkpoint is None) == (args.tf_checkpoint is None):
        p.error("exactly one of --checkpoint / --tf-checkpoint is required")
    if args.tf_checkpoint is not None:
        print("--tf-checkpoint is not ported yet (ROADMAP A.12, TF interop)",
              file=sys.stderr)
        return 2

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    model = build_model(args.structure, dtype=args.dtype, device=args.device)
    try:
        weights = _model_weights(args.checkpoint, args.model_dir, args.device)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
    model.load_state_dict(weights, strict=True)
    with SlidingWindowPredictor(
        make_eval_step(model), batch_windows=args.batch_windows,
        image_size=args.imagesize, device=args.device,
    ) as pred:
        n = pred.export_dataset(args.data, args.out)
    print(f"exported {n} videos")
    return 0


def infer_structure_from_run_name(run_name: str) -> str | None:
    """The model name or alias that prefixes a run directory's name
    (``<model>_<batch>_<lr>_<info>_<date>``, train/trainer.py), the longest
    that does; None when none does (reference test.py:129-136)."""
    from sap3d_tpu_torch.models.registry import MODEL_REGISTRY, STRUCTURE_ALIASES

    base = os.path.basename(run_name.rstrip("/"))
    for cand in sorted(list(MODEL_REGISTRY) + list(STRUCTURE_ALIASES), key=len, reverse=True):
        if base == cand or base.startswith(cand + "_"):
            return cand
    return None


def cmd_eval(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch eval")
    # float32 default: the reference evaluates in fp32 (TF1 default dtype)
    _add_common_model_flags(p, dtype="float32")
    _add_data_flags(p)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--checkpoint", type=str, nargs="+", default=[],
                   help="run directory name(s) or weights files under --model-dir; globs "
                        "allowed: every match is evaluated in one invocation")
    p.add_argument("--model-dir", type=str, default="./model")
    p.add_argument("--tf-checkpoint", type=str, default=None,
                   help="not ported yet (ROADMAP A.12, TF interop)")
    p.add_argument("--bn-quirk", action="store_true",
                   help="not ported yet (ROADMAP A.12, bn_reference_quirk)")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel devices; more than one is not ported yet "
                        "(ROADMAP A.11)")
    args = p.parse_args(argv)
    if args.tf_checkpoint or args.bn_quirk:
        raise NotImplementedError("--tf-checkpoint and --bn-quirk are not ported yet "
                                  "(ROADMAP A.12, TF interop and bn_reference_quirk)")
    if args.devices > 1:
        raise NotImplementedError("--devices > 1 is not ported yet (ROADMAP A.11, "
                                  "multi-device evaluation)")
    if not args.checkpoint:
        p.error("--checkpoint is required")

    import glob as globlib

    import torch

    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.data.indexer import ClipIndex
    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.eval.evaluator import evaluate_prediction_batches
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    device = resolve_device(args.device)
    data = _data_config(args)
    if not data.fixation_dir:
        # NSS and the AUCs are scored against fixation maps (reference
        # test.py:173-175); the named DATASET_ROOTS carry densities only
        p.error("eval needs fixation maps: pass --fixations <dir> "
                "(NSS/AUC-Judd/AUC-Borji are fixation-based)")
    idx = ClipIndex(data.frame_dirs, data.density_dirs, fixation_dir=data.fixation_dir,
                    video_length=data.video_length).setup(
        overlap=data.overlap, training_props=0.0, skip_head=data.skip_head)
    print(idx.summary())

    runs: list[str] = []
    for pat in args.checkpoint:
        matches = sorted(globlib.glob(os.path.join(args.model_dir, pat)))
        runs += [os.path.basename(m) for m in matches] if matches else [pat]
    runs = list(dict.fromkeys(runs))

    results: dict[str, dict] = {}
    failures = 0
    for run in runs:
        structure = infer_structure_from_run_name(run) or args.structure
        model = build_model(structure, dtype=args.dtype, device=device)
        try:
            weights = _model_weights(run, args.model_dir, device)
        except FileNotFoundError as e:
            print(f"no checkpoint found under {args.model_dir}/{run}: {e}", file=sys.stderr)
            failures += 1
            continue
        model.load_state_dict(weights, strict=True)
        ev = make_eval_step(model)
        loader = ClipLoader(idx.valid_clips(with_fixations=True), args.batch,
                            size=data.image_size, num_threads=data.num_threads,
                            shuffle=False, test_mode=True)
        with loader:
            result = evaluate_prediction_batches(
                iter(loader), lambda f: ev(torch.from_numpy(f).to(device)))
        results[run] = result
        print(
            f"Model: {run} (structure {structure})\n"
            f" All: {result['n']}, Metrics: CC: {result['cc']:.3f}  "
            f"SIM: {result['sim']:.3f}   NSS: {result['nss']:.3f}  "
            f"AUC_Judd: {result['auc_judd']:.3f}   "
            f"AUC_Borji: {result['auc_borji']:.3f}"
            f"   (compute dtype: {args.dtype})"
        )
    if len(results) > 1:
        print("\nmodel                                    CC     SIM    NSS    "
              "AUC_J  AUC_B")
        for run, r in results.items():
            print(f"{run:<40} {r['cc']:.3f}  {r['sim']:.3f}  {r['nss']:.3f}  "
                  f"{r['auc_judd']:.3f}  {r['auc_borji']:.3f}")
    return 0 if results and not failures else 1


def cmd_make_video(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch make-video")
    p.add_argument("--results", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--fps", type=float, default=25.0)
    args = p.parse_args(argv)
    from sap3d_tpu_torch.infer.video import export_all_videos

    n = export_all_videos(args.results, args.out, fps=args.fps)
    print(f"wrote {n} videos")
    return 0


def eval_dirs_device(value: str) -> str:
    """``eval-dirs --device``: a bool spelling of the JAX command line
    (``parse_bool``) names the card (``cuda``) when true and the per-frame
    NumPy path (``host``) when false; any other value is kept as given (a
    torch device, or ``host``)."""
    try:
        return "cuda" if parse_bool(value) else "host"
    except ValueError:
        return value


def cmd_eval_dirs(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch eval-dirs")
    p.add_argument("--dsname", type=str, default=None,
                   help="named dataset (core/config.py EVAL_DATASETS); resolves "
                        "--pred/--density/--fixation under $SAP3D_DATA_ROOT")
    p.add_argument("--pred", type=str, default=None)
    p.add_argument("--density", type=str, default=None)
    p.add_argument("--fixation", type=str, default=None)
    p.add_argument("--metrics", type=str, nargs="*", default=["cc", "sim", "auc_judd"],
                   choices=["cc", "sim", "kldiv", "nss", "auc_judd", "auc_borji",
                            "auc_shuffled"],
                   help="auc_shuffled/auc_borji/nss need --fixation")
    p.add_argument("--workers", type=int, default=None,
                   help="videos scored concurrently with --device host "
                        "(default: min(8, cpus))")
    p.add_argument("--device", type=eval_dirs_device, default="cuda",
                   help="torch device of the batched metrics (default cuda; cuda:N, "
                        "cpu), or 'host' for the per-frame NumPy metrics; true and "
                        "false (the JAX command line's bool) mean cuda and host")
    args = p.parse_args(argv)
    if args.dsname:
        from sap3d_tpu_torch.core.config import EVAL_DATASETS

        if args.dsname not in EVAL_DATASETS:
            print(f"unknown dsname {args.dsname!r}; known: {sorted(EVAL_DATASETS)}",
                  file=sys.stderr)
            return 2
        ds = EVAL_DATASETS[args.dsname]
        args.pred = args.pred or ds["saliency_dir"]
        args.density = args.density or ds["density_dir"]
        args.fixation = args.fixation or ds["fixation_dir"]
    if not args.pred or not args.density:
        print("--pred and --density are required (or use --dsname)", file=sys.stderr)
        return 2
    from sap3d_tpu_torch.eval.evaluator import evaluate_saliency_dirs

    results = evaluate_saliency_dirs(args.pred, args.density, args.fixation,
                                     tuple(args.metrics), workers=args.workers,
                                     device=args.device)
    for video, scores in results.items():
        line = "  ".join(f"{k}: {v:.4f}" for k, v in scores.items())
        print(f"{video}: {line}")
    if results:
        for m in args.metrics:
            vals = [s[m] for s in results.values() if m in s]
            if vals:
                print(f"MEAN {m}: {float(np.nanmean(vals)):.4f}")
    return 0


def cmd_inspect(argv) -> int:
    """Checkpoint variable inspector (reference utils/test_model.py parity)."""
    from sap3d_tpu_torch.train.inspect_ckpt import main as inspect_main

    return inspect_main(argv)


def cmd_plot(argv) -> int:
    """Draw the 4-pane training-curve figure again from a run's logs."""
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch plot")
    p.add_argument("logs_dir", type=str)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    from sap3d_tpu_torch.train.plotting import plot_curves

    out = plot_curves(args.logs_dir, args.out)
    print(out or "matplotlib unavailable")
    return 0


COMMANDS = {
    "train": cmd_train,
    "eval": cmd_eval,
    "predict": cmd_predict,
    "make-video": cmd_make_video,
    "eval-dirs": cmd_eval_dirs,
    "inspect": cmd_inspect,
    "plot": cmd_plot,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: sap3d_tpu_torch {{{','.join(COMMANDS)}}} [args]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
