"""Command-line interface of the port: ``train`` and ``predict``.

Counterpart of ``sap3d_tpu/cli.py``'s subcommands of the same names, with
the same flags plus ``--device`` (default ``cuda``; ``cpu`` runs the plain
path).

    python -m sap3d_tpu_torch.cli train --structure unet++ \\
        --frames <frames root> --densities <density root> [--device cuda]
    python -m sap3d_tpu_torch.cli predict --checkpoint <run or weights.pt> \\
        --data <frames root> --out <output root> [--device cuda]

``train`` writes ``./model/<run>/ckpt_<step>.pt`` checkpoints and
``./logs/<run>/metrics.jsonl``.  ``predict --checkpoint`` takes such a
run directory (its latest checkpoint) or a weights file (``torch.save`` of
the model's ``state_dict``; ``interop/flax_bridge.py`` makes one from flax
weights), under ``--model-dir`` or as a path.  ``train --time-shards N``
(long clips, ``--videolength`` a multiple of 16 N) runs the UNet++ SA
decoder's attention as rings over N devices: the visible cards (N more than
them raises, as in the JAX package), or the CPU N times with ``--device
cpu``.  Data-parallel and multi-host training (``--devices`` > 1,
``--distributed``) port with ROADMAP A.11, ``--tf-checkpoint`` with A.12,
and the other subcommands with A.8.
"""

from __future__ import annotations

import argparse
import os
import sys

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


COMMANDS = {"train": cmd_train, "predict": cmd_predict}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: sap3d_tpu_torch {{{','.join(COMMANDS)}}} [args]", file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
