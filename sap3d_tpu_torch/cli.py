"""Command-line interface of the port.

Counterpart of ``sap3d_tpu/cli.py``: ``train``, ``eval``, ``predict``,
``make-video``, ``eval-dirs``, ``inspect`` and ``plot``, with the same flags
plus ``--device`` (default ``cuda``; ``cpu`` runs the plain path) where a
subcommand runs on a device.

    python -m sap3d_tpu_torch.cli train --structure unet++ \\
        --frames <frames root> --densities <density root> [--device cuda]
    python -m sap3d_tpu_torch.cli predict --checkpoint <run or weights.pt> \\
        --data <frames root> --out <output root> [--device cuda]
    python -m sap3d_tpu_torch.cli predict --tf-checkpoint <dir or prefix> \\
        --structure unet++ --data <frames root> --out <output root>
    python -m sap3d_tpu_torch.cli eval --checkpoint <run or glob> \\
        --frames <root> --densities <root> --fixations <root> [--device cuda]
    python -m sap3d_tpu_torch.cli eval --tf-checkpoint <dir or prefix> \\
        --structure unet++ --frames <root> --densities <root> --fixations <root>
    python -m sap3d_tpu_torch.cli eval-dirs --pred <maps root> \\
        --density <root> [--fixation <root>] [--device cuda|cpu|host|true|false]
    python -m sap3d_tpu_torch.cli make-video --results <maps root> --out <dir>
    python -m sap3d_tpu_torch.cli inspect [--tf] <checkpoint> [filter]
    python -m sap3d_tpu_torch.cli plot <logs dir>

``train`` writes ``./model/<run>/ckpt_<step>.pt`` checkpoints and
``./logs/<run>/metrics.jsonl``.  ``predict --checkpoint`` and ``eval
--checkpoint`` take such a run directory (its latest checkpoint) or a
weights file (``torch.save`` of the model's ``state_dict``;
``interop/flax_bridge.py`` makes one from flax weights), under
``--model-dir`` or as a path; ``eval`` also takes globs under
``--model-dir`` and scores every match, each with the structure its run
name starts with.  ``--tf-checkpoint`` takes a reference TF1 ``Saver``
checkpoint (its directory or prefix; read without TensorFlow,
``interop/tf_bundle.py``) of the ``--structure`` variant and runs it with
the reference's inference, the bottleneck BNs on batch statistics
(``bn_reference_quirk``); ``eval --bn-quirk`` runs the port's own
checkpoints that way.  ``eval-dirs --device`` is a torch device on which the
batched metrics run (``cuda``, the default, ``cuda:N`` or ``cpu``), or
``host`` for the per-frame NumPy metrics on a thread pool; it also takes the
JAX package's bool spellings (``parse_bool``): true means ``cuda``, false
``host`` (the JAX package's default).  ``train --time-shards N`` (long clips,
``--videolength`` a multiple of 16 N) cuts each clip along time over N
devices and runs every layer on each device's own shard, in training and
validation (``ops/time_shard.py``, the JAX package's GSPMD time-sharding):
the visible cards (N more than them raises, as in the JAX package), or the
CPU N times with ``--device cpu``.  The UNet++ SA decoder's attention runs
as rings over the shards; with ``--ring-attention false``, and at the other
decoders' sites, the attention gathers its tokens on the first device.
``train --devices N`` and ``eval --devices N`` run data parallel, one
process per device of the data mesh (``core/mesh.py``): the first N visible
cards over NCCL (-1, the default, means all of them), or with ``--device
cpu`` the CPU N times over gloo (-1 means once).  ``train`` returns 2 when
``--batch`` (the global batch) does not divide by N, and ``--time-shards``
above 1 keeps a data mesh of 1; ``eval`` scores data parallel when
``--batch`` divides by N and otherwise falls back to one device with a
message, as the JAX command line does.

Multi-host training (ROADMAP A.5): run ``train --distributed true
--coordinator HOST:PORT --num-processes P --process-id i`` once per process,
each on its host.  The processes meet at the coordinator (process 0 holds
its port), and their ranks form one data mesh: ``--devices N`` counts the
ranks of every process, each process starting N / P of them, one per local
card (``core/mesh.py``).  ``--batch`` is the global batch and must divide by
P, then by N.  Every process takes process 0's run name, and global rank 0
writes the run's logs and checkpoints, on a filesystem the hosts share.
``--time-shards`` is one process.
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


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch train")
    _add_common_model_flags(p)
    _add_data_flags(p)
    p.add_argument("--plotiter", type=int, default=1000)
    p.add_argument("--validiter", type=int, default=160000)
    p.add_argument("--saveiter", type=int, default=4000)
    p.add_argument("--pretrain", type=str, default=None,
                   help="run dir under ./model to resume from (its latest checkpoint)")
    p.add_argument("--epoch", type=int, default=4)
    p.add_argument("--batch", type=int, default=2,
                   help="the global batch, over every device of every process")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--info", type=str, default="")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel devices, one process each, counted over every "
                        "process of a --distributed run (-1: every visible card of every "
                        "process; with --device cpu, the CPU N times, or once per process "
                        "for -1); each process of P takes N / P of its own, and an N that "
                        "does not divide by P is refused (the JAX package would build a "
                        "mesh that leaves out part of a host)")
    p.add_argument("--sync-bn", type=parse_bool, default=False,
                   help="no effect: BN statistics are always global-batch")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="K train steps per call (train/steps.make_multi_train_step): "
                        "on one card one captured CUDA graph of a step, replayed K "
                        "times; on the CPU, a data mesh or --time-shards, K single "
                        "steps in one call.  Logging, validation and saving are "
                        "tested after each call, as in the JAX trainer")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="coupled L2 on conv kernels")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--distributed", type=parse_bool, default=False,
                   help="multi-host training: run the command once per process, each "
                        "with the same --coordinator, --num-processes and its own "
                        "--process-id; their ranks form one data mesh.  Without "
                        "--coordinator, one process")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host coordinator address host:port, where process 0 "
                        "listens")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--dropout", type=float, default=0.5,
                   help="decoder dropout rate (0 disables)")
    p.add_argument("--shuffle", type=parse_bool, default=True,
                   help="per-epoch clip shuffle")
    p.add_argument("--time-shards", type=int, default=0,
                   help="long clips: cut each clip along time over N devices and "
                        "run every layer on each device's shard (--videolength a "
                        "multiple of 16*N; one process)")
    p.add_argument("--ring-attention", type=parse_bool, default=True,
                   help="with --time-shards on a UNet++ SA variant: ring attention "
                        "across the shards instead of attention over the clip's "
                        "tokens gathered on the first device")
    return p


def _train_config(args) -> Config:
    return Config(
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


def _clip_index(cfg: Config):
    from sap3d_tpu_torch.data.indexer import ClipIndex

    return ClipIndex(cfg.data.frame_dirs, cfg.data.density_dirs,
                     fixation_dir=cfg.data.fixation_dir,
                     video_length=cfg.data.video_length).setup(
        overlap=cfg.data.overlap, training_props=cfg.data.training_props,
        skip_head=cfg.data.skip_head, seed=cfg.data.shuffle_seed)


def cmd_train(argv) -> int:
    p = _train_parser()
    args = p.parse_args(argv)

    from sap3d_tpu_torch.core.mesh import initialize_distributed

    cluster = None
    if args.distributed:
        if args.coordinator:
            if args.num_processes is None or args.process_id is None:
                p.error("--coordinator requires --num-processes and --process-id")
            cluster = initialize_distributed(args.coordinator, args.num_processes,
                                             args.process_id)
        elif args.num_processes is not None or args.process_id is not None:
            # without a coordinator these flags would be silently dropped
            # and both launched processes would train independently
            p.error("--num-processes/--process-id require --coordinator")
        else:
            initialize_distributed()
    if cluster is None:
        return _train_processes(args, None)
    with cluster:
        return _train_processes(args, cluster)


def _train_processes(args, cluster) -> int:
    """``cli train`` in this process: alone, or as process ``i`` of a
    ``cluster``, starting the ranks of its share of the data mesh."""
    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.core.mesh import launch
    from sap3d_tpu_torch.train.trainer import run_name

    processes = cluster.num_processes if cluster is not None else 1
    if args.batch % processes:
        print(f"--batch {args.batch} must divide by process_count {processes}",
              file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    cfg = _train_config(args)
    idx = _clip_index(cfg)
    print(idx.summary())
    if not idx.train_clips():
        print("no training clips found: check --dataset/--frames/--densities",
              file=sys.stderr)
        return 2
    if args.time_shards > 1 and processes > 1:
        # sap3d_tpu/train/trainer.py's reason, word for word
        raise NotImplementedError("--time-shards is single-process: a multi-host time mesh "
                                  "would put temporal halo exchanges on DCN")
    # time mode: the data mesh is a single device group
    mesh = _data_mesh(1 if args.time_shards > 1 else args.devices, device, cluster)
    if mesh is None:
        return 2
    n_dev = len(mesh.devices)
    if args.batch % n_dev:
        print(f"--batch {args.batch} must divide by the data-parallel mesh size {n_dev} "
              "(use --devices to shrink the mesh)", file=sys.stderr)
        return 2
    clips = (idx.train_clips(), idx.valid_clips())
    if n_dev == 1:
        _train(None, cfg, None, device, *clips, args.batch, args.shuffle)
    else:
        # one run directory: every process takes process 0's name (it holds the date)
        run = run_name(cfg) if cluster is None else cluster.all_gather("run", run_name(cfg))[0]
        launch(mesh, _train, cfg, run, None, *clips, args.batch // n_dev, args.shuffle)
    return 0


def _data_mesh(devices: int, device, cluster=None):
    """The data mesh of ``--devices`` on ``device``'s kind (over every
    process of ``cluster``), or None after printing why there is none (more
    cards asked for than are visible, or a count that does not divide over
    the processes)."""
    from sap3d_tpu_torch.core.mesh import make_mesh

    try:
        return make_mesh(devices, device=device, cluster=cluster)
    except ValueError as e:
        print(f"--devices {devices}: {e}", file=sys.stderr)
        return None


def _train(group, cfg: Config, run, device, train_clips, valid_clips, batch: int,
           shuffle: bool) -> None:
    """``cli train``'s loop on one device, or as one rank of a data mesh
    (``group``; ``batch`` the rank's share and the loaders its partition)."""
    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.train.trainer import Trainer

    part = ({} if group is None
            else dict(process_index=group.rank, process_count=group.world_size))
    trainer = Trainer(cfg, run=run, device=device, group=group)
    train_loader = ClipLoader(
        train_clips, batch, size=cfg.data.image_size,
        num_threads=cfg.data.num_threads, epochs=cfg.train.epochs,
        cache_frames=cfg.data.cache_frames, shuffle=shuffle, **part)
    valid_fn = lambda: ClipLoader(  # noqa: E731
        valid_clips, batch, size=cfg.data.image_size,
        num_threads=cfg.data.num_threads, shuffle=False, **part)
    try:
        with train_loader:
            trainer.fit(iter(train_loader), valid_fn)
    finally:
        trainer.close()


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


def model_from_tf_variables(structure: str, tf_vars: dict, dtype: str,
                            device: str):
    """The ``structure`` model on ``device`` in ``dtype``, built with the
    reference's inference (``bn_reference_quirk``) and carrying the weights
    of an in-memory ``{TF name: array}`` dict (a reference TF1 checkpoint's
    variables, optimizer slots and bookkeeping included): mapped by
    ``interop/tf_import.py``, validated against the model, loaded strictly."""
    from sap3d_tpu_torch.interop.tf_import import (
        state_dict_from_tf_variables,
        validate_against_model,
    )
    from sap3d_tpu_torch.models.registry import build_model, resolve_name

    name = resolve_name(structure)
    model = build_model(name, dtype=dtype, device=device, bn_reference_quirk=True)
    state_dict = state_dict_from_tf_variables(name, tf_vars)
    validate_against_model(state_dict, model)
    model.load_state_dict(state_dict, strict=True)
    return model


def model_from_tf_checkpoint(structure: str, path: str, dtype: str, device: str):
    """``model_from_tf_variables`` of the TF checkpoint at ``path`` (a
    directory or a prefix), read without TensorFlow."""
    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.interop.tf_import import load_tf_checkpoint

    resolve_device(device)  # no card: raise before reading the checkpoint
    return model_from_tf_variables(structure, load_tf_checkpoint(path), dtype, device)


def cmd_predict(argv) -> int:
    p = argparse.ArgumentParser(prog="sap3d_tpu_torch predict")
    _add_common_model_flags(p)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a port run directory (its latest checkpoint) or weights "
                        "file (torch.save of the state_dict), under --model-dir "
                        "or a path")
    p.add_argument("--model-dir", type=str, default="./model")
    p.add_argument("--tf-checkpoint", type=str, default=None,
                   help="a reference TF1 checkpoint (directory or prefix) of the "
                        "--structure variant, run with the reference's inference "
                        "(bottleneck BNs on batch statistics)")
    p.add_argument("--data", type=str, required=True, help="video frames root")
    p.add_argument("--out", type=str, required=True, help="output root")
    p.add_argument("--batch-windows", type=int, default=16,
                   help="windows per device step")
    p.add_argument("--imagesize", type=int, default=112,
                   help="network input resolution")
    args = p.parse_args(argv)
    if (args.checkpoint is None) == (args.tf_checkpoint is None):
        p.error("exactly one of --checkpoint / --tf-checkpoint is required")

    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model
    from sap3d_tpu_torch.train.steps import make_eval_step

    try:
        if args.tf_checkpoint is not None:
            model = model_from_tf_checkpoint(args.structure, args.tf_checkpoint,
                                             args.dtype, args.device)
        else:
            model = build_model(args.structure, dtype=args.dtype, device=args.device)
            model.load_state_dict(_model_weights(args.checkpoint, args.model_dir,
                                                 args.device), strict=True)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 1
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
                   help="evaluate a reference TF1 checkpoint (directory or prefix) "
                        "of the --structure variant first, as run 'tf:<path>'; "
                        "implies --bn-quirk for it")
    p.add_argument("--bn-quirk", action="store_true",
                   help="the reference's inference: bottleneck BNs normalize with "
                        "batch statistics (the reference never forwards its training "
                        "flag into its bottlenecks, p3d.py:290-303)")
    p.add_argument("--devices", type=int, default=-1,
                   help="data-parallel devices, one process each (-1: every visible "
                        "card; with --device cpu, the CPU N times); --batch must "
                        "divide by them, else one device scores")
    args = p.parse_args(argv)
    if not args.checkpoint and not args.tf_checkpoint:
        p.error("one of --checkpoint / --tf-checkpoint is required")

    import glob as globlib

    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.core.mesh import launch
    from sap3d_tpu_torch.data.indexer import ClipIndex

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
    # (run name, TF checkpoint or None); a TF checkpoint's run goes first
    runs = [(run, None) for run in dict.fromkeys(runs)]
    if args.tf_checkpoint is not None:
        runs.insert(0, ("tf:" + args.tf_checkpoint, args.tf_checkpoint))

    # data-parallel scoring when the batch divides by the mesh
    mesh = _data_mesh(args.devices, device)
    if mesh is None:
        return 2
    n_dev = len(mesh.devices)
    clips = idx.valid_clips(with_fixations=True)
    if n_dev > 1 and args.batch % n_dev == 0:
        results, failures = launch(mesh, _evaluate_runs, args, data, clips, runs, None)[0]
    else:
        if n_dev > 1:
            print(f"[eval] --batch {args.batch} does not divide by {n_dev} devices; "
                  "falling back to SINGLE-device eval", file=sys.stderr)
        results, failures = _evaluate_runs(None, args, data, clips, runs, device)
    if len(results) > 1:
        print("\nmodel                                    CC     SIM    NSS    "
              "AUC_J  AUC_B")
        for run, r in results.items():
            print(f"{run:<40} {r['cc']:.3f}  {r['sim']:.3f}  {r['nss']:.3f}  "
                  f"{r['auc_judd']:.3f}  {r['auc_borji']:.3f}")
    return 0 if results and not failures else 1


def _evaluate_runs(group, args, data, clips, runs, device) -> tuple[dict, int]:
    """Score each ``(run, TF checkpoint or None)`` of ``runs`` on ``clips``
    as ``cli eval`` does, printing each run's line; on one ``device``, or
    as one rank of a data mesh (``group``: rank 0 loads the batches and
    scores, every rank forwards its rows, ``train/steps.DataParallelForward``).
    Returns ({run: means}, the runs whose weights were missing); the other
    ranks return nothing."""
    import torch

    from sap3d_tpu_torch.data.pipeline import ClipLoader
    from sap3d_tpu_torch.eval.evaluator import evaluate_prediction_batches
    from sap3d_tpu_torch.models.registry import build_model, resolve_name
    from sap3d_tpu_torch.ops.layers import set_data_group
    from sap3d_tpu_torch.train.steps import DataParallelForward, make_eval_step

    main = group is None or group.is_main
    device = device if group is None else group.device
    results: dict[str, dict] = {}
    failures = 0
    for run, tf_path in runs:
        try:
            if tf_path is not None:
                structure = resolve_name(args.structure)
                model = model_from_tf_checkpoint(structure, tf_path, args.dtype, device)
            else:
                structure = infer_structure_from_run_name(run) or args.structure
                model = build_model(structure, dtype=args.dtype, device=device,
                                    bn_reference_quirk=args.bn_quirk)
                model.load_state_dict(_model_weights(run, args.model_dir, device),
                                      strict=True)
        except FileNotFoundError as e:
            if main:
                print(f"no checkpoint found under {args.model_dir}/{run}: {e}"
                      if tf_path is None else e, file=sys.stderr)
            failures += 1
            continue
        ev = make_eval_step(model)
        if group is None:
            forward = lambda f: ev(torch.from_numpy(f).to(device))  # noqa: E731
        else:
            set_data_group(model, group)  # the quirk's statistics: global-batch
            forward = DataParallelForward(ev, group)
            if not main:
                forward.serve()
                continue
        loader = ClipLoader(clips, args.batch, size=data.image_size,
                            num_threads=data.num_threads, shuffle=False, test_mode=True)
        try:
            with loader:
                result = evaluate_prediction_batches(iter(loader), forward)
        finally:
            if group is not None:
                forward.stop()
        results[run] = result
        print(
            f"Model: {run} (structure {structure})\n"
            f" All: {result['n']}, Metrics: CC: {result['cc']:.3f}  "
            f"SIM: {result['sim']:.3f}   NSS: {result['nss']:.3f}  "
            f"AUC_Judd: {result['auc_judd']:.3f}   "
            f"AUC_Borji: {result['auc_borji']:.3f}"
            f"   (compute dtype: {args.dtype})", flush=True
        )
    return (results, failures) if main else None


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
