"""The training loop: batches in, train steps, logging, validation,
checkpoints.  Counterpart of ``sap3d_tpu/train/trainer.py``: on one
device, as one rank of a data mesh, or in long-clip mode over a time mesh.

* ``fit`` takes host batches (numpy ``(frames, targets)``, e.g. from
  ``data.pipeline.ClipLoader``), copies each to the device and steps; every
  ``plot_iter`` steps (and the first ten) it logs the loss and clips/s to
  ``metrics.jsonl`` and TensorBoard events and dumps the last frame's
  prediction and target as JPEGs (when ``cv2`` is present); it validates
  every ``valid_iter`` steps, saves every ``save_iter`` steps and at the
  end, and stops at ``max_steps``.
* ``validate`` scores the last frame of each clip with CC, SIM, KLD and
  AUC-Judd on the device (``eval/metrics.py``) and logs NaN-filtered means.
* Dropout masks come from a generator seeded with ``seed + 1`` (the JAX
  trainer's ``PRNGKey(seed + 1)``), on global rank r of a data mesh ``seed
  + 1 + r`` (equal local shapes would give every rank the same masks); AUC jitter
  from one seeded with the step.
* Data parallel (``num_devices`` N > 1): the trainer runs in each of N
  processes that ``core/mesh.launch`` started, given the rank's ``group``
  (``cli train --devices N`` does this, and ``cli train --distributed``
  with the ranks of several processes, perhaps on several hosts, in one
  mesh).  Each rank steps on its share of the global batch
  (``data.pipeline.ClipLoader``'s ``process_index``, the global rank); the
  step sums the gradients and BN takes global-batch statistics
  (``train/steps.py``), so every rank holds the same state.  The model and
  a pretrain restore are broadcast from rank 0 (parameters, buffers and
  Adam moments).  Global rank 0 alone writes ``metrics.jsonl``, TB events,
  JPEGs and checkpoints, the others waiting at a barrier after each save
  (several hosts share the run's filesystem, as the JAX trainer assumes);
  clips/s counts the global batch; validation gathers every rank's
  per-clip scores before the means.  ``sync_bn`` changes nothing: the
  statistics are always global-batch, as in the JAX trainer.
* Profiler traces (``profile_dir``): the calls that run any of the steps
  ``[profile_start, profile_start + profile_steps)`` are traced with
  ``torch.profiler`` (CPU activity, and CUDA activity on the card), each
  call a ``train_step <n>`` range (``train_step <first>-<last>`` for a call
  of K steps); the device is synchronized before the trace stops, as the
  JAX trainer blocks, and each rank writes its own Chrome trace,
  ``rank<r>_steps_<first>-<last>.pt.trace.json``, into ``profile_dir``.
* ``steps_per_call`` K > 1: as the JAX trainer, ``fit`` groups K
  consecutive batches (``_macro_batches``; the batches left over at the
  end go through the single step), puts each group on the device in one
  copy and runs it through ``train/steps.make_multi_train_step``: one
  captured CUDA graph replayed K times on one card, K single steps in one
  call on the CPU, on a data mesh (each rank groups its own batches) and in
  long-clip mode.  Logging, validation, saving and ``max_steps`` are tested
  after each call by the JAX trainer's rule, with the call's K steps
  behind it: it logs when ``step < 10 + k or step % plot_iter < k`` (the
  call's last loss; the JPEG dump and plot forward on its last batch),
  validates when ``step >= valid_iter and step % valid_iter < k`` and
  saves when ``step >= save_iter and step % save_iter < k``; at K = 1 these
  are every step up to 10 and every ``plot_iter``-th, ``valid_iter``-th and
  ``save_iter``-th step.  A profiler window traces whole calls.
* Long-clip mode (``time_shards`` N > 1): a time mesh of N devices
  (``core/mesh.py``), with the JAX trainer's guards (N no more than the
  devices; the clip length a multiple of 16 N, so that every shard keeps a
  frame at pool4 and every temporal pool sees an even shard).  Each batch
  is cut along time from the host onto the shards' devices
  (``core/mesh.time_shard_batch``), and every layer runs on its own shard
  of the clip on that shard's device, in training and in validation: the
  counterpart of the JAX trainer's GSPMD time-sharding (ROADMAP A.6,
  ``ops/time_shard.py``).  The temporal convs take halo frames from their
  neighbours, the norms sum their statistics over the shards, and the loss
  adds the shards' sums; the parameters and the Adam moments stay on the
  trainer's device, the mesh's first.  With ``ring_attention`` the UNet++
  SA decoder's sites run as rings over the shards where they lie
  (``ops/ring_attention.py``); other sites (the other decoders', or every
  site without ``ring_attention``) and the non-local blocks gather their
  tokens on the first device and scatter the output back, as GSPMD does.
  On CUDA the mesh holds the visible cards; on the CPU it names the CPU N
  times (the counterpart of the JAX tests' virtual devices).  Time mode is
  one process and keeps a data mesh of 1, as in the JAX trainer.

"""

from __future__ import annotations

import contextlib
import datetime
import json
import os
import time
import warnings
from typing import Callable, Iterable

import numpy as np
import torch

from sap3d_tpu_torch.core.config import Config
from sap3d_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from sap3d_tpu_torch.core.mesh import make_time_mesh, time_shard_batch
from sap3d_tpu_torch.eval import metrics
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.ops.time_shard import last_frame
from sap3d_tpu_torch.train.checkpoint import CheckpointManager, try_restore_latest
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import (
    make_eval_step,
    make_multi_train_step,
    make_train_step,
)
from sap3d_tpu_torch.train.tb_events import EventWriter


def run_name(cfg: Config) -> str:
    """<model>_<batch>_<lr>_<info>_<date>."""
    t = datetime.date.today().isoformat()
    return f"{cfg.model.name}_{cfg.train.batch_size}_{cfg.train.lr}_{cfg.train.info}_{t}"


class Trainer:
    """``group``: this process's ``core/mesh.DataGroup`` when it is one rank
    of a data mesh (its device is the trainer's), else None."""

    def __init__(self, cfg: Config, run: str | None = None,
                 device: str | torch.device = DEFAULT_DEVICE, group=None):
        tc = cfg.train
        time_mode = int(tc.time_shards or 0) > 1
        self.group = group if group is not None and group.world_size > 1 else None
        if self.group is not None and time_mode:
            raise ValueError("time mode (time_shards > 1) keeps a data mesh of 1")
        if tc.num_devices > 1 and not time_mode and (
                self.group is None or self.group.world_size != tc.num_devices):
            raise ValueError(
                f"a data mesh of {tc.num_devices} devices runs one process per device: "
                "start them with core.mesh.launch (as cli train --devices N does) and "
                "give each rank's Trainer its group")
        if tc.sync_bn:
            warnings.warn(
                "--sync-bn has no effect: BN statistics are always global-batch under "
                "this trainer (each BN layer sums its statistics over the data mesh), "
                "which is what sync-BN asks for", stacklevel=2)
        self.rank = self.group.rank if self.group is not None else 0
        self.world_size = self.group.world_size if self.group is not None else 1
        self.is_main_process = self.rank == 0
        self.device = resolve_device(self.group.device if self.group is not None else device)
        self.time_mesh = self._time_mesh(cfg)
        self.cfg = cfg
        self.run = run or run_name(cfg)
        self.model_dir = os.path.join(tc.model_dir, self.run)
        self.logs_dir = os.path.join(tc.logs_dir, self.run)
        if self.is_main_process:
            os.makedirs(self.model_dir, exist_ok=True)
            os.makedirs(self.logs_dir, exist_ok=True)
        if tc.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        ring_mesh = self.time_mesh if tc.ring_attention else None
        self.model = build_model(cfg.model.name, dtype=cfg.model.dtype, device=self.device,
                                 seed=tc.seed, dropout_rate=cfg.model.dropout,
                                 ring_mesh=ring_mesh)
        if self.time_mesh is not None and self.model.attention_modules() \
                and not self.model.ring_sites():
            print(f"[time-shards] model '{cfg.model.name}' has no ring-attention sites; its "
                  f"attention sites gather their tokens on {self.time_mesh.devices[0]}")
        self.state = create_train_state(self.model, lr=tc.lr, weight_decay=tc.weight_decay)
        self.steps_per_call = max(1, tc.steps_per_call)
        self.train_step = make_train_step(self.state, self.group)
        self.multi_step = make_multi_train_step(
            self.state, self.steps_per_call, self.group, time_mesh=self.time_mesh) \
            if self.steps_per_call > 1 else None
        self.eval_step = make_eval_step(self.model)
        if self.is_main_process:
            self.ckpt = CheckpointManager(self.model_dir, tc.max_to_keep)
            self._metrics_log = open(os.path.join(self.logs_dir, "metrics.jsonl"), "a")
            self._tb = EventWriter(self.logs_dir)
        else:
            self.ckpt = self._metrics_log = self._tb = None

        if tc.pretrain:
            pre_dir = os.path.join(tc.model_dir, tc.pretrain)
            self.state, ok = try_restore_latest(self.state, pre_dir)
            if self.is_main_process:
                print(f"pretrain restore from {pre_dir}: {'ok' if ok else 'MISSING'}")
        if self.group is not None:
            self._broadcast_state()

    def _broadcast_state(self) -> None:
        """Rank 0's parameters, buffers, Adam moments and step on every rank."""
        g = self.group
        for t in self.model.state_dict().values():
            g.broadcast(t)
        opt = self.state.optimizer
        for p in (p for group in opt.param_groups for p in group["params"]):
            for t in opt.state.get(p, {}).values():
                if torch.is_tensor(t):
                    g.broadcast(t)
        step = torch.tensor([self.state.step], dtype=torch.int64, device=g.device)
        self.state.step = int(g.broadcast(step).item())

    def _time_mesh(self, cfg: Config):
        """The long-clip time mesh, or None (``time_shards`` 0 or 1)."""
        n, t = int(cfg.train.time_shards or 0), cfg.data.video_length
        if n <= 1:
            return None
        cpu = self.device.type == "cpu"
        available = n if cpu else torch.cuda.device_count()
        if n > available:
            raise ValueError(f"--time-shards {n} exceeds the {available} available devices")
        if t % (16 * n):
            raise ValueError(f"--videolength {t} must be a multiple of 16x--time-shards {n} "
                             "(the encoder pools time by 16; every shard needs >= 1 frame "
                             "at pool4)")
        return make_time_mesh(n, devices=[self.device] * n if cpu else None)

    # -- logging helpers ---------------------------------------------------

    def _log(self, record: dict) -> None:
        if not self.is_main_process:
            return
        record["time"] = datetime.datetime.now().isoformat(timespec="seconds")
        self._metrics_log.write(json.dumps(record) + "\n")
        self._metrics_log.flush()
        if "step" in record:
            self._tb.scalars(record, record["step"])
            self._tb.flush()

    def _dump_images(self, step: int, pred_last: np.ndarray, gt_last: np.ndarray):
        """The last frame's prediction and target as JPEGs."""
        try:
            import cv2
        except ImportError:
            return
        d = os.path.join(self.logs_dir, "smap_Result")
        os.makedirs(d, exist_ok=True)
        to_u8 = lambda m: np.clip(m * 255.0, 0, 255).astype(np.uint8)  # noqa: E731
        cv2.imwrite(os.path.join(d, f"step_{step}_pred.jpg"), to_u8(pred_last))
        cv2.imwrite(os.path.join(d, f"step_{step}_gt.jpg"), to_u8(gt_last))

    # -- main loop ---------------------------------------------------------

    def _put(self, array):
        """A host array on the device, or cut along time onto the time
        mesh's shards."""
        if self.time_mesh is not None:
            return time_shard_batch(self.time_mesh, array)
        return torch.as_tensor(np.asarray(array), device=self.device)

    def _macro_batches(self, batches: Iterable):
        """``(k, frames, targets)``: K consecutive batches stacked into [K,
        B, ...] arrays with k = K, and the batches left over after the last
        whole group one by one with k = 1 (the JAX trainer's
        ``_macro_batches``)."""
        if self.steps_per_call == 1:
            for f, t in batches:
                yield 1, f, t
            return
        group: list = []
        for f, t in batches:
            group.append((f, t))
            if len(group) == self.steps_per_call:
                yield (len(group), np.stack([g[0] for g in group]),
                       np.stack([g[1] for g in group]))
                group = []
        for f, t in group:
            yield 1, f, t

    def _save(self, step: int) -> None:
        """Rank 0 saves; the other ranks wait for it."""
        if self.is_main_process:
            self.ckpt.save(self.state, step)
        if self.group is not None:
            self.group.barrier()

    def _start_trace(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities)
        trace.start()
        return trace

    def _stop_trace(self, trace, first: int, last: int) -> str:
        """Wait for the device, stop ``trace`` and write this rank's Chrome
        trace of steps ``first`` to ``last``; returns its path."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        trace.stop()
        os.makedirs(self.cfg.train.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.train.profile_dir,
                            f"rank{self.rank}_steps_{first}-{last}.pt.trace.json")
        trace.export_chrome_trace(path)
        return path

    def fit(self, train_batches: Iterable,
            valid_batches_fn: Callable[[], Iterable] | None = None) -> None:
        """Train on ``train_batches`` (this rank's share of each global
        batch under a data mesh).  Dropout draws from a generator seeded
        by the rank; the trainer does not reach tensor parallel, whose
        ranks of a model row need one seed, their data index
        (``train/steps.py``)."""
        tc = self.cfg.train
        gen = torch.Generator(device=self.device).manual_seed(tc.seed + 1 + self.rank)
        step = self.state.step
        t_last, n_last = time.time(), 0
        ran_any = False
        traced = range(tc.profile_start, tc.profile_start + tc.profile_steps) \
            if tc.profile_dir else range(0)
        trace, trace_first = None, None
        for k, frames, targets in self._macro_batches(train_batches):
            first, step = step + 1, step + k
            ran_any = True
            in_window = first < traced.stop and step >= traced.start
            if trace is None and in_window:
                trace, trace_first = self._start_trace(), first
            elif trace is not None and not in_window:
                self._stop_trace(trace, trace_first, first - 1)
                trace = None
            label = f"train_step {step}" if k == 1 else f"train_step {first}-{step}"
            with (torch.profiler.record_function(label) if trace is not None
                  else contextlib.nullcontext()):
                if k == 1:
                    f = self._put(frames)
                    loss = self.train_step(f, self._put(targets), gen)
                elif self.time_mesh is None:
                    fk = self._put(frames)
                    loss = self.multi_step(fk, self._put(targets), gen)[-1]
                    f = fk[-1]
                else:  # the time mesh's multi-step cuts each batch from the host
                    loss = self.multi_step(frames, targets, gen)[-1]
                    f = None
            if k > 1:  # the JPEG dump and the plot forward take the last batch
                frames, targets = frames[-1], targets[-1]
            n_last += frames.shape[0] * k * self.world_size

            if (step < 10 + k or step % tc.plot_iter < k) and self.is_main_process:
                loss_v = float(loss)
                dt = time.time() - t_last
                cps = n_last / dt if dt > 0 else 0.0
                f = self._put(frames) if f is None else f
                pred_last = last_frame(self.eval_step(f)).cpu().numpy()
                self._dump_images(step, pred_last[0], np.asarray(targets)[0, -1])
                print(f"[{datetime.datetime.now().isoformat(timespec='seconds')}] "
                      f"step {step} loss {loss_v:.4f} clips/s {cps:.2f}", flush=True)
                self._log({"step": step, "loss": loss_v, "clips_per_sec": cps})
                t_last, n_last = time.time(), 0

            if valid_batches_fn is not None and step >= tc.valid_iter \
                    and step % tc.valid_iter < k:
                self.validate(step, valid_batches_fn())
                if self.is_main_process:
                    from sap3d_tpu_torch.train.plotting import plot_curves

                    plot_curves(self.logs_dir)

            if step >= tc.save_iter and step % tc.save_iter < k:
                t_save = time.time()
                self._save(step)
                self._log({"step": step, "save_dispatch_s": time.time() - t_save})

            if tc.max_steps is not None and step >= tc.max_steps:
                break
        if trace is not None:
            self._stop_trace(trace, trace_first, step)
        if not ran_any:
            if step == 0:
                raise RuntimeError(
                    "fit() ran zero training steps: the loader produced no full "
                    "batches (too few clips for the batch size after the "
                    "train/valid split?).  Nothing was saved.")
            print(f"fit(): no new batches at step {step}; nothing to do")
        else:
            self._save(step)
        if self.is_main_process:
            print("Training Finished!", flush=True)

    def validate(self, step: int, valid_batches: Iterable) -> dict:
        """CC/SIM/KLD/AUC-Judd on the last frame of each clip, NaN-filtered
        means (under a data mesh, of every rank's clips); logged and
        returned.  In time mode the eval forward runs sharded and the last
        frame comes from the last shard."""
        ccs, sims, klds, aucs = [], [], [], []
        gen = torch.Generator(device=self.device).manual_seed(step)
        for frames, targets in valid_batches:
            pred_last = last_frame(self.eval_step(self._put(frames))).to(self.device).float()
            gt_last = torch.as_tensor(np.asarray(targets)[:, -1], device=self.device).float()
            ccs += metrics.cc(pred_last, gt_last).tolist()
            sims += metrics.sim(pred_last, gt_last).tolist()
            klds += metrics.kldiv(pred_last, gt_last).tolist()
            # dense density targets: sweep the full pixel count
            aucs += metrics.auc_judd(pred_last, gt_last, gen,
                                     fix_cap=gt_last.shape[-2] * gt_last.shape[-1]).tolist()
        if self.group is not None:
            ranks = self.group.all_gather_object((ccs, sims, klds, aucs))
            ccs, sims, klds, aucs = ([v for r in ranks for v in r[i]] for i in range(4))
        result = {
            "step": step,
            "cc": metrics.nan_filtered_mean(ccs),
            "sim": metrics.nan_filtered_mean(sims),
            "kld": metrics.nan_filtered_mean(klds),
            "auc_judd": metrics.nan_filtered_mean(aucs),
        }
        if self.is_main_process:
            print(f"[valid] step {step} CC {result['cc']:.4f} SIM {result['sim']:.4f} "
                  f"KLD {result['kld']:.4f} AUC_Judd {result['auc_judd']:.4f}", flush=True)
        self._log(result)
        return result

    def close(self):
        if self.is_main_process:
            self.ckpt.close()
            self._metrics_log.close()
            self._tb.close()
