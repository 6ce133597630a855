"""The training loop: batches in, train steps, logging, validation,
checkpoints.  Counterpart of ``sap3d_tpu/train/trainer.py`` on one device
(in long-clip mode, a time mesh of devices for the attention sites).

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
  trainer's ``PRNGKey(seed + 1)``); AUC jitter from one seeded with the step.
* ``steps_per_call`` is accepted for the JAX command line and changes
  nothing: the JAX trainer groups K batches into one ``lax.scan`` dispatch,
  which in eager PyTorch would be the same K single steps
  (``train/steps.py``).
* Long-clip mode (``time_shards`` N > 1): a time mesh of N devices
  (``core/mesh.py``), with the JAX trainer's guards (N no more than the
  devices; the clip length a multiple of 16 N, so that every shard keeps a
  frame at pool4).  With ``ring_attention`` the UNet++ SA decoder's sites run
  as rings over it (``ops/ring_attention.py``); other decoders have no ring
  sites.  The other layers run unsharded on the trainer's device: the JAX
  package's GSPMD time-sharding of convolutions is not ported (ROADMAP
  A.6).  On CUDA the mesh holds the visible cards; on the CPU it names the
  CPU N times (the counterpart of the JAX tests' virtual devices).

Not ported yet: a data mesh of more than one device (ROADMAP A.2),
multi-host training (A.5) and profiler traces (A.8); the constructor raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Iterable

import numpy as np
import torch

from sap3d_tpu_torch.core.config import Config
from sap3d_tpu_torch.core.device import DEFAULT_DEVICE, resolve_device
from sap3d_tpu_torch.core.mesh import make_time_mesh
from sap3d_tpu_torch.eval import metrics
from sap3d_tpu_torch.models.registry import build_model
from sap3d_tpu_torch.train.checkpoint import CheckpointManager, try_restore_latest
from sap3d_tpu_torch.train.state import create_train_state
from sap3d_tpu_torch.train.steps import make_eval_step, make_train_step
from sap3d_tpu_torch.train.tb_events import EventWriter


def run_name(cfg: Config) -> str:
    """<model>_<batch>_<lr>_<info>_<date>."""
    t = datetime.date.today().isoformat()
    return f"{cfg.model.name}_{cfg.train.batch_size}_{cfg.train.lr}_{cfg.train.info}_{t}"


class Trainer:
    def __init__(self, cfg: Config, run: str | None = None,
                 device: str | torch.device = DEFAULT_DEVICE):
        tc = cfg.train
        if tc.num_devices > 1:
            raise NotImplementedError(f"a data mesh of {tc.num_devices} devices is not "
                                      "ported yet (ROADMAP A.2, data parallel)")
        if tc.profile_dir:
            raise NotImplementedError("profile_dir is not ported yet (ROADMAP A.8, "
                                      "profiler traces)")
        self.device = resolve_device(device)
        self.time_mesh = self._time_mesh(cfg)
        self.cfg = cfg
        self.run = run or run_name(cfg)
        self.model_dir = os.path.join(tc.model_dir, self.run)
        self.logs_dir = os.path.join(tc.logs_dir, self.run)
        os.makedirs(self.model_dir, exist_ok=True)
        os.makedirs(self.logs_dir, exist_ok=True)
        if tc.debug_nans:
            torch.autograd.set_detect_anomaly(True)

        ring_mesh = self.time_mesh if tc.ring_attention else None
        self.model = build_model(cfg.model.name, dtype=cfg.model.dtype, device=self.device,
                                 seed=tc.seed, dropout_rate=cfg.model.dropout,
                                 ring_mesh=ring_mesh)
        if ring_mesh is not None and not self.model.ring_sites():
            print(f"[time-shards] model '{cfg.model.name}' has no ring-attention sites; its "
                  "attention runs unsharded")
        self.state = create_train_state(self.model, lr=tc.lr, weight_decay=tc.weight_decay)
        self.train_step = make_train_step(self.state)
        self.eval_step = make_eval_step(self.model)
        self.ckpt = CheckpointManager(self.model_dir, tc.max_to_keep)
        self._metrics_log = open(os.path.join(self.logs_dir, "metrics.jsonl"), "a")
        self._tb = EventWriter(self.logs_dir)

        if tc.pretrain:
            pre_dir = os.path.join(tc.model_dir, tc.pretrain)
            self.state, ok = try_restore_latest(self.state, pre_dir)
            print(f"pretrain restore from {pre_dir}: {'ok' if ok else 'MISSING'}")

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

    def _put(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), device=self.device)

    def fit(self, train_batches: Iterable,
            valid_batches_fn: Callable[[], Iterable] | None = None) -> None:
        tc = self.cfg.train
        gen = torch.Generator(device=self.device).manual_seed(tc.seed + 1)
        step = self.state.step
        t_last, n_last = time.time(), 0
        ran_any = False
        for frames, targets in train_batches:
            f, t = self._put(frames), self._put(targets)
            step += 1
            ran_any = True
            loss = self.train_step(f, t, gen)
            n_last += frames.shape[0]

            if step <= 10 or step % tc.plot_iter == 0:
                loss_v = float(loss)
                dt = time.time() - t_last
                cps = n_last / dt if dt > 0 else 0.0
                pred = self.eval_step(f).cpu().numpy()
                self._dump_images(step, pred[0, -1], np.asarray(targets)[0, -1])
                print(f"[{datetime.datetime.now().isoformat(timespec='seconds')}] "
                      f"step {step} loss {loss_v:.4f} clips/s {cps:.2f}", flush=True)
                self._log({"step": step, "loss": loss_v, "clips_per_sec": cps})
                t_last, n_last = time.time(), 0

            if valid_batches_fn is not None and step % tc.valid_iter == 0:
                self.validate(step, valid_batches_fn())
                from sap3d_tpu_torch.train.plotting import plot_curves

                plot_curves(self.logs_dir)

            if step % tc.save_iter == 0:
                t_save = time.time()
                self.ckpt.save(self.state, step)
                self._log({"step": step, "save_dispatch_s": time.time() - t_save})

            if tc.max_steps is not None and step >= tc.max_steps:
                break
        if not ran_any:
            if step == 0:
                raise RuntimeError(
                    "fit() ran zero training steps: the loader produced no full "
                    "batches (too few clips for the batch size after the "
                    "train/valid split?).  Nothing was saved.")
            print(f"fit(): no new batches at step {step}; nothing to do")
        else:
            self.ckpt.save(self.state, step)
        print("Training Finished!", flush=True)

    def validate(self, step: int, valid_batches: Iterable) -> dict:
        """CC/SIM/KLD/AUC-Judd on the last frame of each clip, NaN-filtered
        means; logged and returned."""
        ccs, sims, klds, aucs = [], [], [], []
        gen = torch.Generator(device=self.device).manual_seed(step)
        for frames, targets in valid_batches:
            pred_last = self.eval_step(self._put(frames))[:, -1].float()
            gt_last = self._put(targets)[:, -1].float()
            ccs += metrics.cc(pred_last, gt_last).tolist()
            sims += metrics.sim(pred_last, gt_last).tolist()
            klds += metrics.kldiv(pred_last, gt_last).tolist()
            # dense density targets: sweep the full pixel count
            aucs += metrics.auc_judd(pred_last, gt_last, gen,
                                     fix_cap=gt_last.shape[-2] * gt_last.shape[-1]).tolist()
        result = {
            "step": step,
            "cc": metrics.nan_filtered_mean(ccs),
            "sim": metrics.nan_filtered_mean(sims),
            "kld": metrics.nan_filtered_mean(klds),
            "auc_judd": metrics.nan_filtered_mean(aucs),
        }
        print(f"[valid] step {step} CC {result['cc']:.4f} SIM {result['sim']:.4f} "
              f"KLD {result['kld']:.4f} AUC_Judd {result['auc_judd']:.4f}", flush=True)
        self._log(result)
        return result

    def close(self):
        self.ckpt.close()
        self._metrics_log.close()
        self._tb.close()
