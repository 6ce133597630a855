"""Checkpoint save and restore with keep-last-K retention.

Counterpart of ``sap3d_tpu/train/checkpoint.py``.  A checkpoint is one file,
``<directory>/ckpt_<step>.pt``: ``torch.save`` of the model's ``state_dict``
(parameters and BN statistics), the optimizer's ``state_dict`` (Adam
moments and step counts) and the train step, so a resume is exact.

Saves are asynchronous, as the JAX package's Orbax saves are: ``save``
copies the state to host memory on the caller's thread (so training may
move the parameters on at once) and writes the file on a background thread,
to a temporary name and then renamed, so a reader never sees half a file.
One save is in flight at a time; ``restore``, a newer ``save`` and
``close`` wait for it.  After each write the oldest files beyond
``max_to_keep`` are deleted.
"""

from __future__ import annotations

import os
import re
import threading

import torch

from sap3d_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def checkpoint_steps(directory: str) -> list[int]:
    """The steps of the checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def load_checkpoint(directory: str, step: int | None = None,
                    map_location: str | torch.device = "cpu") -> dict:
    """The payload of the checkpoint at ``step`` (default: the latest):
    ``{"model": state_dict, "optimizer": state_dict, "step": int}``."""
    steps = checkpoint_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint in {directory}")
        step = steps[-1]
    return torch.load(checkpoint_path(directory, step), map_location=map_location,
                      weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, state: TrainState, step: int | None = None) -> None:
        step = state.step if step is None else step
        self.wait_until_finished()
        payload = {"model": _to_host(state.model.state_dict()),
                   "optimizer": _to_host(state.optimizer.state_dict()),
                   "step": int(state.step)}
        self._thread = threading.Thread(target=self._write, args=(payload, step),
                                        name="checkpoint-writer", daemon=True)
        self._thread.start()

    def _write(self, payload: dict, step: int) -> None:
        try:
            path = checkpoint_path(self.directory, step)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in checkpoint_steps(self.directory)[:-self.max_to_keep]:
                os.remove(checkpoint_path(self.directory, old))
        except Exception as e:  # raised on the caller's next wait
            self._error = e

    def wait_until_finished(self) -> None:
        """Barrier for the save in flight; raises if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"checkpoint write failed in {self.directory}") from err

    def latest_step(self) -> int | None:
        steps = checkpoint_steps(self.directory)
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: int | None = None) -> TrainState:
        """Load the checkpoint at ``step`` (default: the latest) into
        ``state``'s model and optimizer; shapes must match.  The optimizer
        keeps its own ``fused`` and ``capturable``."""
        self.wait_until_finished()
        payload = load_checkpoint(self.directory, step)
        state.model.load_state_dict(payload["model"], strict=True)
        optimizer = payload["optimizer"]
        # fused and capturable follow this process's device (a checkpoint
        # written on the CPU, or before the step could be captured, carries
        # others); the rest is the checkpoint's
        for saved, live in zip(optimizer["param_groups"], state.optimizer.param_groups):
            saved.update({k: live[k] for k in ("fused", "capturable")})
        state.optimizer.load_state_dict(optimizer)
        state.step = int(payload["step"])
        return state

    def close(self) -> None:
        self.wait_until_finished()


def try_restore_latest(state: TrainState, directory: str) -> tuple[TrainState, bool]:
    """Restore the latest checkpoint of ``directory`` if one exists."""
    if not checkpoint_steps(directory):
        return state, False
    return CheckpointManager(directory).restore(state), True
