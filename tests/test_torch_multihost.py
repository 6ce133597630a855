"""Multi-host training in the port (``cli train --distributed``), on the CPU.

* Two OS processes of ``cli train --distributed true --coordinator
  127.0.0.1:<port> --num-processes 2 --process-id {0,1} --device cpu
  --devices 4`` (two CPU ranks each, global ranks 0-3 over gloo) against one
  process of ``cli train --device cpu --devices 4`` on the same synthetic
  dataset, with ``tests/test_multihost.py``'s arguments (``p3d_micro``, 32
  px, float32, dropout 0, shuffle off, global batch 4, 5 steps).  Both are
  the same four gloo ranks on the same clips, so the logged losses are held
  to rtol 1e-6 and were read bit for bit equal, as is the checkpoint
  (every tensor ``torch.equal``, held so).  One run directory, one
  ``Training Finished!``.
* The clips of each global batch of a P x L run (P processes, L ranks each)
  against the JAX package's ``ClipLoader`` with ``process_index`` and
  ``process_count`` P, each host batch split into L contiguous rows: the
  same set at every step, and the same number of steps.
* The flag rules against ``sap3d_tpu.cli.main``, the port's own returns
  (the batch or ``--devices`` not dividing by the processes, ``--time-shards``
  with two processes), the mesh across processes and its backend, and a
  lost peer or coordinator raising within the timeout.

Processes of one run meet on a TCP store at a free port of 127.0.0.1; the
other process of a rule's run is a ``Cluster`` on a thread of this one.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from sap3d_tpu import cli as jax_cli
from sap3d_tpu.data.pipeline import ClipLoader as JaxClipLoader
from sap3d_tpu_torch import cli
from sap3d_tpu_torch.core.mesh import (
    DATA_AXIS,
    Cluster,
    Mesh,
    data_backend,
    initialize_distributed,
    make_mesh,
)
from sap3d_tpu_torch.data.pipeline import ClipLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300        # one cli run, spawn to exit
LOST_PEER_TIMEOUT_S = 2.0  # the rendezvous's timeout in the lost-peer tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _coordinator() -> str:
    return f"127.0.0.1:{_free_port()}"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    pytest.importorskip("cv2")
    from sap3d_tpu_torch.data.synthetic import make_synthetic_dataset

    root = tmp_path_factory.mktemp("multihost_synthetic")
    return make_synthetic_dataset(str(root), num_videos=3, frames_per_video=40,
                                  size=(48, 36), with_fixations=False)


def _train_args(ds) -> list[str]:
    """``tests/test_multihost.py``'s run, on the CPU, with 4 data ranks."""
    return [
        "train", "--structure", "p3d_micro",
        "--frames", ds["frame_dirs"], "--densities", ds["density_dirs"],
        "--overlap", "12", "--batch", "4", "--epoch", "4",
        "--imagesize", "32", "--threads", "2", "--dtype", "float32",
        "--dropout", "0.0", "--shuffle", "false",
        "--plotiter", "1", "--validiter", "100000", "--saveiter", "100000",
        "--max-steps", "5", "--info", "mh", "--device", "cpu", "--devices", "4",
    ]


def _start(args: list[str], cwd, ranks: int) -> subprocess.Popen:
    """``python -m sap3d_tpu_torch.cli`` in ``cwd``, one CPU thread per rank."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=str(ranks))
    env.pop("PYTEST_CURRENT_TEST", None)
    return subprocess.Popen([sys.executable, "-m", "sap3d_tpu_torch.cli", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc: subprocess.Popen) -> str:
    try:
        out = proc.communicate(timeout=RUN_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0]
        pytest.fail(f"cli train did not end within {RUN_TIMEOUT_S} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    return out


def _losses(workdir) -> list[tuple[int, float]]:
    (run,) = os.listdir(os.path.join(workdir, "logs"))
    with open(os.path.join(workdir, "logs", run, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f) if "loss" in r]


def _checkpoint(workdir) -> dict:
    (run,) = os.listdir(os.path.join(workdir, "model"))
    (name,) = os.listdir(os.path.join(workdir, "model", run))
    return torch.load(os.path.join(workdir, "model", run, name), weights_only=False)


def _tensors(tree, prefix="") -> dict:
    """Every tensor of a checkpoint by its path."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree) \
        if isinstance(tree, (list, tuple)) else ()
    return {k: v for key, sub in items for k, v in _tensors(sub, f"{prefix}/{key}").items()}


def test_two_processes_match_one_process_of_four_ranks(dataset, tmp_path):
    dist_dir, single_dir = tmp_path / "dist", tmp_path / "single"
    dist_dir.mkdir()
    single_dir.mkdir()
    coordinator = _coordinator()
    procs = [_start(_train_args(dataset) + [
        "--distributed", "true", "--coordinator", coordinator, "--num-processes", "2",
        "--process-id", str(pid)], dist_dir, 2) for pid in (0, 1)]
    single = _start(_train_args(dataset), single_dir, 4)
    outs = [_finish(p) for p in procs]
    _finish(single)

    assert sum(out.count("Training Finished!") for out in outs) == 1
    assert len(os.listdir(dist_dir / "model")) == len(os.listdir(dist_dir / "logs")) == 1
    got, want = _losses(dist_dir), _losses(single_dir)
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3, 4, 5]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want], rtol=1e-6)
    a, b = _tensors(_checkpoint(dist_dir)), _tensors(_checkpoint(single_dir))
    assert a.keys() == b.keys() and len(a) > 0
    for name, t in a.items():
        assert torch.equal(t, b[name]), name


# ---- the clips of each global batch -------------------------------------------

def _clip_ids(loader) -> list[list[int]]:
    with loader:
        return [b[0][:, 0].tolist() for b in loader]


@pytest.mark.parametrize("processes,per_process", [(2, 2), (3, 1)], ids=["P2xL2", "P3xL1"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in_order"])
def test_global_batches_are_the_jax_loaders(processes, per_process, shuffle):
    """Rank r of W = P L takes ``order[r::W]`` with the rank batch b; JAX's
    host p takes ``order[p::P]`` with the host batch L b, its rows split
    contiguously over the host's L devices.  Every step's global batch is
    the same set of clips."""
    clips, b = list(range(53)), 2
    world = processes * per_process
    kw = dict(shuffle=shuffle, epochs=2, seed=11, num_threads=2,
              decode_fn=lambda c: (np.array([c], np.int64),))
    port = [_clip_ids(ClipLoader(clips, b, process_index=r, process_count=world, **kw))
            for r in range(world)]
    hosts = [_clip_ids(JaxClipLoader(clips, per_process * b, process_index=p,
                                     process_count=processes, **kw))
             for p in range(processes)]
    devices = [[batch[j * b:(j + 1) * b] for batch in host]
               for host in hosts for j in range(per_process)]
    steps = 2 * (53 // (world * b))
    assert all(len(r) == steps for r in port + devices)
    for s in range(steps):
        got = [c for r in port for c in r[s]]
        want = [c for d in devices for c in d[s]]
        assert len(got) == len(set(got)) == world * b
        assert set(got) == set(want), s


# ---- the flag rules and the port's returns ------------------------------------

@pytest.mark.parametrize("flags", [["--num-processes", "2"], ["--process-id", "0"]],
                         ids=["num_processes", "process_id"])
def test_process_flags_without_a_coordinator_are_the_jax_error(flags, capsys):
    argv = ["train", "--distributed", "true", *flags]
    errors = []
    for main in (jax_cli.main, cli.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1].split("error: ")[1])
    assert errors[0] == errors[1] == "--num-processes/--process-id require --coordinator"


def test_without_a_coordinator_distributed_is_one_process(capsys):
    assert initialize_distributed() is None
    assert "initialize_distributed skipped" in capsys.readouterr().out


@pytest.mark.parametrize("case", ["batch", "devices", "time_shards"])
def test_process_rules_return_before_any_rank(dataset, case, tmp_path, monkeypatch, capsys):
    """Process 1 of 2 through ``cli.main``, process 0 a ``Cluster`` on a
    thread: a global batch that does not divide by the processes and a
    ``--devices`` that does not return 2; ``--time-shards`` above 1 raises
    with the JAX trainer's reason."""
    monkeypatch.chdir(tmp_path)
    coordinator = _coordinator()
    first = []

    def process_0():
        with Cluster(coordinator, 2, 0, timeout=60) as c:
            first.append(c.hosts)

    peer = threading.Thread(target=process_0)
    peer.start()
    argv = [*_train_args(dataset), "--distributed", "true", "--coordinator", coordinator,
            "--num-processes", "2", "--process-id", "1"]
    try:
        if case == "batch":
            assert cli.main([*argv, "--batch", "3"]) == 2
            assert "--batch 3 must divide by process_count 2" in capsys.readouterr().err
        elif case == "devices":
            assert cli.main([*argv, "--devices", "3"]) == 2
            assert "does not divide over 2 processes" in capsys.readouterr().err
        else:
            with pytest.raises(NotImplementedError, match="single-process"):
                cli.main([*argv, "--time-shards", "2"])
    finally:
        peer.join(timeout=120)
    assert not peer.is_alive() and len(first) == 1 and len(first[0]) == 2
    assert not os.path.exists(tmp_path / "model")


def test_cluster_mesh_spans_every_process():
    """Two processes (threads here) of 2 CPU ranks each: one mesh of 4
    global ranks, each process's at its offset; the backend by (host,
    card); a count that does not divide by the processes raises."""
    coordinator, meshes, errors = _coordinator(), {}, {}

    def process(pid):
        with Cluster(coordinator, 2, pid, timeout=60) as c:
            meshes[pid] = make_mesh(4, device="cpu", cluster=c)
            try:
                make_mesh(3, device="cpu", cluster=c)
            except ValueError as e:
                errors[pid] = str(e)

    threads = [threading.Thread(target=process, args=(pid,)) for pid in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    host = socket.gethostname()
    for pid, mesh in meshes.items():
        assert mesh.shape == {DATA_AXIS: 4} and mesh.local == (2 * pid, 2 * pid + 2)
        assert mesh.places == ((host, "cpu"),) * 4 and data_backend(mesh) == "gloo"
    assert meshes[0].devices == meshes[1].devices and meshes[0].places == meshes[1].places
    assert all("does not divide over 2 processes" in e for e in errors.values())
    assert len(errors) == 2

    cards = (torch.device("cuda", 0),) * 2
    assert data_backend(Mesh(cards, DATA_AXIS, places=(("a", "GPU-1"), ("b", "GPU-1")))) \
        == "nccl"
    assert data_backend(Mesh(cards, DATA_AXIS, places=(("a", "GPU-1"), ("a", "GPU-2")))) \
        == "nccl"
    assert data_backend(Mesh(cards, DATA_AXIS, places=(("a", "GPU-1"), ("a", "GPU-1")))) \
        == "gloo"


@pytest.mark.parametrize("who", ["lost_peer", "no_coordinator"])
def test_a_missing_process_raises_within_the_timeout(who):
    """Process 0 of 2 alone waits for process 1 at its own store; process 1
    of 2 alone finds no store at the coordinator.  Each raises within a
    bounded multiple of the timeout (the store retries a connection within
    it), and nothing is returned to train on."""
    t0 = time.perf_counter()
    match = r"no host from process \[1\]" if who == "lost_peer" else "no store at"
    with pytest.raises(RuntimeError, match=match):
        initialize_distributed(_coordinator(), 2, 0 if who == "lost_peer" else 1,
                               timeout=LOST_PEER_TIMEOUT_S)
    assert time.perf_counter() - t0 < 5 * LOST_PEER_TIMEOUT_S
