"""The port stands alone and runs where it is told to.

* Importing every module of ``sap3d_tpu_torch`` in a fresh interpreter puts
  no ``jax``, ``flax``, ``sap3d_tpu``, ``tensorflow``, ``tf_keras`` or
  ``google.protobuf`` into ``sys.modules``: the GPU host has none of them.
* ``chip_smoke.py`` imports nothing of JAX or the JAX package, and on a host
  without a GPU it exits non-zero and prints no result line.
* Every entry point's default device is CUDA, and on this GPU-less host it
  raises instead of running on the CPU.
* On a CUDA tensor each kernel wrapper (B1 to B6) launches its
  kernel or raises: with the library absent it raises and never takes the
  plain path; a ring over CUDA devices takes the kernel hop.
"""

import ast
import os
import pkgutil
import subprocess
import sys
import types

import pytest
import torch

import sap3d_tpu_torch
from sap3d_tpu_torch.ops.cuda import build
from sap3d_tpu_torch.ops.cuda import flash_attention as fa
from sap3d_tpu_torch.ops.cuda import flash_attention_bwd as fb
from sap3d_tpu_torch.ops.cuda import flash_attention_nolse as nolse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sap3d_tpu", "tensorflow",
             "tf_keras", "google.protobuf")


def forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        sap3d_tpu_torch.__path__, prefix="sap3d_tpu_torch."))


def _run(code: str, cwd: str = REPO, timeout: int = 120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_nothing_of_jax():
    mods = _all_modules()
    assert "sap3d_tpu_torch.ops.cuda.flash_attention" in mods
    assert "sap3d_tpu_torch.cli" in mods
    assert "sap3d_tpu_torch.ops.cbam" in mods
    assert "sap3d_tpu_torch.ops.ring_attention" in mods
    assert "sap3d_tpu_torch.core.mesh" in mods
    for new in ("ops.cuda.flash_attention_nolse", "scripts.bisect_infer", "eval.metrics_np",
                "eval.evaluator", "infer.video", "train.inspect_ckpt", "interop.tf_bundle",
                "interop.tf_import", "scripts._timing", "scripts.profile_attention",
                "scripts.profile_ring_hop", "scripts.profile_decoder", "scripts.profile_encoder",
                "scripts.profile_step", "scripts.profile_gn", "scripts.bench_eval",
                "scripts.bench_cli_eval", "scripts.bench_export", "scripts.bench_loader",
                "ops.concat_split", "ops.conv2d_path", "ops.fast_tconv", "ops.stem_s2d",
                "scripts.profile_tconv", "scripts.profile_tconv2", "scripts.profile_tconv3"):
        assert f"sap3d_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "print(repr(bad))\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_name_no_jax_import():
    """A static check as well: no import statement anywhere in the package
    or chip_smoke.py names a forbidden top-level module."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.dirname(sap3d_tpu_torch.__file__)):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert not forbidden(name), f"{path}: import {name}"


def test_chip_smoke_fails_without_a_gpu_and_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "    code = 0\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') "
        f"for f in {FORBIDDEN!r}))\n"
        "print('EXIT', code, repr(bad))\n"
    )
    res = _run(code)
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("EXIT ") and not last.startswith("EXIT 0 ")
    assert last.endswith("[]")
    assert '"ok": true' not in res.stdout


def test_chip_smoke_alone_in_a_directory_fails(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        (tmp_path / "chip_smoke.py").write_text(src.read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_default_device_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.core.device import resolve_device
    from sap3d_tpu_torch.infer.predictor import SlidingWindowPredictor
    from sap3d_tpu_torch.models.registry import build_model

    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        build_model("p3d_micro")
    with pytest.raises(RuntimeError, match="cuda"):
        SlidingWindowPredictor(lambda clips: clips)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["predict", "--structure", "p3d_micro", "--checkpoint", "w.pt",
                  "--data", str(tmp_path), "--out", str(tmp_path / "out")])
    assert resolve_device("cpu") == torch.device("cpu")


def test_eval_and_bisect_entry_points_default_to_cuda_and_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.eval.evaluator import evaluate_saliency_dirs
    from sap3d_tpu_torch.scripts import bisect_infer

    with pytest.raises(RuntimeError, match="cuda"):
        bisect_infer.main(batch=1)
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_saliency_dirs(str(tmp_path), str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["eval", "--checkpoint", "r", "--frames", str(tmp_path), "--densities",
                  str(tmp_path), "--fixations", str(tmp_path)])
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["eval-dirs", "--pred", str(tmp_path), "--density", str(tmp_path)])


def test_train_entry_points_default_to_cuda_and_raise_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device is valid here")
    from sap3d_tpu_torch import cli
    from sap3d_tpu_torch.core.config import Config, ModelConfig, TrainConfig
    from sap3d_tpu_torch.train.trainer import Trainer

    cfg = Config(model=ModelConfig(name="p3d_micro"),
                 train=TrainConfig(model_dir=str(tmp_path), logs_dir=str(tmp_path)))
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", "--structure", "p3d_micro", "--frames", str(tmp_path),
                  "--densities", str(tmp_path)])


def _fake_cuda_tensor(*shape):
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                                 shape=shape, dim=lambda: len(shape))


def test_wrapper_raises_on_cuda_tensors_when_the_library_is_absent(monkeypatch):
    def absent(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    monkeypatch.setattr(build, "load", absent)
    monkeypatch.setattr(fa, "flash_attend_tokens_reference",
                        lambda *a: pytest.fail("fell back to the plain version"))
    q, k, v = (_fake_cuda_tensor(1, 256, 8), _fake_cuda_tensor(1, 64, 8),
               _fake_cuda_tensor(1, 64, 64))
    before = fa.flash_attend_tokens.launches
    with pytest.raises(OSError, match="cannot open"):
        fa.flash_attend_tokens(q, k, v)
    assert fa.flash_attend_tokens.launches == before


def test_b6_raises_on_cuda_tensors_when_the_library_is_absent(monkeypatch):
    def absent(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    monkeypatch.setattr(build, "load", absent)
    monkeypatch.setattr(nolse, "flash_nolse_reference",
                        lambda *a: pytest.fail("fell back to the plain version"))
    q, k, v = (_fake_cuda_tensor(1, 256, 8), _fake_cuda_tensor(1, 64, 8),
               _fake_cuda_tensor(1, 64, 64))
    before = nolse.flash_nolse.launches
    with pytest.raises(OSError, match="cannot open"):
        nolse.flash_nolse(q, k, v)
    assert nolse.flash_nolse.launches == before


@pytest.mark.parametrize("kernel", ["B2", "B3", "B4"])
def test_training_wrappers_raise_on_cuda_tensors_when_the_library_is_absent(
        monkeypatch, kernel):
    def absent(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    fail = lambda *a: pytest.fail("fell back to the plain version")  # noqa: E731
    monkeypatch.setattr(build, "load", absent)
    monkeypatch.setattr(fa, "flash_forward_lse_reference", fail)
    monkeypatch.setattr(fb, "flash_backward_reference", fail)
    q, k, v = (_fake_cuda_tensor(1, 256, 8), _fake_cuda_tensor(1, 64, 8),
               _fake_cuda_tensor(1, 64, 64))
    o, lse = _fake_cuda_tensor(1, 256, 64), _fake_cuda_tensor(1, 256)
    wrapper, args = {"B2": (fa.flash_forward_lse, (q, k, v)),
                     "B3": (fb.flash_backward, (q, k, v, o, lse, o)),
                     "B4": (fb.flash_backward, (q, k, v, o, lse, o, lse))}[kernel]
    before = fa.flash_forward_lse.launches, fb.flash_backward.launches, \
        fb.flash_backward.launches_lse
    with pytest.raises(OSError, match="cannot open"):
        wrapper(*args)
    assert (fa.flash_forward_lse.launches, fb.flash_backward.launches,
            fb.flash_backward.launches_lse) == before


def test_b5_raises_on_cuda_tensors_when_the_library_is_absent(monkeypatch):
    from sap3d_tpu_torch.ops import attention

    def absent(name):
        raise OSError(f"lib{name}.so: cannot open shared object file")

    monkeypatch.setattr(build, "load", absent)
    monkeypatch.setattr(attention, "_dot_softmax_attend",
                        lambda *a: pytest.fail("fell back to the plain version"))
    q, k, v = (_fake_cuda_tensor(1, 256, 8), _fake_cuda_tensor(1, 64, 8),
               _fake_cuda_tensor(1, 64, 64))
    before = attention.flash_fwd_chunked_bwd.launches
    ctx = types.SimpleNamespace(save_for_backward=lambda *a: None)
    with pytest.raises(OSError, match="cannot open"):
        attention._FlashForwardChunkedBackward.forward(ctx, q, k, v)
    assert attention.flash_fwd_chunked_bwd.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """With no nvcc to be found the build raises (it does not skip the
    kernel); the library is looked for under a fresh build directory."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed at /usr/local/cuda on this host")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(fa.SOURCE)


def test_ring_on_cuda_devices_takes_the_kernel_hop(monkeypatch):
    """Shards on CUDA devices whose per-shard shape the backward gate takes
    run the kernel hop (B2 + B4, whose wrappers raise above without the
    library), never the plain chunked hop."""
    from sap3d_tpu_torch.core.mesh import make_time_mesh
    from sap3d_tpu_torch.ops import ring_attention as ra

    def kernel_hop(*args):
        raise RuntimeError("the kernel hop")

    monkeypatch.delenv("SAP3D_RING_HOP", raising=False)
    monkeypatch.setitem(ra._HOPS, "xla", (lambda *a: pytest.fail("took the chunked hop"),
                                          None))
    monkeypatch.setitem(ra._HOPS, "pallas", (kernel_hop, None))
    monkeypatch.setattr(torch.Tensor, "to", lambda t, *a, **kw: t)  # no card here
    mesh = make_time_mesh(2, devices=["cuda:0"] * 2)
    q, k, v = torch.randn(1, 512, 8), torch.randn(1, 64, 8), torch.randn(1, 64, 64)
    with pytest.raises(RuntimeError, match="the kernel hop"):
        ra.ring_attend_sharded(mesh, q, k, v)
