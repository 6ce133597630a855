"""sap3d_tpu_torch — the PyTorch/CUDA port of ``sap3d_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, held against it by parity tests
(``tests/test_torch_*.py``).  It imports ``torch``, ``numpy`` and the
standard library only: nothing of ``jax``, ``flax`` or ``sap3d_tpu``, whose
package import pulls in JAX, and nothing of ``tensorflow`` or protobuf (the
reference's TF checkpoints are read by ``interop/tf_bundle.py``).  What it needs from framework-free modules of
the JAX package is copied here.

The module layout mirrors ``sap3d_tpu`` so each counterpart is easy to find.
Public functions keep the JAX package's layouts: model input
``[B, T, H, W, 3]``, model output ``[B, T, H, W, 1]`` in float32, attention
tokens ``[B, N, C]``.  Every entry point takes ``device`` (default
``"cuda"``) and raises where no GPU is present instead of running on the CPU.

Ported so far: every model of the registry, the inference path (the
sliding-window predictor, ``cli predict``), the train path (``cli train``,
long clips with ring attention), the evaluation path (``cli eval``,
``eval-dirs``, ``make-video``, ``inspect``, ``plot``), the reference's TF1
checkpoints with its inference (``--tf-checkpoint``, ``bn_reference_quirk``)
and the inference bisect (``scripts/bisect_infer.py``), with a hand-written CUDA kernel in
``csrc/`` for every Pallas kernel of the JAX package.  ``ROADMAP.md``
queues the rest.
"""

__version__ = "0.1.0"
