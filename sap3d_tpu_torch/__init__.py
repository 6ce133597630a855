"""sap3d_tpu_torch — the PyTorch/CUDA port of ``sap3d_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, held against it by parity tests
(``tests/test_torch_*.py``).  It imports ``torch``, ``numpy`` and the
standard library only: nothing of ``jax``, ``flax`` or ``sap3d_tpu``, whose
package import pulls in JAX.  What it needs from framework-free modules of
the JAX package is copied here.

The module layout mirrors ``sap3d_tpu`` so each counterpart is easy to find.
Public functions keep the JAX package's layouts: model input
``[B, T, H, W, 3]``, model output ``[B, T, H, W, 1]`` in float32, attention
tokens ``[B, N, C]``.  Every entry point takes ``device`` (default
``"cuda"``) and raises where no GPU is present instead of running on the CPU.

Ported so far, for the flagship (``p3d_unetplusplus_ds``): the inference
path (layers, self-attention with the hand-written CUDA flash forward
``csrc/flash_attention_fwd.cu``, the P3D encoder and UNet++ decoder, the
flax weight bridge, the eval forward, the sliding-window predictor, ``cli
predict``) and the train path (train-mode BN and dropout, the loss, Adam,
the train step with the flash forward's lse output and the hand-written
flash backward ``csrc/flash_attention_bwd.cu``, checkpoints, validation
metrics, the trainer, ``cli train``).  ``ROADMAP.md`` queues the rest.
"""

__version__ = "0.1.0"
