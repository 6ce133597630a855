"""Hand-written CUDA kernels for Hopper (sources in ``sap3d_tpu_torch/csrc``)."""
