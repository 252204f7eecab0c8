"""Hand-written CUDA kernels of the megachain path and their plain torch
versions. Sources are in ``hydra_pspec_torch/csrc``; ``_build`` compiles
them with nvcc for sm_90a at first use and binds them with ctypes."""
