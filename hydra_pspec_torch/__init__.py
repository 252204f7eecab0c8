"""PyTorch and CUDA port of the hydra-pspec Gibbs sampler for NVIDIA Hopper.

The JAX package ``hydra_pspec_tpu`` is the reference this package is held
against. This package imports ``torch``, ``numpy`` and ``scipy`` only. The
slice ported so far is the megachain engine's main path: the host operator
build, the K-iteration chain driver with its hand-written CUDA kernels
(``ops/kernels``, sources in ``csrc/``), and ``runner.run_baselines``.

Every entry point takes an explicit ``device``. CUDA tensors go through the
hand-written kernels; CPU tensors take each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
