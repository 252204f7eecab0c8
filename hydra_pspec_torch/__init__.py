"""PyTorch and CUDA port of the hydra-pspec Gibbs sampler for NVIDIA Hopper.

The JAX package ``hydra_pspec_tpu`` is the reference this package is held
against. This package imports ``torch``, ``numpy`` and ``scipy`` only. It
holds the host operator build, the three sampler engines (megachain, the
single-step mega engine and the real engine, ``models/``) on the
hand-written CUDA kernels (``ops/kernels``, sources in ``csrc/``), and
``runner.run_baselines``, which routes a run to its engine.

Every entry point takes an explicit ``device``. CUDA tensors go through the
hand-written kernels; CPU tensors take each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
