"""PyTorch and CUDA port of the hydra-pspec Gibbs sampler for NVIDIA Hopper.

The JAX package ``hydra_pspec_tpu`` is the reference this package is held
against. This package imports ``torch``, ``numpy`` and ``scipy`` only. It
holds the host operator build, the sampler engines (megachain, the
single-step mega engine, the real engine and the complex float64 engine,
``models/``) on the hand-written CUDA kernels (``ops/kernels``, sources in
``csrc/``), ``runner.run_baselines``, which routes a run to its engine and
splits it over processes and devices (``parallel/dist.py``), the CLI
(``cli/run.py``), and the LSSA, OQE and DPSS estimators.

Every entry point takes ``device``, the card unless the caller asks for
the CPU; tensors passed in keep their device. CUDA tensors go through the
hand-written kernels; CPU tensors take each kernel's plain PyTorch version.
"""
import importlib

__version__ = "0.1.0"

# the reference's public API surface (hydra_pspec/__init__.py re-exports
# dpss, lssa, oqe, pspec and utils; hydra_pspec_tpu/__init__.py:31-34),
# imported at first use: importing the package loads no numpy or torch, so
# a module run with ``-m`` (validation/oracle.py) still sets its BLAS
# threads before numpy loads
_EXPORTS = {
    "dpss": ".models.dpss", "gcr": ".models.gcr", "gibbs": ".models.gibbs",
    "lssa": ".models.lssa", "oqe": ".models.oqe",
    "gibbs_sample_with_fg": ".models.gibbs",
    "gibbs_step_fgmodes": ".models.gibbs",
    "fourier_operator": ".ops.fourier",
    "inversion_sample_invgamma": ".ops.invgamma",
    "sample_S": ".ops.invgamma", "sprior": ".ops.invgamma",
}


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(_EXPORTS[name], __name__)
    return module if module.__name__.endswith("." + name) else getattr(
        module, name)


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))
