"""Run configuration (port of ``hydra_pspec_tpu/utils/config.py``): the
reference's YAML config keys (test_data/config.yaml,
scripts/3bl-example/config-3bl-mpi.yaml) plus command-line overrides, with
the reference's per-baseline ``--X`` / ``--X_file`` resolution
(run-hydra-pspec.py:248-266). ``yaml`` is imported by :meth:`from_yaml`
only, so a run configured from flags needs no pyyaml."""
from dataclasses import dataclass, field, fields
from pathlib import Path
from typing import Optional

import numpy as np


@dataclass
class RunConfig:
    """The reference's ~25 driver flags (run-hydra-pspec.py:39-239), then
    the knobs of this implementation, with the JAX package's names and
    defaults."""

    file_paths: list = field(default_factory=list)
    ant_str: str = "cross"
    sigcov0: Optional[str] = None
    sigcov0_file: Optional[str] = None
    Nfgmodes: int = 8
    fgmodes: Optional[str] = None
    fgmodes_file: Optional[str] = None
    freq_range: Optional[str] = None
    flags: Optional[str] = None
    flags_file: Optional[str] = None
    noise: Optional[str] = None
    noise_file: Optional[str] = None
    noise_cov: Optional[str] = None
    noise_cov_file: Optional[str] = None
    nsamples: Optional[str] = None
    nsamples_file: Optional[str] = None
    n_ps_prior_bins: int = 3
    ps_prior_lo: float = 0.0
    ps_prior_hi: float = 0.0
    map_estimate: bool = False
    Niter: int = 100
    seed: Optional[int] = None
    verbose: bool = False
    Nproc: int = 1            # accepted for config parity; unused (no pools)
    out_dir: str = "./"
    dirname: Optional[str] = None
    clobber: bool = False
    write_Niter: int = 100
    # --- extensions of the reference ---------------------------------------
    nchains: int = 1          # independent Gibbs chains per baseline
    time_flags: bool = False  # per-time flag patterns (reference FIXME :541)
    precision: str = "auto"   # auto | x32: the float32 engines; x64: the
                              # complex float64 engine (engine auto becomes
                              # complex)
    store_cr: bool = True     # materialize per-iteration signal CRs
    resume: bool = False      # resume from checkpoint.npz if present
    checkpoint_Niter: int = 0  # 0 = checkpoint every write_Niter
    jitter: float = 0.0       # diagonal jitter of the real engine's solve
    engine: str = "auto"      # auto (= megachain) | megachain (K iterations
                              # a chunk, a CUDA graph on the card) | mega
                              # (one fused step an iteration) | real (the
                              # unpadded engine); runner.route_engine sends
                              # MAP, dense Ninv, wide priors, long nights
                              # and many flag patterns where they run;
                              # complex (complex128, the correctness tier)
    solver: str = "auto"      # real engine: auto | chol | pallas | pallas2
                              # | pallas2f | recinv | identity (profiling)
    warm_ns: int = 3          # megachain: Newton-Schulz inverse-refresh steps
    drift_max: float = 0.6    # megachain: max rel. ps move for warm start
    profile_dir: Optional[str] = None  # a torch.profiler trace (CPU and
                              # CUDA) of one steady-state sampling chunk,
                              # as a Chrome trace in this directory

    @classmethod
    def from_yaml(cls, path, **overrides):
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, base_dir=Path(path).parent, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, base_dir=None, **overrides):
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        merged = {**raw,
                  **{k: v for k, v in overrides.items() if v is not None}}
        cfg = cls(**merged)
        if base_dir is not None:
            # The reference resolves config-relative paths from the run's
            # working directory (test_data/README.md runs from within
            # test_data/); they are resolved relative to the config file,
            # which is stricter.
            for attr in ("sigcov0", "fgmodes", "flags", "noise", "noise_cov",
                         "nsamples"):
                v = getattr(cfg, attr)
                if v and not Path(v).is_absolute():
                    setattr(cfg, attr, str(Path(base_dir) / v))
            cfg.file_paths = [
                str(p if Path(p).is_absolute() else Path(base_dir) / p)
                for p in cfg.file_paths
            ]
            if not Path(cfg.out_dir).is_absolute():
                cfg.out_dir = str(Path(base_dir) / cfg.out_dir)
        return cfg

    def to_dict(self):
        return {f.name: getattr(self, f.name) for f in fields(self)}


def check_load_path(fp):
    """File-or-directory resolution (reference run-hydra-pspec.py:248-266):
    ``(is_dir, data)``, the data loaded when ``fp`` is a file."""
    fp = Path(fp)
    if fp.is_dir():
        return True, None
    return False, np.load(fp)


def resolve_per_baseline(path, per_file, bl_str, default_name=None):
    """A per-baseline auxiliary input: ``path`` is a single file (shared by
    all baselines) or a directory holding ``<ant1>-<ant2>/<per_file>``
    (the reference's convention, run-hydra-pspec.py:379-391).

    Compatibility fallback: when ``path`` names a file that does not exist
    but ``<parent>/<bl_str>/<filename>`` does, that per-baseline file is
    used -- the reference's bundled test_data/config.yaml points at
    ``./noise.npy`` and the like while the files live in ``0-1/``."""
    if path is None:
        return None
    p = Path(path)
    if not p.exists():
        alt = p.parent / bl_str / p.name
        if alt.exists():
            return np.load(alt)
    is_dir, data = check_load_path(p)
    if not is_dir:
        return data
    name = per_file or default_name
    if name is None:
        raise ValueError(f"Need a filename for per-baseline directory {path}")
    return np.load(p / bl_str / name)
