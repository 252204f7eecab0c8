"""Sample output files, collision guards, and checkpoint/resume.

Port of hydra_pspec_tpu/utils/io.py (numpy only). Output filenames match
the reference exactly (hydra_pspec/utils.py:307-312)
so its validation plotter (test_data/plot-test-data-results.py) works
unmodified on our results. Checkpoint/resume is new capability: the
reference writes incremental samples but cannot restart a chain
(SURVEY.md §5.4)."""
import json
import os
import shutil
from datetime import datetime
from pathlib import Path

import numpy as np

SAMPLE_FILENAMES = {
    "signal_cr": "gcr-eor.npy",
    "signal_S": "cov-eor.npy",
    "signal_ps": "dps-eor.npy",
    "fg_amps": "fg-amps.npy",
    "chisq": "chisq.npy",
    "ln_post": "ln-post.npy",
}


def write_numpy_files(fp, signal_cr, signal_S, signal_ps, fg_amps, chisq,
                      ln_post, writer=None):
    """Write the six sample arrays with the reference's fixed filenames
    (hydra_pspec/utils.py:272-313). ``writer``: optional
    :class:`utils.fastio.AsyncNpyWriter` -- the writes are queued on its
    native thread pool (the caller drains it with ``writer.wait()`` before
    recording a checkpoint); None writes synchronously with np.save."""
    fp = Path(fp)
    fp.mkdir(parents=True, exist_ok=True)
    save = writer.save if writer is not None else np.save
    save(fp / SAMPLE_FILENAMES["signal_cr"], np.asarray(signal_cr))
    save(fp / SAMPLE_FILENAMES["signal_S"], np.asarray(signal_S))
    save(fp / SAMPLE_FILENAMES["signal_ps"], np.asarray(signal_ps))
    save(fp / SAMPLE_FILENAMES["fg_amps"], np.asarray(fg_amps))
    save(fp / SAMPLE_FILENAMES["chisq"], np.asarray(chisq))
    save(fp / SAMPLE_FILENAMES["ln_post"], np.asarray(ln_post))


def add_mtime_to_filepath(fp, join_char="-"):
    """Rename an existing file/dir with its mtime suffix instead of
    clobbering (reference utils.py:243-268)."""
    fp = Path(fp)
    mtime = datetime.fromtimestamp(os.path.getmtime(fp)).isoformat()
    if fp.is_file():
        fp.rename(fp.with_stem(f"{fp.stem}{join_char}{mtime}"))
    elif fp.is_dir():
        shutil.move(str(fp), str(fp.with_name(f"{fp.name}{join_char}{mtime}")))


CHECKPOINT_FILE = "checkpoint.npz"


def _ck_name(tag):
    return f"checkpoint{tag}.npz" if tag else CHECKPOINT_FILE


def save_checkpoint(out_dir, *, iteration, ps, key_data, extra=None, tag=""):
    """Persist resumable chain state: (iteration index, current bandpowers,
    PRNG key data). ``tag`` distinguishes per-process checkpoints in
    multi-host runs. The reference has checkpointing-by-overwrite but no
    resume path (SURVEY.md §5.4)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = _ck_name(tag)
    tmp = out_dir / ("tmp-" + name)  # .npz suffix kept: np.savez appends it otherwise
    np.savez(
        tmp,
        iteration=np.asarray(iteration),
        ps=np.asarray(ps),
        key_data=np.asarray(key_data),
        extra=json.dumps(extra or {}),
    )
    os.replace(tmp, out_dir / name)


def load_checkpoint(out_dir, tag=""):
    """Load chain state saved by :func:`save_checkpoint`; returns a dict or
    None when absent."""
    fp = Path(out_dir) / _ck_name(tag)
    if not fp.exists():
        return None
    with np.load(fp, allow_pickle=False) as z:
        return {
            "iteration": int(z["iteration"]),
            "ps": z["ps"],
            "key_data": z["key_data"],
            "extra": json.loads(str(z["extra"])),
        }


def load_samples(res_dir):
    """Read back a results directory into a dict keyed like
    SAMPLE_FILENAMES."""
    res_dir = Path(res_dir)
    out = {}
    for key, name in SAMPLE_FILENAMES.items():
        fp = res_dir / name
        if fp.exists():
            out[key] = np.load(fp)
    return out
