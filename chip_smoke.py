"""Smoke run of the PyTorch/CUDA port (hydra_pspec_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --rows OUT [PARENT]   # the two row passes alone
    python3 chip_smoke.py --herm OUT PARENT     # the Hermitian kernels
                                                # against a parent's
    python3 chip_smoke.py --rng OUT PARENT      # rng_fields against a
                                                # parent's
    python3 chip_smoke.py --cgemm OUT PARENT    # cgemm against a parent's

Phases, one printed line each (any failure raises; exit code non-zero):
  1. environment: torch/CUDA versions, and the card's name and power limit
     as nvidia-smi prints them, on a line of its own;
  2. build the hand-written kernels from hydra_pspec_torch/csrc with nvcc;
  3. each kernel against its plain torch version on the card, at the main
     path's shapes (B=8, n=120, t=204, m=12: the layout at the data's own
     widths, models/mega.py), with the tolerance stated;
     Philox bits against the twin; normal and Gamma moments (bandpower at
     alpha = 202 and, on its own table, 1099); rng_fields also at the
     real engine's layouts (n = 120 and 180 channels, t = 203 times),
     and its time maps at the grouped real engine's groups (the 11 flag
     patterns of rfi_windows, odd widths, and signature A's 3 groups,
     even widths), each group as a tmap launch and all groups as one
     segment launch: within 1e-5 of the twin and torch.equal to the
     kernel's own full fields gathered at the groups' times;
     draw_rhs and draw_system in keyed mode (the omegas drawn in the
     kernel) bit-identical to their stored mode fed rng_fields' fields,
     plain (t = 204), grouped (t = 80 at the port's layout, 128 at the JAX
     package's), at n = 180 (the wide band), at odd n and t (121 x 203, the
     kernels' 8-byte paths) and at the JAX package's layout (n = 128,
     t = 256), and with the iteration read from a device counter
     (as in a graph replay) bit-identical to it given by value, bandpower
     too; herm_inv (also at n = 180) and cgemm with an active mask
     (flagged chains bit-identical to the unmasked launch, the others'
     outputs untouched); herm_inv's gate mode (the warm start's drift
     gate computed in the launch) at B=100, n=120, 128, 180 (one launch)
     and blocked at n=256 against its plain version, the plain gate and the masked inverse:
     flags and rebuilt inverses torch.equal, with an unmoved row, a NaN
     row and a row whose drift is exactly drift_max; the grouped
     time-flags variants (per-row time counts, pooled bandpower) at the
     tflags path's shapes (8 chains x G=3 rows, t=80), and at the JAX
     package's layout (G=4 with a dummy row of zero operators, t=128:
     exact zeros and the exact identity there); the Hermitian
     factor-solve (herm_chol_solve) at B=8, n=120, K=203, the herm_inv
     solve entry (hermitian_solve) and the single-step entry
     (gcr_megastep) against their plain compositions; the two 32 x 32
     tile kernels herm_inv and herm_chol_solve at ragged, padded and full
     widths (n in HERM_NS, K in HERM_KS) within 1e-3 of plain, exactly
     the identity on the identity (herm_inv(I) == I, herm_chol_solve(I, b)
     == b), and an equilibrated system of condition ~1e5 under the
     residual gates, with their launches counted; the same two above 128
     (n in TRI_NS: one launch on the lower tiles, no cgemm; n in
     BLOCKED_NS: the blocked route over it), the inverse with
     max|S X - I| <= 1e-4, the factor-solve at K = 203 and 1 with
     max|A x - b| <= 2e-4, both within 3e-3 of the plain results' mean
     magnitude, the identity exactly at n = 180; cgemm at every
     product shape of the paths at the paths' batch (B = 100, or the
     grouped products' own; the tile plan depends on the batch count)
     against plain, the plan's tile named, C aliasing X, and each
     torch.equal to the same product on chain slices of 1, 7 and the
     rest and on every tile of the kernel; herm_inv at the
     wide band's system, B=8, n=180 and herm_chol_solve at B=8, n=180,
     K=203, one launch each;
     the two row passes, row_scale_sumsq and draw_resid, on random inputs
     at t in ROW_TS (1, 2, 31, 80, 203, 204, 256, 257, 1100) x n in
     ROW_NS (120, 121, 180), every variant (s1, s2 and y present and
     absent; each optional output of draw_resid present and absent, on
     ragged row_times and on ntimes alone) within 1e-5 of the largest
     plain output, one line a (kernel, n, t);
  4. chain phase: run_chunk_megachain with numpy-made randomness, K=3,
     B=8, kernels against the plain path, at the CPU pin's tolerances; the
     same for a grouped chain (8 chains x G=3);
  5. main path: runner.run_baselines, 100 baselines x 1 chain at
     203 times x 120 channels, 12 Legendre foreground modes, 7-bin prior,
     200 iterations, on data drawn from the model (chi^2 should be 1);
     the host side's split from the runner's timings (process, write,
     flush, pool wait and the pool threads' write seconds, fetch wait,
     staging copy, pinned bytes, the two graph slots' pools; the native
     writer required) and from the runner's own profile_dir trace of its
     steady-state chunk (device kernel busy seconds, DtoH bytes, seconds
     and GB/s, pinned required; host seconds by span);
  6. invariance: the first 10 baselines alone give bit-identical samples,
     and so do they with all-False time flags (the grouped path, G=1);
  graph: at B=100 a chunk of 10 iterations from global iteration 37 as a
     CUDA graph replay (ChunkGraph) against the eager kernel path, under
     torch.cuda.set_sync_debug_mode("error"), torch.equal on every output
     and the same launches, for plain full (drift_max 0.6) and lean (0.3:
     a mix of chains rebuild), the mega engine, grouped 100 chains x G=3
     and the wide band (n = 180, the masked rebuild on the lower tiles);
     a second
     replay from iteration 38 equal to the eager chunk there; warm-up,
     capture and instantiate seconds, the graph pool's bytes and the
     chains each iteration rebuilt;
  layout: the main path (100 baselines), the time-flags signatures A
     (3 flag patterns) and B (2), the mega engine and the wide band
     (180 channels), each a chunk on the Philox streams at the port's
     layout (data's own widths, G = the pattern count) and at the JAX
     package's (128-lane and 8-sublane pads, G a power of two): every
     real lane of every sample output torch.equal at the two layouts;
  7. tflags: the same data with time-dependent RFI flags (two signatures,
     3 and 2 flag patterns) and RFI of amplitude 1e4 in the flagged
     entries, through run_baselines' grouped time-flags path: chi^2 on the
     unflagged entries, every kernel launched, a subset bit-identical;
  8. fallback: the engines run_baselines routes to. A dense Ninv at full
     width (100 baselines, correlated noise C_ij = s^2 0.5^|i-j|, 200
     iterations, files and checkpoint) routes to the real engine and runs
     the factor-solve kernel: whitened chi^2 r^H Ninv r / (Ntimes Nfreqs)
     from the written samples within 2 % of 1; solver="pallas2" (10
     baselines x 50) launches herm_inv on the real path; MAP mode (10
     baselines) routes to real and agrees with the CPU run at 3e-3; 20
     baselines with 11 flag patterns (10 RFI windows) run the grouped real
     path: chi^2 on unflagged entries within 2 %, 5 baselines alone
     bit-identical, all-False flags bit-identical to the plain real run;
     the mega engine with a 21-bin prior (100 baselines x 100) and with
     1100 times (10 x 50): chi^2 within 2 %; with 7 bins mega is
     bit-identical to megachain without the warm start;
  cli: the production entry point after the load, cli.run.run_jobs, on
     the main path's 100 jobs with a RunConfig made from flags (200
     iterations in chunks of 50, so each graph slot replays twice,
     store_cr, the main seed, profile_dir): git.json, args.json,
     timings.json and resources.json with the JAX CLI's keys, the native
     writer, pinned copies in the trace, chi^2 within 2 %, every main
     kernel launched, the checkpoint at 200; every baseline's six files
     bit-identical to the same chunks run eagerly with synchronous copies
     (run_baselines overlap=False) and to a run stopped at 100 and
     resumed; as information, whether chunks of 100 give the same files;
  wideband: the same model-drawn data at 203 times x 180 channels (HERA
     Phase I sub-bands), where herm_inv and herm_chol_solve run one launch
     each on the lower tiles, from S_initial = I as everywhere, 400 iterations with the gates
     over the last 200 (the noise-dominated delay bins burn in slowly):
     megachain at n = 180, 100 baselines with files and checkpoint (chi^2
     within 2 % and by 50-iteration window, every main kernel launched,
     the first 10 baselines alone bit-identical); a dense Ninv on the
     real engine, 20 baselines (whitened chi^2 within 2 %, two
     factor-solve calls a solve); solver="pallas2", 10 x 50; the mega
     engine with 21 prior bins, 20 baselines (chi^2 within 2 %, two
     herm_inv launches an iteration);
  oracle: the posterior oracle gate (hydra_pspec_torch/validation/
     validate.py) against the committed synthetic oracle
     (validation/oracle_posterior_synth.json, 4 x 25000 chains of the
     NumPy reference sampler): 16 chains (stream ids 0-15 of one
     baseline of the main path's data, from ps_truth) of megachain
     (production warm start, chunk graphs, lean), megachain with the
     channels 12,30-33,77-79,100 flagged (chi_mask), mega and real
     (solver pallas), 12000 iterations each, burn 2000: chi^2 within 2 %,
     split-R-hat max <= 1.1, max_z < 4.5, at most 5 bins with z > 3, CI
     cover >= 0.95; max_z, n_z_gt3, CI cover, min ESS, R-hat, chi^2 and
     wall printed; every kernel of each engine launched;
  complex: precision x64 through cli.run.run_jobs, the complex float64
     engine (complex128, Cholesky solves, a chunk a CUDA graph, no
     hand-written kernel): its float64 Philox words equal the CPU twin's,
     8 main jobs x 2 chains x 200 iterations in chunks of 50 with files
     and checkpoint (complex128 samples, chi^2 within 2 %, the first 2
     baselines alone and a run stopped at 100 and resumed bit-identical),
     4 jobs of the tflags signature A on the complex time-flags path
     (chi^2 on unflagged entries within 2 %), then the oracle gate on 16
     complex chains x 12000 (burn 500);
  multiproc: two processes sharing the card over gloo (python3
     chip_smoke.py --multiproc RANK SPEC OUT, started by this one), each
     through cli.run.run_jobs on its block of 21 main jobs x 2 chains x
     100 iterations (11 + 10 by the block rule, chunks of 50): every
     sample file bit-identical to one process on the same jobs,
     timings.json over 2 ranks, rhat.json, checkpoint-p0/p1; a two-process
     run stopped at 50 and resumed; the time-flags path with the tflags
     signatures A and B, A split across the ranks; every main kernel
     launched on each rank; the sampling-only rates per rank, their sum
     and one process's, that one a fresh worker process as each rank is
     (descriptive: two processes share one card); then
     run_baselines(mesh_devices=[cuda:0, cuda:0]) bit-identical to one
     device on megachain, mega and real (20 baselines x 200, kernels
     launched), and with time flags on grouped megachain (signatures A
     and B, 10 baselines each, A split across the devices) and on the
     grouped real engine (11 flag patterns, 20 baselines x 100), with
     the rates of one and two devices (descriptive: both are cuda:0),
     entry.dryrun_multichip(2), and one call of entry.entry()'s
     real-engine step at 203 x 120 (finite, on the card, kernels
     launched);
  estimators: LSSA, OQE and DPSS (models/lssa.py, oqe.py, dpss.py) on
     the card against the same call on the CPU at 120 channels within
     1e-10 relative, and the time of one call;
  scripts: hydra_pspec_torch/scripts on the card: simple_example
     (gibbs_sample_with_fg, one synthetic baseline at 203 x 120, 100
     iterations: finite, chi^2 within 2 %, the recovered EoR power within
     a factor 2 of the truth) and the scaling harness (scaling_test:
     8 baselines x 100 iterations through cli.run.run_jobs at one and
     two processes on the card and at two devices in one process, cuda:0
     twice): every point's sample files bit-identical to one process;
  9. times, in a process of its own (python3 chip_smoke.py --times OUT,
     started by this one: a profiler session earlier in a process and the
     large runs after it make later windows lose device activities): one
     chain iteration and each kernel at B=100, one grouped
     chain iteration and the grouped kernels at 100 chains x G=3, one real
     iteration (dense noise, pallas and pallas2) and one mega iteration at
     B=100 (megachain, grouped, mega and the wide band each eagerly and as
     a graph replay of a 5-iteration chunk, in turns), the masked herm_inv
     launch with no chain active (n = 120) and
     herm_inv's gate mode with no chain and with every chain rebuilding,
     the factor-solve at B=100, n=120, K=203 and K=1 (the factor
     and one tile, with its own bound), kernels against the
     plain versions (CUDA events), with each kernel's bound and the
     iteration bounds (each cgemm launch priced at its own shape); cgemm,
     its plain version and one PyTorch call at every product shape of the
     paths, each beside its bound; torch.profiler over 5 plain iterations
     at B=100 on the eager path and over 3 graph replays of 5 (each
     kernel's device time per iteration, the device's busy share, the
     longest idle gaps); the wide band: herm_inv (n = 180) and
     herm_chol_solve (n = 180, K = 203 and 1) against their plain
     versions, library calls and the parent's route (the blocked
     compositions over launches of at most 128, parent_route), in turns;
     the masked herm_inv with no chain rebuilding (device time, both
     routes); the megachain iteration eagerly and as a graph replay, the
     mega iteration as a graph replay and the dense real iteration, each
     on both routes in turns (parent, this, this, parent);
     device times (profiler) of bandpower (alpha 202 and 1099, and 100
     chains x G=3) and of the omega passes in two layouts (stored
     rng_fields fields; keyed draw_rhs and draw_system) beside their
     bounds, and of rng_fields at the real engine's shape (n = 120,
     t = 203) beside its SASS issue floor; one iteration of the grouped
     real engine (20 baselines, 11 flag patterns) eagerly, kernels and
     plain, with its hand-written launches and all its device activities
     (every kernel, copy and fill) an iteration; the wide mega and wide
     dense real iterations' bounds (each launch's work summed) and plain
     times; the main, grouped-A and wide iterations as graph replays at
     the port's layout and at the JAX package's, in turns (port, JAX, JAX,
     port), and the keyed passes' device times at both layouts; the keyed
     passes' and rng_fields' SASS instructions a drawn lane (cuobjdump
     -sass of the built library, where the toolkit has it), which bound
     them; the two row
     passes' device times (in a third process, python3 chip_smoke.py
     --rows OUT) at each path's shape (main B=100, t=204; grouped
     100 x G=3, t=80; real 20 x t=203 and the grouped real engine's groups
     of 15 and 53 times; each variant as its path launches it) beside
     their bounds, torch.linalg.vector_norm beside the unscaled sums, and
     the replaced kernels' times (PARENT_ROW_MS; --rows OUT PARENT times a
     parent checkout's kernels in turns, parent, this, this, parent, and
     holds this tree's outputs torch.equal to them at every case and at
     every variant of phase 3's widths). Every bound counts the data's
     own widths: n = nfreqs, m = nmodes, and each row's true times.
--rng OUT PARENT (not part of the full run) builds this tree's kernels
and a parent checkout's and holds rng_fields torch.equal to the parent's
at B = 100, t = 203, n = 120 and 180, at the main layout's pad lane and
with row_times, and each time group's segment torch.equal to the parent's
full fields gathered at its times (11 patterns at B = 20 and 100, and
signature A's 3 groups); then times both kernels (device time and
events), the segment launch against the parent's full fields and
gathers, and the grouped real and dense real iterations with the
parent's omegas, in turns (parent, this, this, parent).
--cgemm OUT PARENT (not part of the full run) builds both trees' kernels
and holds cgemm torch.equal to the parent's at every CGEMM_SHAPES product
and at B = 1, 8, 100 (and the grouped products' own 300 or 20), with and
without an active mask, on every tile the kernel has and on chain slices;
then times each product in turns (parent, this, this, parent: CUDA
events and profiler device time) beside torch.matmul / torch.baddbmm and
every tile's device time, reads the SM clock under load, and times the
main, grouped and wide megachain iterations as graph replays on both
libraries (their outputs torch.equal).
The megachain and mega paths draw their omegas in draw_rhs and draw_system
and must launch no rng_fields; the real paths launch it. Through
run_baselines those two engines run each chunk as a CUDA graph; the launch
counts then add, for each replay, the launches recorded in its capture.
The line before the last is a JSON object with every kernel's launches,
error, times and bound, the cgemm shapes, the profiler window and the
wideband runs; the last line is the device JSON object.
"""
import collections
import dataclasses
import filecmp
import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# one copy of the data generator: the synthetic problem of the port's checks
# (SEED, the reference shape NT x NF with NM Legendre modes, the 7-bin prior)
from hydra_pspec_torch.validation.synth import (  # noqa: E402
    NF, NM, NT, PRIOR_HALF, SEED, make_jobs, make_prior, ps_truth)

N_BASELINES, NITER, WRITE_NITER = 100, 200, 100
# the environment this process started with, for the multiproc phase's
# ranks: validation/oracle.py, imported by the oracle phase, sets the BLAS
# thread count in os.environ for its own pool (after this process's BLAS
# has loaded), and the host's float64 products (cov-eor.npy) round by it
ENV0 = dict(os.environ)
CHI2_GATE = 0.02              # README.md:43-48
N_SIG_A, N_SUBSET = 90, 10    # tflags: baselines of signature A; subset
RFI = 1.0e4                   # added to every flagged entry of d
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12   # H100 SXM data sheet
# operations of one Philox4x32-10 call (10 rounds of two 32x32 -> 64-bit
# products, xors and key additions) and of one Box-Muller pair with its
# scale (log, sqrt, cos, sin, conversions, products): the floor that
# rng_fields is bounded by, and the keyed passes where the toolkit has no
# cuobjdump (:func:`sass_draw_slots` counts theirs in the compiled code)
PHILOX_OPS, BOX_MULLER_OPS = 110, 10
# issue slots a lane of each SASS instruction class takes against one
# FP32 FMA (a warp instruction per scheduler per clock, 128 lanes an SM):
# the 32 x 32 -> 64-bit integer products at half that rate, the special
# function unit (16 lanes an SM a clock) at an eighth
SLOT_WEIGHT = {"IMAD.WIDE": 2, "IMAD.HI": 2, "MUFU": 8}
# the keyed passes' draw: issue slots a drawn lane, set by sass_draw_slots
# in the times process (None: not counted, PHILOX_OPS + BOX_MULLER_OPS);
# rng_fields' entry is its issue floor, never its bound
DRAW_SLOTS = {}

N_MAP, N_PALLAS2, PALLAS2_NITER = 10, 10, 50
N_TF_REAL, N_TF_SUB, TF_REAL_NITER = 20, 5, 100
MEGA_HALF, MEGA_NITER = 10, 100   # 21 bounded prior bins
LONG_NT, N_LONG, LONG_NITER = 1100, 10, 50
N_MEGA_EQ, MEGA_EQ_NITER = 10, 20
# the wide band: HERA Phase I sub-bands of ~15-18 MHz at 97.66 kHz (HERA
# Collaboration 2022, ApJ 925, 221); megachain runs at n = 180 (the JAX
# package's layout pads it to 256)
WIDE_NF = 180
# from S_initial = I the noise-dominated delay bins of 180 channels burn in
# slowly: chi^2 climbs to its equilibrium over ~400 iterations, so the wide
# chains run twice as long and their gates read the second half
WIDE_NITER, WIDE_WRITE_NITER, WIDE_BURN = 400, 200, 200
N_WIDE_DENSE, N_WIDE_MEGA = 20, 20
N_WIDE_PALLAS2, WIDE_PALLAS2_NITER = 10, 50
PROFILE_ITERS = 5             # the profiler window: plain iterations at B=100
# the oracle phase: 16 chains of one baseline against the synthetic oracle
# (the JAX package's validate_posterior.json entries used 16 x 12000); the
# real engine at the same size: at 16 x 3000 its split-R-hat fails for a
# correct sampler (the slowest bins' autocorrelation, ROADMAP.md Queue 3)
ORACLE_NCHAINS, ORACLE_NITER, ORACLE_NBURN = 16, 12000, 2000
ORACLE_REAL_NITER = 12000
# the complex phase: precision x64 on 8 main jobs x 2 chains, 4 chunks, the
# resume split at 100; 4 jobs of the tflags signature A; its oracle gate
N_COMPLEX, COMPLEX_NCHAINS, N_COMPLEX_TF = 8, 2, 4
COMPLEX_NITER, COMPLEX_WRITE_NITER, COMPLEX_RESUME_AT = 200, 50, 100
COMPLEX_ORACLE_NITER, COMPLEX_ORACLE_NBURN = 12000, 500
# the cli phase: the main phase's jobs through cli.run.run_jobs, 4 chunks
# (each of the two graph slots replayed twice), the resume split at 100
CLI_NITER, CLI_WRITE_NITER, CLI_RESUME_AT = 200, 50, 100
# the multiproc phase: N_MP main jobs (an odd count: 11 + 10 by the block
# rule) x MP_NCHAINS chains over two processes sharing the card, chunks of
# MP_WRITE_NITER, the resume split at MP_RESUME_AT; signature A on the
# first N_MP_SIG_A of the time-flags run (split across the ranks); the
# in-process shards on N_SHARD baselines x SHARD_NITER
N_MP, MP_NCHAINS, MP_NITER, MP_WRITE_NITER, MP_RESUME_AT = 21, 2, 100, 50, 50
N_MP_SIG_A, MP_TIMEOUT_S = 12, 600
N_SHARD, SHARD_NITER = 20, 200
# the estimators phase: card against CPU (complex128 / float64), the calls
# timed after one
EST_RTOL, EST_REPS = 1e-10, 5
# the runner's profiler spans of the host side (runner.py)
HOST_SPANS = ("hydra:chunk", "hydra:fetch_wait", "hydra:staging",
              "hydra:flush", "hydra:pool_wait")
# the tile kernels' widths: one ragged tile, one full, ragged second,
# third and fourth tiles, the real engine's 120, the pad of one, full 128;
# right-hand sides: one, one over a tile, the reference's time count
HERM_NS, HERM_KS = (1, 17, 32, 52, 96, 120, 127, 128), (1, 33, 203)
ILL_COND = 1.0e5              # condition of the ill-conditioned case
# above 128: one launch on the lower tiles up to 192 (one over a tile
# boundary, a ragged fifth and sixth tile, the wide band's 180, full 192),
# the blocked route over it above (192 + 64, 192 + 108)
TRI_NS, BLOCKED_NS = (129, 140, 160, 180, 192), (256, 300)

# kernel name -> (source, the TPU code it replaces)
KERNELS = {
    "cgemm": ("hydra_pspec_torch/csrc/cgemm.cu",
              "hydra_pspec_tpu/ops/pallas/megastep.py:41"),
    "herm_inv": ("hydra_pspec_torch/csrc/herm_inv.cu",
                 "hydra_pspec_tpu/ops/pallas/spd_inv.py:57"),
    "draw_rhs": ("hydra_pspec_torch/csrc/draw_fused.cu",
                 "hydra_pspec_tpu/ops/pallas/megastep.py:139"),
    "draw_system": ("hydra_pspec_torch/csrc/draw_fused.cu",
                    "hydra_pspec_tpu/ops/pallas/megastep.py:153"),
    "row_scale_sumsq": ("hydra_pspec_torch/csrc/draw_fused.cu",
                        "hydra_pspec_tpu/ops/pallas/megastep.py:199"),
    "draw_resid": ("hydra_pspec_torch/csrc/draw_fused.cu",
                   "hydra_pspec_tpu/ops/pallas/megastep.py:221"),
    "rng_fields": ("hydra_pspec_torch/csrc/rng_bandpower.cu",
                   "hydra_pspec_tpu/ops/pallas/megachain.py:238"),
    "bandpower": ("hydra_pspec_torch/csrc/rng_bandpower.cu",
                  "hydra_pspec_tpu/ops/pallas/megachain.py:102"),
    "herm_chol_solve": ("hydra_pspec_torch/csrc/herm_chol_solve.cu",
                        "hydra_pspec_tpu/ops/pallas/spd_solve.py:228"),
    "hermitian_solve": ("hydra_pspec_torch/ops/kernels/herm_inv.py",
                        "hydra_pspec_tpu/ops/pallas/spd_inv.py:149"),
    "gcr_megastep": ("hydra_pspec_torch/ops/kernels/megastep.py",
                     "hydra_pspec_tpu/ops/pallas/megastep.py:388"),
}
# the kernels each path must launch
MAIN_KERNELS = ("cgemm", "herm_inv", "draw_rhs", "draw_system",
                "row_scale_sumsq", "draw_resid", "bandpower")
REAL_KERNELS = ("cgemm", "herm_chol_solve", "row_scale_sumsq", "rng_fields",
                "bandpower")
PALLAS2_KERNELS = ("cgemm", "herm_inv", "hermitian_solve", "row_scale_sumsq",
                   "rng_fields", "bandpower")
# the mega engine: the exact inverse every iteration, no warm start
MEGA_KERNELS = MAIN_KERNELS + ("gcr_megastep",)
ENTRIES = ("hermitian_solve", "gcr_megastep")   # composed from kernels
# where each kernel's "launches" of the kernels JSON line are read
HOME_PATH = dict({k: "main" for k in MAIN_KERNELS},
                 herm_chol_solve="dense", hermitian_solve="pallas2",
                 gcr_megastep="mega", rng_fields="dense")
# the megachain and mega engines draw their omegas inside draw_rhs and
# draw_system (keyed mode); only the real engine launches rng_fields
NOT_ON_KEYED_PATHS = ("rng_fields",)

# every cgemm product of the paths, per chain: (what, M, K, N, op, A shared,
# X[, batch]) with X None, "x" (its own tensor) or "out" (C aliases X), at
# the port's layout (n = 120, t = 204, m = 12), and the batch of the
# grouped paths' products (cgemm_batch). The plain megachain iteration
# (ops/kernels/megastep.py:58-75, megachain.py:112-113, herm_inv.py
# apply_refine), F rc at t = 203 (is the even t worth its pad lane?) and
# at the JAX package's layout (n = 128, t = 256), the real engine (n =
# 120, t = 203), the wide band (n = 180), the blocked inverse and
# factor-solve at n = 256 (blocks of 192 and 64: the wide band at the JAX
# package's layout, phase layout), the grouped megachain's rows (100
# chains x G = 3, t = 80) and the grouped real engine's groups of 15 and
# 53 times (20 baselines)
CGEMM_SHAPES = (
    ("ba = Fg^H rc", 12, 120, 204, "H", False, None),
    ("rc -= G ba", 120, 12, 204, "N", False, "out"),
    ("frc = F rc", 120, 120, 204, "N", True, None),
    ("frc = F rc, t = 203", 120, 120, 203, "N", True, None),
    ("frc = F rc, JAX layout", 128, 128, 256, "N", True, None),
    ("NS ex = S inv", 120, 120, 120, "N", False, None),
    ("NS 2 inv - inv ex", 120, 120, 120, "N", False, "x"),
    ("x = inv xs", 120, 120, 204, "N", False, None),
    ("r = xs - S x", 120, 120, 204, "N", False, "x"),
    ("x += inv r", 120, 120, 204, "N", False, "out"),
    ("sig = F^H sk / n", 120, 120, 204, "H", True, None),
    ("ma = mi ba", 12, 12, 204, "N", False, None),
    ("da = G^H sig - ma", 12, 120, 204, "H", False, "out"),
    ("fa = Fg da", 120, 12, 204, "N", False, None),
    ("real F rc", 120, 120, 203, "N", True, None),
    ("real b_a = Fg^H rc", 12, 120, 203, "H", False, None),
    ("real rc - G b_a", 120, 12, 203, "N", False, "x"),
    ("real sig = F^H sk", 120, 120, 203, "H", True, None),
    ("wide F rc (n=180)", 180, 180, 204, "N", True, None),
    ("wide NS (n=180)", 180, 180, 180, "N", False, None),
    ("blocked T = A11^-1 A12", 192, 192, 64, "N", False, None),
    ("blocked S = A22 - A12^H T", 64, 192, 64, "H", False, "x"),
    ("blocked TS = T S^-1", 192, 64, 64, "N", False, None),
    ("blocked A11^-1 + TS T^H", 192, 64, 192, "N", False, "out"),
    ("blocked b2 - A12^H Y", 64, 192, 203, "H", False, "x"),
    ("grouped F rc (t=80)", 120, 120, 80, "N", True, None, 300),
    ("grouped x = inv xs (t=80)", 120, 120, 80, "N", False, None, 300),
    ("grouped F^H sk (t=80)", 120, 120, 80, "H", True, None, 300),
    ("grouped real F rc (t=15)", 120, 120, 15, "N", True, None, 20),
    ("grouped real F rc (t=53)", 120, 120, 53, "N", True, None, 20),
)
# the --cgemm mode's batches, and the chain slices (1, 7 and the rest) that
# the kernel phase holds each product at B = 100 to
CGEMM_BATCHES = (1, 8, 100)
CGEMM_SLICES = (1, 7)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def mark(phases, t0):
    """The seconds since ``t0`` at the end of ``phases``."""
    say("time", f"{phases} done at {time.perf_counter() - t0:.1f} s")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


# --- 1. environment ----------------------------------------------------------

def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}; "
        f"card and power limit on the next line")
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# --- synthetic data from the model: hydra_pspec_torch/validation/synth.py ---

def build_ops(jobs, device, layout="port"):
    from hydra_pspec_torch.models import mega, rgibbs

    ops = rgibbs.stack_chain_operators(
        [rgibbs.build_chain_operators(j.d, j.w, j.fgmodes, j.Ninv)
         for j in jobs])
    return mega.from_chain_operators(ops, device, layout=layout)


def real_system(jobs, device):
    """The real engine's operators of ``jobs`` on ``device``, its GCR
    system S = I + D P~ D at ps = truth (B, nf, nf), and the bins of the
    7-bin prior."""
    from hydra_pspec_torch.models import rgibbs
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    nf = jobs[0].d.shape[1]
    rops = rgibbs.to_device(rgibbs.stack_chain_operators(
        [rgibbs.build_chain_operators(j.d, j.w, j.fgmodes, j.Ninv)
         for j in jobs]), device)
    ps = torch.as_tensor(np.tile(ps_truth(nf), (len(jobs), 1)),
                         dtype=torch.float32).to(device)
    dd = torch.sqrt(ps / nf)
    eye = torch.eye(nf, dtype=torch.complex64, device=device)
    s_u = ((dd[:, :, None] * dd[:, None, :]) * rops.p_tilde + eye)
    bins = rb.prior_bins(rb.bounded_bins(make_prior(nf=nf)), device)
    return rops, ps, s_u.contiguous(), bins


def rfi_windows():
    """10 RFI windows on 10 channels, disjoint in time: channel 15 + 9k
    over times 18k + 5 .. 18k + 19, k = 0..9; with the unflagged rows, 11
    flag patterns (more than the megachain engine's 8)."""
    f = np.zeros((NT, NF), dtype=bool)
    for k in range(10):
        f[18 * k + 5: 18 * k + 20, 15 + 9 * k] = True
    return f


def tflag_signatures():
    """Signature A: channels 40-43 flagged over times 60-139 (a satellite
    pass) and channel 90 over times 150-202: 3 patterns (G = 3; 4 at the
    JAX package's layout), and the
    unflagged group (times 0-59 and 140-149) is not contiguous. Signature
    B: channel 17 over times 100-202: 2 patterns, G = 2."""
    a = np.zeros((NT, NF), dtype=bool)
    a[60:140, 40:44] = True
    a[150:, 90] = True
    b = np.zeros((NT, NF), dtype=bool)
    b[100:, 17] = True
    return a, b


def make_tflags_jobs(jobs, n_sig_a):
    """The jobs with flags: signature A on the first ``n_sig_a``, B on the
    rest, and RFI added to every flagged entry of ``d``."""
    a, b = tflag_signatures()
    out = []
    for i, j in enumerate(jobs):
        f = a if i < n_sig_a else b
        out.append(dataclasses.replace(j, d=j.d + RFI * f, flags_tf=f))
    return out


def grouped_setup(jobs, flags, nchains_each, device, layout="port"):
    """The grouped layout of ``jobs`` (one chain each, or one job's
    operators repeated ``nchains_each`` times) under ``flags``, at
    ``layout``."""
    from hydra_pspec_torch.models import megachain, rgibbs, tflags

    per = [tflags.build_grouped_operators_real(j.d, flags, j.fgmodes, j.Ninv)
           for j in jobs]
    groups = [tflags.TimeGroupReal(
                  ops=rgibbs.stack_chain_operators(
                      [p[g].ops for p in per for _ in range(nchains_each)]),
                  idx=per[0][g].idx)
              for g in range(len(per[0]))]
    return megachain.build_tflags_mega_setup(groups, device, layout)


def grouped_ids(setup, nchains, device):
    """(row_times, row stream ids, chain id of each row) on ``device``."""
    from hydra_pspec_torch.ops import philox

    G = len(setup.group_times)
    rows, chains = philox.grouped_stream_ids(np.arange(nchains), G)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (as_t(np.tile(np.asarray(setup.group_times, np.int32), nchains)),
            as_t(rows), as_t(chains))


def numpy_randomness(rng, K, B, n, t, nfreqs, ntimes, group=1):
    """External randomness in the JAX layout (per-chain Gamma and
    uniforms repeated over a chain's rows when ``group`` > 1)."""
    from hydra_pspec_torch.models import megachain

    sa = np.float32(np.sqrt(0.5) * np.sqrt(nfreqs))
    hf = np.float32(np.sqrt(0.5))
    f32 = lambda x: x.astype(np.float32)
    rows = {"oa_re": f32(rng.standard_normal((K, B, n, t))) * sa,
            "oa_im": f32(rng.standard_normal((K, B, n, t))) * sa,
            "ob_re": f32(rng.standard_normal((K, B, n, t))) * hf,
            "ob_im": f32(rng.standard_normal((K, B, n, t))) * hf}
    return megachain.grouped_randomness(
        rows, f32(rng.gamma(ntimes - 1, size=(K, B // group, n))),
        f32(rng.uniform(size=(K, B // group, 128))), group)


# --- 3. kernels against their plain versions --------------------------------

def long_tables(dev):
    """The table rows (tlog, q) at alpha + 1 = LONG_NT on ``dev``."""
    from hydra_pspec_torch.ops import invgamma

    tab = invgamma.make_invgamma_table(LONG_NT)
    return tuple(torch.from_numpy(np.array(v, np.float32)).to(dev)
                 for v in (tab.log_y, tab.q))


def cgemm_batch(shape, B):
    """The batch of a :data:`CGEMM_SHAPES` product: its own (the grouped
    paths'), else ``B``."""
    return shape[7] if len(shape) > 7 else B


def cgemm_operands(shape, B, dev, gen):
    """Random operands (a, b, x, alpha, beta) of one :data:`CGEMM_SHAPES`
    product at batch ``B``."""
    _, M, K, N, op, shared, xmode = shape[:7]
    rn = lambda *s: torch.randn(s, dtype=torch.complex64, device=dev,
                                generator=gen)
    dims = (M, K) if op == "N" else (K, M)
    a = rn(*dims) if shared else rn(B, *dims)
    x = rn(B, M, N) if xmode else None
    return a, rn(B, K, N), x, (-1.0 if xmode else 0.5), 1.0


def cgemm_on_slices(mm, shape, a, b, x, alpha, beta, cuts=CGEMM_SLICES):
    """The product of :func:`cgemm_operands` run on consecutive chain
    slices of ``cuts`` chains and the rest (as far as the batch reaches),
    concatenated (X as its own tensor)."""
    op, shared = shape[4], shape[5]
    B = b.shape[0]
    edges = sorted({0, B, *(min(e, B) for e in np.cumsum(cuts).tolist())})
    return torch.cat([
        mm(a if shared else a[lo:hi], b[lo:hi], op=op,
           x=None if x is None else x[lo:hi], alpha=alpha, beta=beta)
        for lo, hi in zip(edges[:-1], edges[1:])])


def cgemm_plan(B, M, N, K):
    """The name of the tile that cgemm's plan takes for ``B`` (M, K) x
    (K, N) products on the current card."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import cgemm as cg

    return cg.TILES[_build.library().hk_cgemm_plan(B, M, N, K)]


def cgemm_on_tile(tile, a, b, op="N", x=None, alpha=1.0, beta=1.0,
                  out=None, active=None):
    """cgemm's product on the kernel's tile ``tile`` (an index of
    ``cgemm.TILES``) in place of the plan's, through the C entry
    ``hk_cgemm_tile``: the same bits whatever the tile. Operands as
    :func:`cgemm_operands` makes them."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import cgemm as cg

    B, K, N = b.shape
    M = a.shape[-2] if op == "N" else a.shape[-1]
    if out is None:
        out = torch.empty((B, M, N), dtype=torch.complex64, device=b.device)
    _build.call("cgemm", "hk_cgemm_tile", _build.ptr(a), _build.ptr(b),
                _build.ptr(x), _build.ptr(out), B, M, N, K, cg.OPS[op],
                int(a.dim() == 3), float(alpha), float(beta),
                _build.ptr(active), tile)
    return out


def cgemm_bound(B, M, K, N, shared, with_x):
    """(ms, "bytes" or "operations") of one product: A, B (and X) read
    once, C written once; 8 real flops per complex multiply-add."""
    nbytes = 8 * (M * K * (1 if shared else B) + B * K * N
                  + B * M * N * (2 if with_x else 1))
    tb, to = nbytes / HBM_BYTES_S * 1e3, 8 * B * M * N * K / FP32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def equilibrated_spd(B, n, dev, gen, cond=None):
    """B Jacobi-equilibrated Hermitian positive-definite matrices
    (complex64, unit diagonal), made in complex128 on the card: a Wishart
    draw plus 0.05 I, or with ``cond`` Q diag(logspace(0, -log10 cond))
    Q^H for a random unitary Q (condition about ``cond`` after the
    equilibration)."""
    g = torch.randn((B, n, 2 * n), dtype=torch.complex128, generator=gen,
                    device=dev)
    if cond is None:
        a = g @ g.mH / (2 * n) + 0.05 * torch.eye(n, device=dev)
    else:
        q, _ = torch.linalg.qr(g[:, :, :n])
        a = (q * torch.logspace(0, -math.log10(cond), n, dtype=torch.float64,
                                device=dev)) @ q.mH
    d = 1 / torch.sqrt(torch.diagonal(a, dim1=-2, dim2=-1).real)
    return (a * d[..., :, None] * d[..., None, :]).to(
        torch.complex64).contiguous()


def check_herm_tiles(dev, cmp):
    """herm_inv and herm_chol_solve at every width of HERM_NS (and K of
    HERM_KS) against their plain versions at 1e-3, exact on the identity;
    an equilibrated system of condition ILL_COND under the residual gates
    (max|A A^-1 - I| <= 1e-3; max|A x - b| <= 1e-4 max(|A||x| + |b|));
    the launch counts of these checks printed and required."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I

    K, P = I.KERNELS, I.PLAIN
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    _build.reset_launches()
    for n in HERM_NS:
        a = equilibrated_spd(8, n, dev, gen)
        eye = torch.eye(n, dtype=a.dtype, device=dev).expand(8, n, n)
        eye = eye.contiguous()
        cmp("herm_inv", K.herm_inv(a), P.herm_inv(a), 1e-3, f"n={n}")
        require(torch.equal(K.herm_inv(eye), eye),
                f"herm_inv(I) is not exactly I at n={n}")
        for k in HERM_KS:
            b = torch.randn((8, n, k), dtype=torch.complex64, generator=gen,
                            device=dev)
            cmp("herm_chol_solve", K.herm_chol_solve(a, b),
                P.herm_chol_solve(a, b), 1e-3, f"n={n} K={k}")
            require(torch.equal(K.herm_chol_solve(eye, b), b),
                    f"herm_chol_solve(I, b) is not exactly b at n={n} K={k}")
    sync(dev)
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    say("kernels", f"herm tiles: n in {HERM_NS}, K in {HERM_KS}: "
        f"herm_inv(I) == I and herm_chol_solve(I, b) == b exactly; "
        f"launches {got}")
    require(got == {"herm_inv": 2 * len(HERM_NS),
                    "herm_chol_solve": 2 * len(HERM_NS) * len(HERM_KS)},
            "herm tiles: not one launch a call")
    for n in (NF, 128):
        a = equilibrated_spd(8, n, dev, gen, cond=ILL_COND)
        cond = float(torch.linalg.cond(a.to(torch.complex128)).max())
        eye = torch.eye(n, dtype=a.dtype, device=dev)
        res = {w: float(torch.abs(torch.matmul(a, M.herm_inv(a)) - eye).max())
               for w, M in (("kernel", K), ("plain", P))}
        say("kernels", f"herm_inv         cond {cond:.2e} n={n}: max|A A^-1 "
            f"- I| {res['kernel']:.3e} (plain {res['plain']:.3e}) <= 1e-3")
        require(res["kernel"] <= 1e-3, "ill-conditioned herm_inv residual")
        b = torch.randn((8, n, NT), dtype=torch.complex64, generator=gen,
                        device=dev)
        x = K.herm_chol_solve(a, b)
        r = float(torch.abs(torch.matmul(a, x) - b).max())
        mag = float((torch.matmul(torch.abs(a), torch.abs(x))
                     + torch.abs(b)).max())
        say("kernels", f"herm_chol_solve  cond {cond:.2e} n={n} K={NT}: "
            f"max|A x - b| {r:.3e} <= 1e-4 x max(|A||x| + |b|) {mag:.3e}")
        require(r <= 1e-4 * mag, "ill-conditioned herm_chol_solve residual")
    _build.reset_launches()


def check_tri_tiles(dev, cmp):
    """herm_inv and herm_chol_solve above 128: at every n of TRI_NS one
    launch and no cgemm, at BLOCKED_NS the blocked route (base launches of
    at most 192 and cgemm products), at B = 8 against their plain
    versions: the inverse with max|S X - I| <= 1e-4 and within 3e-3 of
    the plain inverse's mean magnitude, the factor-solve at K = 203 and
    K = 1 with max|A x - b| <= 2e-4 and within 3e-3 of the plain
    solution's mean magnitude; at n = WIDE_NF the identity exactly
    (herm_inv(I) == I, herm_chol_solve(I, b) == b)."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import spd_solve as ss

    K, P = I.KERNELS, I.PLAIN
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)

    def launched(fn):
        _build.reset_launches()
        got = fn()
        sync(dev)
        return got, {k: v for k, v in _build.LAUNCHES.items() if v}

    for n in TRI_NS + BLOCKED_NS:
        splits = 0 if n <= ss.BASE_N else 1   # 192 + the rest
        a = equilibrated_spd(8, n, dev, gen)
        eye = torch.eye(n, dtype=a.dtype, device=dev)
        inv, ran = launched(lambda: K.herm_inv(a))
        want = P.herm_inv(a)
        res = float(torch.abs(torch.matmul(a, inv) - eye).max())
        say("kernels", f"herm_inv         n={n}: max|S X - I| {res:.3e} <= "
            f"1e-4; launches {ran}")
        require(res <= 1e-4, f"herm_inv n={n} residual")
        require(ran == ({"herm_inv": 1} if not splits else
                        {"herm_inv": 2, "cgemm": 4}),
                f"herm_inv n={n}: launches {ran}")
        cmp("herm_inv", inv, want, 3e-3, f"n={n} vs plain",
            float(torch.abs(want).mean()))
        for k in (NT, 1):
            b = torch.randn((8, n, k), dtype=torch.complex64, generator=gen,
                            device=dev)
            x, ran = launched(lambda: K.herm_chol_solve(a, b))
            want = P.herm_chol_solve(a, b)
            res = float(torch.abs(torch.matmul(a, x) - b).max())
            say("kernels", f"herm_chol_solve  n={n} K={k}: max|A x - b| "
                f"{res:.3e} <= 2e-4; launches {ran}")
            require(res <= 2e-4, f"herm_chol_solve n={n} K={k} residual")
            require(ran == ({"herm_chol_solve": 1} if not splits else
                            {"herm_chol_solve": 2, "cgemm": 3}),
                    f"herm_chol_solve n={n} K={k}: launches {ran}")
            cmp("herm_chol_solve", x, want, 3e-3, f"n={n} K={k} vs plain",
                float(torch.abs(want).mean()))
            if n == WIDE_NF:
                eyes = eye.expand(8, n, n).contiguous()
                ok = (torch.equal(K.herm_inv(eyes), eyes)
                      and torch.equal(K.herm_chol_solve(eyes, b), b))
                say("kernels", f"herm tiles n={n} K={k}: herm_inv(I) == I "
                    f"and herm_chol_solve(I, b) == b exactly: {ok}")
                require(ok, f"n={n}: the identity is not kept exactly")
    _build.reset_launches()


def check_gate_mode(dev, cmp):
    """herm_inv's gate mode (the warm start's drift gate computed in the
    launch) at B = N_BASELINES against its plain version, plain_warm_gate
    followed by the masked inverse: at n = 120 and 128 (one launch on the
    padded square), n = 180 (one launch on the lower tiles) and n = 256
    (the blocked route, whose first base launch computes the gate), for
    drift_max 0.6, 0.3, 0.05 and the exact drift of one row, with an
    unmoved row (never rebuilds) and a NaN row (always rebuilds). The
    flags written are torch.equal to plain_warm_gate's (the row at exactly
    drift_max does not rebuild), each rebuilt chain is torch.equal to the
    unmasked kernel launch and within 1e-3 of the plain inverse, every
    other chain keeps its carried inverse bit for bit; one herm_inv launch
    at n <= 192, two and four cgemm above."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import herm_inv as hi

    B = N_BASELINES
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for n, launches in ((NF, {"herm_inv": 1}), (128, {"herm_inv": 1}),
                        (WIDE_NF, {"herm_inv": 1}),
                        (256, {"herm_inv": 2, "cgemm": 4})):
        s = equilibrated_spd(B, n, dev, gen)
        full, want = hi.herm_inv(s), hi.plain_herm_inv(s)
        psx = 1.0 + 99.0 * torch.rand((B, n), generator=gen, device=dev)
        ps = psx * torch.exp(0.6 * torch.rand((B, n), generator=gen,
                                              device=dev) - 0.3)
        ps[0] = psx[0]
        ps[2, 5] = float("nan")
        # row 4's drift, by plain_warm_gate's expression: drift_max there
        tiny = torch.finfo(torch.float32).tiny
        rel = torch.abs(ps - psx) / (
            0.5 * (torch.abs(ps) + torch.abs(psx))
            + 1e-6 * torch.amax(psx, dim=1, keepdim=True) + tiny)
        exact = float(torch.amax(rel, dim=1)[4])
        carried = torch.full_like(s, complex(7.0, -3.0))
        for dmax in (0.6, 0.3, 0.05, exact):
            flags = torch.full((B,), -1, dtype=torch.int32, device=dev)
            _build.reset_launches()
            got = hi.herm_inv(s, out=carried.clone(), gate=(ps, psx, dmax),
                              rebuild=flags)
            sync(dev)
            ran = {k: v for k, v in _build.LAUNCHES.items() if v}
            plain = hi.plain_warm_gate(ps, psx, dmax)
            on = plain.bool()
            ok = (torch.equal(flags, plain) and torch.equal(got[on], full[on])
                  and torch.equal(got[~on], carried[~on]))
            rows = (int(plain[0]), int(plain[2]), int(plain[4]))
            say("kernels", f"herm_inv gate    n={n} B={B} drift_max={dmax}: "
                f"{int(plain.sum())} rebuild; flags == plain, rebuilt == "
                f"unmasked launch, others untouched: {ok}; rows 0 (unmoved), "
                f"2 (NaN), 4 (drift {exact}) {rows}; launches {ran}")
            require(ok and rows[:2] == (0, 1) and ran == launches
                    and (dmax != exact or rows[2] == 0),
                    f"herm_inv gate mode n={n} drift_max={dmax}")
            if on.any():
                cmp("herm_inv", got[on], want[on], 1e-3,
                    f"gate n={n} vs plain")
    _build.reset_launches()


def time_groups(flags, dev):
    """The time groups of ``flags`` (the grouped engines' flag patterns)
    as int64 index tensors on ``dev``."""
    from hydra_pspec_torch.models import tflags

    return [torch.as_tensor(ix, dtype=torch.int64, device=dev)
            for _, ix in tflags.group_flag_patterns(flags)]


def check_time_maps(dev, cmp, same, B):
    """rng_fields' time maps at the real engine's width, ``B`` chains: the
    groups of the 11 flag patterns (rfi_windows: widths 15 and 53, odd)
    and of signature A (70, 80 and 53), each group as a ``tmap`` launch
    and all of a pattern set's groups as one segment launch, within 1e-5
    of the twin and torch.equal to the kernel's own full fields gathered
    at the groups' times."""
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    K, P = I.KERNELS, I.PLAIN
    sids = torch.arange(B, dtype=torch.int32, device=dev) * 7 + 3
    fa, fb = K.rng_fields(SEED, sids, 7, NF, NT, NT, NF)
    cat = lambda parts: torch.cat(list(parts), dim=2)
    for label, flags in (("11 patterns", rfi_windows()),
                         ("signature A", tflag_signatures()[0])):
        idx = time_groups(flags, dev)
        segs = rb.time_segments(idx)
        what = f"{label} t={list(segs.widths)}"
        want = (cat(fa[:, :, ix] for ix in idx),
                cat(fb[:, :, ix] for ix in idx))
        maps = [K.rng_fields(SEED, sids, 7, NF, w, w, NF,
                             tmap=ix.to(torch.int32))
                for ix, w in zip(idx, segs.widths)]
        got = (cat(m[0] for m in maps), cat(m[1] for m in maps))
        same("rng_fields", got, want, f"tmap, {label} == full[idx]")
        sa, sb = K.rng_segments(SEED, sids, 7, NF, segs, NF)
        same("rng_fields", (cat(sa), cat(sb)), want,
             f"segments, {label} == full[idx]")
        pa, pb = P.rng_segments(SEED, sids, 7, NF, segs, NF)
        cmp("rng_fields", (cat(sa), cat(sb)), (cat(pa), cat(pb)), 1e-5,
            f"segments vs twin, {what}")
        cmp("rng_fields", got, (cat(pa), cat(pb)), 1e-5,
            f"tmap vs twin, {label}")


def phase_kernels(dev, jobs8, jobs_w8, errs):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import cgemm as cg
    from hydra_pspec_torch.ops.kernels import draw_fused as df
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    K, P = I.KERNELS, I.PLAIN
    mops, dims = build_ops(jobs8, dev)
    B, n, t = mops.nid.shape
    nf, nt = dims.nfreqs, dims.ntimes
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)

    def cmp(name, got, want, tol, what="", scale=None):
        """max|got - want| <= tol * scale, scale defaulting to max|want|
        (a product passes the magnitude its sums run over instead: a
        cancellation's result is no measure of its rounding)."""
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        for g, w in zip(got, want):
            if g is None and w is None:
                continue
            err = float(torch.abs(g - w).max())
            ref = float(torch.abs(w).max()) if scale is None else scale
            errs[name] = max(errs.get(name, 0.0), err)
            say("kernels", f"{name:16s} {what:22s} max_abs_err {err:.3e} "
                f"<= {tol:.0e} x {ref:.3e}")
            require(err <= tol * ref, f"{name} {what}: {err} > "
                    f"{tol} x {ref}")

    def same(name, got, want, what):
        """Bit-identity of a keyed kernel and its stored mode."""
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        say("kernels", f"{name:16s} {what:22s} torch.equal: {ok}")
        require(ok, f"{name} {what}: keyed differs from stored mode")

    def gamma_moments(gams, a):
        gam = torch.cat(gams)
        N = gam.numel()
        m, var = float(gam.mean()), float(gam.var())
        tol_m = 5 * math.sqrt(a / N)
        tol_v = 5 * math.sqrt((2 * a * a + 6 * a) / N)
        say("kernels", f"bandpower        Gamma({a}) N={N} mean-a "
            f"{m - a:+.3f} (5 sigma {tol_m:.3f}) var-a {var - a:+.2f} "
            f"(5 sigma {tol_v:.2f})")
        require(abs(m - a) < tol_m and abs(var - a) < tol_v,
                f"Gamma({a}) moments")

    def mm(a, b, op="N", x=None, alpha=1.0, beta=1.0, what=""):
        """cgemm against plain_cgemm; the scale is max(|alpha| |op(A)| |B|
        + |beta| |X|), the magnitude the FP32 sums run over."""
        got = K.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta)
        want = P.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta)
        aop = a if op == "N" else a.transpose(-2, -1)
        mag = abs(alpha) * torch.matmul(torch.abs(aop), torch.abs(b))
        if x is not None:
            mag = mag + abs(beta) * torch.abs(x)
        cmp("cgemm", got, want, 1e-5, what, float(mag.max()))
        return want

    # Philox words: bit-identical to the twin
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ctr = torch.randint(-2**31, 2**31 - 1, (1 << 20, 4), generator=gen,
                        dtype=torch.int32)
    key = torch.randint(-2**31, 2**31 - 1, (1 << 20, 2), generator=gen,
                        dtype=torch.int32)
    words = rb.philox_raw(ctr.to(dev), key.to(dev)).cpu()
    require(torch.equal(words, rb.philox_raw(ctr, key)),
            "Philox kernel bits differ from the twin")
    say("kernels", f"philox_raw       2^20 counters: bit-identical to twin")

    oa, ob = K.rng_fields(SEED, sids, 7, n, t, nt, nf)
    cmp("rng_fields", (oa, ob), P.rng_fields(SEED, sids, 7, n, t, nt, nf),
        1e-5, "omegas vs twin")
    sa = math.sqrt(0.5) * math.sqrt(nf)
    for name, v, s in (("oa", oa, sa), ("ob", ob, math.sqrt(0.5))):
        x = torch.cat([v[:, :, :nt].real.flatten(),
                       v[:, :, :nt].imag.flatten()]).double() / s
        N = x.numel()
        m, var = float(x.mean()), float(x.var())
        say("kernels", f"rng_fields       {name} normals N={N} mean {m:+.2e} "
            f"var-1 {var - 1:+.2e} (5 sigma {5 / math.sqrt(N):.1e}, "
            f"{5 * math.sqrt(2 / N):.1e})")
        require(abs(m) < 5 / math.sqrt(N) and abs(var - 1) <
                5 * math.sqrt(2 / N), f"{name} normal moments")
        require(torch.all(v[:, :, nt:] == 0), f"{name} pad lanes not zero")
    # the real engine's transposed layout (i = channel, j = time, no pad
    # lanes), at the reference width and the wide band's
    for nr in (NF, WIDE_NF):
        cmp("rng_fields", K.rng_fields(SEED, sids, 7, nr, NT, NT, nr),
            P.rng_fields(SEED, sids, 7, nr, NT, NT, nr), 1e-5,
            f"real layout n={nr} t={NT}")
    for b in (N_TF_REAL, 100):   # the grouped real path's batch; 100 chains
        check_time_maps(dev, cmp, same, b)

    rc = K.draw_rhs(mops.nid, mops.nih, ob, nt)
    cmp("draw_rhs", rc, P.draw_rhs(mops.nid, mops.nih, ob, nt), 1e-5)
    ba = mm(mops.fg, rc, op="H", what="Fg^H rc")
    rc2 = mm(mops.g, ba, x=rc, alpha=-1.0, beta=1.0, what="rc - G ba")
    frc = mm(mops.f, rc2, what="F rc (shared F)")
    sys_k = K.draw_system(mops.pt, ps, frc, oa, nt, nf)
    sys_p = P.draw_system(mops.pt, ps, frc, oa, nt, nf)
    cmp("draw_system", sys_k, sys_p, 1e-5)
    # keyed mode (the megachain and mega engines): the kernels draw the
    # omegas in registers, bit-identical to the stored mode fed rng_fields
    key = df.OmegaKey(SEED, sids, 7)
    rk = K.draw_rhs(mops.nid, mops.nih, None, nt, key=key)
    same("draw_rhs", rk, rc, "keyed == stored")
    cmp("draw_rhs", rk, P.draw_rhs(mops.nid, mops.nih, None, nt, key=key),
        1e-5, "keyed vs plain")
    sk_ = K.draw_system(mops.pt, ps, frc, None, nt, nf, key=key)
    same("draw_system", sk_, sys_k, "keyed == stored")
    cmp("draw_system", sk_,
        P.draw_system(mops.pt, ps, frc, None, nt, nf, key=key), 1e-5,
        "keyed vs plain")
    # the iteration read from a device counter (a graph replay's): 5 + 2
    g_dev = torch.tensor([5], dtype=torch.int32, device=dev)
    dkey = df.OmegaKey(SEED, sids, g_dev, 2)
    same("draw_rhs", K.draw_rhs(mops.nid, mops.nih, None, nt, key=dkey), rk,
         "g on the device == g")
    same("draw_system", K.draw_system(mops.pt, ps, frc, None, nt, nf,
                                      key=dkey), sk_, "g on the device == g")

    def keyed_passes(what, nid, nih, pt, ps_, frc_, nt_, nf_):
        """draw_rhs and draw_system keyed and stored (fed rng_fields) at
        these shapes: each against its plain version, keyed == stored."""
        Bx, nx, tx = nid.shape
        ids = torch.arange(Bx, dtype=torch.int32, device=dev)
        oa_, ob_ = K.rng_fields(SEED, ids, 7, nx, tx, nt_, nf_)
        kx = df.OmegaKey(SEED, ids, 7)
        r_s = K.draw_rhs(nid, nih, ob_, nt_)
        r_k = K.draw_rhs(nid, nih, None, nt_, key=kx)
        cmp("draw_rhs", r_k, P.draw_rhs(nid, nih, None, nt_, key=kx), 1e-5,
            f"{what} keyed vs plain")
        same("draw_rhs", r_k, r_s, f"{what} keyed == stored")
        s_s = K.draw_system(pt, ps_, frc_, oa_, nt_, nf_)
        s_k = K.draw_system(pt, ps_, frc_, None, nt_, nf_, key=kx)
        cmp("draw_system", s_k,
            P.draw_system(pt, ps_, frc_, None, nt_, nf_, key=kx), 1e-5,
            f"{what} keyed vs plain")
        same("draw_system", s_k, s_s, f"{what} keyed == stored")

    # the passes at the JAX package's layout (n = 128, t = 256), at the
    # wide band's (n = 180) and at odd n and t (the 8-byte paths)
    jm, jd = build_ops(jobs8, dev, "jax")
    psj = mega.pad_ps(np.tile(ps_truth(), (B, 1)), jd, dev)
    keyed_passes(f"JAX layout n={jm.nid.shape[1]} t={jm.nid.shape[2]}",
                 jm.nid, jm.nih, jm.pt, psj,
                 P.cgemm(jm.f, P.draw_rhs(jm.nid, jm.nih, None, nt,
                                          key=df.OmegaKey(SEED, sids, 7))),
                 nt, nf)
    del jm
    wm, wd = build_ops(jobs_w8, dev)
    psw = mega.pad_ps(np.tile(ps_truth(WIDE_NF), (B, 1)), wd, dev)
    keyed_passes(f"wide n={wm.nid.shape[1]} t={wm.nid.shape[2]}", wm.nid,
                 wm.nih, wm.pt, psw,
                 P.cgemm(wm.f, P.draw_rhs(wm.nid, wm.nih, None, nt,
                                          key=df.OmegaKey(SEED, sids, 7))),
                 nt, WIDE_NF)
    del wm
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    no, to = 121, NT                       # odd n and t
    rn = lambda *sh: torch.randn(sh, dtype=torch.complex64, device=dev,
                                 generator=gen)
    a = rn(B, no, no)
    pto = ((a + a.mH) / 2 + no * torch.eye(no, device=dev)).contiguous()
    keyed_passes(f"odd n={no} t={to}", rn(B, no, to),
                 torch.rand((B, no), device=dev, generator=gen), pto,
                 10 * torch.rand((B, no), device=dev, generator=gen),
                 rn(B, no, to), to, no)
    s = sys_p[0]
    inv_k, inv_p = K.herm_inv(s), P.herm_inv(s)
    cmp("herm_inv", inv_k, inv_p, 1e-3, "vs Cholesky inverse")
    eye = torch.eye(n, dtype=s.dtype, device=dev)
    res = float(torch.abs(torch.matmul(s, inv_k) - eye).max())
    res_p = float(torch.abs(torch.matmul(s, inv_p) - eye).max())
    say("kernels", f"herm_inv         max|A A^-1 - I| {res:.3e} (plain "
        f"{res_p:.3e}) <= 1e-3")
    require(res <= 1e-3, "herm_inv residual")
    # the warm start's masked rebuild: flagged chains bit-identical to the
    # unmasked launch, the others' outputs untouched
    active = (torch.arange(B, device=dev) % 3 == 1).to(torch.int32)
    on = active.bool()
    sentinel = torch.full_like(inv_k, complex(7.0, -3.0))
    got = K.herm_inv(s, out=sentinel.clone(), active=active)
    ok_inv = (torch.equal(got[on], inv_k[on])
              and torch.equal(got[~on], sentinel[~on]))
    prod = K.cgemm(s, inv_k)
    got = K.cgemm(s, inv_k, out=sentinel.clone(), active=active)
    ok_mm = (torch.equal(got[on], prod[on])
             and torch.equal(got[~on], sentinel[~on]))
    say("kernels", f"herm_inv, cgemm  active mask {active.tolist()}: "
        f"flagged chains == unmasked, others untouched: {ok_inv}, {ok_mm}")
    require(ok_inv and ok_mm, "masked herm_inv/cgemm")
    check_gate_mode(dev, cmp)
    ex = mm(s, inv_k, what="S X")
    mm(inv_k, ex, x=inv_k, alpha=-1.0, beta=2.0, what="NS X(2I - S X)")
    x = mm(inv_k, sys_p[1], what="S^-1 xs")
    mm(s, x, x=sys_p[1], alpha=-1.0, beta=1.0, what="refine xs - S x")
    dd, dinv = sys_p[2], sys_p[3]
    cmp("row_scale_sumsq", K.row_scale_sumsq(x, dinv, dd),
        P.row_scale_sumsq(x, dinv, dd), 1e-5, "sk, beta")
    sk = P.row_scale_sumsq(x, dinv, dd)[0]
    sig = mm(mops.f, sk, op="H", alpha=1.0 / nf, what="F^H sk / n")
    da = P.cgemm(mops.g, sig, op="H", x=P.cgemm(mops.mi, ba), alpha=-1.0)
    fa = P.cgemm(mops.fg, da)
    w = mops.w.clone()
    w[:, 5] = 0.0                                   # flagged variant
    for lean in (False, True):
        kw = dict(want_chi=not lean, want_chit=lean, want_amp=not lean,
                  want_ws=True)
        args = (mops.dw, sig, fa, mops.ninv_full, w, da, mops.a0, nt)
        cmp("draw_resid", K.draw_resid(*args, **kw),
            P.draw_resid(*args, **kw), 1e-5, "lean" if lean else "full")
    check_row_widths(dev, cmp)

    tables = megachain.make_chain_tables(mops, dev)
    prior = rb.prior_bins(megachain.prior_static_from(make_prior(), dims),
                          dev)
    beta = P.row_scale_sumsq(x, dinv, dd)[1]
    # the main path's alpha = 202 and a long night's 1099 (the mega_long
    # shape, on its own table), each Gamma draw and ps against the plain
    # version; the warp search needs monotone table rows
    long_tab = long_tables(dev)
    for a, (tl, tq) in ((nt - 1, (tables.tlog, tables.q)),
                        (LONG_NT - 1, long_tab)):
        require(bool(torch.all(tl[1:] > tl[:-1]))
                and bool(torch.all(tq[1:] <= tq[:-1])),
                f"the alpha = {a} table rows are not monotone")
        gams = []
        for g in range(16):
            kp, kg = K.bandpower(beta, prior, tl, tq, seed=SEED, sids=sids,
                                 g=g, alpha=a, gam_out=True)
            pp, pg = P.bandpower(beta, prior, tl, tq, seed=SEED, sids=sids,
                                 g=g, alpha=a, gam_out=True)
            if g == 0:
                cmp("bandpower", (kg, kp), (pg, pp), 1e-5,
                    f"gamma, ps alpha={a}")
            require(float(torch.abs(kp - pp).max() / torch.abs(pp).max())
                    < 1e-5, f"bandpower ps g={g} alpha={a}")
            require(float(torch.abs(kg - pg).max() / torch.abs(pg).max())
                    < 1e-5, f"bandpower gamma g={g} alpha={a}")
            gams.append(kg.double().flatten())
        gamma_moments(gams, a)
        g_dev = torch.tensor([9], dtype=torch.int32, device=dev)
        got = K.bandpower(beta, prior, tl, tq, seed=SEED, sids=sids, g=g_dev,
                          g_off=6, alpha=a, gam_out=True)
        same("bandpower", got, K.bandpower(beta, prior, tl, tq, seed=SEED,
                                           sids=sids, g=15, alpha=a,
                                           gam_out=True),
             f"alpha={a} g on the device == g")
    kp, kg = K.bandpower(beta, prior, tables.tlog, tables.q, seed=SEED,
                         sids=sids, g=0, alpha=nt - 1, gam_out=True)
    u = torch.rand((B, 128), generator=torch.Generator(device=dev)
                   .manual_seed(3), device=dev)
    gext = kg
    cmp("bandpower",
        K.bandpower(beta, prior, tables.tlog, tables.q, gam=gext, u_pb=u),
        P.bandpower(beta, prior, tables.tlog, tables.q, gam=gext, u_pb=u),
        1e-5, "external randomness")
    require(torch.all(kp[:, nf:] == 0), "pad bins of ps not zero")

    # grouped time-flags variants, at the tflags path's layout (G = 3,
    # t = 80) and at the JAX package's (G = 4 with a dummy row of zero
    # operators, t = 128), where the dummy rows must come out exact
    for layout in ("port", "jax"):
        gs = grouped_setup(jobs8, tflag_signatures()[0], 1, dev, layout)
        dummy = len(gs.group_times) - len(gs.group_idx)
        gm, G = gs.mops, len(gs.group_times)
        Bg, ng, tg = gm.nid.shape
        ntot = gs.dims.ntimes
        rt, sids_r, sidc_r = grouped_ids(gs, Bg // G, dev)
        what = f"grouped {layout} G={G} B={Bg} t={tg}"
        oa, ob = K.rng_fields(SEED, sids_r, 7, ng, tg, ntot, nf, rt)
        cmp("rng_fields", (oa, ob),
            P.rng_fields(SEED, sids_r, 7, ng, tg, ntot, nf, rt), 1e-5, what)
        for r, c in enumerate(rt.tolist()):
            require(torch.all(oa[r, :, c:] == 0)
                    and torch.all(ob[r, :, c:] == 0),
                    f"grouped omegas of row {r} not zero beyond its {c} "
                    f"times")
        rc = K.draw_rhs(gm.nid, gm.nih, ob, ntot, rt)
        cmp("draw_rhs", rc, P.draw_rhs(gm.nid, gm.nih, ob, ntot, rt), 1e-5,
            what)
        frc = P.cgemm(gm.f, rc)
        psg = mega.pad_ps(np.tile(ps_truth(), (Bg, 1)), gs.dims, dev)
        sys_k = K.draw_system(gm.pt, psg, frc, oa, ntot, nf, rt)
        sys_p = P.draw_system(gm.pt, psg, frc, oa, ntot, nf, rt)
        cmp("draw_system", sys_k, sys_p, 1e-5, what)
        gkey = df.OmegaKey(SEED, sids_r, 7)
        same("draw_rhs", K.draw_rhs(gm.nid, gm.nih, None, ntot, rt, gkey), rc,
             f"{what} keyed")
        same("draw_system", K.draw_system(gm.pt, psg, frc, None, ntot, nf, rt,
                                          gkey), sys_k, f"{what} keyed")
        s, xs, dd, dinv = sys_p
        if dummy:
            require(torch.all(sys_k[3][G - 1::G] == 1.0),
                    "dummy rows: dinv is not 1")
            inv = K.herm_inv(s)
            eye = torch.eye(ng, dtype=s.dtype, device=dev)
            dummy_err = float(torch.abs(inv[G - 1::G] - eye).max())
            say("kernels", f"herm_inv         dummy rows (S = I): max|S^-1 "
                f"- I| {dummy_err:.1e} == 0")
            require(dummy_err == 0.0, "herm_inv of the identity is not "
                    "exact")
        x = P.cgemm(P.herm_inv(s), xs)
        sk, beta = P.row_scale_sumsq(x, dinv, dd)
        require(not dummy or torch.all(beta[G - 1::G] == 0),
                "dummy rows: beta is not 0")
        sig = P.cgemm(gm.f, sk, op="H", alpha=1.0 / nf)
        da = P.cgemm(gm.g, sig, op="H", x=P.cgemm(gm.mi, P.cgemm(gm.fg, rc,
                                                                op="H")),
                     alpha=-1.0)
        fa = P.cgemm(gm.fg, da)
        for lean in (False, True):
            kw = dict(want_chi=not lean, want_chit=lean, want_amp=not lean,
                      want_ws=True, row_times=rt)
            args = (gm.dw, sig, fa, gm.ninv_full, gm.w, da, gm.a0, ntot)
            got = K.draw_resid(*args, **kw)
            cmp("draw_resid", got, P.draw_resid(*args, **kw), 1e-5,
                f"{what} {'lean' if lean else 'full'}")
            require(not dummy or torch.all(got[1][G - 1::G] == 0),
                    "dummy rows: noise_nu is not 0")
        gtab = megachain.make_chain_tables(gm, dev)
        for g in range(4):
            kp, kg = K.bandpower(beta, prior, gtab.tlog, gtab.q, seed=SEED,
                                 sids=sidc_r, g=g, alpha=ntot - 1,
                                 gam_out=True, group=G)
            pp, pg = P.bandpower(beta, prior, gtab.tlog, gtab.q, seed=SEED,
                                 sids=sidc_r, g=g, alpha=ntot - 1,
                                 gam_out=True, group=G)
            cmp("bandpower", (kg, kp), (pg, pp), 1e-5, f"{what} g={g}")
            rows_same = all(torch.equal(v[c * G + r], v[c * G])
                            for v in (kp, kg) for c in range(Bg // G)
                            for r in range(G))
            require(rows_same,
                    "grouped bandpower: the rows of a chain differ")
        u = torch.rand((Bg, 128), generator=torch.Generator(device=dev)
                       .manual_seed(4), device=dev)
        cmp("bandpower",
            K.bandpower(beta, prior, gtab.tlog, gtab.q, gam=kg, u_pb=u,
                        group=G),
            P.bandpower(beta, prior, gtab.tlog, gtab.q, gam=kg, u_pb=u,
                        group=G),
            1e-5, f"{what} external randomness")

    # the real engine's factor-solve at its shapes (n = 120, K = 203)
    from hydra_pspec_torch.ops.kernels import herm_inv as hi
    from hydra_pspec_torch.ops.kernels import spd_solve as ss
    from hydra_pspec_torch.ops.kernels.megastep import gcr_megastep

    _, _, s_u, _ = real_system(jobs8, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    rhs = torch.randn((s_u.shape[0], NF, NT), dtype=torch.complex64,
                      generator=gen, device=dev)
    ms, _ = ss.equilibrate(s_u)
    x_k = K.herm_chol_solve(ms, rhs)
    x_p = P.herm_chol_solve(ms, rhs)
    what = f"B={ms.shape[0]} n={NF} K={NT}"
    cmp("herm_chol_solve", x_k, x_p, 1e-3, f"{what} vs plain")
    res = float(torch.abs(torch.matmul(ms, x_k) - rhs).max())
    mag = float((torch.matmul(torch.abs(ms), torch.abs(x_k))
                 + torch.abs(rhs)).max())
    say("kernels", f"herm_chol_solve  {what}: max|A x - b| {res:.3e} <= 1e-4 "
        f"x max(|A||x| + |b|) {mag:.3e}")
    require(res <= 1e-4 * mag, "herm_chol_solve residual")
    cmp("hermitian_solve", hi.hermitian_solve(s_u, rhs),
        hi.hermitian_solve(s_u, rhs, inv=P.herm_inv, mm=P.cgemm), 1e-3,
        f"{what} vs plain (pallas2)")

    check_herm_tiles(dev, cmp)
    check_tri_tiles(dev, cmp)

    # cgemm at every product shape of the paths, at the paths' batch (B =
    # 100, or the grouped products' own: the tile plan depends on it, and
    # the plan's tile is named), against plain; torch.equal to the same
    # product on chain slices of 1, 7 and the rest (other batches, other
    # tiles) and on every tile of the kernel, so that each tile is held
    # against plain too; C aliasing X
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    for shape in CGEMM_SHAPES:
        what, Mc, Kc, Nc, op = shape[:5]
        Bc = cgemm_batch(shape, N_BASELINES)
        a, b, x, alpha, beta = cgemm_operands(shape, Bc, dev, gen)
        mm(a, b, op=op, x=x, alpha=alpha, beta=beta,
           what=f"{what} B={Bc} ({cgemm_plan(Bc, Mc, Nc, Kc)})")
        got = K.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta)
        require(torch.equal(got, cgemm_on_slices(K.cgemm, shape, a, b, x,
                                                 alpha, beta)),
                f"cgemm {what}: B={Bc} differs from its chain slices "
                f"{CGEMM_SLICES} + the rest")
        for k, name in enumerate(cg.TILES):
            require(torch.equal(got, cgemm_on_tile(k, a, b, op=op, x=x,
                                                   alpha=alpha, beta=beta)),
                    f"cgemm {what}: B={Bc} differs on tile {name}")
        if shape[6] == "out":
            K.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta, out=x)
            require(torch.equal(x, got), f"cgemm {what}: out=x differs")
    say("kernels", f"cgemm: every product at its paths' batch torch.equal "
        f"to its chain slices {CGEMM_SLICES} + the rest and on every tile "
        f"({', '.join(cg.TILES)})")

    # the wide band's systems: herm_inv at its megachain system and
    # herm_chol_solve at its real engine's (n = 180, K = 203), one launch
    # each on the lower tiles
    wm, wdims = build_ops(jobs_w8, dev)
    Bw, nw, tw = wm.nid.shape
    wsids = torch.arange(Bw, dtype=torch.int32, device=dev)
    oa, ob = P.rng_fields(SEED, wsids, 7, nw, tw, wdims.ntimes, wdims.nfreqs)
    rc = P.draw_rhs(wm.nid, wm.nih, ob, wdims.ntimes)
    rc = P.cgemm(wm.g, P.cgemm(wm.fg, rc, op="H"), x=rc, alpha=-1.0)
    psw = mega.pad_ps(np.tile(ps_truth(WIDE_NF), (Bw, 1)), wdims, dev)
    sw = P.draw_system(wm.pt, psw, P.cgemm(wm.f, rc), oa, wdims.ntimes,
                       wdims.nfreqs)[0]
    _build.reset_launches()
    inv_k = K.herm_inv(sw)
    sync(dev)
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    say("kernels", f"herm_inv         wide B={Bw} n={nw}: launches {got}")
    require(got == {"herm_inv": 1}, "wide herm_inv: not one launch")
    cmp("herm_inv", inv_k, P.herm_inv(sw), 1e-3,
        f"wide n={nw} vs Cholesky inverse")
    eye = torch.eye(nw, dtype=sw.dtype, device=dev)
    res = float(torch.abs(torch.matmul(sw, inv_k) - eye).max())
    say("kernels", f"herm_inv         wide n={nw}: max|A A^-1 - I| "
        f"{res:.3e} <= 1e-3")
    require(res <= 1e-3, "wide herm_inv residual")
    active = (torch.arange(Bw, device=dev) % 3 == 1).to(torch.int32)
    on = active.bool()
    sentinel = torch.full_like(inv_k, complex(7.0, -3.0))
    _build.reset_launches()
    got = K.herm_inv(sw, out=sentinel.clone(), active=active)
    sync(dev)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    ok = (torch.equal(got[on], inv_k[on])
          and torch.equal(got[~on], sentinel[~on]))
    say("kernels", f"herm_inv         wide n={nw}, active mask: flagged "
        f"chains == unmasked, others untouched: {ok}; launches {launches}")
    require(ok and launches == {"herm_inv": 1}, "masked wide herm_inv")
    _, _, s_w, _ = real_system(jobs_w8, dev)
    ms_w, _ = ss.equilibrate(s_w)
    rhs_w = torch.randn((Bw, WIDE_NF, NT), dtype=torch.complex64,
                        generator=gen, device=dev)
    _build.reset_launches()
    x_k = K.herm_chol_solve(ms_w, rhs_w)
    sync(dev)
    got = {k: v for k, v in _build.LAUNCHES.items() if v}
    what = f"wide B={Bw} n={WIDE_NF} K={NT}"
    say("kernels", f"herm_chol_solve  {what}: launches {got}")
    require(got == {"herm_chol_solve": 1},
            "wide herm_chol_solve: not one launch")
    cmp("herm_chol_solve", x_k, P.herm_chol_solve(ms_w, rhs_w), 1e-3,
        f"{what} vs plain")
    res = float(torch.abs(torch.matmul(ms_w, x_k) - rhs_w).max())
    mag = float((torch.matmul(torch.abs(ms_w), torch.abs(x_k))
                 + torch.abs(rhs_w)).max())
    say("kernels", f"herm_chol_solve  {what}: max|A x - b| {res:.3e} <= "
        f"1e-4 x max(|A||x| + |b|) {mag:.3e}")
    require(res <= 1e-4 * mag, "wide herm_chol_solve residual")

    # the single-step entry against its plain composition, main shapes
    rng = np.random.default_rng(SEED + 8)
    rnd = numpy_randomness(rng, 1, B, n, t, nf, nt)
    oa = torch.complex(torch.from_numpy(rnd["oa_re"][0]),
                       torch.from_numpy(rnd["oa_im"][0])).to(dev)
    ob = torch.complex(torch.from_numpy(rnd["ob_re"][0]),
                       torch.from_numpy(rnd["ob_im"][0])).to(dev)
    step = lambda M: gcr_megastep(mops, ps, oa, ob, nfreqs=nf, ntimes=nt,
                                  all_unflagged=dims.all_unflagged, impl=M)
    dk, dp = step(K), step(P)
    cmp("gcr_megastep", (dk.sig, dk.amp, dk.chi, dk.beta, dk.noise_nu,
                         dk.bmask),
        (dp.sig, dp.amp, dp.chi, dp.beta, dp.noise_nu, dp.bmask), 1e-4,
        "sig, amp, chi, beta, noise_nu, bmask")
    sync(dev)
    _build.reset_launches()


# --- 4. chain phase ----------------------------------------------------------

def phase_chain(dev, jobs8):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import impl as I

    Kit = 3
    mops, dims = build_ops(jobs8, dev)
    gs = grouped_setup(jobs8, tflag_signatures()[0], 1, dev)
    G = len(gs.group_times)
    layouts = (("plain", mops, dims, 1, {}),
               (f"grouped G={G}", gs.mops, gs.dims, G,
                dict(group_times=gs.group_times, group_idx=gs.group_idx)))
    for label, mo, di, grp, gkw in layouts:
        B, n, t = mo.nid.shape
        rng = np.random.default_rng(SEED + 1)
        rnd = numpy_randomness(rng, Kit, B, n, t, di.nfreqs, di.ntimes, grp)
        tables = megachain.make_chain_tables(mo, dev)
        static = megachain.prior_static_from(make_prior(), di)
        ps0 = mega.pad_ps(np.tile(ps_truth(), (B, 1)), di, dev)
        for warm in ({}, {"warm_ns": 3, "drift_max": 10.0}):
            out = {}
            for name, impl in (("kernels", I.KERNELS), ("plain", I.PLAIN)):
                out[name] = megachain.run_chunk_megachain(
                    mo, tables, di, ps0, Kit, static, randomness=rnd,
                    impl=impl, **warm, **gkw)
            (kps, ks), (pps, ps_) = out["kernels"], out["plain"]
            sync(dev)
            sig_err = max(
                float(torch.abs(f(ks.signal_cr) - f(ps_.signal_cr)).max()
                      / torch.abs(f(ps_.signal_cr)).mean())
                for f in (torch.real, torch.imag))
            ps_ok = torch.allclose(ks.ps, ps_.ps, rtol=2e-3, atol=1e-6) and \
                torch.allclose(kps, pps, rtol=2e-3, atol=1e-6)
            # flagged entries carry chi = |foreground model|^2 (~1e6): the
            # grouped layout is held relatively, as its CPU pin is
            chi_tol = (dict(rtol=5e-3, atol=1e-5) if grp > 1
                       else dict(rtol=0.0, atol=5e-3))
            chi_ok = torch.allclose(ks.chisq, ps_.chisq, **chi_tol)
            chi_err = float(torch.abs(ks.chisq - ps_.chisq).max())
            say("chain", f"{label} K={Kit} B={B} {warm or 'exact'}: sig "
                f"{sig_err:.2e} < 2e-4 (rel. mean), ps within rtol 2e-3/"
                f"atol 1e-6: {ps_ok}, chi max|err| {chi_err:.2e} within "
                f"{chi_tol}: {chi_ok}")
            require(sig_err < 2e-4 and ps_ok and chi_ok,
                    "chain phase: kernels disagree with the plain path")


# --- graph phase -----------------------------------------------------------

GRAPH_K, GRAPH_ITER0 = 10, 37   # iterations of a checked chunk; its start


def rebuilt_chains(ps0, ps_out, drift_max):
    """(chains rebuilt at each iteration k >= 1) of a warm-started chunk
    from its input ``ps0`` and its per-iteration ``ps`` outputs (K, B, >=)
    (padded or trimmed: the gate reads zero pad bins as no move), by the
    plain gate: the rebuilds the kernels' device-side gate chose."""
    from hydra_pspec_torch.ops.kernels.herm_inv import plain_warm_gate

    nf = ps_out.shape[2]
    prev = [ps0[:, :nf]] + [ps_out[k] for k in range(ps_out.shape[0] - 1)]
    return [int(plain_warm_gate(prev[k], prev[k - 1], drift_max).sum())
            for k in range(1, ps_out.shape[0])]


def graph_case(label, dev, make_body, ps, drift_max=None):
    """One chunk of :data:`GRAPH_K` iterations from global iteration
    :data:`GRAPH_ITER0` through a body of ``make_body()`` on the kernels,
    eagerly and as a ChunkGraph replay, under
    torch.cuda.set_sync_debug_mode("error") (any synchronizing torch call
    raises): every output torch.equal, the same launches; a second replay
    from the next iteration against the eager chunk there (the device
    counter moves). The graph gets a body of its own and the caller keeps
    none; freed memory is filled with junk before the replays, so a tensor
    the graph reads but does not hold would show. Returns the graph's
    costs."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph
    from hydra_pspec_torch.ops.kernels.megachain import ChainOut

    # the bodies copy their index tensors and tables to the device: made
    # before the sync check, which covers the chunks themselves
    body, gbody = make_body(), make_body()
    sync(dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _build.counted() as rec:
            eager = body(ps, GRAPH_ITER0, GRAPH_K)
        cg = ChunkGraph(gbody, ps, GRAPH_K)
        del gbody
        junk = [torch.full((1 << p,), 127, dtype=torch.uint8, device=dev)
                for p in range(2, 22) for _ in range(4)]
        got = cg.replay(ps, GRAPH_ITER0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    del junk
    sync(dev)
    diff = [f for f in ChainOut._fields
            if (getattr(got, f) is None) != (getattr(eager, f) is None)
            or (getattr(got, f) is not None
                and not torch.equal(getattr(got, f), getattr(eager, f)))]
    compared = [f for f in ChainOut._fields if getattr(got, f) is not None]
    say("graph", f"{label}: replay == eager kernel path, torch.equal on "
        f"{compared}: {not diff}; launches {cg.launches} (eager "
        f"{rec.launches})")
    require(not diff, f"graph {label}: replay differs from the eager path "
            f"in {diff}")
    require(cg.launches == rec.launches,
            f"graph {label}: the capture recorded other launches")
    again = cg.replay(ps, GRAPH_ITER0 + 1).ps.clone()
    eager1 = body(ps, GRAPH_ITER0 + 1, GRAPH_K).ps
    require(torch.equal(again, eager1),
            f"graph {label}: a replay from iteration {GRAPH_ITER0 + 1} "
            f"differs")
    info = {"k": GRAPH_K, "capture_s": cg.capture_s,
            "instantiate_s": cg.instantiate_s, "warmup_s": cg.warmup_s,
            "pool_bytes": cg.pool_bytes, "output_bytes": cg.output_bytes,
            "launches_per_iteration": {k: v / GRAPH_K
                                       for k, v in cg.launches.items()}}
    if drift_max is not None:
        info["rebuilt_chains"] = rebuilt_chains(ps, eager.ps, drift_max)
    say("graph", f"{label}: warm-up {cg.warmup_s:.3f} s, capture "
        f"{cg.capture_s:.3f} s, instantiate {cg.instantiate_s:.3f} s, pool "
        f"{cg.pool_bytes / 2**20:.1f} MiB (outputs "
        f"{cg.output_bytes / 2**20:.1f} MiB); a replay from iteration "
        f"{GRAPH_ITER0 + 1} == eager"
        + (f"; chains rebuilt at k = 1..{GRAPH_K - 1}: "
           f"{info['rebuilt_chains']}" if drift_max is not None else ""))
    del cg, got, eager
    return info


def phase_graph(dev, jobs, jobs_w):
    """The chunk graph at B = 100 against the eager kernel path: plain
    full and lean, grouped 100 x G=3, the wide band (n = 180) and the mega
    engine."""
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    out = {}
    mops, dims = build_ops(jobs, dev)
    B = mops.nid.shape[0]
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(), dims)

    def chain(m, d, nf=NF, ids=sids, **kw):
        return lambda: megachain.chunk_body(
            m, megachain.make_chain_tables(m, dev), d,
            megachain.prior_static_from(make_prior(nf=nf), d), seed=SEED,
            sids=ids, warm_ns=3, **kw)

    # production drift_max 0.6; lean at 0.3, where some chains rebuild
    out["plain"] = graph_case(
        f"plain full B={B}", dev,
        chain(mops, dims, drift_max=0.6), ps, 0.6)
    out["plain_lean"] = graph_case(
        f"plain lean B={B} drift_max=0.3", dev,
        chain(mops, dims, drift_max=0.3, lean=True), ps, 0.3)
    bins = rb.prior_bins(static, dev)
    out["mega"] = graph_case(
        f"mega B={B}", dev, lambda: mega.mega_chunk_body(
            mops, dims, bins, tables.tlog, tables.q, seed=SEED, sids=sids),
        ps)
    del mops

    gs = grouped_setup(jobs[:1], tflag_signatures()[0], B, dev)
    G = len(gs.group_times)
    Bg = gs.mops.nid.shape[0]
    _, sids_r, sidc_r = grouped_ids(gs, Bg // G, dev)
    psg = mega.pad_ps(np.tile(ps_truth(), (Bg, 1)), gs.dims, dev)
    out["grouped"] = graph_case(
        f"grouped {Bg // G} chains x G={G} full", dev, chain(
            gs.mops, gs.dims, ids=sids_r, sidc=sidc_r, drift_max=0.6,
            group_times=gs.group_times, group_idx=gs.group_idx), psg)
    del gs

    wm, wdims = build_ops(jobs_w, dev)
    psw = mega.pad_ps(np.tile(ps_truth(WIDE_NF), (B, 1)), wdims, dev)
    out["wide"] = graph_case(
        f"wide n={wm.nid.shape[1]} full B={B} drift_max=0.3", dev,
        chain(wm, wdims, nf=WIDE_NF, drift_max=0.3), psw, 0.3)
    return out


# --- layout phase ------------------------------------------------------------

LAYOUT_K = 10   # iterations of each path's chunk at both layouts


def _real_lanes(ps_final, sample, nf, every=1):
    """A chunk's outputs on the real lanes only, cloned: the state's real
    bins (of every ``every``-th row: a chain's first in the grouped mode)
    and the sample's fields, which the engines trim to the true widths."""
    out = {"ps_final": ps_final[::every, :nf].clone()}
    for k, v in sample._asdict().items():
        if v is not None:
            out[k] = v.clone()
    return out


def phase_layout(dev, jobs, jobs_w):
    """The main path (full and lean), the time-flags signatures A and B,
    the mega engine and the wide band, each a chunk of LAYOUT_K iterations
    on the Philox streams from global iteration GRAPH_ITER0 (warm start
    drift_max 0.6 on megachain; chunk graphs, as the runner runs them), at
    the port's layout and at the JAX package's: every real lane of every
    output torch.equal."""
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    stats = {}

    def chain_at(jobs_, nf, lean=False):
        def run(layout):
            mops, dims = build_ops(jobs_, dev, layout)
            B = mops.nid.shape[0]
            ps = mega.pad_ps(np.tile(ps_truth(nf), (B, 1)), dims, dev)
            ps_f, smp = megachain.run_chunk_megachain(
                mops, megachain.make_chain_tables(mops, dev), dims, ps,
                LAYOUT_K, megachain.prior_static_from(make_prior(nf=nf),
                                                      dims),
                seed=SEED, sids=torch.arange(B, dtype=torch.int32,
                                             device=dev),
                iter0=GRAPH_ITER0, warm_ns=3, drift_max=0.6,
                store_cr=not lean)
            return _real_lanes(ps_f, smp, nf), (dims.n, dims.t, dims.m)
        return run

    def grouped_at(flags):
        def run(layout):
            gs = grouped_setup(jobs, flags, 1, dev, layout)
            G = len(gs.group_times)
            Bg = gs.mops.nid.shape[0]
            _, sids_r, sidc_r = grouped_ids(gs, Bg // G, dev)
            psg = mega.pad_ps(np.tile(ps_truth(), (Bg, 1)), gs.dims, dev)
            ps_f, smp = megachain.run_chunk_megachain(
                gs.mops, megachain.make_chain_tables(gs.mops, dev), gs.dims,
                psg, LAYOUT_K, megachain.prior_static_from(make_prior(),
                                                           gs.dims),
                seed=SEED, sids=sids_r, sidc=sidc_r, iter0=GRAPH_ITER0,
                warm_ns=3, drift_max=0.6, group_times=gs.group_times,
                group_idx=gs.group_idx)
            return (_real_lanes(ps_f, smp, NF, every=G),
                    (gs.dims.n, gs.dims.t, gs.dims.m, G))
        return run

    def mega_at(layout):
        mops, dims = build_ops(jobs, dev, layout)
        B = mops.nid.shape[0]
        tables = megachain.make_chain_tables(mops, dev)
        ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
        ps_f, smp = mega.run_chain_mega(
            mops, dims, ps, rb.prior_bins(rb.bounded_bins(make_prior()),
                                          dev),
            LAYOUT_K, tables.tlog, tables.q, seed=SEED,
            sids=torch.arange(B, dtype=torch.int32, device=dev),
            iter0=GRAPH_ITER0)
        return _real_lanes(ps_f, smp, NF), (dims.n, dims.t, dims.m)

    sig_a, sig_b = tflag_signatures()
    cases = {"main": chain_at(jobs, NF),
             "main lean": chain_at(jobs, NF, True),
             "tflags A": grouped_at(sig_a), "tflags B": grouped_at(sig_b),
             "mega": mega_at, "wide": chain_at(jobs_w, WIDE_NF)}
    for label, run in cases.items():
        (a, shape_a), (b, shape_b) = run("port"), run("jax")
        diff = {k: float(torch.abs(a[k] - b[k]).max()) for k in a
                if not torch.equal(a[k], b[k])}
        stats[label] = {"equal": not diff, "max_abs_diff": diff,
                        "fields": sorted(a), "port": shape_a,
                        "jax": shape_b}
        say("layout", f"{label:9s} port (n, t, m[, G]) {shape_a}, JAX "
            f"{shape_b}: {LAYOUT_K} iterations, every real lane of "
            f"{sorted(a)} torch.equal: {not diff}"
            + (f"; max |diff| {diff}" if diff else ""))
        del a, b
        torch.cuda.empty_cache()
    bad = {k: v["max_abs_diff"] for k, v in stats.items() if not v["equal"]}
    require(not bad, f"layout: real lanes differ between layouts: {bad}")
    return stats


# --- 5. main path -----------------------------------------------------------

class _DeviceAudit(TorchDispatchMode):
    """Counts the ops that produce tensors on each device; host transfers
    (the flush of samples) are the only ops allowed to produce CPU
    tensors, and tensors in pinned memory (the runner's staging of those
    transfers)."""

    HOST_OK = {"_to_copy", "copy_", "lift_fresh", "lift_fresh_copy",
               "_local_scalar_dense", "detach", "alias", "view"}

    def __init__(self):
        super().__init__()
        self.cuda_ops = 0
        self.cpu_ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for o in outs:
            if isinstance(o, torch.Tensor):
                if o.device.type == "cuda":
                    self.cuda_ops += 1
                elif not o.is_pinned():
                    name = func.__name__.split(".")[0]
                    if name not in self.HOST_OK:
                        self.cpu_ops[name] += 1
        return out


def trace_split(label, profile_dir):
    """The runner's profiled turn of its chunk loop, from the Chrome trace
    it wrote into ``profile_dir``: the device's kernel busy seconds (union
    of kernel spans), the device-to-host copies (bytes, seconds, GB/s,
    pinned or pageable) and the host seconds in each of the runner's
    spans. Fails unless the chunk's samples left by a pinned copy."""
    files = sorted(Path(profile_dir).glob("chunk-*.trace.json"))
    require(len(files) == 1, f"{label}: no single runner trace in "
            f"{profile_dir}: {files}")
    ev = json.loads(files[0].read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev
                   if e.get("cat") == "kernel")
    busy, hi = 0.0, -math.inf
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, hi))
        hi = max(hi, t1)
    d2h = [e for e in ev if e.get("cat") == "gpu_memcpy"
           and "DtoH" in e.get("name", "")]
    pinned = [e for e in d2h if "Pinned" in e["name"]]
    nbytes = sum(int(e.get("args", {}).get("bytes", 0)) for e in d2h)
    d2h_s = sum(e["dur"] for e in d2h) / 1e6
    timed = [e for e in ev if "dur" in e and e.get("ph") == "X"]
    window = (max(e["ts"] + e["dur"] for e in timed)
              - min(e["ts"] for e in timed)) / 1e6
    host = {k: sum(e["dur"] for e in ev if e.get("cat") == "user_annotation"
                   and e.get("name") == k) / 1e6 for k in HOST_SPANS}
    out = {"trace": files[0].name, "window_s": window,
           "device_busy_s": busy / 1e6, "kernels": len(spans),
           "d2h_copies": len(d2h), "d2h_pinned_copies": len(pinned),
           "d2h_bytes": nbytes, "d2h_s": d2h_s,
           "d2h_GB_s": nbytes / d2h_s / 1e9 if d2h_s else None,
           "host_s": host}
    say(label, f"runner trace {files[0].name}: window {window:.4f} s; "
        f"device kernels busy {busy / 1e6:.4f} s ({len(spans)} kernels); "
        f"DtoH {len(d2h)} copies, {nbytes} bytes in {d2h_s:.4f} s = "
        f"{out['d2h_GB_s'] or 0:.2f} GB/s, to pinned memory: "
        f"{len(pinned)} of {len(d2h)}; host s {host}")
    require(d2h and len(pinned) == len(d2h),
            f"{label}: the chunk's samples did not leave by pinned copies")
    return out


def host_side(label, tim, nbl, niter):
    """The runner's host-side split (its ``timings``) as a line and a
    dict."""
    sampling = tim["process"] - tim["write"]
    keys = ("process", "write", "flush", "pool_wait", "pool", "fetch_wait",
            "staging", "pin_alloc", "pinned_bytes", "is_native",
            "graph_pool_bytes")
    out = dict({k: tim[k] for k in keys},
               sampling_baseline_iters_per_s=nbl * niter / sampling)
    say(label, f"host side: process {tim['process']:.3f} s, write "
        f"{tim['write']:.3f} s (flush submit {tim['flush']:.3f}, pool wait "
        f"{tim['pool_wait']:.3f}), sampling only "
        f"{out['sampling_baseline_iters_per_s']:.1f} baseline-iterations/s; "
        f"fetch wait {tim['fetch_wait']:.3f} s, staging copy "
        f"{tim['staging']:.3f} s, pinned allocation {tim['pin_alloc']:.3f} "
        f"s; pool threads' write seconds "
        f"{tim['pool']:.3f}, native writer {tim['is_native']}; pinned "
        f"staging {tim['pinned_bytes'] / 2**20:.1f} MiB; graph slots' pools "
        f"{[round(b / 2**20, 1) for b in tim['graph_pool_bytes']]} MiB")
    require(tim["is_native"], f"{label}: the native writer did not load")
    return out


def run_megachain_path(label, dev, jobs, nf, niter=NITER,
                       write_niter=WRITE_NITER, burn=50, profile_dir=None):
    """run_baselines on ``jobs`` (megachain, files and checkpoint) for
    ``niter`` iterations under the device audit, with the launch counts
    set to 0 just before and read just after: the six reference files, the
    checkpoint, the chi^2 gate over the iterations after ``burn`` and
    every main kernel launched; the host-side split, and with
    ``profile_dir`` the runner's trace of its steady-state chunk (pinned
    copies required). Returns (results, launches, the sampling rate in
    baseline-iterations/s, stats)."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.utils import io as hio

    audit = _DeviceAudit()
    _build.reset_launches()
    t0 = time.perf_counter()
    with audit:
        results, tim = runner.run_baselines(
            jobs, make_prior(nf=nf), niter, device=dev, seed=SEED,
            write_niter=write_niter, store_cr=True, warm_ns=3,
            drift_max=0.6, profile_dir=profile_dir)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    say(label, f"{len(jobs)} baselines x {niter} iterations at {nf} "
        f"channels: wall {wall:.2f} s, process {tim['process']:.2f} s "
        f"(write {tim['write']:.2f} s), build+transfer "
        f"{tim['scatter']:.2f} s")
    sampling = tim["process"] - tim["write"]
    rate = len(jobs) * niter / sampling
    say(label, f"iterations/s {niter / sampling:.2f} sampling only "
        f"({niter / tim['process']:.2f} with flushes); baseline-iterations/s "
        f"{rate:.1f}")
    host = host_side(label, tim, len(jobs), niter)
    if profile_dir is not None:
        host.update(trace=trace_split(label, profile_dir))
    require(tim["device"].startswith("cuda"), "runner did not run on cuda")
    require(tim["engine"] == "megachain", f"{label}: ran {tim['engine']}")
    say(label, f"device audit: {audit.cuda_ops} cuda tensor ops, CPU "
        f"compute ops {dict(audit.cpu_ops) or 'none'}")
    require(not audit.cpu_ops and audit.cuda_ops > 0,
            "tensors of the path left the device")
    shapes = {"signal_cr": (niter, NT, nf), "signal_S": (nf, nf),
              "signal_ps": (niter, nf), "fg_amps": (niter, NT, NM),
              "chisq": (niter, NT, nf), "ln_post": (niter,)}
    for job in jobs:
        got = hio.load_samples(job.out_dir)
        for k, shape in shapes.items():
            require(k in got and got[k].shape == shape,
                    f"{job.out_dir}: {k} missing or wrong shape")
            require(np.isfinite(got[k]).all(), f"{job.out_dir}: {k} "
                    f"not finite")
    ck = hio.load_checkpoint(Path(jobs[0].out_dir).parent)
    require(ck is not None and ck["iteration"] == niter,
            f"{label}: no checkpoint at the last iteration")
    say(label, f"six reference files per baseline with the JAX runner's "
        f"shapes, all finite; checkpoint at iteration {niter}")
    chi2 = float(np.mean([r.chisq[burn:niter].mean() for r in results]))
    windows = [float(np.mean([r.chisq[w:w + 50].mean() for r in results]))
               for w in range(0, niter, 50)]
    say(label, f"mean chi^2 over iterations {burn + 1}-{niter}: {chi2:.5f} "
        f"(gate |chi^2 - 1| <= {CHI2_GATE}); by 50-iteration window "
        f"{[round(c, 5) for c in windows]}")
    require(abs(chi2 - 1.0) <= CHI2_GATE, f"{label} chi^2 gate")
    truth = ps_truth(nf)
    delay = np.abs(np.arange(nf) - nf // 2)
    eor = (delay >= 4) & (delay <= 16)
    ratio = np.median([r.signal_ps[burn:].mean(axis=0)[eor] / truth[eor]
                       for r in results])
    say(label, f"posterior-mean / truth on EoR bins 4 <= |delay| <= 16: "
        f"median {ratio:.4f} (information only)")
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    say(label, f"launches {launches}")
    require(not missing, f"kernels never launched on the {label} path: "
            f"{missing}")
    require(not any(launches[k] for k in NOT_ON_KEYED_PATHS),
            f"{label}: rng_fields launched on the keyed megachain path")
    stats = {"baselines": len(jobs), "niter": niter, "nfreqs": nf,
             "wall_s": wall, "build_s": tim["scatter"],
             "process_s": tim["process"], "flush_s": tim["write"],
             "baseline_iters_per_s": rate, "chi2": chi2,
             "chi2_burn": burn, "chi2_windows_50": windows,
             "host_side": host}
    return results, launches, rate, stats


def phase_main(dev, out_root):
    from hydra_pspec_torch import runner

    jobs = make_jobs(N_BASELINES, out_root)
    results, launches, rate, stats = run_megachain_path(
        "main", dev, jobs, NF, profile_dir=out_root / "main-trace")
    return jobs, results, launches, rate, stats["host_side"]


# --- cli ---------------------------------------------------------------------

# the JAX CLI's artifact keys (hydra_pspec_tpu/utils/provenance.py)
CLI_JSON_KEYS = {
    "git.json": {"git_origin", "git_hash", "git_description", "git_branch"},
    "timings.json": {"num_ranks", "num_baselines", "rank_0_timers",
                     "write_data"},
    "resources.json": {"ru_maxrss", "ru_utime", "ru_stime"},
}
RANK0_TIMERS = {"load_data", "scatter", "process", "barrier", "total"}


def differing_files(dir_a, dir_b, jobs):
    """The sample files of ``jobs`` that differ, byte for byte, between
    two results directories."""
    from hydra_pspec_torch.utils.io import SAMPLE_FILENAMES

    bad = []
    for j in jobs:
        bl = f"{j.antpair[0]}-{j.antpair[1]}"
        for name in SAMPLE_FILENAMES.values():
            if not filecmp.cmp(Path(dir_a) / bl / name,
                               Path(dir_b) / bl / name, shallow=False):
                bad.append(f"{bl}/{name}")
    return bad


def phase_cli(dev, jobs_main, out_root):
    """The production entry point after the load: ``cli.run.run_jobs`` on
    the main phase's jobs with a RunConfig made from flags (no yaml, no
    h5py), CLI_NITER iterations in chunks of CLI_WRITE_NITER (each of the
    two graph slots replayed twice), with the runner's trace. Gates: the
    JAX CLI's artifacts and keys, the native writer, the pinned copies in
    the trace, chi^2 within 2 %, every main kernel launched, the
    checkpoint at CLI_NITER, every file bit-identical to the same chunks
    run eagerly with synchronous copies (``overlap=False``), and to a run
    stopped at CLI_RESUME_AT and resumed. As information: whether chunks
    of CLI_WRITE_NITER and of 2 x CLI_WRITE_NITER give the same bits."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.cli import run as cli
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.utils import io as hio
    from hydra_pspec_torch.utils.config import RunConfig

    prior = make_prior()
    lo, hi = prior[1][prior[1] > 0].min(), prior[0].max()
    flags = dict(Niter=CLI_NITER, write_Niter=CLI_WRITE_NITER, store_cr=True,
                 seed=SEED, out_dir=str(out_root), dirname="cli",
                 n_ps_prior_bins=PRIOR_HALF, ps_prior_lo=float(lo),
                 ps_prior_hi=float(hi), warm_ns=3, drift_max=0.6,
                 profile_dir=str(out_root / "cli-trace"))
    cfg = RunConfig.from_dict(flags)

    def run(cfg):
        out = cli.output_dir(cfg)
        jobs = [dataclasses.replace(j, out_dir=out / f"{a}-{b}")
                for j in jobs_main for a, b in [j.antpair]]
        t0 = time.perf_counter()
        results, tim = cli.run_jobs(cfg, jobs, NF, len(jobs), 0.0, out,
                                    device=dev)
        sync(dev)
        return out, jobs, results, tim, time.perf_counter() - t0

    _build.reset_launches()
    out, jobs, results, tim, wall = run(cfg)
    launches = dict(_build.LAUNCHES)
    say("cli", f"run_jobs: {len(jobs)} baselines x {CLI_NITER} iterations "
        f"in chunks of {CLI_WRITE_NITER}: wall {wall:.2f} s, engine "
        f"{tim['engine']}, into {out.name}/")
    host = host_side("cli", tim, len(jobs), CLI_NITER)
    host.update(trace=trace_split("cli", cfg.profile_dir), wall_s=wall)
    for name, keys in CLI_JSON_KEYS.items():
        got = json.loads((out / name).read_text())
        require(set(got) == keys, f"cli: {name} keys {sorted(got)}")
    tj = json.loads((out / "timings.json").read_text())
    require(set(tj["rank_0_timers"]) == RANK0_TIMERS
            and len(tj["write_data"][0]["ant_pairs"]) == len(jobs),
            "cli: timings.json does not follow the reference schema")
    args = json.loads((out / "args.json").read_text())
    require(set(args) == {f.name for f in dataclasses.fields(RunConfig)},
            "cli: args.json keys are not RunConfig's")
    ck = hio.load_checkpoint(out)
    require(ck is not None and ck["iteration"] == CLI_NITER,
            "cli: no checkpoint at the last iteration")
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    require(tim["engine"] == "megachain" and not missing,
            f"cli: engine {tim['engine']}, kernels never launched {missing}")
    chi2 = float(np.mean([r.chisq[50:].mean() for r in results]))
    del results
    say("cli", f"git.json, args.json, timings.json, resources.json with "
        f"the JAX CLI's keys; checkpoint at {CLI_NITER}; launches "
        f"{launches}; mean chi^2 over iterations 51-{CLI_NITER}: "
        f"{chi2:.5f} (gate |chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "cli chi^2 gate")

    # the same chunks, eagerly, with synchronous copies and a serial loop
    eager = out_root / "eager"
    ejobs = [dataclasses.replace(j, out_dir=eager / j.out_dir.name)
             for j in jobs]
    t0 = time.perf_counter()
    _, etim = runner.run_baselines(
        ejobs, cli.build_prior(cfg, NF), CLI_NITER, device=dev, seed=SEED,
        write_niter=CLI_WRITE_NITER, store_cr=True, warm_ns=3,
        drift_max=0.6, overlap=False)
    sync(dev)
    ewall = time.perf_counter() - t0
    eager_host = host_side("cli eager", etim, len(jobs), CLI_NITER)
    eager_host.update(wall_s=ewall)
    bad = differing_files(out, eager, jobs)
    say("cli", f"eager serial run (overlap=False): wall {ewall:.2f} s; "
        f"files differing from the overlapped graph run: {len(bad)} of "
        f"{6 * len(jobs)}")
    require(not bad, f"cli: files differ from the eager run: {bad[:5]}")
    shutil.rmtree(eager)

    # stopped at CLI_RESUME_AT, resumed to CLI_NITER
    part = dataclasses.replace(cfg, dirname="cli-resume",
                               Niter=CLI_RESUME_AT, profile_dir=None)
    run(part)
    res_out, _, _, rtim, _ = run(dataclasses.replace(part, Niter=CLI_NITER,
                                                     resume=True))
    bad = differing_files(out, res_out, jobs)
    say("cli", f"stopped at {CLI_RESUME_AT}, resumed from "
        f"{rtim['start_iter']} to {CLI_NITER}: files differing "
        f"{len(bad)} of {6 * len(jobs)}")
    require(rtim["start_iter"] == CLI_RESUME_AT and not bad,
            f"cli: the resumed run differs: {bad[:5]}")
    shutil.rmtree(res_out)

    # information: does a coarser chunking give the same bits?
    coarse, *_ = run(dataclasses.replace(
        cfg, dirname="cli-coarse", write_Niter=2 * CLI_WRITE_NITER,
        profile_dir=None))
    bad = differing_files(out, coarse, jobs)
    say("cli", f"write_Niter {2 * CLI_WRITE_NITER} against "
        f"{CLI_WRITE_NITER}: {len(bad)} of {6 * len(jobs)} files differ "
        f"(information only: the warm start rebuilds every inverse at a "
        f"chunk's first iteration)")
    shutil.rmtree(coarse)
    shutil.rmtree(out)
    return {"niter": CLI_NITER, "write_niter": CLI_WRITE_NITER,
            "chi2": chi2, "launches": launches, "host_side": host,
            "eager_host_side": eager_host,
            "coarse_chunking_files_differing": len(bad)}


# --- 6. invariance -----------------------------------------------------------

def subset_identical(label, dev, jobs, nf, niter=NITER,
                     write_niter=WRITE_NITER):
    """The first :data:`N_SUBSET` baselines alone give dps-eor files
    bit-identical to the full run's; returns their jobs without files."""
    from hydra_pspec_torch import runner

    sub = [dataclasses.replace(j, out_dir=None) for j in jobs[:N_SUBSET]]
    res, _ = runner.run_baselines(
        sub, make_prior(nf=nf), niter, device=dev, seed=SEED,
        write_niter=write_niter, store_cr=True, warm_ns=3, drift_max=0.6,
        global_baseline_ids=list(range(N_SUBSET)))
    for j, r in zip(jobs, res):
        dps = np.load(Path(j.out_dir) / "dps-eor.npy")
        require(np.array_equal(dps, r.signal_ps),
                f"baseline {j.antpair}: dps-eor differs in the subset run")
    say(label, f"first {N_SUBSET} baselines alone: dps-eor bit-identical "
        f"to the {len(jobs)}-baseline run")
    return sub


def phase_invariance(dev, jobs, results):
    from hydra_pspec_torch import runner

    sub = subset_identical("invariance", dev, jobs, NF)
    none = np.zeros((NT, NF), dtype=bool)
    res_tf, tim = runner.run_baselines(
        [dataclasses.replace(j, flags_tf=none) for j in sub], make_prior(),
        NITER, device=dev, seed=SEED, write_niter=WRITE_NITER,
        store_cr=True, warm_ns=3, drift_max=0.6,
        global_baseline_ids=list(range(N_SUBSET)))
    for j, r in zip(jobs, res_tf):
        dps = np.load(Path(j.out_dir) / "dps-eor.npy")
        require(np.array_equal(dps, r.signal_ps),
                f"baseline {j.antpair}: all-False flags_tf changes dps-eor")
    say("invariance", f"the same {N_SUBSET} with all-False flags_tf "
        f"(grouped path, G=1): dps-eor bit-identical to the plain run")


# --- 7. tflags ---------------------------------------------------------------

def phase_tflags(dev, jobs_plain, out_root):
    """The main path's data with time-dependent RFI flags, through the
    grouped time-flags path of run_baselines."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.utils import io as hio

    n_a = min(N_SIG_A, len(jobs_plain))
    jobs = [dataclasses.replace(j, out_dir=out_root / Path(j.out_dir).name)
            for j in make_tflags_jobs(jobs_plain, n_a)]
    audit = _DeviceAudit()
    _build.reset_launches()
    t0 = time.perf_counter()
    with audit:
        results, tim = runner.run_baselines(
            jobs, make_prior(), NITER, device=dev, seed=SEED,
            write_niter=WRITE_NITER, store_cr=True, warm_ns=3,
            drift_max=0.6)
    sync(dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    sampling = tim["process"] - tim["write"]
    rate = len(jobs) * NITER / sampling
    stats = {"build_s": tim["scatter"], "process_s": tim["process"],
             "flush_s": tim["write"], "wall_s": wall,
             "baseline_iters_per_s": rate}
    say("tflags", f"{len(jobs)} baselines ({n_a} signature A, G=3; "
        f"{len(jobs) - n_a} signature B, G=2) x {NITER} iterations: wall "
        f"{wall:.2f} s, host build+transfer {tim['scatter']:.2f} s, process "
        f"{tim['process']:.2f} s (flush {tim['write']:.2f} s)")
    say("tflags", f"iterations/s {NITER / sampling:.2f} sampling only; "
        f"baseline-iterations/s {rate:.1f}")
    require(tim["device"].startswith("cuda"), "runner did not run on cuda")
    say("tflags", f"device audit: {audit.cuda_ops} cuda tensor ops, CPU "
        f"compute ops {dict(audit.cpu_ops) or 'none'}")
    require(not audit.cpu_ops and audit.cuda_ops > 0,
            "tensors of the tflags path left the device")
    shapes = {"signal_cr": (NITER, NT, NF), "signal_S": (NF, NF),
              "signal_ps": (NITER, NF), "fg_amps": (NITER, NT, NM),
              "chisq": (NITER, NT, NF), "ln_post": (NITER,)}
    for job in jobs:
        got = hio.load_samples(job.out_dir)
        for k, shape in shapes.items():
            require(k in got and got[k].shape == shape,
                    f"{job.out_dir}: {k} missing or wrong shape")
            require(np.isfinite(got[k]).all(), f"{job.out_dir}: {k} "
                    f"not finite")
    say("tflags", "six reference files per baseline with the JAX runner's "
        "shapes, all finite")
    burn = min(50, NITER // 4)
    chi2 = float(np.mean([r.chisq[burn:NITER][:, ~j.flags_tf].mean()
                          for j, r in zip(jobs, results)]))
    say("tflags", f"mean chi^2 over unflagged (time, channel) entries, "
        f"iterations {burn + 1}-{NITER}: {chi2:.5f} (gate |chi^2 - 1| <= "
        f"{CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "tflags chi^2 gate")
    truth = ps_truth()
    delay = np.abs(np.arange(NF) - NF // 2)
    eor = (delay >= 4) & (delay <= 16)
    ratio = np.median([r.signal_ps[burn:].mean(axis=0)[eor] / truth[eor]
                       for r in results])
    say("tflags", f"posterior-mean / truth on EoR bins 4 <= |delay| <= 16: "
        f"median {ratio:.4f} (information only)")
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    say("tflags", f"launches {launches}")
    require(not missing, f"kernels never launched on the tflags path: "
            f"{missing}")
    require(not any(launches[k] for k in NOT_ON_KEYED_PATHS),
            "tflags: rng_fields launched on the keyed megachain path")

    nsub = min(N_SUBSET, n_a)
    sub = [dataclasses.replace(j, out_dir=None) for j in jobs[:nsub]]
    res_sub, _ = runner.run_baselines(
        sub, make_prior(), NITER, device=dev, seed=SEED,
        write_niter=WRITE_NITER, store_cr=True, warm_ns=3, drift_max=0.6,
        global_baseline_ids=list(range(nsub)))
    for a, b in zip(results[:nsub], res_sub):
        for f in ("signal_ps", "signal_cr", "fg_amps", "chisq", "ln_post"):
            require(np.array_equal(getattr(a, f), getattr(b, f)),
                    f"baseline {a.antpair}: {f} differs in the subset run")
    say("tflags", f"first {nsub} baselines of signature A alone: all six "
        f"sample arrays bit-identical")
    return launches, stats


# --- 8. fallback engines -----------------------------------------------------

def _rel_err(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).mean() + 1e-30))


def _chi2_unflagged(results, flags, lo, hi):
    return float(np.mean([r.chisq[lo:hi][:, ~flags].mean() for r in results]))


def drive(dev, launches, stats, label, kernels, engine, jobs, niter,
          prior=None, **kw):
    """run_baselines on ``jobs``, routed to ``engine``, under the device
    audit, with the launch counts set to 0 just before and read just
    after into ``launches[label]``; every kernel of ``kernels`` must have
    launched. Its timings go to ``stats[label]``."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build

    prior = make_prior() if prior is None else prior
    want = runner.route_engine(jobs, prior, kw.get("engine", "auto"),
                               kw.get("map_estimate", False))
    require(want == engine, f"{label}: routed to {want}, not {engine}")
    audit = _DeviceAudit()
    _build.reset_launches()
    t0 = time.perf_counter()
    with audit:
        res, tim = runner.run_baselines(jobs, prior, niter, device=dev,
                                        seed=SEED, **kw)
    sync(dev)
    wall = time.perf_counter() - t0
    got = dict(_build.LAUNCHES)
    launches[label] = got
    sampling = tim["process"] - tim["write"]
    stats[label] = {"engine": tim["engine"], "baselines": len(jobs),
                    "nfreqs": jobs[0].d.shape[1], "niter": tim["niter"],
                    "wall_s": wall, "build_s": tim["scatter"],
                    "process_s": tim["process"], "flush_s": tim["write"],
                    "baseline_iters_per_s": len(jobs) * tim["niter"]
                    / sampling}
    phase = "wideband" if label.startswith("wide") else "fallback"
    say(phase, f"{label}: engine {tim['engine']}, {len(jobs)} baselines x "
        f"{tim['niter']} iterations at {jobs[0].d.shape[1]} channels, wall "
        f"{wall:.2f} s, build+transfer {tim['scatter']:.2f} s, process "
        f"{tim['process']:.2f} s (write {tim['write']:.2f} s), "
        f"baseline-iterations/s {stats[label]['baseline_iters_per_s']:.1f}")
    say(phase, f"{label}: launches {({k: got[k] for k in kernels})}; "
        f"device audit {audit.cuda_ops} cuda tensor ops, CPU compute ops "
        f"{dict(audit.cpu_ops) or 'none'}")
    require(tim["engine"] == engine, f"{label}: ran {tim['engine']}")
    require(not audit.cpu_ops and audit.cuda_ops > 0,
            f"{label}: tensors of the path left the device")
    missing = [k for k in kernels if got[k] == 0]
    require(not missing, f"{label}: never launched: {missing}")
    if engine != "real":
        require(not any(got[k] for k in NOT_ON_KEYED_PATHS),
                f"{label}: rng_fields launched on the keyed {engine} path")
    return res, tim


def whitened_chi2(jobs, niter, burn):
    """Mean of r^H Ninv r / (Ntimes Nfreqs) over ``jobs`` from their
    written samples, iterations after ``burn``."""
    from hydra_pspec_torch.utils import io as hio

    white = []
    for j in jobs:
        nt, nf = j.d.shape
        got = hio.load_samples(j.out_dir)
        require(got["signal_cr"].shape == (niter, nt, nf)
                and np.isfinite(got["signal_cr"]).all(),
                f"{j.out_dir}: signal_cr")
        r = (j.d[None] - got["signal_cr"][burn:]
             - got["fg_amps"][burn:] @ j.fgmodes.T).reshape(-1, nf)
        white.append(float(np.sum((r.conj() * (r @ j.Ninv.T)).real))
                     / (r.shape[0] * nf))
    return float(np.mean(white))


def phase_fallback(dev, jobs_plain, out_root):
    """The engines run_baselines routes away from megachain, each driven
    through run_baselines with the launch counts set to 0 just before and
    read just after, under the device audit."""
    import functools

    from hydra_pspec_torch import runner
    from hydra_pspec_torch.utils import io as hio

    launches, stats = {}, {}
    plain_jobs = [dataclasses.replace(j, out_dir=None) for j in jobs_plain]
    run = functools.partial(drive, dev, launches, stats)

    # a dense Ninv at full width: the real engine, the factor-solve kernel
    dense = make_jobs(len(jobs_plain), out_root / "dense", dense=True,
                      seed=SEED + 3)
    res, _ = run("dense", REAL_KERNELS, "real", dense, NITER,
                   write_niter=WRITE_NITER, store_cr=True)
    ck = hio.load_checkpoint(Path(dense[0].out_dir).parent)
    require(ck is not None and ck["iteration"] == NITER,
            "dense: no checkpoint at the last iteration")
    burn = min(50, NITER // 4)
    chi2_w = whitened_chi2(dense, NITER, burn)
    chi2_d = float(np.mean([r.chisq[burn:].mean() for r in res]))
    say("fallback", f"dense: whitened chi^2 r^H Ninv r / (Ntimes Nfreqs) "
        f"from the written samples, iterations {burn + 1}-{NITER}: "
        f"{chi2_w:.5f} (gate |chi^2 - 1| <= {CHI2_GATE}); diagonal chisq "
        f"mean {chi2_d:.5f} (information only)")
    require(abs(chi2_w - 1.0) <= CHI2_GATE, "dense whitened chi^2 gate")
    stats["dense"].update(whitened_chi2=chi2_w, diag_chisq=chi2_d)
    del res

    # solver="pallas2": herm_inv and the hermitian_solve entry
    sub = [dataclasses.replace(j, out_dir=None) for j in dense[:N_PALLAS2]]
    res, _ = run("pallas2", PALLAS2_KERNELS, "real", sub, PALLAS2_NITER,
                   write_niter=PALLAS2_NITER, solver="pallas2",
                   global_baseline_ids=list(range(N_PALLAS2)))
    chi2 = float(np.mean([r.chisq[PALLAS2_NITER // 2:].mean() for r in res]))
    say("fallback", f"pallas2: diagonal chisq mean, second half "
        f"{chi2:.5f}, finite: {bool(np.isfinite(chi2))}")
    require(np.isfinite(chi2), "pallas2 chi^2 not finite")
    stats["pallas2"].update(diag_chisq=chi2)

    # MAP mode: the real engine, against the same run on the CPU
    sub = plain_jobs[:N_MAP]
    res, _ = run("map", ("cgemm", "herm_chol_solve", "row_scale_sumsq",
                           "bandpower"), "real", sub, NITER,
                   map_estimate=True, global_baseline_ids=list(range(N_MAP)))
    res_cpu, tim_cpu = runner.run_baselines(
        sub, make_prior(), NITER, device="cpu", seed=SEED, map_estimate=True,
        global_baseline_ids=list(range(N_MAP)))
    require(tim_cpu["engine"] == "real", "map: the CPU run not on real")
    err = max(_rel_err(getattr(a, f), getattr(b, f))
              for a, b in zip(res, res_cpu)
              for f in ("signal_cr", "fg_amps", "signal_ps", "ln_post"))
    say("fallback", f"map: one iteration, card against CPU: max |diff| / "
        f"mean |CPU| {err:.2e} <= 3e-3 over signal_cr, fg_amps, ps, ln_post")
    require(err <= 3e-3 and res[0].signal_ps.shape == (1, NF),
            "map: card and CPU disagree")
    stats["map"].update(card_vs_cpu=err)

    # more than 8 flag patterns: the grouped real path
    flags = rfi_windows()
    tf = [dataclasses.replace(j, d=j.d + RFI * flags, flags_tf=flags)
          for j in plain_jobs[:N_TF_REAL]]
    res, _ = run("tflags_real", REAL_KERNELS, "real", tf, TF_REAL_NITER,
                   write_niter=TF_REAL_NITER, store_cr=True)
    require(launches["tflags_real"]["rng_fields"] == TF_REAL_NITER,
            f"tflags_real: {launches['tflags_real']['rng_fields']} "
            f"rng_fields launches in {TF_REAL_NITER} iterations, not one an "
            f"iteration")
    burn = TF_REAL_NITER // 2
    chi2 = _chi2_unflagged(res, flags, burn, TF_REAL_NITER)
    say("fallback", f"tflags_real: 11 flag patterns; mean chi^2 over "
        f"unflagged entries, iterations {burn + 1}-{TF_REAL_NITER}: "
        f"{chi2:.5f} (gate |chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "tflags_real chi^2 gate")
    stats["tflags_real"].update(chi2_unflagged=chi2)
    res_sub, _ = runner.run_baselines(
        tf[:N_TF_SUB], make_prior(), TF_REAL_NITER, device=dev, seed=SEED,
        write_niter=TF_REAL_NITER, global_baseline_ids=list(range(N_TF_SUB)))
    for a, b in zip(res[:N_TF_SUB], res_sub):
        for f in ("signal_ps", "signal_cr", "fg_amps", "chisq", "ln_post"):
            require(np.array_equal(getattr(a, f), getattr(b, f)),
                    f"tflags_real: {a.antpair} {f} differs in the subset run")
    say("fallback", f"tflags_real: first {N_TF_SUB} baselines alone: all six "
        f"sample arrays bit-identical")
    none = np.zeros((NT, NF), dtype=bool)
    kw = dict(device=dev, seed=SEED, write_niter=MEGA_EQ_NITER,
              engine="real", global_baseline_ids=list(range(N_TF_SUB)))
    res_none, tim = runner.run_baselines(
        [dataclasses.replace(j, flags_tf=none) for j in plain_jobs[:N_TF_SUB]],
        make_prior(), MEGA_EQ_NITER, **kw)
    res_pl, _ = runner.run_baselines(plain_jobs[:N_TF_SUB], make_prior(),
                                     MEGA_EQ_NITER, **kw)
    require(tim["engine"] == "real", "all-False flags: not the real engine")
    for a, b in zip(res_none, res_pl):
        require(np.array_equal(a.signal_ps, b.signal_ps),
                f"{a.antpair}: all-False flags change dps-eor on real")
    say("fallback", f"real engine, {N_TF_SUB} baselines: all-False flags_tf "
        f"(grouped path, one pattern) dps-eor bit-identical to no flags")

    # the single-step mega engine: more than 8 bins, a long night
    res, _ = run("mega", MEGA_KERNELS, "mega", plain_jobs, MEGA_NITER,
                   prior=make_prior(MEGA_HALF), write_niter=MEGA_NITER,
                   store_cr=False)
    burn = MEGA_NITER // 2
    chi2 = float(np.mean([r.chisq[burn:].mean() for r in res]))
    say("fallback", f"mega: {2 * MEGA_HALF + 1} bounded prior bins; mean "
        f"chi^2 over iterations {burn + 1}-{MEGA_NITER}: {chi2:.5f} (gate "
        f"|chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "mega chi^2 gate")
    stats["mega"].update(chi2=chi2)
    long = make_jobs(N_LONG, ntimes=LONG_NT, seed=SEED + 5)
    res, _ = run("mega_long", MEGA_KERNELS, "mega", long, LONG_NITER,
                   write_niter=LONG_NITER, store_cr=False)
    burn = LONG_NITER // 2
    chi2 = float(np.mean([r.chisq[burn:].mean() for r in res]))
    say("fallback", f"mega_long: {LONG_NT} times; mean chi^2 over "
        f"iterations {burn + 1}-{LONG_NITER}: {chi2:.5f} (gate |chi^2 - 1| "
        f"<= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "mega_long chi^2 gate")
    stats["mega_long"].update(chi2=chi2)
    sub = plain_jobs[:N_MEGA_EQ]
    kw = dict(device=dev, seed=SEED, write_niter=MEGA_EQ_NITER,
              store_cr=True, global_baseline_ids=list(range(N_MEGA_EQ)))
    res_m, tim_m = runner.run_baselines(sub, make_prior(), MEGA_EQ_NITER,
                                        engine="mega", **kw)
    res_c, tim_c = runner.run_baselines(sub, make_prior(), MEGA_EQ_NITER,
                                        engine="megachain", warm_ns=0, **kw)
    require((tim_m["engine"], tim_c["engine"]) == ("mega", "megachain"),
            "mega/megachain comparison routed elsewhere")
    diff = max(_rel_err(getattr(a, f), getattr(b, f))
               for a, b in zip(res_m, res_c)
               for f in ("signal_ps", "signal_cr", "fg_amps", "chisq",
                         "ln_post"))
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               for a, b in zip(res_m, res_c)
               for f in ("signal_ps", "signal_cr", "fg_amps", "chisq",
                         "ln_post"))
    say("fallback", f"mega vs megachain (warm_ns=0), 7 bins, {N_MEGA_EQ} x "
        f"{MEGA_EQ_NITER}: bit-identical {same} (max |diff| / mean "
        f"{diff:.2e}; the CPU runs are bit-identical)")
    require(same, "mega and megachain (warm_ns=0) differ")
    return launches, stats, dense


# --- the wide band ------------------------------------------------------------

def phase_wideband(dev, out_root):
    """The model-drawn data at 203 times x 180 channels: megachain (n = 180,
    one herm_inv launch on the lower tiles an iteration: the warm start's
    gated rebuild), a dense Ninv on the real engine (one herm_chol_solve
    launch a solve), solver="pallas2" and the mega engine (one herm_inv
    launch every iteration). Each run with the launch counts set to 0
    just before and read just after."""
    from hydra_pspec_torch import runner

    nf = WIDE_NF
    depth = dict(niter=WIDE_NITER, write_niter=WIDE_WRITE_NITER)
    jobs = make_jobs(N_BASELINES, out_root / "megachain", nf=nf,
                     seed=SEED + 20)
    results, mc_launches, _, mc_stats = run_megachain_path(
        "wideband", dev, jobs, nf, burn=WIDE_BURN, **depth)
    del results
    say("wideband", f"wide_megachain: herm_inv {mc_launches['herm_inv']} "
        f"launches = 1 an iteration x {WIDE_NITER}")
    require(mc_launches["herm_inv"] == WIDE_NITER,
            "wideband: herm_inv not one launch a rebuild")
    subset_identical("wideband", dev, jobs, nf, **depth)
    launches, stats = {"wide_megachain": mc_launches}, {
        "wide_megachain": mc_stats}
    run = functools.partial(drive, dev, launches, stats)

    dense = make_jobs(N_WIDE_DENSE, out_root / "dense", dense=True,
                      seed=SEED + 21, nf=nf)
    run("wide_dense", REAL_KERNELS, "real", dense, WIDE_NITER,
        prior=make_prior(nf=nf), write_niter=WIDE_NITER, store_cr=True)
    got = launches["wide_dense"]["herm_chol_solve"]
    say("wideband", f"wide_dense: herm_chol_solve {got} launches = 1 a "
        f"solve x {WIDE_NITER}")
    require(got == WIDE_NITER,
            "wide_dense: the factor-solve not one launch a solve")
    chi2_w = whitened_chi2(dense, WIDE_NITER, WIDE_BURN)
    say("wideband", f"wide_dense: whitened chi^2 r^H Ninv r / (Ntimes "
        f"Nfreqs), iterations {WIDE_BURN + 1}-{WIDE_NITER}: {chi2_w:.5f} "
        f"(gate |chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2_w - 1.0) <= CHI2_GATE, "wide_dense whitened chi^2")
    stats["wide_dense"].update(whitened_chi2=chi2_w)

    sub = [dataclasses.replace(j, out_dir=None)
           for j in dense[:N_WIDE_PALLAS2]]
    res, _ = run("wide_pallas2", PALLAS2_KERNELS, "real", sub,
                 WIDE_PALLAS2_NITER, prior=make_prior(nf=nf),
                 write_niter=WIDE_PALLAS2_NITER, solver="pallas2",
                 global_baseline_ids=list(range(N_WIDE_PALLAS2)))
    got = launches["wide_pallas2"]
    require(got["herm_inv"] == got["hermitian_solve"],
            "wide_pallas2: herm_inv not one launch a solve")
    chi2 = float(np.mean([r.chisq[WIDE_PALLAS2_NITER // 2:].mean()
                          for r in res]))
    say("wideband", f"wide_pallas2: herm_inv {got['herm_inv']} "
        f"launches for {got['hermitian_solve']} solves; diagonal chisq "
        f"mean, second half {chi2:.5f}, finite: {bool(np.isfinite(chi2))}")
    require(np.isfinite(chi2), "wide_pallas2 chi^2 not finite")
    stats["wide_pallas2"].update(diag_chisq=chi2)

    plain = [dataclasses.replace(j, out_dir=None)
             for j in jobs[:N_WIDE_MEGA]]
    res, _ = run("wide_mega", MEGA_KERNELS, "mega", plain, WIDE_NITER,
                 prior=make_prior(MEGA_HALF, nf), write_niter=WIDE_NITER,
                 store_cr=False)
    got = launches["wide_mega"]["herm_inv"]
    require(got == WIDE_NITER,
            "wide_mega: herm_inv not one launch every iteration")
    chi2 = float(np.mean([r.chisq[WIDE_BURN:].mean() for r in res]))
    say("wideband", f"wide_mega: {2 * MEGA_HALF + 1} bounded prior bins, "
        f"herm_inv {got} launches (1 an iteration); mean chi^2 over "
        f"iterations {WIDE_BURN + 1}-{WIDE_NITER}: {chi2:.5f} (gate "
        f"|chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "wide_mega chi^2 gate")
    stats["wide_mega"].update(chi2=chi2)
    return launches, stats


# --- oracle: the posterior gate (hydra_pspec_torch/validation/validate.py) ---

def phase_oracle(dev):
    """Each engine's chains against the committed synthetic oracle
    (``validation/oracle_posterior_synth.json``) through
    ``validate.validate``, with the launch counts set to 0 just before
    each run and read just after: chi^2 within 2 %, split-R-hat <= 1.1 and
    ``oracle_acceptance``; any failed gate fails the phase."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.validation import synth
    from hydra_pspec_torch.validation import validate as V

    runs = (("megachain", None, ORACLE_NITER, MAIN_KERNELS),
            ("megachain", synth.FLAG_CHANNELS, ORACLE_NITER, MAIN_KERNELS),
            ("mega", None, ORACLE_NITER, MEGA_KERNELS),
            ("real", None, ORACLE_REAL_NITER, REAL_KERNELS))
    stats, launches, failed = {}, {}, []
    for engine, flags, niter, kernels in runs:
        _build.reset_launches()
        v = V.validate(engine, flag_channels=flags, nchains=ORACLE_NCHAINS,
                       niter=niter, nburn=ORACLE_NBURN, device=dev)
        sync(dev)
        label = V.label_of(v)
        launches[label] = got = dict(_build.LAUNCHES)
        stats[label] = oracle_line("oracle", label, v)
        missing = [k for k in kernels if got[k] == 0]
        require(not missing, f"oracle {label}: never launched: {missing}")
        if not v["pass"]:
            failed.append(label)
    require(not failed, f"oracle: gates failed for {failed}")
    return stats, launches


def oracle_line(phase, label, v):
    """Print one validation verdict; return its numbers."""
    c = v["oracle_compare"]
    out = {"niter": v["niter"], "nburn": v["nburn"],
           "nchains": v["nchains"], "wall_s": v["wall_s"],
           "max_z": c["max_z"], "n_z_gt3": c["n_z_gt3"],
           "ci_cover": c["ci_cover_frac"], "min_ess": c["min_ess_ours"],
           "split_rhat_max": v["split_rhat_max"],
           "chisq": v["chisq_postburn_mean"], "gates": v["gates"],
           "pass": v["pass"]}
    say(phase, f"{label}: {v['nchains']} chains x {v['niter']} iterations "
        f"(burn {v['nburn']}): max_z {c['max_z']} (< 4.5), n_z_gt3 "
        f"{c['n_z_gt3']} (<= 5), ci_cover {c['ci_cover_frac']} (>= 0.95), "
        f"min ESS {c['min_ess_ours']}, split-R-hat max "
        f"{v['split_rhat_max']} (<= 1.1), chi^2 {v['chisq_postburn_mean']}"
        f" (within 2 %), wall {v['wall_s']} s: "
        f"{'pass' if v['pass'] else 'FAIL'} {v['gates']}")
    return out


# --- complex: the complex float64 engine behind precision x64 -------------------

def chain_files_differing(dir_a, dir_b, jobs, nchains):
    """The sample files of ``jobs``' chains that differ between two results
    directories (``<bl>/chain-<c>/`` with more than one chain)."""
    from hydra_pspec_torch.utils.io import SAMPLE_FILENAMES

    bad = []
    for j in jobs:
        bl = f"{j.antpair[0]}-{j.antpair[1]}"
        for c in range(nchains):
            sub = f"{bl}/chain-{c}" if nchains > 1 else bl
            for name in SAMPLE_FILENAMES.values():
                if not filecmp.cmp(Path(dir_a) / sub / name,
                                   Path(dir_b) / sub / name, shallow=False):
                    bad.append(f"{sub}/{name}")
    return bad


def phase_complex(dev, jobs_main, out_root):
    """``precision x64`` through ``cli.run.run_jobs``: the complex float64
    engine on N_COMPLEX of the main jobs x COMPLEX_NCHAINS chains,
    COMPLEX_NITER iterations in chunks of COMPLEX_WRITE_NITER with files
    and checkpoint, its launch counts read (no hand-written kernel lies on
    this path). Gates: the float64 Philox words on the card equal the CPU
    twin's; complex128 samples; chi^2 within 2 %; the first 2 baselines
    alone and a run stopped at COMPLEX_RESUME_AT and resumed give
    bit-identical files; N_COMPLEX_TF jobs with the tflags phase's
    signature A on the complex time-flags path, chi^2 on unflagged entries
    within 2 %; then the oracle gate on the complex engine."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.cli import run as cli
    from hydra_pspec_torch.ops import philox
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.utils import io as hio
    from hydra_pspec_torch.utils.config import RunConfig
    from hydra_pspec_torch.validation import validate as V

    sids = torch.arange(COMPLEX_NCHAINS * N_COMPLEX, dtype=torch.int32)
    ctr = philox._layout64(NT, NF, NT - 1, 7, "cpu")
    words = [philox.philox4x32(37, *(c.to(dev) if d else c for c in ctr),
                               SEED, (sids.to(dev) if d else sids)[:, None])
             for d in (True, False)]
    require(all(torch.equal(a.cpu(), b) for a, b in zip(*words)),
            "complex: float64 Philox words on the card differ from the twin")
    got = philox.draws64(SEED, sids.to(dev), 37, NT, NF, NT - 1, 7)
    want = philox.draws64(SEED, sids, 37, NT, NF, NT - 1, 7)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(got, want))
    say("complex", f"float64 Philox: {words[0][0].numel()} x 4 words "
        f"bit-identical to the CPU twin; draws within {err:.2e}")
    require(err < 1e-9, "complex: float64 draws differ from the twin")

    prior = make_prior()
    lo, hi = prior[1][prior[1] > 0].min(), prior[0].max()
    cfg = RunConfig.from_dict(dict(
        Niter=COMPLEX_NITER, write_Niter=COMPLEX_WRITE_NITER, store_cr=True,
        seed=SEED, nchains=COMPLEX_NCHAINS, precision="x64",
        out_dir=str(out_root), dirname="complex", n_ps_prior_bins=PRIOR_HALF,
        ps_prior_lo=float(lo), ps_prior_hi=float(hi)))
    base = jobs_main[:N_COMPLEX]

    def run(cfg, jobs):
        out = cli.output_dir(cfg)
        jobs = [dataclasses.replace(j, out_dir=out / f"{a}-{b}")
                for j in jobs for a, b in [j.antpair]]
        t0 = time.perf_counter()
        res, tim = cli.run_jobs(cfg, jobs, NF, len(jobs), 0.0, out,
                                device=dev)
        sync(dev)
        return out, jobs, res, tim, time.perf_counter() - t0

    _build.reset_launches()
    out, jobs, results, tim, wall = run(cfg, base)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    nb = len(jobs) * COMPLEX_NCHAINS
    rate = nb * COMPLEX_NITER / (tim["process"] - tim["write"])
    say("complex", f"run_jobs precision x64: {len(jobs)} baselines x "
        f"{COMPLEX_NCHAINS} chains x {COMPLEX_NITER} iterations in chunks "
        f"of {COMPLEX_WRITE_NITER}: engine {tim['engine']}, wall {wall:.2f}"
        f" s, process {tim['process']:.2f} s (write {tim['write']:.2f} s), "
        f"sampling {1e3 / (rate / nb):.3f} ms an iteration at B = {nb}; "
        f"kernel launches {launches or 'none'}")
    require(tim["engine"] == "complex", f"complex: ran {tim['engine']}")
    s = hio.load_samples(jobs[0].out_dir / "chain-0")
    dtypes = {k: str(s[k].dtype) for k in ("signal_cr", "fg_amps",
                                            "signal_ps", "chisq")}
    require(dtypes == {"signal_cr": "complex128", "fg_amps": "complex128",
                       "signal_ps": "float64", "chisq": "float64"},
            f"complex: sample dtypes {dtypes}")
    ck = hio.load_checkpoint(out)
    require(ck is not None and ck["iteration"] == COMPLEX_NITER,
            "complex: no checkpoint at the last iteration")
    chi2 = float(np.mean([r.chisq[50:].mean() for r in results]))
    say("complex", f"samples {dtypes}; checkpoint at {COMPLEX_NITER}; mean "
        f"chi^2 over iterations 51-{COMPLEX_NITER}: {chi2:.5f} (gate "
        f"|chi^2 - 1| <= {CHI2_GATE})")
    require(abs(chi2 - 1.0) <= CHI2_GATE, "complex chi^2 gate")

    sub, *_ = run(dataclasses.replace(cfg, dirname="complex-subset"),
                  base[:2])
    bad = chain_files_differing(out, sub, jobs[:2], COMPLEX_NCHAINS)
    say("complex", f"first 2 baselines alone: {len(bad)} of "
        f"{6 * 2 * COMPLEX_NCHAINS} files differ")
    require(not bad, f"complex: the subset run differs: {bad[:5]}")
    part = dataclasses.replace(cfg, dirname="complex-resume",
                               Niter=COMPLEX_RESUME_AT)
    run(part, base)
    res_out, _, _, rtim, _ = run(dataclasses.replace(
        part, Niter=COMPLEX_NITER, resume=True), base)
    bad = chain_files_differing(out, res_out, jobs, COMPLEX_NCHAINS)
    say("complex", f"stopped at {COMPLEX_RESUME_AT}, resumed from "
        f"{rtim['start_iter']}: {len(bad)} of {6 * nb} files differ")
    require(rtim["start_iter"] == COMPLEX_RESUME_AT and not bad,
            f"complex: the resumed run differs: {bad[:5]}")
    for d in (out, sub, res_out):
        shutil.rmtree(d)

    tf_jobs = [dataclasses.replace(j, out_dir=None) for j in
               make_tflags_jobs(base[:N_COMPLEX_TF], N_COMPLEX_TF)]
    t0 = time.perf_counter()
    res_tf, tim_tf = runner.run_baselines(
        tf_jobs, prior, COMPLEX_NITER, device=dev, seed=SEED,
        write_niter=COMPLEX_WRITE_NITER, engine="complex")
    sync(dev)
    tf_wall = time.perf_counter() - t0
    chi2_tf = float(np.mean([r.chisq[50:][:, ~j.flags_tf].mean()
                             for j, r in zip(tf_jobs, res_tf)]))
    say("complex", f"time flags (signature A, 3 flag patterns), "
        f"{N_COMPLEX_TF} "
        f"baselines x {COMPLEX_NITER} on the complex path: wall "
        f"{tf_wall:.2f} s; chi^2 over unflagged entries, iterations "
        f"51-{COMPLEX_NITER}: {chi2_tf:.5f} (gate within {CHI2_GATE})")
    require(tim_tf["engine"] == "complex"
            and abs(chi2_tf - 1.0) <= CHI2_GATE, "complex tflags chi^2 gate")

    v = V.validate("complex", nchains=ORACLE_NCHAINS,
                   niter=COMPLEX_ORACLE_NITER, nburn=COMPLEX_ORACLE_NBURN,
                   device=dev)
    oracle = oracle_line("complex", V.label_of(v), v)
    require(v["pass"], "complex: the oracle gate failed")
    return {"baselines": len(jobs), "nchains": COMPLEX_NCHAINS,
            "niter": COMPLEX_NITER, "chi2": chi2, "dtypes": dtypes,
            "ms_per_iteration": 1e3 / (rate / nb), "batch": nb,
            "process_s": tim["process"], "write_s": tim["write"],
            "launches": launches, "tflags_chi2": chi2_tf,
            "tflags_wall_s": tf_wall, "oracle": oracle}


# --- multiproc: processes and device shards (parallel/dist.py) -------------

def _mp_config(out_root, dirname, niter, resume=False):
    """The multiproc phase's RunConfig (flags only, no yaml): the main
    seed and prior, MP_NCHAINS chains, chunks of MP_WRITE_NITER."""
    from hydra_pspec_torch.utils.config import RunConfig

    prior = make_prior()
    lo, hi = prior[1][prior[1] > 0].min(), prior[0].max()
    return RunConfig.from_dict(dict(
        Niter=niter, write_Niter=MP_WRITE_NITER, nchains=MP_NCHAINS,
        store_cr=True, seed=SEED, out_dir=str(out_root), dirname=dirname,
        n_ps_prior_bins=PRIOR_HALF, ps_prior_lo=float(lo),
        ps_prior_hi=float(hi), warm_ns=3, drift_max=0.6, resume=resume))


def _mp_jobs(jobs, cfg):
    """``jobs`` writing under ``cfg``'s results directory."""
    out = Path(cfg.out_dir) / cfg.dirname
    return [dataclasses.replace(j, out_dir=out / f"{a}-{b}")
            for j in jobs for a, b in [j.antpair]]


def multiproc_worker(rank, nranks, spec_path, out_path):
    """``python3 chip_smoke.py --multiproc RANK NRANKS SPEC OUT``: one rank
    of the multiproc phase's runs over NRANKS processes (two on one card;
    one a card under ``--multichip``; one for the one-process reference,
    with no group). SPEC (a pickle the phase wrote)
    holds each run's label, config, all jobs and its coordinator port;
    the rank joins each run's process group over gloo, takes its device
    (``dist.rank_device``), lets rank 0 create the results directory, runs
    its block (the block rule) through ``cli.run.run_jobs`` with the
    launch counts set to 0 just before and read just after, and writes
    its launches and timings to OUT as JSON."""
    import pickle

    from hydra_pspec_torch.cli import run as cli
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.parallel import dist
    from hydra_pspec_torch.parallel.partition import local_indices

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(spec_path, "rb") as f:
        runs = pickle.load(f)   # written by phase_multiproc
    _build.library()
    got = {}
    for label, cfg, jobs, port in runs:
        dist.initialize_distributed(f"localhost:{port}", nranks, rank)
        try:
            dev = dist.rank_device("cuda", rank)
            out = cli.output_dir(cfg, create=rank == 0)
            dist.barrier()
            ids = list(local_indices(len(jobs), rank, nranks))
            _build.reset_launches()
            _, tim = cli.run_jobs(
                cfg, [jobs[i] for i in ids], NF, len(jobs), 0.0, out,
                device=dev, global_baseline_ids=ids, process_id=rank,
                num_processes=nranks)
            sync(dev)
            got[label] = {"launches": dict(_build.LAUNCHES),
                          "rows": len(ids) * cfg.nchains,
                          "device": tim["device"], "engine": tim["engine"],
                          **{k: tim[k] for k in ("process", "write",
                                                 "scatter", "start_iter")}}
        finally:
            dist.shutdown()
        say(f"multiproc rank {rank}", f"{label}: {len(ids)} baselines "
            f"{ids[0]}-{ids[-1]} x {cfg.nchains} chains on {tim['device']}, "
            f"process {tim['process']:.2f} s (write {tim['write']:.2f} s)")
    Path(out_path).write_text(json.dumps(got))


def _mp_workers(runs, out_root, nranks):
    """The ``nranks`` ranks of ``runs``, each a process of its own
    (:func:`multiproc_worker`); their results by rank. All are stopped
    if one fails."""
    import pickle

    spec = out_root / "multiproc-spec.pkl"
    with open(spec, "wb") as f:
        pickle.dump(runs, f)
    outs = [out_root / f"multiproc-rank{r}.json" for r in range(nranks)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--multiproc", str(r), str(nranks), str(spec),
                               str(outs[r])], env=ENV0)
             for r in range(nranks)]
    try:
        rcs = [p.wait(timeout=MP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rcs == [0] * nranks, f"multiproc: the ranks exited with {rcs}")
    return [json.loads(o.read_text()) for o in outs]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_multiproc(dev, jobs_main, out_root, nranks=2, shard_devices=None):
    """Two processes sharing the card over gloo (``nranks``; under
    ``--multichip`` one a card, ``shard_devices`` every card), each through
    ``cli.run.run_jobs`` on its block of N_MP main jobs x MP_NCHAINS
    chains (11 + 10 baselines by the block rule), MP_NITER iterations in
    chunks of MP_WRITE_NITER, held against one process on the same jobs:
    every sample file bit-identical, ``timings.json`` over 2 ranks with
    every baseline's write seconds, ``rhat.json`` with every baseline,
    ``checkpoint-p0.npz`` and ``checkpoint-p1.npz``; a two-process run
    stopped at MP_RESUME_AT and resumed; the time-flags path with the
    tflags phase's two signatures, A split across the ranks; every main
    kernel launched on each rank. Then the in-process device shards:
    ``run_baselines(mesh_devices=[cuda:0, cuda:0])`` on N_SHARD baselines
    x SHARD_NITER iterations bit-identical to one device on megachain,
    mega and real, each with its kernels launched; then
    ``entry.dryrun_multichip(2)`` (the shards' count) and one call of
    ``entry.entry()``'s step on the card (finite outputs on the card, the
    real engine's kernels launched). The one-process reference runs as a
    fresh worker process too, so its rate and the ranks' pay the same
    start-up; rates of two processes on one card are descriptive only
    (they share the card), not a scaling result."""
    from hydra_pspec_torch import entry, runner
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.parallel.partition import local_indices
    from hydra_pspec_torch.utils import io as hio

    t_phase = time.perf_counter()
    out_root.mkdir(parents=True, exist_ok=True)
    jobs = [dataclasses.replace(j, out_dir=None) for j in jobs_main[:N_MP]]
    jobs_tf = make_tflags_jobs(jobs, N_MP_SIG_A)
    cfgs = {"plain": _mp_config(out_root, "mp", MP_NITER),
            "resume_a": _mp_config(out_root, "mp-resume", MP_RESUME_AT),
            "resume_b": _mp_config(out_root, "mp-resume", MP_NITER, True),
            "tflags": _mp_config(out_root, "mp-tf", MP_NITER)}
    runs = [(k, cfg, _mp_jobs(jobs_tf if k == "tflags" else jobs, cfg),
             _free_port()) for k, cfg in cfgs.items()]
    # one process on the same jobs, a fresh worker as each rank is
    one_runs = [(k, cfg, _mp_jobs(src, cfg), _free_port())
                for k, src in (("plain", jobs), ("tflags", jobs_tf))
                for cfg in [_mp_config(out_root, f"one-{k}", MP_NITER)]]
    one = _mp_workers(one_runs, out_root, 1)[0]
    t0 = time.perf_counter()
    ranks = _mp_workers(runs, out_root, nranks)
    shard_devices = shard_devices or [dev, dev]
    cards = len({str(d) for d in [dev] + list(shard_devices)})
    mp_wall = time.perf_counter() - t0
    for run, ref in (("plain", "plain"), ("resume_b", "plain"),
                     ("tflags", "tflags")):
        src = jobs_tf if ref == "tflags" else jobs
        bad = chain_files_differing(out_root / f"one-{ref}",
                                    out_root / cfgs[run].dirname, src,
                                    MP_NCHAINS)
        say("multiproc", f"{run}, {nranks} processes: files differing "
            f"from one process {len(bad)} of {6 * MP_NCHAINS * len(src)}")
        require(not bad, f"multiproc {run}: files differ: {bad[:5]}")
    res = out_root / "mp"
    tj = json.loads((res / "timings.json").read_text())
    rhat = json.loads((res / "rhat.json").read_text())
    n_wd = sum(len(e["ant_pairs"]) for e in tj["write_data"])
    blocks = [len(local_indices(N_MP, r, nranks)) for r in range(nranks)]
    require(tj["num_ranks"] == nranks and n_wd == N_MP
            and [len(e["ant_pairs"]) for e in tj["write_data"]] == blocks,
            f"multiproc: timings.json num_ranks {tj['num_ranks']}, "
            f"write_data {n_wd} baselines")
    require(len(rhat) == N_MP, f"multiproc: rhat.json has {len(rhat)}")
    for d in (res, out_root / "mp-resume"):
        for p in range(nranks):
            ck = hio.load_checkpoint(d, tag=f"-p{p}")
            require(ck is not None and ck["iteration"] == MP_NITER,
                    f"multiproc: {d.name}/checkpoint-p{p}.npz")
    require(all(r["resume_b"]["start_iter"] == MP_RESUME_AT for r in ranks),
            "multiproc: the resumed ranks did not start at the checkpoint")
    say("multiproc", f"timings.json: num_ranks {nranks}, write seconds of "
        f"{n_wd} baselines ({[len(e['ant_pairs']) for e in tj['write_data']]}"
        f" by rank), barrier {tj['rank_0_timers']['barrier']:.4f} s; "
        f"rhat.json {len(rhat)} baselines; checkpoint-p0..p{nranks - 1} at "
        f"{MP_NITER}, resumed from {MP_RESUME_AT}")
    launches = {}
    for run in cfgs:
        for r, got in enumerate(ranks):
            launches[f"{run} rank {r}"] = got[run]["launches"]
            missing = [k for k in MAIN_KERNELS if got[run]["launches"][k] == 0]
            require(got[run]["device"].startswith("cuda") and not missing,
                    f"multiproc {run} rank {r}: on {got[run]['device']}, "
                    f"kernels never launched {missing}")
    say("multiproc", f"launches by run and rank {launches}")
    rates = {}
    for run in ("plain", "tflags"):
        per = [g[run]["rows"] * MP_NITER / (g[run]["process"]
                                            - g[run]["write"])
               for g in ranks]
        tim = one[run]
        one_rate = tim["rows"] * MP_NITER / (tim["process"] - tim["write"])
        rates[run] = {"per_rank": per, "aggregate": sum(per),
                      "one_process": one_rate}
        say("multiproc", f"{run}: sampling only, (baseline x chain)-"
            f"iterations/s, {nranks} processes on {cards} card(s) "
            f"(descriptive, not a scaling result): by rank "
            f"{[round(r, 1) for r in per]}, aggregate {sum(per):.1f}; one "
            f"process on the same jobs, also a fresh worker, {one_rate:.1f} "
            f"(aggregate / one process {sum(per) / one_rate:.3f})")
    say("multiproc", f"{nranks}-process runs: wall {mp_wall:.1f} s for "
        f"{len(runs)} runs, processes started included")

    # in-process device shards: one process, a shard a device
    shards = {}
    sjobs = [dataclasses.replace(j, out_dir=None)
             for j in jobs_main[:N_SHARD]]
    for engine, kernels in (("megachain", MAIN_KERNELS),
                            ("mega", MEGA_KERNELS), ("real", REAL_KERNELS)):
        kw = dict(device=dev, seed=SEED, write_niter=WRITE_NITER,
                  store_cr=True, warm_ns=3, drift_max=0.6, engine=engine)
        res1, tim1 = runner.run_baselines(sjobs, make_prior(), SHARD_NITER,
                                          **kw)
        _build.reset_launches()
        res2, tim2 = runner.run_baselines(sjobs, make_prior(), SHARD_NITER,
                                          mesh_devices=shard_devices, **kw)
        sync(dev)
        got = dict(_build.LAUNCHES)
        same = all(np.array_equal(getattr(a, f), getattr(b, f))
                   for a, b in zip(res1, res2)
                   for f in ("signal_ps", "signal_cr", "fg_amps", "chisq",
                             "ln_post"))
        missing = [k for k in kernels if got[k] == 0]
        say("multiproc", f"shards {engine}: {N_SHARD} baselines x "
            f"{SHARD_NITER} over [{tim2['device']}]: bit-identical to one "
            f"device {same}; launches {got}")
        require(tim1["engine"] == tim2["engine"] == engine and same
                and not missing,
                f"multiproc shards {engine}: engine {tim2['engine']}, "
                f"identical {same}, kernels never launched {missing}")
        shards[engine] = {"launches": got, "identical": same,
                          "process_s": [tim1["process"], tim2["process"]]}
    # time flags over the devices: grouped megachain with signatures A and
    # B (A's chains split across the devices) and the grouped real engine
    # with 11 flag patterns, against one device
    rf = rfi_windows()
    for label, tjobs, engine, kernels, niter in (
            ("tflags", make_tflags_jobs(sjobs, N_SHARD // 2), "megachain",
             MAIN_KERNELS, SHARD_NITER),
            ("tflags_real", [dataclasses.replace(j, d=j.d + RFI * rf,
                                                 flags_tf=rf)
                             for j in sjobs], "real", REAL_KERNELS,
             TF_REAL_NITER)):
        kw = dict(device=dev, seed=SEED, write_niter=WRITE_NITER,
                  store_cr=True, warm_ns=3, drift_max=0.6)
        res1, tim1 = runner.run_baselines(tjobs, make_prior(), niter, **kw)
        _build.reset_launches()
        res2, tim2 = runner.run_baselines(tjobs, make_prior(), niter,
                                          mesh_devices=shard_devices, **kw)
        sync(dev)
        got = dict(_build.LAUNCHES)
        same = all(np.array_equal(getattr(a, f), getattr(b, f))
                   for a, b in zip(res1, res2)
                   for f in ("signal_ps", "signal_cr", "fg_amps", "chisq",
                             "ln_post"))
        missing = [k for k in kernels if got[k] == 0]
        rates = [len(tjobs) * niter / (t["process"] - t["write"])
                 for t in (tim1, tim2)]
        say("multiproc", f"shards {label}: {len(tjobs)} baselines x {niter} "
            f"on {engine} over [{tim2['device']}]: bit-identical to one "
            f"device {same}; launches {got}; sampling only, baseline-"
            f"iterations/s: one device {rates[0]:.1f}, "
            f"{len(shard_devices)} devices {rates[1]:.1f} (descriptive, "
            f"not a scaling result)")
        require(tim1["engine"] == tim2["engine"] == engine and same
                and not missing
                and len(tim2["device"].split(", ")) == len(shard_devices),
                f"multiproc shards {label}: engine {tim2['engine']} on "
                f"{tim2['device']}, identical {same}, kernels never launched "
                f"{missing}")
        shards[label] = {"launches": got, "identical": same,
                         "engine": engine, "niter": niter,
                         "baselines": len(tjobs),
                         "process_s": [tim1["process"], tim2["process"]],
                         "baseline_iters_per_s": rates}
    entry.dryrun_multichip(len(shard_devices))
    # entry(): one real-engine Gibbs step at 203 x 120 on the card
    fn, args = entry.entry()
    _build.reset_launches()
    step = fn(*args)
    sync(dev)
    got = dict(_build.LAUNCHES)
    missing = [k for k in REAL_KERNELS if got[k] == 0]
    shapes = [tuple(t.shape) for t in step]
    say("multiproc", f"entry(): one real-engine gibbs_step, outputs "
        f"{shapes} on {step[0].device}, launches {got}")
    require(all(t.device.type == "cuda" and bool(torch.isfinite(t).all())
                for t in step) and shapes == [(1, NF), (1,), (1, NF)]
            and not missing,
            f"multiproc: entry() outputs {shapes} on "
            f"{[str(t.device) for t in step]}, finite "
            f"{[bool(torch.isfinite(t).all()) for t in step]}, kernels "
            f"never launched {missing}")
    wall = time.perf_counter() - t_phase
    say("multiproc", f"phase wall {wall:.1f} s")
    return {"ranks": nranks, "cards": cards, "shard_devices":
            [str(d) for d in shard_devices],
            "baselines": N_MP, "nchains": MP_NCHAINS, "niter": MP_NITER,
            "launches": launches, "sampling_rates": rates,
            "barrier_s": tj["rank_0_timers"]["barrier"], "shards": shards,
            "wall_s": wall}


# --- scripts: hydra_pspec_torch/scripts on the card ----------------------------

N_SCALING, SCALING_NITER, SCALING_WRITE_NITER = 8, 100, 50


def phase_scripts(dev, out_root):
    """``simple_example`` on the card (finite, chi^2 within CHI2_GATE, the
    recovered EoR power within a factor 2 of the truth) and the scaling
    harness at one and two processes and at two devices in one process
    (``cuda:0`` twice on one card), each point its own processes: every
    point's sample files bit-identical to one process."""
    from hydra_pspec_torch.scripts import scaling_test, simple_example

    t0 = time.perf_counter()
    ex = simple_example.main(["--device", str(dev)])
    t_ex = time.perf_counter() - t0
    say("scripts", f"simple_example: chi^2 {ex['chi2']:.5f} (gate "
        f"|chi^2 - 1| <= {CHI2_GATE}), median recovered/true on the EoR "
        f"bins {ex['ratio']:.4f}, finite {ex['finite']}, {t_ex:.1f} s")
    require(ex["finite"] and abs(ex["chi2"] - 1.0) <= CHI2_GATE
            and 0.5 < ex["ratio"] < 2.0, "scripts: simple_example")
    out = out_root / "scaling"
    t0 = time.perf_counter()
    rc = scaling_test.main([
        "--out", str(out), "--ranks", "1,2", "--device_sweep", "2",
        "--devices", str(dev), "--device", "cuda", "--n", str(N_SCALING),
        "--niter", str(SCALING_NITER), "--write_niter",
        str(SCALING_WRITE_NITER)])
    wall = time.perf_counter() - t0
    rows, ok = scaling_test.table(out)
    say("scripts", f"scaling_test: points {[r['point'] for r in rows]}, "
        f"every point's files bit-identical to ranks-1: {ok} (exit {rc}); "
        f"wall {wall:.1f} s, processes started included")
    require(rc == 0 and ok and len(rows) == 3, "scripts: scaling_test")
    return {"simple_example": {"chi2": ex["chi2"], "ratio": ex["ratio"],
                               "seconds": t_ex},
            "scaling": {"rows": rows, "identical": ok, "wall_s": wall,
                        "baselines": N_SCALING, "niter": SCALING_NITER}}


# --- estimators: LSSA, OQE and DPSS on the card ------------------------------

def _est_rel(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-300))


def phase_estimators(dev):
    """Each estimator (``models/lssa.py``, ``oqe.py``, ``dpss.py``) on the
    card against the same call on the CPU, on seeded numpy inputs at NF
    channels (OQE: NT visibilities), within EST_RTOL relative to the
    largest magnitude, with the inputs as tensors on the card and as numpy
    arrays with the default device (the outputs must be on the card); the
    time of one call on the card (host clock over EST_REPS calls after
    one, inputs on the card, synchronised)."""
    from hydra_pspec_torch.models import dpss, lssa, oqe

    rng = np.random.default_rng(SEED + 40)
    crandn = lambda *s: (rng.standard_normal(s)
                         + 1j * rng.standard_normal(s)) / np.sqrt(2)
    freqs = 100.0 + 0.09765625 * np.arange(NF)   # MHz
    d = crandn(NF)
    X = crandn(NF, NF)
    cov = X @ X.conj().T / NF + np.eye(NF)
    invcov = np.linalg.inv(cov)
    w = np.ones(NF)
    w[[12, 30, 31, 77]] = 0.0
    R = crandn(NF, NF) / np.sqrt(NF) + np.eye(NF)
    Rh = np.eye(NF) * 2.0 + 0.1 * np.exp(-np.abs(
        np.subtract.outer(np.arange(NF), np.arange(NF))) / 4.0)
    V = crandn(NT, NF)
    cs = np.eye(NF) * 0.8 + 0.02
    tau = lssa.default_tau(freqs, device="cpu").numpy()
    are, aim = rng.standard_normal(NF), rng.standard_normal(NF)
    calls = {
        "lssa_fit_modes": (lssa.lssa_fit_modes,
                           lambda t: (t(d), t(freqs), t(invcov))),
        "decorr_pspec": (lssa.decorr_pspec,
                         lambda t: (t(are), t(aim), t(w), t(tau), t(freqs))),
        "oqe_F": (oqe.F, lambda t: (t(R),)),
        "oqe_M_Finv": (lambda r: oqe.M_Finv(oqe.F(r)), lambda t: (t(R),)),
        "oqe_M_opt": (lambda r: oqe.M_opt(oqe.F(r)), lambda t: (t(R),)),
        "oqe_M_Fhalf": (lambda r: oqe.M_Fhalf(oqe.F(r)), lambda t: (t(Rh),)),
        "oqe_bias": (oqe.bias, lambda t: (t(R), t(cov))),
        "oqe_qhat_all": (oqe.qhat_all, lambda t: (t(V), t(R))),
        "oqe_qhat_h_all": (oqe.qhat_h_all, lambda t: (t(V[0:NT - 1:2]),
                                                      t(V[1::2]), t(R))),
        "oqe_getqs": (oqe.getqs, lambda t: (t(V[:NT - 1]), t(R))),
        "oqe_Sig_QESN": (oqe.Sig_QESN, lambda t: (t(R), t(cov), t(cs),
                                                  t(np.asarray(0.7)))),
        "dpss_fit_modes": (lambda *a: dpss.dpss_fit_modes(*a, nmodes=NM),
                           lambda t: (t(d), t(w), t(freqs), t(cov))),
    }
    out = {}
    for name, (fn, args) in calls.items():
        cpu = fn(*args(lambda x: torch.from_numpy(np.array(x))))
        on_dev = args(lambda x: torch.from_numpy(np.array(x)).to(dev))
        gpu = fn(*on_dev)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(EST_REPS):
            fn(*on_dev)
        sync(dev)
        ms = (time.perf_counter() - t0) / EST_REPS * 1e3
        # numpy inputs and the default device: the card
        from_np = fn(*args(np.array))
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        gpu = ((gpu if isinstance(gpu, tuple) else (gpu,))
               + (from_np if isinstance(from_np, tuple) else (from_np,)))
        require(all(g.device.type == "cuda" for g in gpu),
                f"estimators {name}: an output left the card (tensors on "
                f"the card, or numpy inputs with the default device)")
        err = max(_est_rel(g, c) for g, c in zip(gpu, cpu + cpu))
        require(all(torch.isfinite(g).all() for g in gpu),
                f"estimators {name}: not finite")
        say("estimators", f"{name}: card against CPU max rel. error "
            f"{err:.3e} (gate {EST_RTOL}; inputs as tensors on the card and "
            f"as numpy arrays); one call on the card {ms:.3f} ms (inputs on "
            f"the card)")
        require(err <= EST_RTOL, f"estimators {name}: {err:.3e}")
        out[name] = {"max_rel_err": err, "ms": ms}
    pd, ratio, cond = oqe.matc(torch.from_numpy(R).to(dev))
    pd_c, ratio_c, cond_c = oqe.matc(torch.from_numpy(R))
    say("estimators", f"matc: card ({pd}, {ratio:.6e}, {cond:.6e}), CPU "
        f"({pd_c}, {ratio_c:.6e}, {cond_c:.6e})")
    require(pd == pd_c and abs(ratio - ratio_c) <= EST_RTOL * abs(ratio_c)
            and abs(cond - cond_c) <= EST_RTOL * abs(cond_c),
            "estimators: matc differs between the card and the CPU")
    return out


# --- 9. times ----------------------------------------------------------------

def work(name, B, n, t, m, ntimes, valid=None, chains=None, alpha=None,
         scales=2, want_y=True, lean=False, ws=False):
    """(bytes, operations) one call of kernel ``name`` needs at the data's
    own widths: ``n`` channels, ``m`` modes and the real time lanes of the
    rows (``B * ntimes``, or ``valid``: in the grouped mode each row has its
    own count), never a layout's pad lanes. Each input is read once and
    each output written once (complex64 8 bytes, float32 4); operations
    are real flops, with an integer or transcendental step counted as one,
    and, for the keyed passes' draw, two for each SASS issue slot a drawn
    lane takes (:data:`DRAW_SLOTS`; a slot is the time of one FMA, two
    flops at the FP32 peak). ``chains``: Gamma draws (the grouped bandpower
    draws once per chain). The solves take ``t`` as their right-hand-side
    count K. ``draw_rhs`` and ``draw_system`` are the keyed mode of the
    main path (no omega field read; a Philox call and a Box-Muller pair per
    drawn lane instead); ``*_stored`` their stored mode.
    ``row_scale_sumsq`` reads ``scales`` row scales (0 to 2) and writes
    ``y`` if ``want_y``; ``draw_resid`` writes chi and amps, or with
    ``lean`` the row sums chi_t instead, and w sig with ``ws``."""
    lanes = B * ntimes if valid is None else valid
    cfield, mfield, vec = 8 * n * lanes, 8 * m * lanes, 4 * B * n

    def draw(kernel):   # the omega draws of a keyed pass
        slots = DRAW_SLOTS.get(kernel)
        return n * lanes * (PHILOX_OPS + BOX_MULLER_OPS if slots is None
                            else 2 * slots)

    if name == "herm_chol_solve":  # Cholesky n^3/6 + two sweeps n^2 K cMACs
        return (8 * B * n * n + 2 * 8 * B * n * t,
                8 * B * (n ** 3 // 6 + n * n * t))
    if name == "hermitian_solve":  # herm_inv + apply + refine (3 n^2 K)
        return (8 * B * n * n + 2 * 8 * B * n * t,
                B * (4 * n ** 3 + 24 * n * n * t))
    if name == "gcr_megastep":     # the draw's products and inverse
        ins = (8 * B * n * n + 4 * cfield + 2 * 8 * B * n * m
               + 8 * B * m * m + mfield + 8 * n * n + 4 * vec)
        outs = cfield + mfield + 4 * n * lanes + 3 * vec
        return ins + outs, (B * 4 * n ** 3
                            + 8 * (5 * n * n + 4 * n * m + m * m) * lanes)
    if name == "cgemm":        # F rc: shared (n, n) times (B, n, lanes)
        return 8 * n * n + 2 * cfield, 8 * n * n * lanes
    if name == "herm_inv":     # Cholesky, L^-1, L^-H L^-1: n^3/2 cMACs
        return 2 * 8 * B * n * n, 4 * n ** 3 * B
    if name == "draw_rhs":
        return 2 * cfield + vec, 4 * n * lanes + draw("draw_rhs")
    if name == "draw_rhs_stored":
        return 3 * cfield + vec, 4 * n * lanes
    if name in ("draw_system", "draw_system_stored"):
        keyed = name == "draw_system"
        return (2 * 8 * B * n * n + (2 if keyed else 3) * cfield + 3 * vec,
                6 * B * n * n + 6 * n * lanes
                + (draw("draw_system") if keyed else 0))
    if name == "row_scale_sumsq":
        return ((2 if want_y else 1) * cfield + (scales + 1) * vec,
                (2 * scales + 4) * n * lanes)
    if name == "draw_resid":   # dw, sig, fa, ninvf, w read; noise written
        nbytes = 3 * cfield + 3 * vec + (cfield if ws else 0) + (
            vec if lean else 3 * mfield + 4 * n * lanes)
        return nbytes, (10 * n * lanes + (2 * n * lanes if ws else 0)
                        + (0 if lean else 2 * m * lanes))
    if name == "rng_fields":   # a Philox call, two Box-Muller pairs a lane
        return 2 * cfield, n * lanes * (PHILOX_OPS + 2 * BOX_MULLER_OPS)
    if name == "herm_inv_gate":   # the gate alone: two (B, n) rows read,
        return 2 * vec + 4 * B, 10 * B * n   # a flag a chain written
    if name == "bandpower":    # ceil(alpha/4) Philox calls + logs per bin
        draws = B if chains is None else chains
        return 2 * vec + 8 * 4096, draws * n * (-(-alpha // 4)) * 120
    raise KeyError(name)


def bound(name, **shape):
    nbytes, ops = work(name, **shape)
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / FP32_OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _time(fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _profile_window(run, accept, tries=5, cpu=False):
    """One torch.profiler window over ``run`` (called once before it, to
    warm up): its device activities as (start us, end us, name) in start
    order, and the window's wall time in ms. The window is taken again, up
    to ``tries`` times, while ``accept(activities)`` is false: the
    profiler can lose activities. ``cpu``: record host activities too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    run()
    torch.cuda.synchronize()
    for _ in range(tries):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ev = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA)
        if ev and accept(ev):
            return ev, wall
        say("times", f"profiler window lost device activities ({len(ev)} "
            f"recorded); taking it again")
    raise AssertionError("the profiler's device activities do not match "
                         "the calls")


def _device_ms(fn, reps=20):
    """Device time per call of ``fn`` (the sum of its device activities)
    from a profiler window of ``reps`` calls, whose activity count must be
    a multiple of ``reps``."""
    def run():
        for _ in range(reps):
            fn()

    ev, _ = _profile_window(run, lambda ev: len(ev) % reps == 0)
    return sum(t1 - t0 for t0, t1, _ in ev) / reps / 1e3


def _time_pairs(label, cases, reps=10):
    """kernel and plain times of each case, in turns plain, kernel,
    kernel, plain."""
    from hydra_pspec_torch.ops.kernels import impl as I

    K, P = I.KERNELS, I.PLAIN
    times = {}
    for name, fn in cases.items():
        pk = [_time(lambda: fn(P), reps), _time(lambda: fn(K), reps),
              _time(lambda: fn(K), reps), _time(lambda: fn(P), reps)]
        times[name] = ((pk[1] + pk[2]) / 2, (pk[0] + pk[3]) / 2)
        say("times", f"{name:16s} {label}: kernel {times[name][0]:.4f} ms, "
            f"plain {times[name][1]:.4f} ms (plain, kernel, kernel, plain "
            f"= {', '.join(f'{v:.4f}' for v in pk)})")
    return times


class _CgemmShapes:
    """Counts the (batch, M, K, N, op, A shared, X, masked) of every cgemm
    launch while it is active, and the herm_inv launches with an ``active``
    mask or a drift gate (the warm start's rebuilds), read at the launch
    wrapper ``_build.call``."""

    def __enter__(self):
        from hydra_pspec_torch.ops.kernels import _build

        self._build, self._call = _build, _build.call
        self.shapes = collections.Counter()
        self.masked = collections.Counter()

        def spy(kernel, entry, *args):
            if kernel == "cgemm":
                batch, M, N, K, op, a_batched = args[4:10]
                masked = args[12] is not None
                self.shapes[(batch, M, K, N, "NTH"[op], not a_batched,
                             args[2] is not None, masked)] += 1
            elif kernel == "herm_inv" and (args[4] is not None
                                           or args[5] is not None):
                self.masked[kernel] += 1
            return self._call(kernel, entry, *args)

        _build.call = spy
        return self

    def __exit__(self, *exc):
        self._build.call = self._call


def _time_chain(label, run, kit):
    """One iteration's time on the eager kernel path and the plain path, in
    turns (kit iterations a run), the kernels' launches per iteration, the
    masked ones among them and the shapes of its cgemm launches."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I

    _build.reset_launches()
    with _CgemmShapes() as rec:
        run(I.KERNELS)
        torch.cuda.synchronize()
    per_iter = {k: v / kit for k, v in _build.LAUNCHES.items() if v}
    chain = {"masked_per_iteration": {k: v / kit
                                      for k, v in rec.masked.items()}}
    for name, impl in (("kernels", I.KERNELS), ("plain", I.PLAIN),
                       ("kernels", I.KERNELS), ("plain", I.PLAIN)):
        ms = _time(lambda: run(impl), 2) / kit
        chain.setdefault(name, []).append(ms)
    chain["launches_per_iteration"] = per_iter
    chain["cgemm_shapes"] = [list(k) + [v / kit]
                             for k, v in sorted(rec.shapes.items())]
    say("times", f"one chain iteration, {label}: kernel path "
        f"{chain['kernels']} ms, plain path {chain['plain']} ms; launches "
        f"per iteration {per_iter}")
    return chain


def iteration_bound(chain, bounds, share=1.0, widths=None):
    """Sum over the kernels of launches per iteration x bound, each cgemm
    launch priced at its own shape (:func:`cgemm_bound`) counted at the
    data's own widths: ``widths`` maps a layout width to the true one (the
    time width to the rows' mean true time count). A launch with an
    ``active`` mask (the warm start's rebuild) does the work of the chains
    it flags: ``share`` of them, measured on the run's data."""
    masked = chain.get("masked_per_iteration", {})
    per = {k: v - (1.0 - share) * masked.get(k, 0.0)
           for k, v in chain["launches_per_iteration"].items()
           if k not in ENTRIES and k != "cgemm"}   # entries: their kernels
    missing = [k for k in per if k not in bounds]
    require(not missing, f"no bound for {missing}")
    own = lambda d: (widths or {}).get(d, d)
    products = sum(c * (share if is_masked else 1.0)
                   * cgemm_bound(B, own(M), own(K), own(N), shared,
                                 with_x)[0]
                   for B, M, K, N, _, shared, with_x, is_masked, c
                   in chain["cgemm_shapes"])
    return sum(v * bounds[k][0] for k, v in per.items()) + products


def _time_graph(label, chain, body, ps, kit, drift_max=None):
    """One iteration's time as a ChunkGraph replay of ``kit`` iterations
    beside the eager kernel path through the same ``body``, in turns
    (eager, graph, graph, eager), into ``chain``; with ``drift_max`` (a
    warm start) also the share of masked rebuild work the run's data
    needs. Returns the graph."""
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph

    cg = ChunkGraph(body, ps, kit)
    turns = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        fn = ((lambda: body(ps, 0, kit)) if name == "eager"
              else (lambda: cg.replay(ps, 0)))
        turns[name].append(_time(fn, 3) / kit)
    chain.update(graph=turns["graph"], eager_beside_graph=turns["eager"],
                 graph_capture={"capture_s": cg.capture_s,
                                "instantiate_s": cg.instantiate_s,
                                "warmup_s": cg.warmup_s,
                                "pool_bytes": cg.pool_bytes})
    if drift_max is not None:
        outs = body(ps, 0, kit)
        rebuilt = rebuilt_chains(ps, outs.ps, drift_max)
        chain["rebuilt_chains"] = rebuilt
        chain["rebuild_share"] = sum(rebuilt) / ((kit - 1) * ps.shape[0])
    say("times", f"one chain iteration, {label}: graph replay "
        f"{turns['graph']} ms, eager kernel path {turns['eager']} ms "
        f"(eager, graph, graph, eager); capture {cg.capture_s:.3f} s, "
        f"instantiate {cg.instantiate_s:.4f} s"
        + (f"; chains rebuilt at k = 1..{kit - 1}: "
           f"{chain['rebuilt_chains']}" if drift_max is not None else ""))
    return cg


def _device_ms_pairs(pairs, reps=10):
    """Device time per call of each (kernel call, library call) pair, from
    one profiler window in which each pair runs ``reps`` times, the kernel
    first: the kernels' own time, without the host's launch gaps that CUDA
    events around short launches also count. The device activities must
    fall into alternating runs of cgemm and library kernels."""
    ours = "(anonymous namespace)::cgemm_kernel"

    def run():
        for fns in pairs:
            for fn in fns:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()

    def runs_of(ev):
        runs = []
        for t0, t1, name in ev:
            is_ours = ours in name
            if not runs or runs[-1][0] != is_ours:
                runs.append([is_ours, 0.0, 0])
            runs[-1][1] += t1 - t0
            runs[-1][2] += 1
        return runs

    def accept(ev):
        runs = runs_of(ev)
        return (len(runs) == 2 * len(pairs)
                and all(r[0] == (i % 2 == 0) for i, r in enumerate(runs))
                and all(r[2] == reps for r in runs[::2]))

    runs = runs_of(_profile_window(run, accept)[0])
    return [(runs[2 * i][1] / reps / 1e3, runs[2 * i + 1][1] / reps / 1e3)
            for i in range(len(pairs))]


def time_cgemm_shapes(dev, B=N_BASELINES):
    """cgemm, its plain version and one PyTorch call (TF32 off) at every
    :data:`CGEMM_SHAPES` product, batch ``B`` (or the product's own), each
    beside its bound and the tile the plan takes; the kernel's and the
    library call's device time from the profiler too."""
    from hydra_pspec_torch.ops.kernels import impl as I

    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rows, pairs = [], []
    for shape in CGEMM_SHAPES:
        what, M, K, N, op, shared, xmode = shape[:7]
        Bs = cgemm_batch(shape, B)
        a, b, x, alpha, beta = cgemm_operands(shape, Bs, dev, gen)
        out = x if xmode == "out" else None
        call = (lambda M_, a=a, b=b, op=op, x=x, alpha=alpha, beta=beta,
                out=out: M_.cgemm(a, b, op=op, x=x, alpha=alpha, beta=beta,
                                  out=out))
        pk = [_time(lambda: call(I.PLAIN), 10), _time(lambda: call(I.KERNELS), 10),
              _time(lambda: call(I.KERNELS), 10), _time(lambda: call(I.PLAIN), 10)]
        aop = a if op == "N" else a.transpose(-2, -1)
        aop = aop.conj() if op == "H" else aop
        if xmode is None:
            library = lambda aop=aop, b=b: torch.matmul(aop, b)
        else:   # one call with the epilogue: X + alpha op(A) B
            library = (lambda aop=aop, b=b, x=x, alpha=alpha:
                       torch.baddbmm(x, aop, b, alpha=alpha))
        lib = _time(library, 10)
        b_ms, by = cgemm_bound(Bs, M, K, N, shared, xmode is not None)
        rows.append({"what": what, "batch": Bs, "M": M, "K": K, "N": N,
                     "op": op, "a_shared": shared, "x": xmode,
                     "tile": cgemm_plan(Bs, M, N, K),
                     "ms": (pk[1] + pk[2]) / 2,
                     "plain_ms": (pk[0] + pk[3]) / 2, "library_ms": lib,
                     "bound_ms": b_ms, "bound_by": by})
        pairs.append((lambda call=call: call(I.KERNELS), library))
    for row, (dev_ms, lib_dev_ms) in zip(rows, _device_ms_pairs(pairs)):
        row.update(device_ms=dev_ms, library_device_ms=lib_dev_ms)
        say("times", f"cgemm {row['what']:26s} B={row['batch']} {row['M']}x"
            f"{row['K']}x{row['N']} {row['op']} ({row['tile']}): kernel "
            f"{row['ms']:.4f} ms (device "
            f"{dev_ms:.4f}), plain {row['plain_ms']:.4f}, library "
            f"{row['library_ms']:.4f} (device {lib_dev_ms:.4f}), bound "
            f"{row['bound_ms']:.4f} ({row['bound_by']}), device time at "
            f"{100 * row['bound_ms'] / dev_ms:.1f} % of it")
    return rows


def _sass_bodies(lib):
    """{function name: its main body's basic blocks, each a list of SASS
    opcodes} of the library's kernels, from ``cuobjdump -sass``: each
    function's instructions up to its last unpredicated EXIT (code after
    it is out of line), cut into blocks at every label and after every
    branch and exit."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        return None
    res = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                         text=True, check=True)
    funcs, cur = {}, None
    for line in res.stdout.splitlines():
        head = line.strip()
        if head.startswith("Function : "):
            cur = funcs.setdefault(head.split(":", 1)[1].strip(), [])
            continue
        if cur is None:
            continue
        if head.startswith(".L") and head.endswith(":"):
            cur.append((None, False))          # a label: a block starts
            continue
        parts = line.split("*/", 1)
        if len(parts) < 2 or not parts[0].strip().startswith("/*"):
            continue
        words = parts[1].split(";")[0].split()
        if not words:
            continue
        pred = words[0].startswith("@")
        op = words[1] if pred and len(words) > 1 else words[0]
        if not op.startswith("NOP"):
            cur.append((op, pred))
    bodies = {}
    for name, ins in funcs.items():
        last = max((i for i, (op, pred) in enumerate(ins)
                    if op == "EXIT" and not pred), default=len(ins) - 1)
        blocks = [[]]
        for op, _ in ins[:last + 1]:
            if op is None:
                blocks.append([])
                continue
            blocks[-1].append(op)
            if op.startswith(("BRA", "EXIT", "RET")):
                blocks.append([])
        bodies[name] = [b for b in blocks if b]
    return bodies


# the draw's arithmetic: Philox's products and xors, Box-Muller's floating
# point and special functions; moves, shifts, selects, compares,
# conversions, addressing and branches are issued too, and not counted
DRAW_ARITH = ("IMAD.WIDE", "IMAD.HI", "LOP3", "FFMA", "FMUL", "FADD", "MUFU")


def _slots(ops):
    """Issue slots a lane of these instructions takes (:data:`SLOT_WEIGHT`)."""
    def weight(op):
        for pre, w in SLOT_WEIGHT.items():
            if op.startswith(pre):
                return w
        return 1
    return sum(weight(op) for op in ops)


def sass_draw_slots():
    """The keyed passes' draw in the compiled code, a drawn lane: the SASS
    of the keyed kernel's main body minus its stored twin's, over LANES,
    the four lanes a thread takes (what the four unrolled Philox calls
    share counted once). Two counts: every instruction of the difference
    (``static``: more than a lane issues, since it holds code the draws
    never run, such as sinf's and cosf's reduction of large arguments),
    and the issue slots of the draw's arithmetic (:data:`DRAW_ARITH`,
    weighted by :data:`SLOT_WEIGHT`) outside the blocks that touch local
    memory (that reduction's): a floor of what a lane issues, which sets
    :data:`DRAW_SLOTS` and so the keyed passes' bound. The same two counts
    of rng_fields' fields_kernel (its full mode), from its body, the floor
    leaving out the blocks that store: its issue floor, reported beside its
    bound and never in it. It has no stored twin to subtract, so the count
    holds the kernel's own index arithmetic and the rarely taken branches
    of logf, sqrtf and sinf, and adds the special function unit's slots to
    the FMA pipe's although the two overlap; its bound stays what the
    function needs (PHILOX_OPS + 2 * BOX_MULLER_OPS a lane, or its bytes).
    Empty when the toolkit has no cuobjdump (the bounds then take
    PHILOX_OPS + BOX_MULLER_OPS)."""
    from hydra_pspec_torch.ops.kernels import _build

    bodies = _sass_bodies(_build.build())
    if bodies is None:
        say("times", "no cuobjdump in the toolkit: the keyed passes' draw "
            "is counted as PHILOX_OPS + BOX_MULLER_OPS operations, a floor")
        return {}
    lanes = 4   # LANES of draw_fused.cu, FIELD_LANES of rng_bandpower.cu
    flat = lambda blocks: [op for b in blocks for op in b]
    arith = lambda blocks: [op for b in blocks
                            if not any(op.startswith(("STL", "LDL"))
                                       for op in b)
                            for op in b if op.startswith(DRAW_ARITH)]
    out = {}
    for kernel, stem in (("draw_rhs", "10rhs_kernel"),
                         ("draw_system", "13system_kernel")):
        keyed = [v for k, v in bodies.items() if f"{stem}ILb1ELb1E" in k]
        stored = [v for k, v in bodies.items() if f"{stem}ILb0ELb1E" in k]
        require(len(keyed) == 1 and len(stored) == 1,
                f"SASS of {kernel}: {len(keyed)} keyed, {len(stored)} "
                f"stored bodies")
        k_ops, s_ops = flat(keyed[0]), flat(stored[0])
        floor = (_slots(arith(keyed[0])) - _slots(arith(stored[0]))) / lanes
        classes = collections.Counter(op.split(".")[0] for op in k_ops)
        classes.subtract(collections.Counter(op.split(".")[0]
                                             for op in s_ops))
        out[kernel] = {
            "static_per_drawn_lane": (len(k_ops) - len(s_ops)) / lanes,
            "floor_slots_per_drawn_lane": floor,
            "keyed_body": len(k_ops), "stored_body": len(s_ops),
            "by_class_per_lane": {k: v / lanes for k, v in
                                  classes.most_common() if v}}
        DRAW_SLOTS[kernel] = floor
        say("times", f"SASS {kernel:11s} keyed body {len(k_ops)} "
            f"instructions, stored {len(s_ops)}: "
            f"{out[kernel]['static_per_drawn_lane']:.1f} instructions a "
            f"drawn lane, of which the draw's arithmetic takes {floor:.1f} "
            f"issue slots (the bound's floor); by class "
            f"{dict(list(out[kernel]['by_class_per_lane'].items())[:12])}")
    # rng_fields (fields_kernel, mode FIELDS_FULL): no stored twin, so its
    # body over its four lanes a thread (a Philox call and two Box-Mullers
    # a lane), the floor without the blocks that store (their address
    # arithmetic, three branches of which one runs); the index arithmetic,
    # a thread's, is counted in, so this is the issue floor, not the bound
    body = [v for k, v in bodies.items() if "13fields_kernelILi0E" in k]
    require(len(body) == 1, f"SASS of rng_fields: {len(body)} full bodies")
    ops = flat(body[0])
    floor = _slots(arith([b for b in body[0]
                          if not any(op.startswith("STG") for op in b)])
                   ) / lanes
    classes = collections.Counter(op.split(".")[0] for op in ops)
    out["rng_fields"] = {
        "static_per_drawn_lane": len(ops) / lanes,
        "floor_slots_per_drawn_lane": floor, "body": len(ops),
        "by_class_per_lane": {k: v / lanes for k, v in
                              classes.most_common()}}
    DRAW_SLOTS["rng_fields"] = floor
    say("times", f"SASS rng_fields  body {len(ops)} instructions: "
        f"{len(ops) / lanes:.1f} a drawn lane, of which the draws' "
        f"arithmetic takes {floor:.1f} issue slots (its issue floor, not "
        f"its bound); by class "
        f"{dict(list(out['rng_fields']['by_class_per_lane'].items())[:12])}")
    return out


def _time_layouts(label, cases, kit):
    """One iteration's time as a graph replay of a ``kit``-iteration chunk
    at each layout of ``cases`` ({layout: (body, ps)}), in turns port,
    jax, jax, port."""
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph

    graphs = {k: (ChunkGraph(body, ps, kit), ps)
              for k, (body, ps) in cases.items()}
    turns = {k: [] for k in cases}
    for k in ("port", "jax", "jax", "port"):
        cg, ps = graphs[k]
        turns[k].append(_time(lambda: cg.replay(ps, 0), 3) / kit)
    say("times", f"one chain iteration, {label}, graph replay at the port's "
        f"layout {turns['port']} ms, at the JAX package's {turns['jax']} ms "
        f"(port, JAX, JAX, port)")
    del graphs
    torch.cuda.empty_cache()
    return turns


GRAPH_REPLAYS = 3   # graph replays in the profiler window


def device_profile(run, iters, what="eager kernel path"):
    """torch.profiler over one ``run`` of ``iters`` iterations: the
    device's busy share of the window from its first to its last device
    activity, the longest idle gaps, and each kernel's summed device time
    per iteration."""
    ev, wall = _profile_window(run, lambda ev: True, cpu=True)
    spans = [(t0, t1) for t0, t1, _ in ev]
    busy, gaps = 0.0, []
    lo, hi = spans[0]
    for s0, s1 in spans[1:]:
        if s0 > hi:
            busy += hi - lo
            gaps.append(s0 - hi)
            lo, hi = s0, s1
        else:
            hi = max(hi, s1)
    busy += hi - lo
    window = spans[-1][1] - spans[0][0]
    per_kernel = collections.Counter()
    count = collections.Counter()
    for t0, t1, name in ev:
        name = name.replace("void ", "").replace("(anonymous namespace)::",
                                                 "")
        name = name.split("<")[0].split("(")[0]
        per_kernel[name] += (t1 - t0) / 1e3
        count[name] += 1
    out = {"iterations": iters, "wall_ms": wall,
           "device_window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
           "busy_share": busy / window,
           "longest_gaps_us": sorted(gaps, reverse=True)[:8],
           "kernel_ms_per_iteration": {k: v / iters for k, v in
                                       per_kernel.most_common()},
           "launches_per_iteration": {k: count[k] / iters for k in count}}
    say("times", f"profiler, {iters} plain iterations at B={N_BASELINES} "
        f"({what}): "
        f"wall {wall:.2f} ms, device window {window / 1e3:.3f} ms, busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / window:.1f} %), {len(ev)} "
        f"device activities; longest idle gaps (us) "
        f"{[round(g, 1) for g in out['longest_gaps_us']]}")
    for k, v in out["kernel_ms_per_iteration"].items():
        say("times", f"  device time per iteration {k:28s} {v:.4f} ms "
            f"({out['launches_per_iteration'][k]:.2f} a iteration)")
    return out


# --- the two row passes at every path's shape ---------------------------

# the widths phase 3 holds row_scale_sumsq and draw_resid at against their
# plain versions: one lane, a pair, a short odd row, the grouped rows, the
# real engine's odd 203, the main 204, one 256-wide tree, one lane over
# it, the long night's 1100; channels 120, odd 121 and the wide band's 180
ROW_TS, ROW_NS = (1, 2, 31, 80, 203, 204, 256, 257, 1100), (120, 121, 180)
# device ms of the row kernels this design replaced (one 256-thread block a
# row) at the cases of row_pass_cases, on an NVIDIA H100 80GB HBM3 at
# 700.00 W as python3 chip_smoke.py --rows printed them; printed beside
# this tree's when no parent checkout is given
PARENT_ROW_MS = {
    "row_scale_sumsq main s1 s2 y": 0.01882,
    "draw_resid main full": 0.03076,
    "draw_resid main lean": 0.02777,
    "row_scale_sumsq grouped 100 x G=3 s1 s2 y": 0.04638,
    "row_scale_sumsq grouped 100 x G=3 unscaled": 0.03461,
    "draw_resid grouped 100 x G=3 full ws": 0.07044,
    "draw_resid grouped 100 x G=3 lean ws": 0.07741,
    "row_scale_sumsq real 20 x t=203 s1 y": 0.00408,
    "row_scale_sumsq real 20 x t=203 unscaled": 0.00386,
    "row_scale_sumsq real grouped 20 x t=15 s1 y": 0.00355,
    "row_scale_sumsq real grouped 20 x t=15 unscaled": 0.00354,
    "row_scale_sumsq real grouped 20 x t=53 s1 y": 0.00365,
    "row_scale_sumsq real grouped 20 x t=53 unscaled": 0.00358,
}


def row_pass_variants(dev, n, t, B=5, m=12):
    """[(what, kernel, call(M))] on random inputs at (B, n, t):
    row_scale_sumsq with and without s1, s2 and y; draw_resid with each
    optional output (chi, chit, amp, ws) present and absent, on ragged
    row_times (0, t and counts between), and once on ntimes alone."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1000 * n + t)
    cx = lambda *s: torch.randn(s, dtype=torch.complex64, device=dev,
                                generator=gen)
    pos = lambda *s: torch.rand(s, device=dev, generator=gen) + 0.5
    x, s1, s2 = cx(B, n, t), pos(B, n), pos(B, n)
    out = []
    for mask in range(8):
        a, c, want_y = (s1 if mask & 1 else None), (s2 if mask & 2 else
                                                     None), bool(mask & 4)
        out.append((f"s1 {a is not None:d} s2 {c is not None:d} y "
                    f"{want_y:d}", "row_scale_sumsq",
                    lambda M, a=a, c=c, y=want_y: M.row_scale_sumsq(
                        x, a, c, want_y=y)))
    dw, sig, fa = cx(B, n, t), cx(B, n, t), cx(B, n, t)
    ninvf, w = pos(B, n), (pos(B, n) > 0.8).float()
    da, a0 = cx(B, m, t), cx(B, m, t)
    rt = torch.randint(0, t + 1, (B,), device=dev, generator=gen,
                       dtype=torch.int32)
    rt[0], rt[-1] = t, 0
    args = (dw, sig, fa, ninvf, w, da, a0, max(t - 1, 1))
    for mask in range(17):
        kw = dict(want_chi=bool(mask & 1), want_chit=bool(mask & 2),
                  want_amp=bool(mask & 4), want_ws=bool(mask & 8),
                  row_times=None if mask == 16 else rt)
        what = ("ntimes = t - 1, all outputs" if mask == 16 else
                " ".join(f"{k[5:]} {int(v)}" for k, v in kw.items()
                         if k.startswith("want")))
        if mask == 16:
            kw.update(want_chi=True, want_chit=True, want_amp=True,
                      want_ws=True)
        out.append((what, "draw_resid",
                    lambda M, kw=kw: M.draw_resid(*args, **kw)))
    return out


def check_row_widths(dev, cmp):
    """Phase 3's widths: both row kernels against their plain versions,
    every variant of :func:`row_pass_variants`, within 1e-5 of the
    largest plain output, one line a (kernel, n, t)."""
    from hydra_pspec_torch.ops.kernels import impl as I

    for n in ROW_NS:
        for t in ROW_TS:
            for kernel in ("row_scale_sumsq", "draw_resid"):
                err, ref = 0.0, 0.0
                for _, k, fn in row_pass_variants(dev, n, t):
                    if k != kernel:
                        continue
                    for g, w in zip(fn(I.KERNELS), fn(I.PLAIN)):
                        if w is not None:
                            err = max(err, float(torch.abs(g - w).max()))
                            ref = max(ref, float(torch.abs(w).max()))
                cmp(kernel, torch.tensor(err), torch.tensor(0.0), 1e-5,
                    f"n={n} t={t} variants", ref)


def row_pass_cases(dev, jobs):
    """[(label, kernel, work kwargs, call(M), library call or None)] of
    row_scale_sumsq and draw_resid at each path's shape, on random inputs:
    the main path (B = 100, t = 204, 203 times); the grouped time-flags
    path (100 chains x G = 3 rows of t = 80, signature A's 70 + 80 + 53
    true times); the real engine (20 baselines, 203 times) and its grouped
    mode's groups (rfi_windows' 11 flag patterns: ten of 15 times, one of
    53). Each variant as its path launches it (scaled with y: beta; y not
    kept: the bmask and the real residual sums; lean: chi_t)."""
    from hydra_pspec_torch.models import mega

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cx = lambda *s: torch.randn(s, dtype=torch.complex64, device=dev,
                                generator=gen)
    pos = lambda *s: torch.rand(s, device=dev, generator=gen) + 0.5
    gs = grouped_setup(jobs[:1], tflag_signatures()[0], N_BASELINES, dev)
    G = len(gs.group_times)
    rt = grouped_ids(gs, N_BASELINES, dev)[0]
    Bg, _, tg = gs.mops.nid.shape
    t_main = mega.layout_dims(NF, NT, NM)[1]
    real_ts = sorted(set(np.unique(rfi_windows(), axis=0,
                                   return_counts=True)[1].tolist()))
    cases = []
    shapes = [("main", N_BASELINES, t_main, NT, None, False),
              (f"grouped {N_BASELINES} x G={G}", Bg, tg, gs.dims.ntimes, rt,
               False),
              (f"real {N_TF_REAL} x t={NT}", N_TF_REAL, NT, NT, None, True)]
    shapes += [(f"real grouped {N_TF_REAL} x t={t}", N_TF_REAL, t, t, None,
                True) for t in real_ts]
    for label, B, t, ntimes, rows, real in shapes:
        sh = dict(B=B, n=NF, t=t, m=NM, ntimes=ntimes,
                  valid=None if rows is None else int(rows.sum()))
        x, s1, s2 = cx(B, NF, t), pos(B, NF), pos(B, NF)
        if real:   # the real engine's sk = dd u
            cases.append((f"row_scale_sumsq {label} s1 y", "row_scale_sumsq",
                          dict(sh, scales=1),
                          lambda M, x=x, s1=s1: M.row_scale_sumsq(x, s1),
                          None))
        else:
            cases.append((f"row_scale_sumsq {label} s1 s2 y",
                          "row_scale_sumsq", sh,
                          lambda M, x=x, s1=s1, s2=s2: M.row_scale_sumsq(
                              x, s1, s2), None))
        if label != "main":   # the bmask launch; the real residual sums
            cases.append((f"row_scale_sumsq {label} unscaled",
                          "row_scale_sumsq", dict(sh, scales=0, want_y=False),
                          lambda M, x=x: M.row_scale_sumsq(x, want_y=False),
                          lambda x=x: torch.linalg.vector_norm(x, dim=-1)))
        if real:
            continue
        dw, sig, fa = cx(B, NF, t), cx(B, NF, t), cx(B, NF, t)
        ninvf, w = pos(B, NF), (pos(B, NF) > 0.6).float()
        da, a0 = cx(B, NM, t), cx(B, NM, t)
        ws = rows is not None   # flagged: w sig for the bmask
        for lean in (False, True):
            kw = dict(want_chi=not lean, want_chit=lean, want_amp=not lean,
                      want_ws=ws, row_times=rows)
            cases.append((f"draw_resid {label} {'lean' if lean else 'full'}"
                          f"{' ws' if ws else ''}", "draw_resid",
                          dict(sh, lean=lean, ws=ws),
                          lambda M, kw=kw, a=(dw, sig, fa, ninvf, w, da, a0,
                                              ntimes): M.draw_resid(*a, **kw),
                          None))
    return cases


def parent_library(root):
    """The kernel library of the checkout at ``root`` (its own
    ``_build.py``, built into its own ``_build/``), loaded beside this
    tree's."""
    import importlib.util

    path = Path(root) / "hydra_pspec_torch" / "ops" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("parent_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


class _LibraryOf:
    """``with _LibraryOf(lib):`` the wrappers launch ``lib``'s entries (a
    parent checkout's kernels: the C signatures are the same)."""

    def __init__(self, lib):
        from hydra_pspec_torch.ops.kernels import _build

        self._build, self.lib = _build, lib

    def __enter__(self):
        self._own = self._build.library()
        self._build._LIB.lib = self.lib

    def __exit__(self, *exc):
        self._build._LIB.lib = self._own


def row_pass_times(dev, jobs, parent_lib=None):
    """Device time (profiler) of each case of :func:`row_pass_cases`
    beside its bound on the true lanes and, for the unscaled sums,
    ``torch.linalg.vector_norm(x, dim=-1)`` (one PyTorch call of a
    bandwidth-bound row reduction; it returns the root). With
    ``parent_lib``, that library's kernels too, in turns parent, this,
    this, parent, their outputs ``torch.equal`` to this tree's; without
    it, :data:`PARENT_ROW_MS` beside."""
    from hydra_pspec_torch.ops.kernels import impl as I

    K = I.KERNELS
    rows = {}
    for label, kernel, wk, fn, lib_fn in row_pass_cases(dev, jobs):
        b_ms, by = bound(kernel, **wk)
        row = {"kernel": kernel, "bound_ms": b_ms, "bound_by": by}
        if parent_lib is None:
            row["ms"] = _device_ms(lambda: fn(K))
            row["parent_ms"] = PARENT_ROW_MS.get(label)
            row["parent_from"] = "PARENT_ROW_MS"
        else:
            with _LibraryOf(parent_lib):
                p0 = _device_ms(lambda: fn(K))
                want = fn(K)
            c = [_device_ms(lambda: fn(K)) for _ in range(2)]
            with _LibraryOf(parent_lib):
                p1 = _device_ms(lambda: fn(K))
            got = fn(K)
            same = all((g is None and w is None) or torch.equal(g, w)
                       for g, w in zip(got, want))
            row.update(ms=sum(c) / 2, parent_ms=(p0 + p1) / 2,
                       parent_turns=[p0, c[0], c[1], p1],
                       parent_from="checkout", equal_parent=same)
            require(same, f"{label}: outputs differ from the parent's")
        row["share"] = b_ms / row["ms"]
        if lib_fn is not None:
            row["library_ms"] = _device_ms(lib_fn)
        rows[label] = row
        pm = row["parent_ms"]
        say("times", f"device time {label:42s} {row['ms']:.5f} ms (parent "
            f"{'not measured' if pm is None else f'{pm:.5f} ms'}), bound "
            f"{b_ms:.5f} ms ({by}), {100 * row['share']:.1f} % of it"
            + (f"; vector_norm {row['library_ms']:.5f} ms" if lib_fn else "")
            + (f"; torch.equal parent: {row['equal_parent']}"
               if "equal_parent" in row else ""))
    return rows


def rows_main(out, parent=None):
    """``python3 chip_smoke.py --rows OUT [PARENT]``: the two row passes
    alone, on one card: :func:`row_pass_times`, beside
    :data:`PARENT_ROW_MS` or, with a PARENT checkout, against the parent's
    kernels, after holding both kernels of this tree ``torch.equal`` to the
    parent's at every variant of phase 3's widths. Results to OUT as
    JSON."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I

    phase_env()
    dev = torch.device("cuda", 0)
    _build.library()
    plib = None if parent is None else parent_library(parent)
    if plib is not None:
        for n in ROW_NS:
            for t in ROW_TS:
                for what, kernel, fn in row_pass_variants(dev, n, t):
                    got = fn(I.KERNELS)
                    with _LibraryOf(plib):
                        want = fn(I.KERNELS)
                    require(all((g is None and w is None) or torch.equal(g, w)
                                for g, w in zip(got, want)),
                            f"{kernel} n={n} t={t} {what}: differs from the "
                            f"parent's")
                say("kernels", f"row passes n={n} t={t}: every variant "
                    f"torch.equal to the parent's kernels")
    rows = row_pass_times(dev, make_jobs(1), plib)
    Path(out).write_text(json.dumps(rows, indent=1))


# the parent's widths of the tile kernels that must not move: the real
# engine's 120, one over three tiles, full 128
HERM_PARENT_NS = (120, 121, 128)


def herm_main(out, parent):
    """``python3 chip_smoke.py --herm OUT PARENT``: the Hermitian inverse and
    factor-solve against a parent checkout's kernels (its own library,
    built from its sources), on one card. At n in HERM_PARENT_NS, where the
    kernels did not change, herm_inv (unmasked, ``active``, gate mode) and
    herm_chol_solve (K = 203 and 1) must be torch.equal to the parent's, at
    B = 100. At n = WIDE_NF the one-launch kernels against the parent's
    blocked route over its own kernels (``base_n=128``), in turns parent,
    this, this, parent (CUDA events; the masked launch with no chain
    rebuilding in device time). Results to OUT as JSON."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import herm_inv as hi
    from hydra_pspec_torch.ops.kernels import spd_solve as ss

    phase_env()
    dev = torch.device("cuda", 0)
    _build.library()
    plib = parent_library(parent)
    B = N_BASELINES
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    equal = {}
    for n in HERM_PARENT_NS:
        a = equilibrated_spd(B, n, dev, gen)
        psx = 1.0 + 99.0 * torch.rand((B, n), generator=gen, device=dev)
        ps = psx * torch.exp(0.6 * torch.rand((B, n), generator=gen,
                                              device=dev) - 0.3)
        act = (torch.arange(B, device=dev) % 3 == 1).to(torch.int32)
        b = torch.randn((B, n, NT), dtype=torch.complex64, generator=gen,
                        device=dev)
        b1 = b[:, :, :1].contiguous()
        carried = torch.full_like(a, complex(7.0, -3.0))

        def gated(dmax):
            flags = torch.full((B,), -1, dtype=torch.int32, device=dev)
            inv = hi.herm_inv(a, out=carried.clone(), gate=(ps, psx, dmax),
                              rebuild=flags)
            return inv, flags

        cases = {"herm_inv": lambda: (hi.herm_inv(a),),
                 "herm_inv active": lambda: (hi.herm_inv(
                     a, out=carried.clone(), active=act),),
                 "herm_inv gate 0.3": lambda: gated(0.3),
                 "herm_inv gate 0.05": lambda: gated(0.05),
                 f"herm_chol_solve K={NT}": lambda: (
                     ss.herm_chol_solve(a, b),),
                 "herm_chol_solve K=1": lambda: (ss.herm_chol_solve(a, b1),)}
        for what, fn in cases.items():
            got = fn()
            with _LibraryOf(plib):
                want = fn()
            ok = all(torch.equal(g, w) for g, w in zip(got, want))
            equal[f"{what} n={n}"] = ok
            say("herm", f"{what:22s} n={n} B={B}: torch.equal to the "
                f"parent's kernels: {ok}")
            require(ok, f"{what} n={n}: differs from the parent's kernels")

    n = WIDE_NF
    s = equilibrated_spd(B, n, dev, gen)
    ps = 1.0 + 99.0 * torch.rand((B, n), generator=gen, device=dev)
    rhs = torch.randn((B, n, NT), dtype=torch.complex64, generator=gen,
                      device=dev)
    one = rhs[:, :, :1].contiguous()
    buf = hi.herm_inv(s)
    cases = {"herm_inv": lambda **kw: hi.herm_inv(s, **kw),
             "herm_inv masked": lambda **kw: hi.herm_inv(
                 s, out=buf, gate=(ps, ps, 0.6), **kw),
             f"herm_chol_solve K={NT}": lambda **kw: ss.herm_chol_solve(
                 s, rhs, **kw),
             "herm_chol_solve K=1": lambda **kw: ss.herm_chol_solve(
                 s, one, **kw)}
    times = {}
    for what, fn in cases.items():
        clock = (_device_ms if what == "herm_inv masked"
                 else (lambda f: _time(f, 10)))

        def parent_ms():
            with _LibraryOf(plib):
                return clock(lambda: fn(base_n=128))

        t = [parent_ms(), clock(fn), clock(fn), parent_ms()]
        times[what] = {"n": n, "batch": B, "ms": (t[1] + t[2]) / 2,
                       "parent_ms": (t[0] + t[3]) / 2, "turns": t,
                       "clock": "device" if clock is _device_ms else "events"}
        say("herm", f"{what:22s} n={n} B={B}: {times[what]['ms']:.5f} ms, "
            f"the parent's blocked route on its own kernels "
            f"{times[what]['parent_ms']:.5f} ms (parent, this, this, parent "
            f"= {', '.join(f'{v:.5f}' for v in t)})")
    Path(out).write_text(json.dumps({"equal": equal, "times": times},
                                    indent=1))


def parent_rng_fields(plib, seed, sids, g, n, t, ntimes, nfreqs,
                      row_times=None):
    """rng_fields on a parent checkout's library ``plib`` (its C entry,
    which takes no time map), launched directly."""
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    B = sids.shape[0]
    oa = torch.empty((B, n, t), dtype=torch.complex64, device=sids.device)
    ob = torch.empty_like(oa)
    err = plib.hk_rng_fields(
        rb._u32(seed), _build.ptr(sids), rb._u32(g), _build.ptr(oa),
        _build.ptr(ob), B, n, t, ntimes, nfreqs, _build.ptr(row_times),
        torch.cuda.current_stream().cuda_stream)
    require(err == 0, f"the parent's hk_rng_fields: CUDA error {err}")
    return oa, ob


def parent_rng_impl(plib):
    """The kernels with the parent's omegas: ``rng_fields`` on the parent's
    kernel, and ``rng_segments`` as the parent's grouped real engine drew
    them (its full fields at every time, then each group's columns
    gathered from both)."""
    from hydra_pspec_torch.ops.kernels import impl as I

    def segments(seed, sids, g, n, segs, nfreqs):
        T = sum(segs.widths)
        fa, fb = parent_rng_fields(plib, seed, sids, g, n, T, T, nfreqs)
        return ([fa[:, :, ix] for ix in segs.idx],
                [fb[:, :, ix] for ix in segs.idx])

    return I.KERNELS._replace(
        rng_fields=functools.partial(parent_rng_fields, plib),
        rng_segments=segments)


def rng_main(out, parent):
    """``python3 chip_smoke.py --rng OUT PARENT``: rng_fields against a
    parent checkout's kernel (its own library, built from its sources), on
    one card. torch.equal to the parent's at B = 100, t = 203, n = 120
    and 180 (the real engine's layouts), at the main layout's pad lane
    (t = 204, ntimes = 203) and with row_times (signature A's rows, G = 3,
    t = 80); each time group's segment torch.equal to the parent's full
    fields gathered at its times (the 11 patterns at B = 20 and 100, and
    signature A's 3 groups). Then, in turns parent, this, this, parent:
    rng_fields' device time and events at n = 120 and 180; the segment
    launch against the parent's full fields and gathers (device time);
    one grouped real iteration (20 baselines, 11 patterns) and one dense
    real iteration (100, solver pallas) on the two omega draws, with
    their device activities an iteration. Results to OUT as JSON."""
    from hydra_pspec_torch.models import rgibbs
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    phase_env()
    dev = torch.device("cuda", 0)
    _build.library()
    plib = parent_library(parent)
    K, old = I.KERNELS, parent_rng_impl(plib)
    B = N_BASELINES
    sids = torch.arange(B, dtype=torch.int32, device=dev) * 3 + 1
    equal = {}

    def hold(what, got, want):
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
        equal[what] = ok
        say("rng", f"{what}: torch.equal to the parent's: {ok}")
        require(ok, f"rng_fields {what}: differs from the parent's kernel")

    for n in (NF, WIDE_NF):
        hold(f"n={n} t={NT} B={B}",
             K.rng_fields(SEED, sids, 7, n, NT, NT, n),
             old.rng_fields(SEED, sids, 7, n, NT, NT, n))
    hold(f"n={NF} t={NT + 1} ntimes={NT} B={B}",
         K.rng_fields(SEED, sids, 7, NF, NT + 1, NT, NF),
         old.rng_fields(SEED, sids, 7, NF, NT + 1, NT, NF))
    gs = grouped_setup(make_jobs(1), tflag_signatures()[0], B, dev)
    Bg, ng, tg = gs.mops.nid.shape
    rt, sids_r, _ = grouped_ids(gs, Bg // len(gs.group_times), dev)
    hold(f"row_times G={len(gs.group_times)} B={Bg} n={ng} t={tg}",
         K.rng_fields(SEED, sids_r, 7, ng, tg, gs.dims.ntimes, NF, rt),
         old.rng_fields(SEED, sids_r, 7, ng, tg, gs.dims.ntimes, NF, rt))
    del gs
    cases = {}
    for label, flags, nb in (("11 patterns", rfi_windows(), N_TF_REAL),
                             ("11 patterns", rfi_windows(), B),
                             ("signature A", tflag_signatures()[0], B)):
        segs = rb.time_segments(time_groups(flags, dev))
        ids = sids[:nb]
        got = K.rng_segments(SEED, ids, 7, NF, segs, NF)
        want = old.rng_segments(SEED, ids, 7, NF, segs, NF)
        hold(f"segments, {label} ({len(segs.widths)} groups, t = "
             f"{list(segs.widths)}), B={nb}", got[0] + got[1],
             want[0] + want[1])
        cases[f"segments {label} B={nb}"] = (
            lambda M, ids=ids, segs=segs: M.rng_segments(
                SEED, ids, 0, NF, segs, NF))

    def turns(clock, fn):
        t = [clock(lambda: fn(old)), clock(lambda: fn(K)),
             clock(lambda: fn(K)), clock(lambda: fn(old))]
        return {"ms": (t[1] + t[2]) / 2, "parent_ms": (t[0] + t[3]) / 2,
                "turns": t}

    times = {}
    for n in (NF, WIDE_NF):
        fn = lambda M, n=n: M.rng_fields(SEED, sids, 0, n, NT, NT, n)
        b_ms, by = bound("rng_fields", B=B, n=n, t=NT, m=NM, ntimes=NT)
        times[f"rng_fields n={n}"] = row = {
            "device": turns(_device_ms, fn),
            "events": turns(lambda f: _time(f, 20), fn),
            "bound_ms": b_ms, "bound_by": by, "batch": B, "n": n, "t": NT}
        say("rng", f"rng_fields B={B} n={n} t={NT}: device "
            f"{row['device']['ms']:.5f} ms (parent "
            f"{row['device']['parent_ms']:.5f}), events "
            f"{row['events']['ms']:.5f} ms (parent "
            f"{row['events']['parent_ms']:.5f}); bound {b_ms:.5f} ms ({by}); "
            f"turns {row['device']['turns']}")
    for k, fn in cases.items():
        times[k] = row = {"device": turns(_device_ms, fn)}
        say("rng", f"{k}: one segment launch {row['device']['ms']:.5f} ms "
            f"device time, the parent's full fields and gathers "
            f"{row['device']['parent_ms']:.5f} ms")

    kit = 5
    run_tf, _, _ = tflags_real_setup(make_jobs(N_TF_REAL), dev)
    rops, ps_r, _, rbins = real_system(
        make_jobs(B, dense=True, seed=SEED + 3), dev)
    iters = {"tflags_real": lambda M: run_tf(M, kit),
             "dense real": lambda M: rgibbs.run_chain(
                 rops, ps_r, rbins, kit, seed=SEED, sids=sids,
                 solver="pallas", impl=M)}
    for k, fn in iters.items():
        row = turns(lambda f: _time(f, 3) / kit, fn)
        act = {name: _device_activities(lambda M=M: fn(M), 1)[0] / kit
               for name, M in (("this", K), ("parent", old))}
        _build.reset_launches()
        fn(K)
        torch.cuda.synchronize()
        row.update(device_activities=act, launches={
            c: v / kit for c, v in _build.LAUNCHES.items() if v})
        times[f"iteration {k}"] = row
        say("rng", f"one {k} iteration: {row['ms']:.4f} ms, on the parent's "
            f"omegas {row['parent_ms']:.4f} ms (parent, this, this, parent "
            f"= {', '.join(f'{v:.4f}' for v in row['turns'])}); device "
            f"activities an iteration {act['this']:.1f} (parent's "
            f"{act['parent']:.1f}); hand-written launches {row['launches']}")
    Path(out).write_text(json.dumps({"equal": equal, "times": times},
                                    indent=1))


def _device_ms_seq(fns, reps=10):
    """Device time per call of each of ``fns`` (one kernel launch a call),
    from one profiler window that runs each ``reps`` times in order: the
    window's activities, in start order, fall to the calls in turn."""
    def run():
        for fn in fns:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()

    ev, _ = _profile_window(run, lambda ev: len(ev) == reps * len(fns))
    return [sum(t1 - t0 for t0, t1, _ in ev[i * reps:(i + 1) * reps])
            / reps / 1e3 for i in range(len(fns))]


def _clocks_under(fn, n=10000):
    """nvidia-smi's SM clock, its maximum, the power draw and the power
    limit, read 0.3 s into ``n`` launches of ``fn`` in a row."""
    q = subprocess.Popen(
        ["bash", "-c", "sleep 0.3; nvidia-smi --query-gpu=clocks.sm,"
         "clocks.max.sm,power.draw,power.limit --format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return q.communicate()[0].strip()


def _replays_by_library(label, make_body, ps, kit, plib):
    """One iteration as a graph replay of a ``kit``-iteration chunk on the
    parent's library ``plib`` and on this tree's, in turns parent, this,
    this, parent; the two replays' outputs torch.equal."""
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph
    from hydra_pspec_torch.ops.kernels.megachain import ChainOut

    with _LibraryOf(plib):
        parent = ChunkGraph(make_body(), ps, kit)
    this = ChunkGraph(make_body(), ps, kit)
    got, want = this.replay(ps, 0), parent.replay(ps, 0)
    diff = [f for f in ChainOut._fields if getattr(got, f) is not None
            and not torch.equal(getattr(got, f), getattr(want, f))]
    say("cgemm", f"{label}: a replay torch.equal to the parent's on every "
        f"output: {not diff}")
    require(not diff, f"{label}: differs from the parent's in {diff}")
    t = [_time(lambda g=g: g.replay(ps, 0), 5) / kit
         for g in (parent, this, this, parent)]
    row = {"ms": (t[1] + t[2]) / 2, "parent_ms": (t[0] + t[3]) / 2,
           "turns": t, "equal": not diff}
    say("cgemm", f"{label}: graph replay {row['ms']:.4f} ms an iteration, "
        f"on the parent's kernels {row['parent_ms']:.4f} ms (parent, this, "
        f"this, parent = {', '.join(f'{v:.4f}' for v in t)})")
    del parent, this
    torch.cuda.empty_cache()
    return row


def cgemm_main(out, parent):
    """``python3 chip_smoke.py --cgemm OUT PARENT``: cgemm against a parent
    checkout's kernel (its own library, built from its sources), on one
    card. At every :data:`CGEMM_SHAPES` product and every batch of
    :data:`CGEMM_BATCHES` (and the product's own), torch.equal to the
    parent's, with an ``active`` mask too, on every tile the kernel has
    (the bits do not depend on the plan) and on chain slices. Then, in
    turns parent, this, this, parent, each product's time at B = 100 (or
    its own batch), CUDA events and profiler device time, beside
    ``torch.matmul`` / ``torch.baddbmm`` (events, TF32 off) and every
    tile's device time; and one iteration of the main, grouped (100 x
    G = 3) and wide (n = 180) megachain chunks as graph replays on both
    libraries. The registers and spills of each cgemm kernel (ptxas).
    Results to OUT as JSON."""
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import cgemm as cg

    phase_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build(verbose=True)
    _build.library()
    ptxas, entry = [], ""
    for line in _build.build_info()[1].splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "cgemm_kernel" in entry and ("registers" in line
                                          or "spill" in line):
            ptxas.append(f"{entry}: {line.strip()}")
            say("cgemm", ptxas[-1])
    plib = parent_library(parent)
    tiles, names = range(len(cg.TILES)), cg.TILES
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    equal = {}
    for shape in CGEMM_SHAPES:
        what, M, K, N, op, shared, xmode = shape[:7]
        for B in sorted({*CGEMM_BATCHES, cgemm_batch(shape, N_BASELINES)}):
            a, b, x, alpha, beta = cgemm_operands(shape, B, dev, gen)
            act = (torch.arange(B, device=dev) % 3 != 1).to(torch.int32)
            kept = torch.randn((B, M, N), dtype=torch.complex64,
                               generator=gen, device=dev)

            def run(masked=False, tile=None):
                o = (x if xmode == "out" else kept) if masked else (
                    x if xmode == "out" else None)
                o = None if o is None else o.clone()
                xo = o if xmode == "out" else x
                kw = dict(op=op, x=xo, alpha=alpha, beta=beta, out=o,
                          active=act if masked else None)
                return (cg.cgemm(a, b, **kw) if tile is None
                        else cgemm_on_tile(tile, a, b, **kw))

            got, got_m = run(), run(True)
            with _LibraryOf(plib):
                want, want_m = run(), run(True)
            checks = {"parent": torch.equal(got, want),
                      "parent, active": torch.equal(got_m, want_m),
                      "slices": torch.equal(got, cgemm_on_slices(
                          cg.cgemm, shape, a, b, x, alpha, beta))}
            for k in tiles:
                checks[f"tile {names[k]}"] = (
                    torch.equal(run(tile=k), got)
                    and torch.equal(run(True, tile=k), got_m))
            bad = [c for c, ok in checks.items() if not ok]
            equal[f"{what} B={B}"] = not bad
            say("cgemm", f"{what:26s} B={B}: torch.equal to the parent's "
                f"(with and without active), on its slices and on every "
                f"tile: {not bad}" + (f" (differs: {bad})" if bad else ""))
            require(not bad, f"cgemm {what} B={B}: differs ({bad})")

    times = []
    for shape in CGEMM_SHAPES:
        what, M, K, N, op, shared, xmode = shape[:7]
        B = cgemm_batch(shape, N_BASELINES)
        a, b, x, alpha, beta = cgemm_operands(shape, B, dev, gen)
        o = x if xmode == "out" else None

        def fn(tile=None):
            kw = dict(op=op, x=x, alpha=alpha, beta=beta, out=o)
            if tile is None:
                cg.cgemm(a, b, **kw)
            else:
                cgemm_on_tile(tile, a, b, **kw)

        def parent_fn():
            with _LibraryOf(plib):
                fn()

        def parent_ms():
            with _LibraryOf(plib):
                return _time(fn, 20)

        ev = [parent_ms(), _time(fn, 20), _time(fn, 20), parent_ms()]
        seq = [parent_fn, fn, fn, parent_fn] + [
            functools.partial(fn, tile=k) for k in tiles]
        dv = _device_ms_seq(seq)
        aop = a if op == "N" else a.transpose(-2, -1)
        aop = aop.conj() if op == "H" else aop
        lib = _time((lambda: torch.matmul(aop, b)) if xmode is None else
                    (lambda: torch.baddbmm(x, aop, b, alpha=alpha)), 20)
        b_ms, by = cgemm_bound(B, M, K, N, shared, xmode is not None)
        row = {"what": what, "batch": B, "M": M, "K": K, "N": N, "op": op,
               "a_shared": shared, "x": xmode,
               "tile": cgemm_plan(B, M, N, K),
               "ms": (ev[1] + ev[2]) / 2, "parent_ms": (ev[0] + ev[3]) / 2,
               "turns": ev, "device_ms": (dv[1] + dv[2]) / 2,
               "parent_device_ms": (dv[0] + dv[3]) / 2,
               "device_turns": dv[:4],
               "tile_device_ms": dict(zip(names, dv[4:])),
               "library_ms": lib, "bound_ms": b_ms, "bound_by": by}
        row["fastest_tile"] = min(row["tile_device_ms"],
                                  key=row["tile_device_ms"].get)
        times.append(row)
        if what == "frc = F rc":
            times_fn = fn
        say("cgemm", f"{what:26s} B={B} {M}x{K}x{N} {op} ({row['tile']}): "
            f"device {row['device_ms']:.5f} ms, the parent's "
            f"{row['parent_device_ms']:.5f}; events {row['ms']:.5f}, the "
            f"parent's {row['parent_ms']:.5f}; library {lib:.5f}; bound "
            f"{b_ms:.5f} ({by}), {100 * b_ms / row['device_ms']:.1f} % of "
            f"the device time (parent "
            f"{100 * b_ms / row['parent_device_ms']:.1f} %); every tile "
            + ", ".join(f"{k} {v:.5f}"
                        for k, v in row["tile_device_ms"].items())
            + f"; fastest {row['fastest_tile']}")

    clocks = _clocks_under(times_fn)
    say("cgemm", f"F rc B={N_BASELINES}, 10000 launches in a row: "
        f"nvidia-smi 0.3 s in (SM clock, its max, power, limit): {clocks}")

    kit = 5
    jobs = make_jobs(N_BASELINES)
    mops, dims = build_ops(jobs, dev)
    B = mops.nid.shape[0]
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(), dims)
    iters = {"main": _replays_by_library(
        f"main megachain B={B}", lambda: megachain.chunk_body(
            mops, tables, dims, static, seed=SEED, sids=sids, warm_ns=3,
            drift_max=0.6), ps, kit, plib)}
    del mops, tables
    gs = grouped_setup(jobs[:1], tflag_signatures()[0], B, dev)
    G = len(gs.group_times)
    Bg = gs.mops.nid.shape[0]
    _, sids_r, sidc_r = grouped_ids(gs, Bg // G, dev)
    gtab = megachain.make_chain_tables(gs.mops, dev)
    gstatic = megachain.prior_static_from(make_prior(), gs.dims)
    psg = mega.pad_ps(np.tile(ps_truth(), (Bg, 1)), gs.dims, dev)
    iters["grouped"] = _replays_by_library(
        f"grouped {Bg // G} chains x G={G}", lambda: megachain.chunk_body(
            gs.mops, gtab, gs.dims, gstatic, seed=SEED, sids=sids_r,
            sidc=sidc_r, warm_ns=3, drift_max=0.6,
            group_times=gs.group_times, group_idx=gs.group_idx), psg, kit,
        plib)
    del gs, gtab
    wm, wd = build_ops(make_jobs(N_BASELINES, nf=WIDE_NF, seed=SEED + 20),
                       dev)
    wtab = megachain.make_chain_tables(wm, dev)
    wstatic = megachain.prior_static_from(make_prior(nf=WIDE_NF), wd)
    psw = mega.pad_ps(np.tile(ps_truth(WIDE_NF), (B, 1)), wd, dev)
    iters["wide"] = _replays_by_library(
        f"wide megachain n={WIDE_NF} B={B}", lambda: megachain.chunk_body(
            wm, wtab, wd, wstatic, seed=SEED, sids=sids, warm_ns=3,
            drift_max=0.6), psw, kit, plib)
    Path(out).write_text(json.dumps(
        {"device": torch.cuda.get_device_name(0), "ptxas": ptxas,
         "equal": equal, "times": times, "clocks_under_load": clocks,
         "iterations": iters}, indent=1))


def phase_times(dev, jobs):
    from hydra_pspec_torch.models import mega, megachain
    from hydra_pspec_torch.ops.kernels import draw_fused as df
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    K, P = I.KERNELS, I.PLAIN
    mops, dims = build_ops(jobs, dev)
    B, n, t = mops.nid.shape
    m = mops.fg.shape[2]
    nf, nt, nm = dims.nfreqs, dims.ntimes, dims.nmodes
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(), dims)
    prior = rb.prior_bins(static, dev)
    sass = sass_draw_slots()

    kit = 5
    chain = _time_chain(f"B={B}", lambda impl: megachain.run_chunk_megachain(
        mops, tables, dims, ps, kit, static, seed=SEED, sids=sids,
        warm_ns=3, drift_max=0.6, impl=impl, graph=False), kit)
    body = megachain.chunk_body(mops, tables, dims, static, seed=SEED,
                                sids=sids, warm_ns=3, drift_max=0.6)
    cg = _time_graph(f"B={B}", chain, body, ps, kit, drift_max=0.6)
    # the same chunk at the JAX package's layout (n = 128, t = 256, m = 16)
    jm, jd = build_ops(jobs, dev, "jax")
    jps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), jd, dev)
    jbody = megachain.chunk_body(
        jm, megachain.make_chain_tables(jm, dev), jd, static, seed=SEED,
        sids=sids, warm_ns=3, drift_max=0.6)
    layouts_ms = {"plain": _time_layouts(f"B={B}", {
        "port": (body, ps), "jax": (jbody, jps)}, kit)}
    profile = device_profile(lambda: megachain.run_chunk_megachain(
        mops, tables, dims, ps, PROFILE_ITERS, static, seed=SEED, sids=sids,
        warm_ns=3, drift_max=0.6, graph=False), PROFILE_ITERS,
        "eager kernel path")
    busy = profile["device_busy_ms"] / PROFILE_ITERS
    profile["busy_share_of_timed_iteration"] = busy / min(chain["kernels"])
    say("times", f"device busy {busy:.4f} ms an iteration under the "
        f"profiler = {100 * profile['busy_share_of_timed_iteration']:.1f} % "
        f"of the eager iteration timed without it")
    # the graph path: GRAPH_REPLAYS replays of the kit-iteration chunk
    gprofile = device_profile(
        lambda: [cg.replay(ps, 0) for _ in range(GRAPH_REPLAYS)],
        GRAPH_REPLAYS * kit, f"graph, {GRAPH_REPLAYS} replays of {kit}")
    busy = gprofile["device_busy_ms"] / (GRAPH_REPLAYS * kit)
    gprofile["busy_share_of_timed_iteration"] = busy / min(chain["graph"])
    say("times", f"graph path: device busy {busy:.4f} ms an iteration = "
        f"{100 * gprofile['busy_share_of_timed_iteration']:.1f} % of the "
        f"graph iteration timed without the profiler")
    del cg
    per = profile["kernel_ms_per_iteration"]
    profile["omega_passes_ms"] = sum(per.get(k, 0.0) for k in (
        "fields_kernel", "rhs_kernel", "system_kernel"))
    say("times", f"omega passes (rng_fields, draw_rhs, draw_system) "
        f"{profile['omega_passes_ms']:.4f} ms device time an iteration; "
        f"fields_kernel launched {per.get('fields_kernel', 0.0):.4f} ms")
    cgemm_rows = time_cgemm_shapes(dev)

    oa, ob = P.rng_fields(SEED, sids, 0, n, t, nt, nf)
    rc = P.draw_rhs(mops.nid, mops.nih, ob, nt)
    frc = P.cgemm(mops.f, rc)
    s, xs, dd, dinv = P.draw_system(mops.pt, ps, frc, oa, nt, nf)
    inv = P.herm_inv(s)
    x = P.cgemm(inv, xs)
    beta = P.row_scale_sumsq(x, dinv, dd)[1]
    da = torch.zeros_like(mops.a0)
    key = df.OmegaKey(SEED, sids, 0)
    cases = {   # draw_rhs and draw_system in the main path's keyed mode
        "cgemm": lambda M: M.cgemm(mops.f, rc),
        "herm_inv": lambda M: M.herm_inv(s),
        "draw_rhs": lambda M: M.draw_rhs(mops.nid, mops.nih, None, nt,
                                         key=key),
        "draw_system": lambda M: M.draw_system(mops.pt, ps, frc, None, nt,
                                               nf, key=key),
        "row_scale_sumsq": lambda M: M.row_scale_sumsq(x, dinv, dd),
        "draw_resid": lambda M: M.draw_resid(
            mops.dw, x, rc, mops.ninv_full, mops.w, da, mops.a0, nt,
            want_chi=True, want_chit=False, want_amp=True, want_ws=False),
        "bandpower": lambda M: M.bandpower(
            beta, prior, tables.tlog, tables.q, seed=SEED, sids=sids, g=0,
            alpha=nt - 1),
    }
    times = _time_pairs(f"B={B}", cases)
    # one PyTorch call computing the same function, where there is one
    library = {
        "cgemm": _time(lambda: torch.matmul(mops.f, rc), 10),
        "herm_inv": _time(lambda: torch.linalg.inv(s), 10),
    }
    # the data's own widths: n = nfreqs, m = nmodes, the true times
    shape = dict(B=B, n=nf, t=nt, m=nm, ntimes=nt, alpha=nt - 1)
    bounds = {k: bound(k, **shape) for k in cases}
    for k, (b_ms, by) in bounds.items():
        say("times", f"{k:16s} B={B}: bound {b_ms:.4f} ms ({by}), kernel "
            f"at {100 * b_ms / times[k][0]:.1f} % of it; library call "
            f"{library.get(k, float('nan')):.4f} ms")

    # device times (profiler) of the bandpower conditional and of the omega
    # passes in their two layouts, beside their bounds
    long_tab = long_tables(dev)
    dcases = {
        "bandpower": ("bandpower", shape, cases["bandpower"]),
        f"bandpower alpha={LONG_NT - 1}": (
            "bandpower", dict(shape, alpha=LONG_NT - 1),
            lambda M: M.bandpower(beta, prior, *long_tab, seed=SEED,
                                  sids=sids, g=0, alpha=LONG_NT - 1)),
        "draw_rhs": ("draw_rhs", shape, cases["draw_rhs"]),
        "draw_system": ("draw_system", shape, cases["draw_system"]),
        "rng_fields stored": ("rng_fields", shape, lambda M: M.rng_fields(
            SEED, sids, 0, n, t, nt, nf)),
        "draw_rhs stored": ("draw_rhs_stored", shape, lambda M: M.draw_rhs(
            mops.nid, mops.nih, ob, nt)),
        "draw_system stored": ("draw_system_stored", shape,
                               lambda M: M.draw_system(mops.pt, ps, frc, oa,
                                                       nt, nf)),
    }
    # what the warm start's masked rebuild costs when no chain rebuilds: an
    # active mask of zeros, and the gate mode (the drift gate in the launch)
    # with ps == psx; the gate mode with every chain rebuilding
    # (drift_max -1) against the unmasked launch
    none = torch.zeros((B,), dtype=torch.int32, device=dev)
    flags = torch.empty((B,), dtype=torch.int32, device=dev)
    inv_buf = K.herm_inv(s)
    dcases["herm_inv masked, none active"] = (
        "herm_inv", dict(shape, B=0),
        lambda M: M.herm_inv(s, out=inv_buf, active=none))
    dcases["herm_inv gate, none rebuild"] = (
        "herm_inv_gate", shape,
        lambda M: M.herm_inv(s, out=inv_buf, gate=(ps, ps, 0.6),
                             rebuild=flags))
    dcases["herm_inv gate, all rebuild"] = (
        "herm_inv", shape,
        lambda M: M.herm_inv(s, out=inv_buf, gate=(ps, ps, -1.0),
                             rebuild=flags))
    dcases["herm_inv unmasked"] = ("herm_inv", shape, cases["herm_inv"])
    # the keyed passes at the JAX package's layout: the same real work
    jkey = df.OmegaKey(SEED, sids, 0)
    jrc = P.draw_rhs(jm.nid, jm.nih, None, nt, key=jkey)
    jfrc = P.cgemm(jm.f, jrc)
    dcases["draw_rhs JAX layout"] = ("draw_rhs", shape, lambda M: M.draw_rhs(
        jm.nid, jm.nih, None, nt, key=jkey))
    dcases["draw_system JAX layout"] = (
        "draw_system", shape, lambda M: M.draw_system(jm.pt, jps, jfrc, None,
                                                      nt, nf, key=jkey))
    device = {}
    for k, (wk, sh, fn) in dcases.items():
        ms = _device_ms(lambda: fn(K))
        b_ms, by = bound(wk, **sh)
        device[k] = {"ms": ms, "bound_ms": b_ms, "bound_by": by}
        say("times", f"device time {k:22s} B={B}: {ms:.5f} ms, bound "
            f"{b_ms:.5f} ms ({by}), {100 * b_ms / ms:.1f} % of it")
    layouts = {
        "stored: rng_fields + draw_rhs + draw_system":
            ("rng_fields stored", "draw_rhs stored", "draw_system stored"),
        "keyed draw_rhs + keyed draw_system": ("draw_rhs", "draw_system")}
    layouts = {k: sum(device[c]["ms"] for c in v)
               for k, v in layouts.items()}
    for k, v in layouts.items():
        say("times", f"omega passes, layout {k}: {v:.5f} ms device time")
    del jm, jrc, jfrc

    # the grouped time-flags layout: 100 chains x G=3 of signature A
    gs = grouped_setup(jobs[:1], tflag_signatures()[0], B, dev)
    gm, G = gs.mops, len(gs.group_times)
    Bg, _, tg = gm.nid.shape
    ntot = gs.dims.ntimes
    rt, sids_r, sidc_r = grouped_ids(gs, Bg // G, dev)
    gtab = megachain.make_chain_tables(gm, dev)
    gstatic = megachain.prior_static_from(make_prior(), gs.dims)
    psg = mega.pad_ps(np.tile(ps_truth(), (Bg, 1)), gs.dims, dev)
    gkw = dict(group_times=gs.group_times, group_idx=gs.group_idx)
    gchain = _time_chain(
        f"{Bg // G} chains x G={G} (B={Bg}, t={tg})",
        lambda impl: megachain.run_chunk_megachain(
            gm, gtab, gs.dims, psg, kit, gstatic, seed=SEED, sids=sids_r,
            sidc=sidc_r, warm_ns=3, drift_max=0.6, impl=impl, graph=False,
            **gkw), kit)
    gbody = megachain.chunk_body(
        gm, gtab, gs.dims, gstatic, seed=SEED, sids=sids_r, sidc=sidc_r,
        warm_ns=3, drift_max=0.6, **gkw)
    _time_graph(f"{Bg // G} chains x G={G}", gchain, gbody, psg, kit,
                drift_max=0.6)
    # the same at the JAX package's layout (G = 4 with a dummy row, t = 128)
    gj = grouped_setup(jobs[:1], tflag_signatures()[0], B, dev, "jax")
    Gj = len(gj.group_times)
    rtj, sids_j, sidc_j = grouped_ids(gj, Bg // G, dev)
    psgj = mega.pad_ps(np.tile(ps_truth(), (Bg // G * Gj, 1)), gj.dims, dev)
    layouts_ms["grouped"] = _time_layouts(
        f"{Bg // G} chains of signature A", {
            "port": (gbody, psg),
            "jax": (megachain.chunk_body(
                gj.mops, megachain.make_chain_tables(gj.mops, dev), gj.dims,
                gstatic, seed=SEED, sids=sids_j, sidc=sidc_j, warm_ns=3,
                drift_max=0.6, group_times=gj.group_times,
                group_idx=gj.group_idx), psgj)}, kit)
    oa, ob = P.rng_fields(SEED, sids_r, 0, n, tg, ntot, nf, rt)
    rc = P.draw_rhs(gm.nid, gm.nih, ob, ntot, rt)
    frc = P.cgemm(gm.f, rc)
    s, xs, dd, dinv = P.draw_system(gm.pt, psg, frc, oa, ntot, nf, rt)
    x = P.cgemm(P.herm_inv(s), xs)
    beta = P.row_scale_sumsq(x, dinv, dd)[1]
    da = torch.zeros_like(gm.a0)
    gkey = df.OmegaKey(SEED, sids_r, 0)
    gcases = {
        "row_scale_sumsq": lambda M: M.row_scale_sumsq(x, dinv, dd),
        "draw_rhs": lambda M: M.draw_rhs(gm.nid, gm.nih, None, ntot, rt,
                                         gkey),
        "draw_system": lambda M: M.draw_system(gm.pt, psg, frc, None, ntot,
                                               nf, rt, gkey),
        "draw_resid": lambda M: M.draw_resid(
            gm.dw, x, rc, gm.ninv_full, gm.w, da, gm.a0, ntot,
            want_chi=True, want_chit=False, want_amp=True, want_ws=False,
            row_times=rt),
        "bandpower": lambda M: M.bandpower(
            beta, prior, gtab.tlog, gtab.q, seed=SEED, sids=sidc_r, g=0,
            alpha=ntot - 1, group=G),
    }
    gtimes = _time_pairs(f"grouped B={Bg} t={tg}", gcases)
    # each row's own time count: the lanes of all rows, rt.sum()
    gshape = dict(B=Bg, n=nf, t=tg, m=nm, ntimes=ntot, alpha=ntot - 1,
                  valid=int(rt.sum()), chains=Bg // G)
    gbounds = {k: bound(k, **gshape) for k in cases}
    for k in gcases:
        b_ms, by = gbounds[k]
        say("times", f"{k:16s} grouped B={Bg}: bound {b_ms:.4f} ms ({by}), "
            f"kernel at {100 * b_ms / gtimes[k][0]:.1f} % of it")
    # the keyed passes' device times, grouped, at both layouts
    gjm = gj.mops
    gjkey = df.OmegaKey(SEED, sids_j, 0)
    gjfrc = P.cgemm(gjm.f, P.draw_rhs(gjm.nid, gjm.nih, None, ntot, rtj,
                                      gjkey))
    for k, fn in (
            ("draw_rhs grouped", gcases["draw_rhs"]),
            ("draw_system grouped", gcases["draw_system"]),
            ("draw_rhs grouped JAX layout", lambda M: M.draw_rhs(
                gjm.nid, gjm.nih, None, ntot, rtj, gjkey)),
            ("draw_system grouped JAX layout", lambda M: M.draw_system(
                gjm.pt, psgj, gjfrc, None, ntot, nf, rtj, gjkey))):
        ms = _device_ms(lambda: fn(K))
        b_ms, by = gbounds[k.split()[0]]
        device[k] = {"ms": ms, "bound_ms": b_ms, "bound_by": by}
        say("times", f"device time {k:30s}: {ms:.5f} ms, bound {b_ms:.5f} "
            f"ms ({by}), {100 * b_ms / ms:.1f} % of it")
    del gj, gjm, gjfrc
    ms = _device_ms(lambda: gcases["bandpower"](K))
    b_ms, by = gbounds["bandpower"]
    device[f"bandpower grouped G={G}"] = {"ms": ms, "bound_ms": b_ms,
                                          "bound_by": by}
    say("times", f"device time bandpower {Bg // G} chains x G={G}: "
        f"{ms:.5f} ms, bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms:.1f} % "
        f"of it")
    return dict(chain=chain, times=times, library=library, bounds=bounds,
                gchain=gchain, gtimes=gtimes, gbounds=gbounds,
                gbatch=(Bg // G, G), profile=profile, cgemm_rows=cgemm_rows,
                device=device, omega_layouts=layouts,
                graph_profile=gprofile, layouts_ms=layouts_ms, sass=sass,
                iter_bounds={
                    "plain": iteration_bound(chain, bounds,
                                             chain["rebuild_share"],
                                             {t: nt}),
                    "grouped": iteration_bound(gchain, gbounds,
                                               gchain["rebuild_share"],
                                               {tg: int(rt.sum()) / Bg})})


def phase_times_fallback(dev, jobs, dense_jobs, tm):
    """The fallback engines' iterations at B=100 and the new kernel and
    entries against their plain versions, their bounds and library
    calls."""
    from hydra_pspec_torch.models import mega, megachain, rgibbs
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import herm_inv as hi
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import spd_solve as ss
    from hydra_pspec_torch.ops.kernels.megastep import gcr_megastep

    P = I.PLAIN
    kit = 5
    rops, ps_r, s_u, bins = real_system(dense_jobs, dev)
    B = s_u.shape[0]
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    real = {solver: _time_chain(
                f"real engine, dense Ninv, solver {solver}, B={B}",
                lambda impl, _s=solver: rgibbs.run_chain(
                    rops, ps_r, bins, kit, seed=SEED, sids=sids, solver=_s,
                    impl=impl), kit)
            for solver in ("pallas", "pallas2")}
    mops, dims = build_ops(jobs, dev)
    n, t, m = mops.nid.shape[1], mops.nid.shape[2], mops.fg.shape[2]
    nf, nt = dims.nfreqs, dims.ntimes
    ps = mega.pad_ps(np.tile(ps_truth(), (B, 1)), dims, dev)
    tables = megachain.make_chain_tables(mops, dev)
    mega_it = _time_chain(f"mega engine, B={B}", lambda impl:
                          mega.run_chain_mega(mops, dims, ps, bins, kit,
                                              tables.tlog, tables.q,
                                              seed=SEED, sids=sids,
                                              impl=impl, graph=False), kit)
    _time_graph(f"mega engine, B={B}", mega_it, mega.mega_chunk_body(
        mops, dims, bins, tables.tlog, tables.q, seed=SEED, sids=sids), ps,
        kit)

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    rhs = torch.randn((B, NF, NT), dtype=torch.complex64, generator=gen,
                      device=dev)
    ms, _ = ss.equilibrate(s_u)
    oa, ob = P.rng_fields(SEED, sids, 0, n, t, nt, nf)
    cases = {
        "herm_chol_solve": lambda M: M.herm_chol_solve(ms, rhs),
        "hermitian_solve": lambda M: hi.hermitian_solve(
            s_u, rhs, inv=M.herm_inv, mm=M.cgemm),
        "gcr_megastep": lambda M: gcr_megastep(
            mops, ps, oa, ob, nfreqs=nf, ntimes=nt,
            all_unflagged=dims.all_unflagged, impl=M),
        # the real engine's omegas: n = Nfreqs, t = Ntimes
        "rng_fields": lambda M: M.rng_fields(SEED, sids, 0, NF, NT, NT, NF),
    }
    times = _time_pairs(f"B={B}", cases)
    one = rhs[:, :, :1].contiguous()
    k1 = _time_pairs(f"B={B} K=1 (the factor and one sweep tile)",
                     {"herm_chol_solve": lambda M: M.herm_chol_solve(ms, one)}
                     )["herm_chol_solve"]
    k1_bound = bound("herm_chol_solve", **dict(
        B=B, n=NF, t=1, m=NM, ntimes=NT, alpha=NT - 1))
    k1_lib = _time(lambda: torch.linalg.solve(ms, one), 10)
    say("times", f"herm_chol_solve  B={B} K=1: bound {k1_bound[0]:.4f} ms "
        f"({k1_bound[1]}), kernel at {100 * k1_bound[0] / k1[0]:.1f} % of "
        f"it; library call {k1_lib:.4f} ms")
    library = {"herm_chol_solve": _time(lambda: torch.linalg.solve(ms, rhs),
                                        10),
               "hermitian_solve": _time(lambda: torch.linalg.solve(s_u, rhs),
                                        10)}
    solve_shape = dict(B=B, n=NF, t=NT, m=NM, ntimes=NT, alpha=NT - 1)
    main_shape = dict(B=B, n=nf, t=nt, m=dims.nmodes, ntimes=nt,
                      alpha=nt - 1)
    bounds = {"herm_chol_solve": bound("herm_chol_solve", **solve_shape),
              "hermitian_solve": bound("hermitian_solve", **solve_shape),
              "gcr_megastep": bound("gcr_megastep", **main_shape),
              "rng_fields": bound("rng_fields", **solve_shape)}
    for k, (b_ms, by) in bounds.items():
        say("times", f"{k:16s} B={B}: bound {b_ms:.4f} ms ({by}), kernel "
            f"at {100 * b_ms / times[k][0]:.1f} % of it; library call "
            f"{library.get(k, float('nan')):.4f} ms")
    ms_f = _device_ms(lambda: cases["rng_fields"](I.KERNELS))
    b_ms, by = bounds["rng_fields"]
    device = {"rng_fields": {"ms": ms_f, "bound_ms": b_ms, "bound_by": by}}
    # the issue floor: the draws' SASS slots a lane over the card's FP32
    # issue rate (an FMA a slot, two flops)
    slots = DRAW_SLOTS.get("rng_fields")
    if slots is not None:
        floor = B * NF * NT * slots * 2 / FP32_OPS_S * 1e3
        device["rng_fields"].update(issue_floor_ms=floor,
                                    floor_slots_per_lane=slots)
    say("times", f"device time rng_fields B={B} n={NF} t={NT}: {ms_f:.5f} "
        f"ms, bound {b_ms:.5f} ms ({by}), {100 * b_ms / ms_f:.1f} % of it"
        + (f"; issue floor {floor:.5f} ms ({slots:.1f} slots a lane)"
           if slots is not None else ""))
    # the real engine's iteration bound: its kernels at n = 120, t = 203
    rb_ = {k: bound(k, **solve_shape) for k in
           ("cgemm", "row_scale_sumsq", "rng_fields", "bandpower",
            "herm_chol_solve", "hermitian_solve", "herm_inv")}
    iter_bounds = {f"real_{k}": iteration_bound(v, rb_)
                   for k, v in real.items()}
    iter_bounds["mega"] = iteration_bound(mega_it, tm["bounds"], 1.0,
                                          {t: nt})
    for k, v in dict(tm["iter_bounds"], **iter_bounds).items():
        it_ms = {"plain": tm["chain"], "grouped": tm["gchain"],
                 "real_pallas": real["pallas"],
                 "real_pallas2": real["pallas2"], "mega": mega_it}[k]
        best = min(it_ms["kernels"])
        graph = (f"; graph iteration {min(it_ms['graph']):.4f} ms, "
                 f"{100 * v / min(it_ms['graph']):.1f} % of it"
                 if "graph" in it_ms else "")
        say("times", f"iteration bound {k}: {v:.4f} ms = sum of launches "
            f"per iteration x bound; eager iteration {best:.4f} ms, "
            f"{100 * v / best:.1f} % of it{graph}")
    _build.reset_launches()
    return dict(real=real, mega=mega_it, times=times, library=library,
                bounds=bounds, device=device, iter_bounds=iter_bounds,
                chol_k1={"ms": k1[0], "plain_ms": k1[1],
                         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
                         "library_ms": k1_lib})


def tflags_real_setup(jobs, dev):
    """The grouped real engine on ``jobs`` under :func:`rfi_windows` (11
    flag patterns, RFI in the flagged entries), as the runner builds it:
    ``(run(impl, niter), groups, sids)``, the chains from the truth."""
    from hydra_pspec_torch.models import rgibbs, tflags
    from hydra_pspec_torch.ops.invgamma import make_invgamma_table
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb

    flags = rfi_windows()
    per = [tflags.build_grouped_operators_real(j.d + RFI * flags, flags,
                                               j.fgmodes, j.Ninv)
           for j in jobs]
    groups = tflags.to_device([tflags.TimeGroupReal(
        ops=rgibbs.stack_chain_operators([p[g].ops for p in per]),
        idx=per[0][g].idx) for g in range(len(per[0]))], dev)
    igt = make_invgamma_table(NT)
    tl, q = (torch.from_numpy(np.asarray(a)).to(dev)
             for a in (igt.log_y, igt.q))
    ps = torch.as_tensor(np.tile(ps_truth(), (len(jobs), 1)),
                         dtype=torch.float32).to(dev)
    bins = rb.prior_bins(rb.bounded_bins(make_prior()), dev)
    sids = torch.arange(len(jobs), dtype=torch.int32, device=dev)

    def run(impl, niter):
        return tflags.run_chain_tflags_real(groups, ps, bins, niter, tl, q,
                                            seed=SEED, sids=sids,
                                            solver="pallas", impl=impl)
    return run, groups, sids


def _device_activities(fn, reps=2):
    """Device activities (kernels, copies, fills) a call of ``fn`` runs,
    by name, from one profiler window of ``reps`` calls."""
    def run():
        for _ in range(reps):
            fn()

    ev, _ = _profile_window(run, lambda ev: len(ev) % reps == 0)
    # a kernel's name without its template and argument lists, keeping
    # the "(anonymous namespace)" of its scope
    names = collections.Counter(
        re.sub(r"\((?!anonymous namespace\)).*$", "", name.split("<")[0])
        for _, _, name in ev)
    return len(ev) / reps, {k: v / reps for k, v in names.most_common()}


def tflags_real_iteration(dev, jobs, kit):
    """One iteration of the grouped real engine (``len(jobs)`` baselines,
    11 flag patterns) on the kernels and on the plain versions, in turns,
    with its hand-written launches and all its device activities an
    iteration."""
    from hydra_pspec_torch.ops.kernels import impl as I

    run, groups, _ = tflags_real_setup(jobs, dev)
    chain = _time_chain(f"grouped real engine, {len(groups)} flag patterns, "
                        f"B={len(jobs)}", lambda impl: run(impl, kit), kit)
    total, by_name = _device_activities(lambda: run(I.KERNELS, kit))
    chain.update(device_activities_per_iteration=total / kit,
                 device_activities_by_name={k: v / kit
                                            for k, v in by_name.items()})
    say("times", f"grouped real engine: {total / kit:.1f} device activities "
        f"an iteration (kernels, copies, fills), hand-written launches "
        f"{chain['launches_per_iteration']}")
    # the omegas: one rng_fields launch an iteration, and no gather of
    # them; the only indexing kernels left are each group's three scatters
    # (sig, fga and chi into the full time axis)
    rng = chain["launches_per_iteration"].get("rng_fields")
    index = sum(v for k, v in by_name.items()
                if "index" in k or "gather" in k) / kit
    require(rng == 1, f"grouped real engine: {rng} rng_fields launches an "
            f"iteration, not one")
    require(index == 3 * len(groups), f"grouped real engine: {index} "
            f"indexing kernels an iteration, not the {3 * len(groups)} "
            f"scatters of {len(groups)} groups (a gather of the omegas?)")
    # its bound, each launch at its own group's width: a group's
    # factor-solve (K = t_g), its three row passes (sk = dd u scaled with
    # y; the residual's and the masked power's sums unscaled) and its
    # cgemm launches at their recorded shapes; once an iteration the
    # omegas of all 203 times and the bandpower draw
    widths = [int(g.idx.shape[0]) for g in groups]
    G, T = len(widths), sum(widths)
    want = {"herm_chol_solve": G, "row_scale_sumsq": 3 * G, "rng_fields": 1,
            "bandpower": 1}
    per = {k: v for k, v in chain["launches_per_iteration"].items()
           if k != "cgemm"}
    require(per == want, f"grouped real engine: launches an iteration "
            f"{per}, the bound counts {want}")
    sh = lambda t: dict(B=len(jobs), n=NF, t=t, m=NM, ntimes=t)
    own = sum(bound("herm_chol_solve", **sh(t))[0]
              + bound("row_scale_sumsq", **sh(t), scales=1)[0]
              + 2 * bound("row_scale_sumsq", **sh(t), scales=0,
                          want_y=False)[0] for t in widths)
    own += (bound("rng_fields", **sh(T))[0]
            + bound("bandpower", **sh(T), alpha=T - 1)[0])
    products = iteration_bound(dict(chain, launches_per_iteration={}), {})
    chain["iteration_bound_ms"] = own + products
    best = min(chain["kernels"])
    say("times", f"iteration bound tflags_real: {own + products:.4f} ms "
        f"(cgemm {products:.4f}, the rest {own:.4f}) = sum of launches per "
        f"iteration x bound at each group's width; eager iteration "
        f"{best:.4f} ms, {100 * (own + products) / best:.2f} % of it")
    return chain


def parent_route(impl):
    """``impl`` with ``herm_inv`` and ``herm_chol_solve`` on the route that
    served 128 < n <= 192 before the lower-tile kernels: the blocked
    compositions over launches of at most 128 (``base_n=128``; the
    kernels up to 128 are the parent's, bit for bit)."""
    return impl._replace(
        herm_inv=functools.partial(impl.herm_inv, base_n=128),
        herm_chol_solve=functools.partial(impl.herm_chol_solve, base_n=128))


def _time_routes(label, cases, device=False, reps=10):
    """Each case ``fn(impl)`` on this tree's kernels and on
    :func:`parent_route`'s, in turns parent, this, this, parent: CUDA
    events over ``reps`` calls, or with ``device`` the profiler's device
    time."""
    from hydra_pspec_torch.ops.kernels import impl as I

    K, old = I.KERNELS, parent_route(I.KERNELS)
    clock = _device_ms if device else (lambda fn: _time(fn, reps))
    out = {}
    for name, fn in cases.items():
        t = [clock(lambda: fn(old)), clock(lambda: fn(K)),
             clock(lambda: fn(K)), clock(lambda: fn(old))]
        out[name] = {"ms": (t[1] + t[2]) / 2, "parent_ms": (t[0] + t[3]) / 2,
                     "turns": t}
        say("times", f"{'device ' if device else ''}{name} {label}: "
            f"{out[name]['ms']:.5f} ms, the parent's route "
            f"{out[name]['parent_ms']:.5f} ms (parent, this, this, parent "
            f"= {', '.join(f'{v:.5f}' for v in t)})")
    return out


def _time_graph_routes(label, make_body, ps, kit):
    """One iteration's time as a graph replay of a ``kit``-iteration chunk
    of ``make_body(impl)`` and eagerly, on this tree's kernels and on
    :func:`parent_route`'s, each in turns parent, this, this, parent."""
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels.graph import ChunkGraph

    bodies = {"this": make_body(I.KERNELS),
              "parent": make_body(parent_route(I.KERNELS))}
    graphs = {k: ChunkGraph(body, ps, kit) for k, body in bodies.items()}
    out = {}
    for mode in ("graph", "eager"):
        turns = {"this": [], "parent": []}
        for k in ("parent", "this", "this", "parent"):
            fn = ((lambda: graphs[k].replay(ps, 0)) if mode == "graph"
                  else (lambda: bodies[k](ps, 0, kit)))
            turns[k].append(_time(fn, 3) / kit)
        out[mode] = turns
        say("times", f"one iteration, {label}, {mode}: {turns['this']} ms, "
            f"the parent's route {turns['parent']} ms (parent, this, this, "
            f"parent)")
    del graphs
    torch.cuda.empty_cache()
    return out


def phase_times_wide(dev, jobs_w, dense_w):
    """The wide band (180 channels) at B=100: herm_inv and herm_chol_solve
    (K = 203 and 1) at n = 180 against their plain versions, bounds,
    library calls and the parent's route (the blocked compositions), the
    masked herm_inv with no chain rebuilding (device time, both routes);
    one megachain iteration and its bound, eagerly and as a graph replay,
    on both routes and at the JAX package's layout (n = 256); one mega
    iteration (graph replay) and one dense real iteration (eager) on both
    routes."""
    from hydra_pspec_torch.models import mega, megachain, rgibbs
    from hydra_pspec_torch.ops.kernels import _build
    from hydra_pspec_torch.ops.kernels import impl as I
    from hydra_pspec_torch.ops.kernels import rng_bandpower as rb
    from hydra_pspec_torch.ops.kernels import spd_solve as ss

    P = I.PLAIN
    mops, dims = build_ops(jobs_w, dev)
    B, n, t = mops.nid.shape
    nf, nt = dims.nfreqs, dims.ntimes
    sids = torch.arange(B, dtype=torch.int32, device=dev)
    ps = mega.pad_ps(np.tile(ps_truth(nf), (B, 1)), dims, dev)
    shape = dict(B=B, n=nf, t=nt, m=dims.nmodes, ntimes=nt, alpha=nt - 1)

    # the solves first: profiler windows after graph captures in a process
    # have lost device activities
    oa, ob = P.rng_fields(SEED, sids, 0, n, t, nt, nf)
    rc = P.draw_rhs(mops.nid, mops.nih, ob, nt)
    s = P.draw_system(mops.pt, ps, P.cgemm(mops.f, rc), oa, nt, nf)[0]
    _, _, s_u, _ = real_system(jobs_w, dev)
    ms, _ = ss.equilibrate(s_u)
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rhs = torch.randn((B, nf, NT), dtype=torch.complex64, generator=gen,
                      device=dev)
    one = rhs[:, :, :1].contiguous()
    cases = {"herm_inv": lambda M: M.herm_inv(s),
             "herm_chol_solve": lambda M: M.herm_chol_solve(ms, rhs),
             "herm_chol_solve K=1": lambda M: M.herm_chol_solve(ms, one)}
    times = _time_pairs(f"n={nf} B={B}", cases)
    routes = _time_routes(f"n={nf} B={B}", cases)
    # the warm start's gate mode when no chain rebuilds (ps == psx): the
    # gate and an early return in every block; on the parent's route two
    # base launches, four masked products, the blocks' copies and the
    # quadrant selects
    inv_buf = I.KERNELS.herm_inv(s)
    masked = _time_routes(f"n={nf} B={B}, gate mode, none rebuild", {
        "herm_inv masked": lambda M: M.herm_inv(s, out=inv_buf,
                                                gate=(ps, ps, 0.6))},
        device=True)["herm_inv masked"]
    library = {"herm_inv": _time(lambda: torch.linalg.inv(s), 10),
               "herm_chol_solve": _time(lambda: torch.linalg.solve(ms, rhs),
                                        10),
               "herm_chol_solve K=1": _time(
                   lambda: torch.linalg.solve(ms, one), 10)}
    solves = {}
    for k, fn in cases.items():
        kernel = k.split()[0]
        b_ms, by = bound(kernel, **dict(shape, t=NT if k == "herm_chol_solve"
                                        else 1))
        _build.reset_launches()
        fn(I.KERNELS)
        torch.cuda.synchronize()
        per_call = {c: v for c, v in _build.LAUNCHES.items() if v}
        solves[k] = {"n": nf, "batch": B, "ms": times[k][0],
                     "plain_ms": times[k][1], "parent_ms":
                     routes[k]["parent_ms"], "parent_turns":
                     routes[k]["turns"], "library_ms": library[k],
                     "bound_ms": b_ms, "bound_by": by,
                     "launches_per_call": per_call}
        say("times", f"{k:20s} n={nf} B={B}: bound {b_ms:.4f} ms ({by}), "
            f"kernel at {100 * b_ms / times[k][0]:.1f} % of it; library "
            f"call {library[k]:.4f} ms; the parent's route "
            f"{routes[k]['parent_ms']:.4f} ms; launches a call {per_call}")
    b_ms, by = bound("herm_inv_gate", **shape)
    masked.update(bound_ms=b_ms, bound_by=by)
    say("times", f"herm_inv gate    n={nf} B={B}, none rebuild: bound "
        f"{b_ms:.6f} ms ({by})")
    del s_u, ms, rhs, one
    _build.reset_launches()

    tables = megachain.make_chain_tables(mops, dev)
    static = megachain.prior_static_from(make_prior(nf=nf), dims)
    kit = 5
    chain = _time_chain(
        f"wide band n={n} ({nf} channels) B={B}",
        lambda impl: megachain.run_chunk_megachain(
            mops, tables, dims, ps, kit, static, seed=SEED, sids=sids,
            warm_ns=3, drift_max=0.6, impl=impl, graph=False), kit)

    def body_of(impl, m=mops, tb=tables, d=dims, st=static):
        return megachain.chunk_body(m, tb, d, st, seed=SEED, sids=sids,
                                    warm_ns=3, drift_max=0.6, impl=impl)

    _time_graph(f"wide band n={n} B={B}", chain, body_of(I.KERNELS), ps,
                kit, drift_max=0.6)
    bounds = {k: bound(k, **shape) for k in MAIN_KERNELS if k != "cgemm"}
    it_bound = iteration_bound(chain, bounds, chain["rebuild_share"],
                               {t: nt})
    best, gbest = min(chain["kernels"]), min(chain["graph"])
    say("times", f"iteration bound wide: {it_bound:.4f} ms; eager "
        f"iteration {best:.4f} ms, {100 * it_bound / best:.1f} % of it; graph "
        f"iteration {gbest:.4f} ms, {100 * it_bound / gbest:.1f} % of it")
    iters = {"megachain": _time_graph_routes(
        f"wide megachain n={n} B={B}", body_of, ps, kit)}
    bins = rb.prior_bins(rb.bounded_bins(make_prior(MEGA_HALF, nf)), dev)
    iters["mega"] = _time_graph_routes(
        f"wide mega n={n} B={B}", lambda impl: mega.mega_chunk_body(
            mops, dims, bins, tables.tlog, tables.q, seed=SEED, sids=sids,
            impl=impl), ps, kit)
    # the wide mega and dense real iterations' bounds (each launch priced
    # at its own shape) and plain times
    wide_bounds = dict(bounds, **{k: bound(k, **shape) for k in (
        "rng_fields", "herm_chol_solve")})
    mega_w = _time_chain(
        f"wide mega n={n} B={B}", lambda impl: mega.run_chain_mega(
            mops, dims, ps, bins, kit, tables.tlog, tables.q, seed=SEED,
            sids=sids, impl=impl, graph=False), kit)
    mega_w["iteration_bound_ms"] = iteration_bound(mega_w, wide_bounds, 1.0,
                                                   {t: nt})
    rops, ps_r, _, rbins = real_system(dense_w, dev)
    real_w = _time_chain(
        f"wide dense real, solver pallas, B={B}", lambda impl:
        rgibbs.run_chain(rops, ps_r, rbins, kit, seed=SEED, sids=sids,
                         solver="pallas", impl=impl), kit)
    real_w["iteration_bound_ms"] = iteration_bound(real_w, wide_bounds)
    for k, v in (("wide mega", mega_w), ("wide dense real", real_w)):
        best = min(v["kernels"])
        say("times", f"iteration bound {k}: {v['iteration_bound_ms']:.4f} "
            f"ms = sum of launches per iteration x bound; eager iteration "
            f"{best:.4f} ms, {100 * v['iteration_bound_ms'] / best:.1f} % "
            f"of it; plain {min(v['plain']):.4f} ms")
    iters["real"] = {"eager": _time_routes(
        f"wide dense real, solver pallas, {kit} iterations B={B}",
        {"real": lambda impl: rgibbs.run_chain(
            rops, ps_r, rbins, kit, seed=SEED, sids=sids, solver="pallas",
            impl=impl)}, reps=2)["real"]}
    iters["real"]["eager"] = {k: v / kit if k != "turns" else
                              [x / kit for x in v]
                              for k, v in iters["real"]["eager"].items()}
    say("times", f"one iteration, wide dense real B={B}: "
        f"{iters['real']['eager']['ms']:.4f} ms, the parent's route "
        f"{iters['real']['eager']['parent_ms']:.4f} ms")
    del rops
    _build.reset_launches()
    # the replayed iteration at the JAX package's layout (n = 256), after
    # the profiler windows: windows after graph captures in a process have
    # lost device activities
    jm, jd = build_ops(jobs_w, dev, "jax")
    jps = mega.pad_ps(np.tile(ps_truth(nf), (B, 1)), jd, dev)
    layouts_ms = _time_layouts(f"wide band B={B}", {
        "port": (body_of(I.KERNELS), ps),
        "jax": (megachain.chunk_body(
            jm, megachain.make_chain_tables(jm, dev), jd, static, seed=SEED,
            sids=sids, warm_ns=3, drift_max=0.6), jps)}, kit)
    return dict(chain=chain, iter_bound=it_bound, solves=solves,
                masked=masked, iterations=iters, layouts_ms=layouts_ms,
                mega_chain=mega_w, real_chain=real_w)


def times_process(out_root):
    """The timing phases (9) in a process of their own, on the same card,
    their results read back. In the process that ran the runner's traces
    (the main and cli phases' profile_dir) and the large runs after them,
    later profiler windows lost device activities (CUPTI records), so the
    windows of the timing phases start from a fresh process."""
    out = Path(out_root) / "times.json"
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--times",
                    str(out)], check=True)
    got = json.loads(out.read_text())
    return got["tm"], got["tf"], got["tw"]


def rows_process(out_root):
    """The two row passes' device times (:func:`rows_main`) in a process
    of their own, like the timing phases: many profiler windows in one
    process make its later windows lose device activities."""
    out = Path(out_root) / "rows.json"
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--rows",
                    str(out)], check=True)
    return json.loads(out.read_text())


def tfreal_process(out_root):
    """The grouped real engine's iteration (:func:`tfreal_main`) in a
    process of its own: its profiler window of thousands of device
    activities made the later windows of the timing process lose
    activities."""
    out = Path(out_root) / "tfreal.json"
    subprocess.run([sys.executable, str(Path(__file__).resolve()),
                    "--tfreal", str(out)], check=True)
    return json.loads(out.read_text())


def tfreal_main(out):
    """``python3 chip_smoke.py --tfreal OUT``: :func:`tflags_real_iteration`
    on the first ``N_TF_REAL`` of the timing phases' jobs, to OUT as
    JSON."""
    from hydra_pspec_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    tfr = tflags_real_iteration(dev, make_jobs(N_BASELINES)[:N_TF_REAL], 5)
    Path(out).write_text(json.dumps(tfr, default=float))


def times_main(out):
    """``python3 chip_smoke.py --times OUT``: the timing phases on the main
    path's, the dense and the wide band's jobs (made from the same seeds
    as in their phases), their results written to OUT as JSON."""
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.library()
    jobs = make_jobs(N_BASELINES)
    dense = make_jobs(N_BASELINES, dense=True, seed=SEED + 3)
    jobs_w = make_jobs(N_BASELINES, nf=WIDE_NF, seed=SEED + 20)
    dense_w = make_jobs(N_BASELINES, dense=True, seed=SEED + 21, nf=WIDE_NF)
    tm = phase_times(dev, jobs)
    tf = phase_times_fallback(dev, jobs, dense, tm)
    tw = phase_times_wide(dev, jobs_w, dense_w)
    Path(out).write_text(json.dumps({"tm": tm, "tf": tf, "tw": tw},
                                    default=float))


def multichip_main(n):
    """``python3 chip_smoke.py --multichip N`` on a machine with N cards:
    the multiproc phase with one rank a card (``cuda:{rank}``), the
    shards over every card and ``dryrun_multichip(N)``; its numbers as
    the last line (JSON). Not part of the one-card run."""
    from hydra_pspec_torch.ops.kernels import _build

    phase_env()
    require(torch.cuda.device_count() >= n,
            f"--multichip {n}: {torch.cuda.device_count()} cards")
    _build.build()
    _build.library()
    out_root = Path(tempfile.mkdtemp(prefix="chip_smoke_multichip_"))
    try:
        stats = phase_multiproc(
            torch.device("cuda", 0), make_jobs(N_MP), out_root, nranks=n,
            shard_devices=[torch.device("cuda", i) for i in range(n)])
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    print(json.dumps({"multichip": stats}), flush=True)


def main():
    phase_env()
    dev = torch.device("cuda", 0)
    from hydra_pspec_torch import runner
    from hydra_pspec_torch.ops.kernels import _build

    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    secs, log = _build.build_info()
    say("build", f"nvcc sm_90a: {secs if secs is not None else 0:.1f} s "
        f"(call {time.perf_counter() - t0:.1f} s)")
    for line in log.splitlines():
        if ("registers" in line or "spill" in line
                or "Compiling entry" in line):
            say("build", line.strip())

    jobs8 = make_jobs(8)
    jobs_w8 = make_jobs(8, nf=WIDE_NF,
                        seed=SEED + 20)
    errs = {}
    phase_kernels(dev, jobs8, jobs_w8, errs)
    mark("kernels", t0)
    phase_chain(dev, jobs8)
    jobs_w = make_jobs(N_BASELINES, nf=WIDE_NF, seed=SEED + 20)
    out_root = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        jobs, results, launches, rate, main_host = phase_main(dev, out_root)
        phase_invariance(dev, jobs, results)
        del results
        mark("main, invariance", t0)
        graphs = phase_graph(dev, jobs, jobs_w)
        layout_stats = phase_layout(dev, jobs, jobs_w)
        tf_launches, tf_stats = phase_tflags(dev, jobs, out_root / "tflags")
        mark("graph, tflags", t0)
        fb_launches, fb_stats, dense = phase_fallback(
            dev, jobs, out_root / "fallback")
        shutil.rmtree(out_root)   # the earlier files are checked: free
        out_root.mkdir()          # the disk for the cli's and wide band's
        cli_stats = phase_cli(dev, jobs, out_root)
        mark("fallback, cli", t0)
        wb_launches, wb_stats = phase_wideband(dev, out_root / "wideband")
        del jobs_w, dense
        torch.cuda.empty_cache()
        mark("wideband", t0)
        oracle_stats, oracle_launches = phase_oracle(dev)
        mark("oracle", t0)
        complex_stats = phase_complex(dev, jobs, out_root)
        torch.cuda.empty_cache()
        mark("complex", t0)
        multiproc_stats = phase_multiproc(dev, jobs, out_root / "multiproc")
        torch.cuda.empty_cache()
        mark("multiproc", t0)
        estimator_stats = phase_estimators(dev)
        mark("estimators", t0)
        scripts_stats = phase_scripts(dev, out_root)
        mark("scripts", t0)
        tm, tf, tw = times_process(out_root)
        rows = rows_process(out_root)
        tf["tflags_real"] = tfreal_process(out_root)
        mark("times", t0)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)

    paths = dict(main=launches, tflags=tf_launches, **fb_launches)
    device_ms = dict(tm["device"], **tf["device"])
    rows = []
    for k, (src, rep) in KERNELS.items():
        t = tm if k in tm["times"] else tf
        row = {"name": k, "route": "cuda", "source": src, "replaces": rep,
               "launches": paths[HOME_PATH[k]][k], "max_abs_err": errs[k],
               "ms": t["times"][k][0], "plain_ms": t["times"][k][1],
               "bound_ms": t["bounds"][k][0],
               "bound_by": t["bounds"][k][1],
               "library_ms": t["library"].get(k),
               "launches_path": HOME_PATH[k],
               "launches_by_path": {p: c[k] for p, c in paths.items()
                                    if c.get(k)}}
        if k in device_ms:
            row.update(device_ms=device_ms[k]["ms"])
            if "issue_floor_ms" in device_ms[k]:
                row.update(issue_floor_ms=device_ms[k]["issue_floor_ms"])
        if k in tm["gtimes"]:
            row.update(tflags_ms=tm["gtimes"][k][0],
                       tflags_plain_ms=tm["gtimes"][k][1],
                       tflags_bound_ms=tm["gbounds"][k][0],
                       tflags_bound_by=tm["gbounds"][k][1])
        rows.append(row)
    its = dict(plain=tm["chain"], grouped=tm["gchain"],
               real_pallas=tf["real"]["pallas"],
               real_pallas2=tf["real"]["pallas2"], mega=tf["mega"],
               tflags_real=tf["tflags_real"])
    print(json.dumps({
        "kernels": rows,
        "iteration_ms": {k: {"kernels": v["kernels"], "plain": v["plain"],
                             "graph": v.get("graph"),
                             "eager_beside_graph": v.get(
                                 "eager_beside_graph")}
                         for k, v in its.items()},
        "tflags_real_per_iteration": {
            "launches": tf["tflags_real"]["launches_per_iteration"],
            "device_activities": tf["tflags_real"][
                "device_activities_per_iteration"],
            "by_name": tf["tflags_real"]["device_activities_by_name"],
            "iteration_bound_ms": tf["tflags_real"]["iteration_bound_ms"]},
        "layout": layout_stats,
        "graph": {"checked": graphs,
                  "timed": {k: v["graph_capture"] for k, v in its.items()
                            if "graph_capture" in v},
                  "rebuilt_chains": {k: v.get("rebuilt_chains")
                                     for k, v in its.items()
                                     if "rebuilt_chains" in v},
                  "device_profile": tm["graph_profile"],
                  "wide": {"ms": tw["chain"]["graph"],
                           "eager_ms": tw["chain"]["eager_beside_graph"],
                           "capture": tw["chain"]["graph_capture"],
                           "masked_none_active_ms": tw["masked"]}},
        "iteration_bound_ms": dict(tm["iter_bounds"], **tf["iter_bounds"]),
        "graph_iteration_ms_by_layout": dict(tm["layouts_ms"],
                                             wide=tw["layouts_ms"]),
        "sass_draw": tm["sass"],
        "row_passes": rows,
        "iteration_batch": {"plain": N_BASELINES, "grouped": tm["gbatch"],
                            "real": N_BASELINES, "mega": N_BASELINES},
        "herm_chol_solve_k1": tf["chol_k1"],
        "main_baseline_iters_per_s": rate,
        "host_side": {"main": main_host, "cli": cli_stats},
        "tflags": dict(tf_stats, launches=tf_launches),
        "fallback": fb_stats,
        "cgemm_shapes": tm["cgemm_rows"],
        # (batch, M, K, N, op, A shared, X, masked, launches an iteration)
        "cgemm_launches_per_iteration": dict(
            {k: v.get("cgemm_shapes") for k, v in its.items()},
            wide=tw["chain"].get("cgemm_shapes")),
        "device_profile": tm["profile"],
        "device_ms": device_ms,
        "omega_layouts_ms": tm["omega_layouts"],
        "oracle": {"runs": oracle_stats, "launches": oracle_launches},
        "complex": complex_stats,
        "multiproc": multiproc_stats,
        "estimators": estimator_stats,
        "scripts": scripts_stats,
        "wideband": {
            "nfreqs": WIDE_NF, "runs": wb_stats, "launches": wb_launches,
            "solves": tw["solves"], "iterations_by_route": tw["iterations"],
            "iteration_ms": {k: tw["chain"][k] for k in ("kernels", "plain")},
            "iteration_bound_ms": tw["iter_bound"],
            "mega_and_dense_real": {k: {f: tw[k][f] for f in (
                "kernels", "plain", "iteration_bound_ms",
                "launches_per_iteration")}
                for k in ("mega_chain", "real_chain")},
            "launches_per_iteration": tw["chain"]["launches_per_iteration"]}}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--times"]:
        times_main(sys.argv[2])
    elif sys.argv[1:2] == ["--multiproc"]:
        multiproc_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5])
    elif sys.argv[1:2] == ["--tfreal"]:
        tfreal_main(sys.argv[2])
    elif sys.argv[1:2] == ["--rows"]:
        rows_main(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--herm"]:
        herm_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--rng"]:
        rng_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--cgemm"]:
        cgemm_main(sys.argv[2], sys.argv[3])
    elif sys.argv[1:2] == ["--multichip"]:
        multichip_main(int(sys.argv[2]))
    else:
        main()
