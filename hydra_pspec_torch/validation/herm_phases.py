"""Where the time of the lower-tile Hermitian kernels goes on the card
(``herm_inv`` and ``herm_chol_solve`` at 128 < n <= 192): each kernel
built again from an edited copy of ``csrc/`` that returns after one of its
phases, and timed beside the unedited kernel at n = 180, B = 100, K = 203
and 1; and the same with the k loops of its tile products unrolled to
other depths.

    python3 -m hydra_pspec_torch.validation.herm_phases [--out FILE]

A phase's time is the difference of two cut points (the factor is
``factored`` minus ``loaded``). Each time is the best of three runs of 20
launches (CUDA events), in two rounds over every build in turn. The
edited copies build into ``hydra_pspec_torch/_build/phases/``
(git-ignored), one library a copy with the plain C entry (one nvcc each,
all started together), loaded with ctypes; an edit whose anchor is not
found once in its source stops the run. Prints the card's name and power
limit first.
"""
import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

N, B, K, REPS = 180, 100, 203, 20
PKG = Path(__file__).resolve().parents[1]
CSRC, OUT = PKG / "csrc", PKG / "_build" / "phases"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_INV_L = ("#pragma unroll 4\n          for (int k = 0; k < TB; ++k) {\n"
          "            const float2 l = L[k * TS + lane];")
_INV_X = ("#pragma unroll 4\n          for (int k = 0; k < TB; ++k) {\n"
          "            const float2 x = Xj[k * TS + lane];")
_STRIP = ("#pragma unroll 2\n  for (int k = 0; k < TB; ++k) {\n"
          "    const float4 xp")
_RET = "  return;\n"

# build name -> (source, [(anchor, replacement)]): herm_inv_tri_kernel's
# and solve_tri_kernel's cut points and unroll depths
BUILDS = {
    "inv": ("herm_inv.cu", []),
    "inv loaded": ("herm_inv.cu", [(
        "  htri::load_lower<NB>(A, S + boff, n);\n",
        "  htri::load_lower<NB>(A, S + boff, n);\n" + _RET)]),
    "inv factored": ("herm_inv.cu", [(
        "  htri::chol<NB>(A);                  // 1.\n",
        "  htri::chol<NB>(A);                  // 1.\n" + _RET)]),
    "inv L^-1": ("herm_inv.cu", [(
        "  // 3. S^-1_IJ = sum_{K >= I} X_KI^H X_KJ into tile (I, J), rows "
        "top down\n", _RET)]),
    "inv unroll 2": ("herm_inv.cu", [
        (a, a.replace("unroll 4", "unroll 2")) for a in (_INV_L, _INV_X)]),
    "inv unroll 8": ("herm_inv.cu", [
        (a, a.replace("unroll 4", "unroll 8")) for a in (_INV_L, _INV_X)]),
    "solve": ("herm_chol_solve.cu", []),
    "solve factored": ("herm_chol_solve.cu", [(
        "  htri::chol<NB>(L);\n", "  htri::chol<NB>(L);\n" + _RET)]),
    "solve folded": ("herm_chol_solve.cu", [(
        "  // 3. chunk c of 16 columns, rows 8q..8q+7 of every row block\n",
        _RET)]),
    "solve unroll 1": ("herm_chol_solve.cu", [
        (_STRIP, _STRIP.replace("unroll 2", "unroll 1"))]),
    "solve unroll 4": ("herm_chol_solve.cu", [
        (_STRIP, _STRIP.replace("unroll 2", "unroll 4"))]),
}


def build_all():
    """Every build of :data:`BUILDS`, one nvcc each, all started together:
    {name: the edited copy's C entry (ctypes, argtypes set)}."""
    from hydra_pspec_torch.ops.kernels import _build

    procs = {}
    for name, (source, edits) in BUILDS.items():
        d = OUT / name.replace(" ", "_").replace("^", "")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(CSRC, d)
        src = (d / source).read_text()
        for anchor, new in edits:
            if src.count(anchor) != 1:
                raise RuntimeError(f"{name}: anchor not found once: "
                                   f"{anchor!r}")
            src = src.replace(anchor, new)
        (d / source).write_text(src)
        procs[name] = (d / "lib.so", source, subprocess.Popen(
            [_build._nvcc(), *NVCC_FLAGS, "-shared", "-I", str(d), "-o",
             str(d / "lib.so"), str(d / source)]))
    fns = {}
    for name, (so, source, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"{name}: nvcc failed")
        entry = ("hk_herm_inv" if source == "herm_inv.cu"
                 else "hk_herm_chol_solve")
        fn = getattr(ctypes.CDLL(str(so)), entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def system(dev):
    """B equilibrated Hermitian PD matrices (a Wishart draw + 0.05 I) and
    K right-hand sides, complex64 on ``dev``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(N)
    g = torch.randn((B, N, 2 * N), dtype=torch.complex128, generator=gen,
                    device=dev)
    a = g @ g.mH / (2 * N) + 0.05 * torch.eye(N, device=dev)
    d = 1 / torch.sqrt(torch.diagonal(a, dim1=-2, dim2=-1).real)
    s = (a * d[..., :, None] * d[..., None, :]).to(torch.complex64)
    rhs = torch.randn((B, N, K), dtype=torch.complex64, generator=gen,
                      device=dev)
    return s.contiguous(), rhs


def best_ms(call):
    import torch

    call()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    runs = []
    for _ in range(3):
        a.record()
        for _ in range(REPS):
            err = call()
        b.record()
        torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"CUDA error {err}")
        runs.append(a.elapsed_time(b) / REPS)
    return min(runs)


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the times as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("herm_phases: needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    s, rhs = system(dev)
    one = rhs[:, :, :1].contiguous()
    out, x, x1 = (torch.empty_like(s), torch.empty_like(rhs),
                  torch.empty_like(one))
    stream = torch.cuda.current_stream().cuda_stream
    fns = build_all()
    calls = {}
    for name, fn in fns.items():
        if name.startswith("inv"):
            calls[name] = (lambda fn=fn: fn(s.data_ptr(), out.data_ptr(), B,
                                            N, None, None, None, 0.0, 0,
                                            None, stream))
        else:
            for k, b, xb in ((K, rhs, x), (1, one, x1)):
                calls[f"{name} K={k}"] = (
                    lambda fn=fn, b=b, xb=xb: fn(
                        s.data_ptr(), b.data_ptr(), None, xb.data_ptr(), B,
                        N, b.shape[2], stream))
    times = {name: [] for name in calls}
    for _ in range(2):
        for name, call in calls.items():
            times[name].append(best_ms(call))
    for name, t in times.items():
        print(f"{name:24s} n={N} B={B}: {min(t):.5f} ms (rounds "
              f"{', '.join(f'{v:.5f}' for v in t)})", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"n": N, "batch": B, "k": K, "ms": times}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
