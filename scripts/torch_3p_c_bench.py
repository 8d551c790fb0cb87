"""Time 3p (the poincaré flash forward), C (the oblique whole-S backward,
its small-S mode) and 2p (the poincaré whole-S backward, its small-S mode),
parent against change, on one NVIDIA GPU.

    python3 scripts/torch_3p_c_bench.py [--parent DIR] [--parent-rev REV]
        [--rounds 6] [--passes 2] [--only 3p,C,crossover,2p,crossover2p]
        [--out FILE]

3p: ``flash_geodesic_attention``'s forward (``mhgsa._launch_flash``) at the
NBA recipe's B = 2304 shape, 88 × 2304² × 8 (as the Q3 swap hands it over),
on ball points at c = 1 (the CLI's default; the epilogue's c = 1 form) and
c = 0.7 (the general form), beside the oblique F at the same shape. C:
``fused_geodesic_attention_backward`` at the bench recipe's 88 × 128² × 8
and on one 1 × 1 × 8 problem (its launch floor). Parent and change are
timed through their public entries as ``chip_smoke.py``'s ``paired_ms``
does: the wrapper ms (CUDA events around back-to-back calls), the host µs
per call (the host clock around the same calls, before synchronizing) and
the device µs per launch (the profiler's kernel time), in the order parent,
change, the variants, the variants, change, parent, ``--rounds`` times; the
median of each is printed with its samples.

The variants take the parts of the design apart (compile-time defines, off
by default, built from this checkout's sources):

- 3p ``ieee_epilogue``: poincare::pair, score and expf in place of
  poincare::fwd_weight (``-DSTTODE_FLASH_FWD_IEEE_EPILOGUE=1``);
  ``reg_staging``: each key staged through a thread's registers in place
  of cp.async (``-DSTTODE_FLASH_FWD_REG_STAGING=1``); ``min_blocks1``:
  launch bounds without the minimum of 8 resident blocks an SM, which caps
  the registers at 64 (``-DSTTODE_FLASH_FWD_MIN_BLOCKS=1``); ``rows2_*``:
  two query rows a thread (``-DSTTODE_FLASH_FWD_ROWS=2``), uncapped, with
  keys through registers, or at 6 blocks an SM; each with its registers
  and spills from the build;
- C ``ieee_epilogue``: acosf, expf and rsqrtf in the small-S mode
  (``-DSTTODE_SMALL_BWD_IEEE_EPILOGUE=1``): the row/key ownership alone;
- C ``one_slice``: the small-S mode with one slice, each thread all the keys
  of its row and then all the rows of its key
  (``-DSTTODE_SMALL_BWD_ONE_SLICE=1``); ``threads512``: blocks of at most
  512 threads at Dh ≤ 8 (``-DSTTODE_SMALL_BWD_THREADS_DH8=512``);
- C ``old_mode``: the one-block-per-problem kernel of before as this
  checkout builds it (``-DSTTODE_SMALL_BWD_MODE=0``), and ``small_all``:
  the small-S mode wherever it fits (``=1``).

``--only 2p`` times 2p, the poincaré whole-S backward
(``fused_geodesic_attention_backward`` with ``metric="poincare"``), parent
against change through that public entry, each build in a child process
of its own (the parent's from the ``--parent`` checkout), in the order
parent, change, the variants, then reversed, ``--passes`` times: at the
poincaré NBA recipe's 88 × 32² × 8 (c = 1, the CLI's default, and c = 0.7,
the general form), at 88 × 128² × 8, at the agent-axis server's
512 × 8² × 8 with a mask (finfo.min exclusions, an all-excluded row; dmask
asked for) and on one 1 × 1 × 8 problem (the launch floor); the wrapper
ms, host µs and device µs of each, gradients held to the plain backward
within 5e-5 × max(1, max |g|) and the all-excluded row's to exactly 0. The
parent's and the change's children also time C at 88 × 128² × 8 and Q
(the packed backward) at 11 × 8 × 32² × 8, the two other users of
``csrc/small_bwd.cuh``'s body, and the outputs of every build are compared
bit for bit with the parent's. The 2p variants are builds of this
checkout's ``mhgsa_bwd.cu`` (``P2_VARIANTS``): ``ieee_epilogue`` (every
poincaré SFU piece, and C's, in IEEE), each piece alone in IEEE
(``STTODE_SMALL_BWD_IEEE_PIECES``: ``ieee_weight``, ``ieee_w``,
``ieee_half_over_n``, ``ieee_r``), ``one_slice``, ``threads1024``
(poincaré blocks of up to 1024 threads at Dh ≤ 8, capping the registers
at 64), ``old_mode`` (``STTODE_SMALL_BWD_MODE=0``: the kernel of before as
this checkout builds it) and ``small_all`` (``=1``). ``--only crossover2p``
times the poincaré crossover, 88 × S² × Dh at c = 1, S = 8 … 1280, Dh = 8,
16 and 32, with and without a mask, wherever the small-S mode's staging
fits shared memory, in ``small_all`` against ``old_mode`` (ABBA over
``--passes``). Each prints its builds' registers and spills;
``--p2-builds`` and ``--p2-cases`` (comma lists) restrict 2p's builds and
its cases, the cases run in the order given. E.g.:

    python3 scripts/torch_3p_c_bench.py --only 2p,crossover2p \
        --parent DIR --out p2.jsonl

The C variants run in child processes, one library each (loading several
builds of ``mhgsa_bwd.cu`` into one process crashed on the card's machine),
at 88 × 128² × 8 and over C's crossover: 88 × S² × Dh, S = 8 … 1024,
Dh = 8, 16 and 32, without a mask and with an additive one (finfo.min
exclusions and finite entries; dmask asked for), where the small-S mode's
staging fits shared memory; each child also times the change as it is.

Every output is held to its plain version on the card: the forward and its
lse within 1e-5, gradients within 5e-5 × max(1, max |g|). One JSON line
per measurement, each with the card's name and power limit.

The parent is a checkout of the commit before (``--parent``; when the
directory does not exist it is exported with ``git archive --parent-rev``,
default HEAD~1, which needs the repository's ``.git``: on a machine without
it, export it first); its package is imported as
``sttode_tpu_torch_parent`` from the git-ignored ``.bench_3p_c/``, where the
variants are built too (one nvcc per source, all started together). Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_small_attn_bench as sab  # noqa: E402

WORK = os.path.join(ROOT, ".bench_3p_c")
FWD_TOL = 1e-5
GRAD_TOL = 5e-5
FWD = "flash_mhgsa_fwd.cu"
BWD = "mhgsa_bwd.cu"


def _fwd(**defs):
    return ([f"-DSTTODE_FLASH_FWD_{k.upper()}={v}" for k, v in defs.items()],
            [FWD])


FWD_VARIANTS = {
    "ieee_epilogue": _fwd(ieee_epilogue=1),
    "reg_staging": _fwd(reg_staging=1),
    "min_blocks1": _fwd(min_blocks=1),
    "rows2_min_blocks1": _fwd(rows=2, min_blocks=1),
    "rows2_reg_staging_min_blocks1": _fwd(rows=2, reg_staging=1,
                                          min_blocks=1),
    "rows2_min_blocks6": _fwd(rows=2, min_blocks=6),
}
BWD_VARIANTS = {
    "ieee_epilogue": (["-DSTTODE_SMALL_BWD_IEEE_EPILOGUE=1"], [BWD]),
    "one_slice": (["-DSTTODE_SMALL_BWD_ONE_SLICE=1"], [BWD]),
    "threads512": (["-DSTTODE_SMALL_BWD_THREADS_DH8=512"], [BWD]),
    "old_mode": (["-DSTTODE_SMALL_BWD_MODE=0"], [BWD]),
    "small_all": (["-DSTTODE_SMALL_BWD_MODE=1"], [BWD]),
}
# the C cases every child times: (B, L = S, Dh, masked), the recipe's shape
# and the launch floor first
C_CASES = [(88, 128, 8, False), (1, 1, 8, False)]
CROSSOVER = [(88, S, Dh, masked) for masked in (False, True)
             for Dh in (8, 16, 32)
             for S in (8, 16, 32, 64, 128, 256, 512, 1024)]


# 2p's variants: builds of this checkout's mhgsa_bwd.cu, each alone
P2_VARIANTS = {
    "ieee_epilogue": (["-DSTTODE_SMALL_BWD_IEEE_EPILOGUE=1"], [BWD]),
    **{f"ieee_{n}": ([f"-DSTTODE_SMALL_BWD_IEEE_PIECES={bit}"], [BWD])
       for n, bit in (("weight", 1), ("w", 2), ("half_over_n", 4),
                      ("r", 8))},
    "one_slice": (["-DSTTODE_SMALL_BWD_ONE_SLICE=1"], [BWD]),
    "threads1024": (["-DSTTODE_SMALL_BWD_BALL_THREADS_DH8=1024"], [BWD]),
    "old_mode": (["-DSTTODE_SMALL_BWD_MODE=0"], [BWD]),
    "small_all": (["-DSTTODE_SMALL_BWD_MODE=1"], [BWD]),
}
# the cases of a 2p child: name → (kernel, lead, L, S, Dh, c, masked); C
# and Q only in the parent's and the change's
P2_CASES = {
    "2p_88x32x32x8_c1": ("2p", (88,), 32, 32, 8, 1.0, False),
    "2p_88x32x32x8_c0.7": ("2p", (88,), 32, 32, 8, 0.7, False),
    "2p_88x128x128x8_c1": ("2p", (88,), 128, 128, 8, 1.0, False),
    "2p_512x8x8x8_masked": ("2p", (512,), 8, 8, 8, 1.0, True),
    "2p_floor_1x1x1x8": ("2p", (1,), 1, 1, 8, 1.0, False),
    "C_88x128x128x8": ("C", (88,), 128, 128, 8, 1.0, False),
    "Q_11x8x32x32x8": ("Q", (11, 8), 32, 32, 8, 1.0, False),
}
P2_CROSSOVER = [(S, Dh, masked) for masked in (False, True)
                for Dh in (8, 16, 32)
                for S in (8, 16, 32, 64, 128, 256, 512, 1024, 1280)]
P2_KERNELS = ("mhgsa_small_bwd_kernel|mhgsa_bwd_kernel|"
              "packed_small_bwd_kernel")


def grad_err(got, want):
    """The largest error of the gradients (dq, dk, dv, dmask) over each
    one's tolerance, and the largest error."""
    worst, err = 0.0, 0.0
    for g, w in zip(got, want):
        if w is None:
            continue
        e = float((g - w).abs().max())
        worst = max(worst, e / (GRAD_TOL * max(1.0, float(w.abs().max()))))
        err = max(err, e)
    return worst, err


def ptxas(log_path: str):
    """(kernel<template arguments>, registers, spill line) of the flash
    forward (3p: ``flash_fwd_kernel`` with the poincaré policy; the parent's
    ``flash_poincare_fwd_kernel``) and the small-S C kernels in an nvcc
    -Xptxas -v log."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    kernels = ("flash_poincare_fwd_kernel|flash_fwd_kernel|"
               "mhgsa_small_bwd_kernel")
    out, name, spill = [], None, ""
    with open(log_path) as f:
        for line in f:
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                name = (cs.sweep_name(mangled, kernels)
                        if re.search(kernels, mangled) else None)
                spill = ""
            elif name and "spill" in line:
                spill = line.split(":", 1)[-1].strip()
            elif name and "Used" in line:
                regs = int(re.search(r"Used (\d+) registers", line).group(1))
                out.append((name, regs, spill))
                name = None
    return out


def common():
    """What the parent process and the children share: the kernels'
    modules, the device and input makers from a numpy seed."""
    sys.path.insert(0, ROOT)
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    return _build, km, dev, rng, randn


def bwd_case(km, rng, randn, dev, B, L, S, Dh, masked):
    """C's operands and a check of its gradients against the plain
    backward (which raises beyond the tolerance; returns the max error)."""
    q, k, v, do = (randn(B, n, Dh) for n in (L, S, S, L))
    m3 = None
    if masked:
        raw = torch.where(torch.from_numpy(rng.random((B, L, S)) < 0.2)
                          .to(dev), torch.finfo(torch.float32).min,
                          3.0 * randn(B, L, S))
        m3 = km._canonicalize_mask(raw)
    a = (q, k, v, m3, do)
    want = km.fused_geodesic_attention_backward_reference(*a, masked)

    def check(got):
        worst, e = grad_err(got, want)
        if not worst <= 1.0:
            raise AssertionError(f"C {B}x{L}x{S}x{Dh} masked={masked}: max "
                                 f"abs err {e}")
        return e
    return a, check


def child(name: str, rounds: int) -> int:
    """Time C at C_CASES and CROSSOVER with one variant's library (or the
    change as it is); print one JSON line per case."""
    _build, km, dev, rng, randn = common()
    if name != "change":
        fn = sab.load_variant(_build, WORK, name, ("mhgsa_bwd",))
        km._BWD.fn = fn["mhgsa_bwd"]
    with torch.inference_mode():
        for B, S, Dh, masked in C_CASES + CROSSOVER:
            if km.small_bwd_layout(S, S, Dh)["smem_bytes"] > \
                    km.SMEM_OPTIN_BYTES:
                continue
            a, check = bwd_case(km, rng, randn, dev, B, S, S, Dh, masked)

            def call(a=a, masked=masked):
                return km.fused_geodesic_attention_backward(
                    *a, need_dmask=masked)
            err = check(call())
            res = sab.interleaved({name: call}, [name], rounds)[name]
            print(json.dumps(dict(
                kernel="C", variant=name, masked=masked,
                shape=f"{B}x{S}x{S}x{Dh}",
                small_bwd_mode=km.small_bwd_mode(S, S, Dh),
                wrapper_ms=res[0], host_us=res[1], ms_samples=res[2],
                device_us=sab.device_us(call), max_abs_err=err)),
                flush=True)
            del a
            torch.cuda.empty_cache()
    return 0


def p2_inputs(dev, kernel, lead, L, S, Dh, c, masked, seed):
    """A 2p, C or Q case's operands from a numpy seed: q and k (ball points
    of norm 0.35–0.65/√c for 2p), v, the canonicalized mask (a fifth of the
    entries excluded, the rest finite, row 0 all excluded) or None, and
    do."""
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    def ball(*shape):
        x = rng.standard_normal(shape)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        r = 0.35 + 0.3 * rng.random(shape[:-1] + (1,))
        return (x * r / c ** 0.5).astype(np.float32)

    if kernel == "2p":
        q, k = ball(*lead, L, Dh), ball(*lead, S, Dh)
    else:
        q, k = arr(*lead, L, Dh), arr(*lead, S, Dh)
    v, do = arr(*lead, S, Dh), arr(*lead, L, Dh)
    mask = None
    if masked:
        mask = np.where(rng.random((*lead, L, S)) < 0.2,
                        np.finfo(np.float32).min, arr(*lead, L, S))
        mask[..., 0, :] = np.finfo(np.float32).min
    return [None if x is None else torch.from_numpy(x).to(dev)
            for x in (q, k, v, mask, do)]


def p2_child(args) -> int:
    """One build's turn at 2p (with ``--crossover``, at P2_CROSSOVER): this
    process imports the working directory's package (with ``--lib``, the
    whole-S backward's C entry from a variant's library), checks and times
    each case, prints one JSON line each and dumps the gradients to
    ``--dump``."""
    sys.path.insert(0, os.getcwd())
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.lib:
        km._BWD.fn = sab.load_variant(_build, WORK, args.p2_child,
                                      ("mhgsa_bwd",))["mhgsa_bwd"]
    if args.p2_child == "old_mode":
        # the mode's Python form follows the build: the wrapper then
        # allocates the workspace where the kernel of before needs it
        km.small_bwd_mode = lambda *a, **kw: False
    dev = torch.device("cuda")
    if args.crossover:
        cases = {f"2p_88x{S}x{S}x{Dh}{'_masked' if m else ''}":
                 ("2p", (88,), S, S, Dh, 1.0, m)
                 for S, Dh, m in P2_CROSSOVER
                 if km.small_bwd_layout(S, S, Dh, metric="poincare")[
                     "smem_bytes"] <= km.SMEM_OPTIN_BYTES}
    else:
        names = args.p2_cases.split(",") if args.p2_cases else P2_CASES
        cases = {n: P2_CASES[n] for n in names
                 if P2_CASES[n][0] == "2p"
                 or args.p2_child in ("parent", "change")}
    dumps = {}
    with torch.inference_mode():
        for i, (name, case) in enumerate(cases.items()):
            kernel, lead, L, S, Dh, c, masked = case
            q, k, v, raw, do = p2_inputs(dev, *case, seed=60 + i)
            if kernel == "Q":
                call = (lambda a=(q, k, v, None, do):
                        kp.packed_geodesic_attention_backward(*a))
                want = kp.packed_geodesic_attention_backward_reference(
                    q, k, v, None, do)
            else:
                kw = dict(metric="poincare" if kernel == "2p" else "oblique",
                          curvature=c)
                mask = None if raw is None else km._canonicalize_mask(raw)
                a = (q, k, v, mask, do)
                call = (lambda a=a, masked=masked, kw=kw:
                        km.fused_geodesic_attention_backward(
                            *a, need_dmask=masked, **kw))
                want = km.fused_geodesic_attention_backward_reference(
                    *a, masked, kw["metric"], c)
            got = call()
            torch.cuda.synchronize()
            worst, err = grad_err(got, want)
            if not worst <= 1.0:
                raise AssertionError(f"{name} {args.p2_child}: max abs err "
                                     f"{err}")
            if masked and not (bool((got[0][:, 0] == 0).all())
                               and bool((got[3][:, 0] == 0).all())):
                raise AssertionError(f"{name} {args.p2_child}: an "
                                     f"all-excluded row's gradients not 0")
            dumps[name] = [g.cpu() for g in got if g is not None]
            res = sab.interleaved({name: call}, [name], args.rounds,
                                  calls=10 if args.crossover else 20)[name]
            print(json.dumps(dict(
                kernel=kernel, build=args.p2_child, shape=name,
                small_bwd_mode=(km.small_bwd_mode(L, S, Dh, metric="poincare")
                                if kernel == "2p" and args.p2_child != "parent"
                                else None),
                wrapper_ms=res[0], host_us=res[1], ms_samples=res[2],
                device_us=sab.device_us(call, calls=5 if args.crossover
                                        else 20),
                max_abs_err=err)), flush=True)
            del q, k, v, raw, do, want, got
            torch.cuda.empty_cache()
    torch.save(dumps, args.dump)
    return 0


def p2_compare(args, parts, emit) -> None:
    """2p's parent, change and variants (and the crossover's two modes),
    each in child processes, in turns; then the registers, the bitwise
    identity with the parent (with ``small_all`` for the crossover) and a
    summary per build and shape."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    parent = os.path.abspath(args.parent)
    if not os.path.isdir(os.path.join(parent, "sttode_tpu_torch")):
        raise SystemExit(f"--parent {parent}: no sttode_tpu_torch there "
                         f"(export it with git archive first)")
    t0 = time.perf_counter()
    pbuild = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from sttode_tpu_torch.kernels import _build; _build.build()"],
        cwd=parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    builds = (args.p2_builds.split(",") if args.p2_builds else
              ["parent", "change", *P2_VARIANTS])
    variants = {n: v for n, v in P2_VARIANTS.items()
                if n in builds or "crossover2p" in parts
                and n in ("small_all", "old_mode")}
    sab.build_variants(_build, variants, WORK, load=False)
    lib = _build.build()
    out, _ = pbuild.communicate()
    if pbuild.returncode:
        raise RuntimeError(f"the parent's build failed:\n{out[-4000:]}")
    emit(build_s=time.perf_counter() - t0)
    logs = {"parent": max(glob.glob(os.path.join(
        parent, "sttode_tpu_torch", "_build", "*.so.log")),
        key=os.path.getmtime), "change": str(lib) + ".log"}
    logs.update({n: os.path.join(WORK, "variants", n, "build.log")
                 for n in variants})
    for n, log in logs.items():
        name, spill = None, ""
        with open(log) as f:
            for line in f:
                if "Compiling entry function" in line:
                    mangled = line.split("'")[1]
                    name = (cs.sweep_name(mangled, P2_KERNELS)
                            if re.search(P2_KERNELS, mangled) else None)
                    spill = ""
                elif name and "spill" in line:
                    spill = line.split(":", 1)[-1].strip()
                elif name and "Used" in line:
                    emit(build=n, ptxas=name, registers=int(re.search(
                        r"Used (\d+) registers", line).group(1)),
                         spill=spill)
                    name = None
    for L, S, Dh in ((32, 32, 8), (128, 128, 8), (8, 8, 8), (1, 1, 8),
                     (1024, 1024, 8), (1280, 1280, 8), (256, 256, 16),
                     (256, 256, 32)):
        emit(p2_layout=f"{L}x{S}x{Dh}",
             mode=km.small_bwd_mode(L, S, Dh, metric="poincare"),
             **km.small_bwd_layout(L, S, Dh, metric="poincare"))
    os.makedirs(WORK, exist_ok=True)
    runs = []
    if "2p" in parts:
        runs.append(("", builds))
    if "crossover2p" in parts:
        runs.append(("crossover", ["small_all", "old_mode"]))
    lines = []
    for tag, order in runs:
        for p in range(args.passes):
            for name in (order if p % 2 == 0 else order[::-1]):
                dump = os.path.join(WORK, f"p2{tag}_{name}.{p}.pt")
                cmd = [sys.executable, os.path.abspath(__file__),
                       "--p2-child", name, "--rounds", str(args.rounds),
                       "--dump", dump]
                if args.p2_cases:
                    cmd += ["--p2-cases", args.p2_cases]
                if name in P2_VARIANTS:
                    cmd += ["--lib"]
                if tag:
                    cmd += ["--crossover"]
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      cwd=parent if name == "parent"
                                      else ROOT)
                if proc.returncode:
                    raise RuntimeError(f"2p child {name}:\n{proc.stdout}\n"
                                       f"{proc.stderr[-4000:]}")
                for line in proc.stdout.splitlines():
                    if line.startswith("{"):
                        rec = dict(json.loads(line), **{"pass": p,
                                                        "run": tag or "2p"})
                        lines.append(rec)
                        emit(**rec)
        base = order[0]
        dumps = {n: torch.load(os.path.join(WORK, f"p2{tag}_{n}.0.pt"))
                 for n in order}
        for n in order[1:]:
            for key in dumps[n]:
                if key in dumps[base]:
                    emit(p2_identical_to=base, build=n, shape=key,
                         max_abs_diff=max(float((a - b).abs().max()) for a, b
                                          in zip(dumps[n][key],
                                                 dumps[base][key])),
                         bitwise=all(torch.equal(a, b) for a, b in
                                     zip(dumps[n][key], dumps[base][key])))
    groups = {}
    for rec in lines:
        groups.setdefault((rec["run"], rec["build"], rec["shape"]),
                          []).append(rec)
    for (run, b, shape), recs in groups.items():
        dev = [r["device_us"] for r in recs if r["device_us"] is not None]
        emit(p2_summary=b, run=run, shape=shape, kernel=recs[0]["kernel"],
             wrapper_ms=statistics.median(
                 [x for r in recs for x in r["ms_samples"]]),
             host_us=statistics.median([r["host_us"] for r in recs]),
             device_us=sum(dev) / len(dev) if dev else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=os.path.join(WORK, "parent"))
    ap.add_argument("--parent-rev", default="HEAD~1")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--only", default="3p,C,crossover")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--p2-builds", default=None,
                    help="2p: the builds to time (default: parent, change "
                         "and every variant)")
    ap.add_argument("--p2-cases", default=None,
                    help="2p: the cases to time, in this order (default: "
                         "every one of P2_CASES)")
    ap.add_argument("--p2-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lib", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--crossover", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_3p_c_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        return child(args.child, args.rounds)
    if args.p2_child:
        return p2_child(args)
    parts = set(args.only.split(","))
    _build, km, dev, rng, randn = common()
    from sttode_tpu_torch.nn.attention import to_ball

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    def write_out():
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(json.dumps(x) for x in lines) + "\n")

    if parts & {"2p", "crossover2p"}:
        if not os.path.isdir(args.parent):
            sab.parent_package(args.parent, args.parent_rev, WORK)
        p2_compare(args, parts, emit)
        write_out()
    if not parts & {"3p", "C", "crossover"}:
        return 0

    t0 = time.perf_counter()
    _, pkm, _ = sab.parent_package(args.parent, args.parent_rev, WORK)
    lib = _build.build()
    fwd_variants = sab.build_variants(
        _build, {f"fwd_{n}": v for n, v in FWD_VARIANTS.items()}, WORK,
        ("flash_mhgsa_fwd",))
    sab.build_variants(_build, {f"bwd_{n}": v for n, v in
                                BWD_VARIANTS.items()}, WORK, load=False)
    emit(build_s=time.perf_counter() - t0)
    for name in ["change", *(f"fwd_{n}" for n in FWD_VARIANTS)]:
        log = (str(lib) + ".log" if name == "change" else
               os.path.join(WORK, "variants", name, "build.log"))
        for kern, regs, spill in ptxas(log):
            if name == "change" or "poincare" in kern.lower():
                emit(ptxas=name, kernel=kern, registers=regs, spill=spill)
    for L, S, Dh in ((128, 128, 8), (8, 8, 8), (32, 32, 8), (1, 1, 8),
                     (256, 256, 16), (512, 512, 8)):
        emit(layout=f"{L}x{S}x{Dh}", mode=km.small_bwd_mode(L, S, Dh),
             **km.small_bwd_layout(L, S, Dh))

    def ball(c, *shape):
        return to_ball(randn(*shape) * (0.5 / (shape[-1] * c) ** 0.5), c)

    def with_fn(entry, fn, call):
        def run():
            with sab.Swap(entry, fn):
                return call()
        return run

    def timed(kname, shape, fns, check, calls):
        """Check every fn, then time them interleaved; emit one line each."""
        errs = {n: check(fn()) for n, fn in fns.items()}
        torch.cuda.synchronize()
        names = list(fns)
        res = sab.interleaved(fns, names, args.rounds, calls=calls)
        for n in names:
            emit(kernel=kname, shape=shape, variant=n, wrapper_ms=res[n][0],
                 host_us=res[n][1], ms_samples=res[n][2],
                 device_us=sab.device_us(fns[n], calls=5),
                 max_abs_err=errs[n])

    with torch.inference_mode():
        if "3p" in parts:
            # 3p at c = 1 and 0.7, and F, at 88 × 2304² × 8
            for metric, c in (("poincare", 1.0), ("poincare", 0.7),
                              ("oblique", 1.0)):
                if metric == "poincare":
                    q, k = ball(c, 88, 2304, 8), ball(c, 88, 2304, 8)
                else:
                    q, k = randn(88, 2304, 8), randn(88, 2304, 8)
                v = randn(88, 2304, 8)
                want = km.flash_geodesic_attention_reference(q, k, v, None,
                                                             metric, c)

                def check(got, want=want):
                    e = max(float((a - b).abs().max())
                            for a, b in zip(got, want))
                    if not e <= FWD_TOL:
                        raise AssertionError(f"3p max abs err {e}")
                    return e

                call = (lambda q=q, k=k, v=v, metric=metric, c=c:
                        km._launch_flash(q, k, v, None, metric, c))
                fns = {"parent": lambda q=q, k=k, v=v, metric=metric, c=c:
                       pkm._launch_flash(q, k, v, None, metric, c),
                       "change": call}
                if metric == "poincare":
                    for n in FWD_VARIANTS:
                        fns[n] = with_fn(km._FLASH_FWD, fwd_variants[
                            f"fwd_{n}"]["flash_mhgsa_fwd"], call)
                timed("3p" if metric == "poincare" else "F",
                      f"88x2304x2304x8 c={c}", fns, check, 5)
                del q, k, v, want, fns
                torch.cuda.empty_cache()

        if "C" in parts:
            # parent against change in this process
            for B, L, Dh, _ in C_CASES:
                a, check = bwd_case(km, rng, randn, dev, B, L, L, Dh, False)
                timed("C", f"{B}x{L}x{L}x{Dh}", {
                    "parent": lambda a=a:
                        pkm.fused_geodesic_attention_backward(*a),
                    "change": lambda a=a:
                        km.fused_geodesic_attention_backward(*a)},
                      check, 20)

    if "crossover" in parts:
        # the C variants and the crossover, each library in its own process
        for name in ("change", *BWD_VARIANTS):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child",
                 name if name == "change" else f"bwd_{name}", "--rounds",
                 str(args.rounds)], capture_output=True, text=True, cwd=ROOT)
            if proc.returncode:
                raise RuntimeError(f"child {name}:\n{proc.stdout}\n"
                                   f"{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    emit(**json.loads(line))
    write_out()
    return 0


if __name__ == "__main__":
    sys.exit(main())
