"""Time the flash attention's register backward sweeps on one NVIDIA GPU.

    python3 scripts/torch_flash_bench.py [--rounds 6] [--cycles] [--out FILE]
    python3 scripts/torch_flash_bench.py --parent DIR [--variants all|A,B]
        [--passes 2] [--rounds 6] [--out FILE]

Times the dq and dk/dv sweeps of ``csrc/flash_mhgsa_bwd.cu`` through their
wrappers (``sttode_tpu_torch.kernels.mhgsa._launch_flash_dq`` and
``_launch_flash_dkv``: CUDA events around back-to-back calls, the median of
``--rounds`` samples) at the shapes of the port's paths: both metrics at the
NBA recipe's B = 2304 (88 problems of 2304 × 2304 × 8, as the Q3 swap hands
them over; poincaré at c = 1, the CLI's default, and at c = 0.7) and both
metrics at the long-context 8 × 4096² × 64. For each: the wrapper ms, the
device µs per launch (the profiler's kernel time), the bound from
``chip_smoke.py``'s ``flash_dq_work`` and ``flash_dkv_work`` (operations at
the fp32 peak, or bytes at the memory rate), and the max abs error against
the plain version on the card (held to 5e-5 × max(1, max |g|), the port's
attention-gradient tolerance). Poincaré inputs are ball points of norm ~0.5
(the attention layer's map), the other operands standard normal, from a
numpy seed of the shape's name. One JSON line per sweep and shape.

``--cycles`` also builds a copy of the package (in the git-ignored
``.flash_bench/``, removed after) whose four register sweep kernels record
``clock64()`` and the SM of each block at its start and end, runs each sweep
once at the B = 2304 shape, and reports the mean cycles per block and the
SM-cycles per pair (each SM's busy span, summed over SMs, over the pairs).

It uses whichever ``sttode_tpu_torch`` (and ``chip_smoke.py``) the working
directory holds, so running it from an unpacked parent checkout and from
the repo in one call compares two commits.

``--parent DIR`` (an unpacked ``git archive`` of the parent commit: the
card's machine has no ``.git``) compares in one call, each in a child
process of its own (several kernel libraries in one process crashed on the
card's machine): the parent, this checkout (``change``) and, with
``--variants``, the oblique sweeps' variants of
``scripts/torch_flash_variants.py``'s ``OBLIQUE_VARIANTS`` (``all`` or a
comma list), each a build of this checkout's ``csrc/flash_mhgsa_bwd.cu``
with its defines (one nvcc each, all started together with the change's
and the parent's builds, in the git-ignored ``.flash_bench_cmp/``). The
children run in the order parent, change, the variants, then reversed,
``--passes`` times; parent and change time every shape, the ``rows*``
variants the oblique shape at Dh ≤ 16 (the only one they change), the
others both oblique shapes. Each child prints the registers and spills of
the register sweep kernels (``-Xptxas -v``) and dumps its oblique B = 2304
outputs (parent and change also kernels A, C and P at the paths' small
shapes), so that the comparison says which builds give bit-identical
outputs. The last lines are a summary per build, shape and sweep: the
median of all its samples and the mean of its device µs. Exits non-zero
without a CUDA device.

``--kernel fwd`` does the same for the flash forward (F, the oblique
``flash_fwd_kernel`` of ``csrc/flash_mhgsa_fwd.cu``) in place of the
sweeps: ``_launch_flash`` at the recipe's 88 × 2304² × 8 and at
8 × 4096² × 64, out and lse held to their plain versions within 1e-5 (the
lse's error over max(1, |lse|), each row on its own, is reported); with ``--parent`` parent and
change also time 3p at the recipe (c = 1), whose outputs must stay
bit-identical, and the variants are ``FWD_VARIANTS``, each a build of this
checkout's ``csrc/flash_mhgsa_fwd.cu`` with its ``STTODE_FLASH_FWD_*``
defines: ``ieee_epilogue`` (acosf and expf in place of oblique.cuh's
weight: with it F must give the parent's out and lse bit for bit),
``reg_staging`` (each key staged through a thread's registers and
normalized there) and ``rows<R>_minb<M>``
(R query rows a thread and launch bounds asking for M blocks an SM; the
recipe's shape only). The registers and spills of every build's flash
kernels come from its ``-Xptxas -v`` log. E.g.:

    python3 scripts/torch_flash_bench.py --kernel fwd --parent DIR \
        --variants all --out f.jsonl
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# name: (B, L = S, Dh, metric, curvature)
SHAPES = {
    "nba_b2304_88x2304x8": (88, 2304, 8, "oblique", 1.0),
    "nba_b2304_88x2304x8_poincare_c1": (88, 2304, 8, "poincare", 1.0),
    "nba_b2304_88x2304x8_poincare_c0.7": (88, 2304, 8, "poincare", 0.7),
    "long_context_8x4096x64": (8, 4096, 64, "oblique", 1.0),
    "long_context_8x4096x64_poincare_c1": (8, 4096, 64, "poincare", 1.0),
}
RECIPE = "nba_b2304_88x2304x8"
KERNELS = ("flash_mhgsa_dq_kernel", "flash_mhgsa_dkv_kernel",
           "flash_poincare_dq_kernel", "flash_poincare_dkv_kernel")
NB = 1 << 16    # blocks recorded by --cycles
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, ".flash_bench_cmp")


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, rounds, calls=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times), times


def device_us(fn, calls=5):
    """Device µs per call of the sweep kernels fn launches, or None."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "_kernel" in e.key)
    return us / calls if us > 0 else None


# the flash forward's variants: name → {define suffix: value}
# (-DSTTODE_FLASH_FWD_<suffix>=<value>)
FWD_VARIANTS = {
    "ieee_epilogue": {"IEEE_EPILOGUE": 1},
    "reg_staging": {"REG_STAGING": 1},
    **{f"rows{r}_minb{m}": {"ROWS": r, "MIN_BLOCKS": m}
       for r in (1, 2) for m in (1, 4, 6, 8)},
}
# the register kernels whose registers a comparison prints: this
# checkout's (chip_smoke.ATTN_KERNELS) and the parent's forward kernels
BENCH_KERNELS = ("flash_mhgsa_fwd_kernel|flash_poincare_fwd_kernel|"
                 "flash_fwd_kernel|flash_(?:mhgsa|poincare)_d(?:q|kv)_kernel")


def ptxas(log: str):
    """(kernel<template arguments>, registers, spill line) of each flash
    register kernel in an ``nvcc -Xptxas -v`` log."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = (cs.sweep_name(mangled, BENCH_KERNELS)
                    if re.search(BENCH_KERNELS, mangled) else None)
            spill = ""
        elif name and "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        elif name and "Used" in line:
            regs = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append((name, regs, spill))
            name = None
    return out


def instrument(src: str) -> str:
    """The sweep kernels of flash_mhgsa_bwd.cu with a (smid, start, end)
    record per block: clock64() at the body's start and end, thread 0."""
    head = ("__device__ long long g_cyc[%d * 3];\n\n" % NB)
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    found = 0
    for m in list(re.finditer(r"__global__ void __launch_bounds__\(kThreads"
                              r"(?:, MINB)?\)\n(\w+)\(", src))[::-1]:
        if m.group(1) not in KERNELS:
            continue
        open_ = src.index("{", m.end())
        depth, i = 0, open_
        while True:
            depth += {"{": 1, "}": -1}.get(src[i], 0)
            if depth == 0:
                break
            i += 1
        body = src[open_ + 1:i]
        if "return" in body:
            raise RuntimeError(f"{m.group(1)} returns early")
        src = (src[:open_ + 1] + "\n  const long long cyc0 = clock64();\n"
               + body + "  if (threadIdx.x == 0 && blockIdx.x < %d) {\n"
               "    unsigned sm;\n"
               "    asm volatile(\"mov.u32 %%0, %%%%smid;\" : \"=r\"(sm));\n"
               "    g_cyc[blockIdx.x * 3] = sm;\n"
               "    g_cyc[blockIdx.x * 3 + 1] = cyc0;\n"
               "    g_cyc[blockIdx.x * 3 + 2] = clock64();\n  }\n" % NB
               + src[i:])
        found += 1
    if found < 2:
        raise RuntimeError("no sweep kernel found to instrument")
    return src + (
        '\nextern "C" int flash_bench_cycles(long long* dst, int n) {\n'
        '  return cudaMemcpyFromSymbol(dst, g_cyc, sizeof(long long) * n);\n'
        '}\n\nextern "C" int flash_bench_clear() {\n  void* p = nullptr;\n'
        '  const int err = cudaGetSymbolAddress(&p, g_cyc);\n'
        '  return err ? err : cudaMemset(p, 0, sizeof(g_cyc));\n}\n')


def inputs(name, dev):
    """The sweeps' operands at shape ``name``, from a numpy seed of the name:
    q, k (ball points of norm ~0.5 for poincaré), v, do, the forward's out
    and lse, δ, the metric and c."""
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.nn.attention import to_ball
    B, L, Dh, metric, c = SHAPES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, L, Dh))
                                    .astype(np.float32)).to(dev)
                   for _ in range(4))
    if metric == "poincare":
        q, k = (to_ball(x * (0.5 / Dh ** 0.5), c) for x in (q, k))
    out, lse = km._flash_forward(q, k, v, None, metric, c)
    return q, k, v, None, do, lse, torch.sum(do * out, dim=-1), metric, c


def cycles_child(work) -> int:
    """Run each sweep at the B = 2304 shapes on the instrumented copy in
    ``work``; print one JSON object of cycle counts."""
    sys.path.insert(0, work)
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    if not _build.__file__.startswith(work):
        raise RuntimeError(f"imported {_build.__file__}, not the copy")
    lib = _build.load()
    lib.flash_bench_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = {}
    for name, (B, L, Dh, metric, c) in SHAPES.items():
        if B != 88:
            continue
        with torch.inference_mode():
            a = inputs(name, torch.device("cuda"))
            for part, fn in (("dq", km._launch_flash_dq),
                             ("dkv", km._launch_flash_dkv)):
                fn(*a)
                torch.cuda.synchronize()
                _build.check(lib.flash_bench_clear(), "flash_bench_clear")
                fn(*a)
                torch.cuda.synchronize()
                buf = np.zeros(NB * 3, np.int64)
                _build.check(lib.flash_bench_cycles(buf.ctypes.data, NB * 3),
                             "flash_bench_cycles")
                rec = buf.reshape(NB, 3)
                rec = rec[rec[:, 2] != 0]
                # each SM's busy span: its first block's start to its last
                # block's end (clock64 is a per-SM counter)
                span = sum(int(rec[rec[:, 0] == sm, 2].max()
                               - rec[rec[:, 0] == sm, 1].min())
                           for sm in np.unique(rec[:, 0]))
                out[f"{name} {part}"] = {
                    "blocks": len(rec), "sms": len(np.unique(rec[:, 0])),
                    "cycles_per_block": float((rec[:, 2] - rec[:, 1]).mean()),
                    "sm_cycles_per_pair": span / (B * L * L)}
    print(json.dumps(out))
    return 0


def cycles(root):
    """Cycles per block and SM-cycles per pair of each sweep at the B = 2304
    shapes, from an instrumented copy of the package run in a child
    process."""
    work = os.path.join(root, ".flash_bench")
    shutil.rmtree(work, ignore_errors=True)
    try:
        shutil.copytree(os.path.join(root, "sttode_tpu_torch"),
                        os.path.join(work, "sttode_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(work, "sttode_tpu_torch", "csrc",
                            "flash_mhgsa_bwd.cu")
        with open(path) as f:
            src = instrument(f.read())
        with open(path, "w") as f:
            f.write(src)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--cycles-of", work], capture_output=True,
                              text=True, cwd=work)
        if proc.returncode != 0:
            raise RuntimeError(f"--cycles run failed:\n{proc.stdout}\n"
                               f"{proc.stderr[-4000:]}")
        return json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        shutil.rmtree(work, ignore_errors=True)


def measure(cs, km, names, rounds, emit, outputs=None):
    """Check each sweep at each shape against its plain version and time
    it; emit one line each. ``outputs`` collects the recipe's oblique
    outputs."""
    dev = torch.device("cuda")
    for name in names:
        B, L, Dh, metric, c = SHAPES[name]
        with torch.inference_mode():
            a = inputs(name, dev)
            for part, fn, plain, work in (
                    ("dq", lambda: km._launch_flash_dq(*a),
                     lambda: (km.flash_dq_reference(*a),),
                     cs.flash_dq_work),
                    ("dkv", lambda: km._launch_flash_dkv(*a),
                     lambda: km.flash_dkv_reference(*a),
                     cs.flash_dkv_work)):
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                want = plain()
                torch.cuda.synchronize()
                err = 0.0
                for g, w in zip(got, want):
                    e = float((g - w).abs().max())
                    tol = 5e-5 * max(1.0, float(w.abs().max()))
                    if not e <= tol:
                        raise AssertionError(f"{name} {part}: max abs err "
                                             f"{e} > {tol}")
                    err = max(err, e)
                if outputs is not None and name == RECIPE:
                    outputs[part] = [g.cpu() for g in got]
                del got, want
                ms, samples = time_ms(fn, rounds)
                bnd = cs.bound(*work(B, L, L, Dh, False, metric),
                               cs.FP32_FLOP_PER_S)
                emit(shape=name, sweep=part, ms=ms, ms_samples=samples,
                     device_us=device_us(fn), bound_ms=bnd[0],
                     bound_by=bnd[1], max_abs_err=err)
        del a
        torch.cuda.empty_cache()


def fwd_inputs(name, dev):
    """The forward's q, k, v at shape ``name`` (the sweeps' operands from
    the same seed: ``inputs``' q, k, v), the metric and c."""
    from sttode_tpu_torch.nn.attention import to_ball
    B, L, Dh, metric, c = SHAPES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, Dh))
                                .astype(np.float32)).to(dev)
               for _ in range(3))
    if metric == "poincare":
        q, k = (to_ball(x * (0.5 / Dh ** 0.5), c) for x in (q, k))
    return q, k, v, metric, c


def measure_fwd(cs, km, names, rounds, emit, outputs=None):
    """Check the forward at each shape against its plain version (out and
    lse within 1e-5; the lse's largest error over max(1, |lse|), row by row,
    is reported, the card tests hold it to 1e-6) and time it; emit one line
    each. ``outputs`` collects (out, lse) of every shape."""
    dev = torch.device("cuda")
    for name in names:
        B, L, Dh, metric, c = SHAPES[name]
        with torch.inference_mode():
            q, k, v, metric, c = fwd_inputs(name, dev)

            def fn():
                return km._launch_flash(q, k, v, None, metric, c)
            out, lse = fn()
            want = km.flash_geodesic_attention_reference(q, k, v, None,
                                                         metric, c)
            torch.cuda.synchronize()
            err = float((out - want[0]).abs().max())
            lse_err = float((lse - want[1]).abs().max())
            lse_rel = float(((lse - want[1]).abs()
                             / want[1].abs().clamp(min=1.0)).max())
            if not (err <= 1e-5 and lse_err <= 1e-5):
                raise AssertionError(f"{name} fwd: out max abs err {err}, "
                                     f"lse {lse_err}")
            if outputs is not None:
                outputs[name] = [out.cpu(), lse.cpu()]
            del out, lse, want
            ms, samples = time_ms(fn, rounds)
            bnd = cs.bound(*cs.flash_fwd_work(B, L, L, Dh, False, metric),
                           cs.FP32_FLOP_PER_S)
            emit(shape=name, sweep="fwd", ms=ms, ms_samples=samples,
                 device_us=device_us(fn), bound_ms=bnd[0], bound_by=bnd[1],
                 max_abs_err=err, lse_max_rel_err=lse_rel)
        del q, k, v
        torch.cuda.empty_cache()


def small_outputs():
    """Kernels A, C and P on seeded inputs at the paths' small shapes: A at
    the bench recipe's 88 × 128² × 8 and masked at the agent axis's
    64 × 8² × 8, C at 88 × 128² × 8, P at the NBA recipe's 11 × 8 × 32² × 8
    with a key validity."""
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
    rng = np.random.default_rng(11)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32)).cuda()
    q, k, v, do = (randn(88, 128, 8) for _ in range(4))
    qm, km_, vm = (randn(64, 8, 8, 8) for _ in range(3))
    mask = torch.where(torch.from_numpy(rng.random((64, 8, 8, 8)) < 0.3)
                       .cuda(), torch.finfo(torch.float32).min, 0.0)
    qp, kp_, vp = (randn(11, 8, 32, 8) for _ in range(3))
    kv = torch.from_numpy(rng.random((11, 32)) < 0.8).cuda().float()
    with torch.inference_mode():
        out = {"A": km.fused_geodesic_attention(q, k, v),
               "A_masked": km.fused_geodesic_attention(qm, km_, vm,
                                                       mask=mask),
               "C": km.fused_geodesic_attention_backward(q, k, v, None, do),
               "P": kp.packed_geodesic_attention(qp, kp_, vp, kv_valid=kv)}
        torch.cuda.synchronize()
    return {n: [t.cpu() for t in (o if isinstance(o, tuple) else (o,))
                if t is not None] for n, o in out.items()}


def child(args) -> int:
    """One build's turn: this process imports the working directory's
    package (or, with ``--lib``, points its sweeps' C entries at a variant's
    library), times ``--shapes`` and dumps its outputs to ``--dump``."""
    root = os.getcwd()
    sys.path.insert(0, root)
    import chip_smoke as cs
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km

    def emit(**rec):
        print(json.dumps({"build": args.child, **rec}), flush=True)

    fwd = args.kernel == "fwd"
    if args.lib:
        lib = ctypes.CDLL(args.lib)
        for entry, attr in ((("flash_mhgsa_fwd", "_FLASH_FWD"),) if fwd else
                            (("flash_mhgsa_dq", "_FLASH_DQ"),
                             ("flash_mhgsa_dkv", "_FLASH_DKV"))):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            getattr(km, attr).fn = fn
    else:
        _build.build()
    outputs = {}
    (measure_fwd if fwd else measure)(cs, km, args.shapes.split(","),
                                      args.rounds, emit, outputs)
    if args.small:
        outputs.update(small_outputs())
    torch.save(outputs, args.dump)
    return 0


def compare(args) -> int:
    """Parent, change and variants, each in child processes, in turns."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_flash_variants as fv
    import torch_small_attn_bench as sab
    from sttode_tpu_torch.kernels import _build

    card = card_name()
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    parent = os.path.abspath(args.parent)
    if not os.path.isdir(os.path.join(parent, "sttode_tpu_torch")):
        raise SystemExit(f"--parent {parent}: no sttode_tpu_torch there "
                         f"(export it with git archive first)")
    fwd = args.kernel == "fwd"
    table = FWD_VARIANTS if fwd else fv.OBLIQUE_VARIANTS
    names = [] if not args.variants else (
        list(table) if args.variants == "all" else args.variants.split(","))
    t0 = time.perf_counter()
    # the parent's library, this checkout's and the variants' at once
    pbuild = subprocess.Popen(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.'); "
         "from sttode_tpu_torch.kernels import _build; _build.build()"],
        cwd=parent, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    prefix, source = (("STTODE_FLASH_FWD", "flash_mhgsa_fwd.cu") if fwd else
                      ("STTODE_FLASH_BWD", "flash_mhgsa_bwd.cu"))
    variants = {n: ([f"-D{prefix}_{k}={v}" for k, v in table[n].items()],
                    [source]) for n in names}
    sab.build_variants(_build, variants, WORK, load=False)
    lib = _build.build()
    out, _ = pbuild.communicate()
    if pbuild.returncode:
        raise RuntimeError(f"the parent's build failed:\n{out[-4000:]}")
    emit(build_s=time.perf_counter() - t0)
    # registers and spills of each build's flash register kernels
    logs = {"parent": max(glob.glob(os.path.join(
        parent, "sttode_tpu_torch", "_build", "*.so.log")),
        key=os.path.getmtime), "change": str(lib) + ".log"}
    logs.update({n: os.path.join(WORK, "variants", n, "build.log")
                 for n in names})
    for n, log in logs.items():
        with open(log) as f:
            for kern, regs, spill in ptxas(f.read()):
                if ("fwd" in kern) == fwd:
                    emit(build=n, ptxas=kern, registers=regs, spill=spill)

    oblique = [n for n, s in SHAPES.items() if s[3] == "oblique"]
    os.makedirs(WORK, exist_ok=True)

    def run(name, p):
        cmd = [sys.executable, os.path.abspath(__file__), "--child", name,
               "--kernel", args.kernel, "--rounds", str(args.rounds),
               "--dump", os.path.join(WORK, f"{name}.{p}.pt")]
        if name in ("parent", "change"):
            cmd += ["--shapes", ",".join(
                oblique + ["nba_b2304_88x2304x8_poincare_c1"] if fwd
                else SHAPES)]
            cmd += [] if fwd else ["--small"]
        else:
            cmd += ["--lib", sab.variant_path(WORK, name), "--shapes",
                    ",".join(s for s in oblique if not name.startswith("rows")
                             or SHAPES[s][2] <= 16)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=parent if name == "parent" else ROOT)
        if proc.returncode:
            raise RuntimeError(f"child {name}:\n{proc.stdout}\n"
                               f"{proc.stderr[-4000:]}")
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                emit(**json.loads(line), **{"pass": p})

    order = ["parent", "change", *names]
    for p in range(args.passes):
        for name in (order if p % 2 == 0 else order[::-1]):
            run(name, p)

    # which builds give bit-identical outputs (first pass)
    dumps = {n: torch.load(os.path.join(WORK, f"{n}.0.pt")) for n in order}
    for n in order[1:]:
        for key in dumps[n]:
            if key not in dumps["parent"]:
                continue
            diff = max(float((a - b).abs().max()) for a, b in
                       zip(dumps[n][key], dumps["parent"][key]))
            emit(identical_to_parent=n, output=key, max_abs_diff=diff,
                 bitwise=all(torch.equal(a, b) for a, b in
                             zip(dumps[n][key], dumps["parent"][key])))
    for n in order[2:]:
        for key in dumps[n]:
            emit(identical_to_change=n, output=key, bitwise=all(
                torch.equal(a, b) for a, b in
                zip(dumps[n][key], dumps["change"][key])))

    # the summary: every sample of a build, shape and sweep over the passes
    runs = {}
    for rec in lines:
        if "ms_samples" in rec:
            runs.setdefault((rec["build"], rec["shape"], rec["sweep"]),
                            []).append(rec)
    for (b, shape, part), recs in runs.items():
        samples = [x for r in recs for x in r["ms_samples"]]
        dev = [r["device_us"] for r in recs if r["device_us"] is not None]
        emit(summary=b, shape=shape, sweep=part,
             ms=statistics.median(samples),
             device_us=sum(dev) / len(dev) if dev else None,
             bound_ms=recs[0]["bound_ms"])
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--cycles", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--parent", default=None)
    ap.add_argument("--variants", default=None)
    ap.add_argument("--kernel", choices=("sweeps", "fwd"), default="sweeps")
    ap.add_argument("--passes", type=int, default=2)
    ap.add_argument("--cycles-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lib", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help=argparse.SUPPRESS)
    ap.add_argument("--small", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.cycles_of:
        return cycles_child(args.cycles_of)
    if args.child:
        return child(args)
    if args.parent:
        return compare(args)
    root = os.getcwd()
    sys.path.insert(0, root)
    import chip_smoke as cs
    from sttode_tpu_torch.kernels import mhgsa as km

    card = card_name()
    lines = []

    def emit(**rec):
        rec["card"] = card
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    if args.kernel == "fwd":
        measure_fwd(cs, km, [n for n, s in SHAPES.items()
                             if s[3] == "oblique"], args.rounds, emit)
    else:
        measure(cs, km, list(SHAPES), args.rounds, emit)
    if args.cycles:
        for key, rec in cycles(root).items():
            emit(cycles=key, **rec)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
