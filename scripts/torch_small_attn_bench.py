"""Time the small-shape attention forward kernels, parent against change, on
one NVIDIA GPU.

    python3 scripts/torch_small_attn_bench.py [--parent DIR]
        [--parent-rev REV] [--rounds 6] [--kinks N] [--out FILE]

Kernel P (``packed_geodesic_attention``) and 1p (``fused_geodesic_attention``
with ``metric="poincare"``, c = 1) at the NBA recipe's 88 × 32² × 8 (the
shape the Q3 swap hands over), timed through their public entries as
``chip_smoke.py``'s ``paired_ms`` does: the wrapper ms (CUDA events around
20 back-to-back calls; the host's work when the host is the slower side),
the device µs per launch (the profiler's kernel time) and the host µs per
call (the host clock around the same calls, before synchronizing). Each
kernel is timed in the order parent, change, the variants, the variants,
change, parent, ``--rounds`` times, and the median of each is printed with
its samples. The variants take one part of the change at a time:

- ``launch_path_only``: the change's wrappers on the parent's kernels (for
  1p the parent's one-block-per-problem kernel as this checkout builds it,
  ``-DSTTODE_SMALL_MODE=0``, so its C entry's cached runtime queries count
  with the launch path);
- ``kernels_only``: the parent's wrappers on this checkout's kernels;
- ``ieee_epilogue``: acosf/expf (P) and the poincaré score's logf/expf in
  place of the SFU epilogue (``-DSTTODE_SMALL_IEEE_EPILOGUE=1``);
- ``one_slice``: one key slice, a warp per 32 rows, each lane all the keys
  (``-DSTTODE_SMALL_ONE_SLICE=1``).

Then the launch-path floor: parent and change on one 1 × 1 × 8 problem.
Then the small-S mode's crossover: the whole-S forward at 88 × S² × Dh,
S = 8 … 2048, Dh = 8 and 64, both metrics, in its small-S mode
(``-DSTTODE_SMALL_MODE=1``) against the mode it replaces (``=0``: the
one-block-per-problem kernel, or beyond shared memory the key-streaming
one), device µs and wrapper ms. Every output is held to its plain version
(1e-5). The block layout (rows × key slices,
``kernels.mhgsa.small_fwd_layout``) is printed for the packed route's
L·S ≤ 32² extremes. One JSON line per measurement,
each with the card's name and power limit.

``--kinks N`` runs, instead of the timings, the NBA recipe's fp32 poincaré
step at B = 32 (c = 1, the CLI's default) for seeds 0 … N−1 (scenes,
parameters and noise from the seed, as
``tests/test_torch_cuda.py::test_poincare_train_step_kernel_route_matches_dense``
builds them at seed 9) on the kernel route with 1p as the change builds
it, as the parent builds it and with the IEEE epilogue, each against the
dense route: the worst gradient leaf's largest difference over its largest
magnitude and how many of its rows differ by more than 1e-4 of it. A
difference confined to some rows of one leaf is a decoder ReLU whose input
lies within rounding of 0 switching between the routes.

``--only Q`` (the default ``--only P1p,Q`` runs both) times Q, the packed
backward (``packed_geodesic_attention_backward``), parent against change,
each build in a child process of its own, in the order parent, change,
the variants, then reversed, ``--passes`` times: at the NBA recipe's
11 × 8 × 32² × 8, at 64 × 8 × 8² × 8 with a random key validity and one
all-invalid problem, and on one 1 × 1 × 8 problem (the launch floor); the
wrapper ms, the host µs and the device µs of each, gradients held to the
plain backward within 5e-5 × max(1, max |g|) and the all-invalid
problem's to exactly 0. The variants are builds of this checkout's
``csrc/packed_mhgsa_bwd.cu``: ``q_ieee_epilogue`` (acosf, expf and rsqrtf
in the small body, ``-DSTTODE_SMALL_BWD_IEEE_EPILOGUE=1``) and
``q_one_slice``
(each thread all the keys of its row, then all the rows of its key,
``-DSTTODE_SMALL_BWD_ONE_SLICE=1``). The change's child also times the
wrapper's host-side trimmings each alone, against the wrapper as it is:
``stats_alloc`` (one allocation more, the parent's den/δ scratch),
``one_alloc`` (dq, dk and dv cut from one allocation) and
``always_convert`` (``do.to(float32).contiguous()`` even when do is
already fp32 and contiguous). It prints each build's registers and
spills, and which builds give the parent's dq, dk, dv bit for bit. E.g.:

    python3 scripts/torch_small_attn_bench.py --only Q --parent DIR \
        --out q.jsonl

The parent is a checkout of the commit before (``--parent``; when the
directory does not exist it is exported with ``git archive --parent-rev``,
default HEAD~1, which needs the repository's ``.git``: on a machine
without it, export it first). For P and 1p its package is copied under
another name,
``sttode_tpu_torch_parent``, into the git-ignored ``.small_attn_bench/``
and builds its own library there, so both import in one process; the
variants are built there too, one nvcc per source, all started together.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(ROOT, ".small_attn_bench")
TOL = 1e-5
# name: extra nvcc flags, sources (csrc/) built into the variant library
VARIANTS = {
    "old_mode": (["-DSTTODE_SMALL_MODE=0"], ["mhgsa_fwd.cu"]),
    "small_all": (["-DSTTODE_SMALL_MODE=1"], ["mhgsa_fwd.cu"]),
    "ieee_epilogue": (["-DSTTODE_SMALL_IEEE_EPILOGUE=1"],
                      ["mhgsa_fwd.cu", "packed_mhgsa_fwd.cu"]),
    "one_slice": (["-DSTTODE_SMALL_ONE_SLICE=1"],
                  ["mhgsa_fwd.cu", "packed_mhgsa_fwd.cu"]),
}
CROSSOVER = [(S, Dh) for Dh in (8, 64)
             for S in (8, 16, 32, 64, 128, 256, 512, 1024, 2048)]
ROUTE_SHAPES = ((32, 32, 8), (8, 128, 8), (128, 8, 8), (1024, 1, 8),
                (1, 1024, 8), (8, 8, 8), (1, 1, 8), (32, 32, 16),
                (32, 32, 128))


def parent_package(parent: str, rev: str, work: str = WORK):
    """Import the parent's ``sttode_tpu_torch`` as
    ``sttode_tpu_torch_parent``, copied under ``work``."""
    if not os.path.isdir(parent):
        os.makedirs(parent)
        tar = subprocess.run(["git", "-C", ROOT, "archive", rev],
                             capture_output=True, check=True).stdout
        subprocess.run(["tar", "-x", "-C", parent], input=tar, check=True)
    pkg = os.path.join(work, "pkg", "sttode_tpu_torch_parent")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(parent, "sttode_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    src = fh.read()
                with open(path, "w") as fh:
                    fh.write(src.replace("sttode_tpu_torch",
                                         "sttode_tpu_torch_parent"))
    sys.path.insert(0, os.path.join(work, "pkg"))
    return (importlib.import_module("sttode_tpu_torch_parent.kernels._build"),
            importlib.import_module("sttode_tpu_torch_parent.kernels.mhgsa"),
            importlib.import_module(
                "sttode_tpu_torch_parent.kernels.packed_mhgsa"))


def build_variants(build, variants: dict = VARIANTS, work: str = WORK,
                   entries=("mhgsa_fwd", "packed_mhgsa_fwd"),
                   load: bool = True) -> dict:
    """Each variant's library (this checkout's sources with its flags), as
    {name: {entry: ctypes function}} (loaded only with ``load``); the
    compilers' output (registers and spills per kernel) is kept beside it
    as ``build.log``."""
    jobs = []
    for name, (flags, sources) in variants.items():
        out = os.path.join(work, "variants", name)
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        for src in sources:
            obj = os.path.join(out, src.replace(".cu", ".o"))
            cmd = [build._nvcc(), *build.NVCC_FLAGS, *flags, "-c", "-o", obj,
                   str(build.CSRC_DIR / src)]
            jobs.append((name, obj, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {name: [] for name in variants}
    for name, _, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: {' '.join(cmd)}\n{log}")
        logs[name].append(log)
    libs = {}
    for name in variants:
        out = os.path.join(work, "variants", name)
        with open(os.path.join(out, "build.log"), "w") as f:
            f.write("\n".join(logs[name]))
        objs = [o for n, o, _, _ in jobs if n == name]
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS[:2], "-shared",
                        "-o", variant_path(work, name), *objs], check=True,
                       capture_output=True)
        if load:
            libs[name] = load_variant(build, work, name, entries)
    return libs


def variant_path(work: str, name: str) -> str:
    return os.path.join(work, "variants", name, f"lib_{name}.so")


def load_variant(build, work: str, name: str, entries) -> dict:
    """A built variant's entries, as {entry: ctypes function}."""
    lib = ctypes.CDLL(variant_path(work, name))
    fns = {}
    for entry in entries:
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
    return fns


def sample(fn, calls):
    """(wrapper ms per call between CUDA events, host µs per call before
    the synchronize) of ``calls`` back-to-back calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls, host


def device_us(fn, calls=20):
    """Device µs per call of the attention kernels ``fn`` launches, or
    None when the trace has no device time."""
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
             and "_kernel" in e.key
             and any(n in e.key
                     for n in ("packed_", "mhgsa_", "poincare_")))
    return us / calls if us > 0 else None


def interleaved(fns: dict, order: list, rounds: int, calls: int = 20):
    """Median wrapper ms and host µs of each named fn, sampled ``rounds``
    times in ``order`` (reversed every other round)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {n: [] for n in fns}
    host = {n: [] for n in fns}
    for r in range(rounds):
        for n in (order if r % 2 == 0 else order[::-1]):
            m, h = sample(fns[n], calls)
            ms[n].append(m)
            host[n].append(h)
    return {n: (statistics.median(ms[n]), statistics.median(host[n]),
                ms[n]) for n in fns}


class Swap:
    """Point a wrapper's cached C entry (``_build.Entry``) at another
    library's function for the duration of a with block."""

    def __init__(self, entry, fn):
        self.entry, self.fn = entry, fn

    def __enter__(self):
        self.saved, self.entry.fn = self.entry.fn, self.fn

    def __exit__(self, *exc):
        self.entry.fn = self.saved


# Q's variants: extra nvcc flags, sources (csrc/)
Q_VARIANTS = {
    "q_ieee_epilogue": (["-DSTTODE_SMALL_BWD_IEEE_EPILOGUE=1"],
                        ["packed_mhgsa_bwd.cu"]),
    "q_one_slice": (["-DSTTODE_SMALL_BWD_ONE_SLICE=1"],
                    ["packed_mhgsa_bwd.cu"]),
}
# Q's shapes: name → (B, H, L, S, Dh, validity)
Q_CASES = {
    "nba_recipe_11x8x32x32x8": (11, 8, 32, 32, 8, None),
    "kv_valid_64x8x8x8x8_one_all_invalid": (64, 8, 8, 8, 8, "one_dead"),
    "floor_1x1x1x1x8": (1, 1, 1, 1, 8, None),
}
Q_KERNELS = "packed_(?:small_|warp_)?bwd_kernel"


def q_inputs(dev, B, H, L, S, Dh, validity, seed):
    """q, k, v, the validity and do of a Q case, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)
    q, k, v, do = (randn(B, H, n, Dh) for n in (L, S, S, L))
    val = None
    if validity:
        val = torch.from_numpy(rng.random((B, S)) < 0.7).to(dev).float()
        val[0] = 0.0                      # a problem with no valid key
    return q, k, v, val, do


def q_host_variants(kp):
    """The wrapper's host-side trimmings, each alone: Q's wrapper as it is
    with one change undone or made."""
    def stats_alloc(q, k, v, val, do):
        B, H, L, _ = q.shape
        torch.empty((B, H, L, 2), device=q.device, dtype=torch.float32)
        return kp.packed_geodesic_attention_backward(q, k, v, val, do)

    def always_convert(q, k, v, val, do):
        return kp._launch_bwd(q, k, v, val,
                              do.to(torch.float32).contiguous())

    def one_alloc(q, k, v, val, do):
        from sttode_tpu_torch.kernels import _build
        if do.dtype != torch.float32 or not do.is_contiguous():
            do = do.to(torch.float32).contiguous()
        kp._check_devices(q, k, v, val, do)
        B, H, L, Dh = q.shape
        S = k.shape[2]
        buf = torch.empty(q.numel() + 2 * k.numel(), device=q.device)
        dq, dk, dv = buf.split([q.numel(), k.numel(), k.numel()])
        dq, dk, dv = dq.view(q.shape), dk.view(k.shape), dv.view(k.shape)
        err = _build.launch(kp._BWD, q.device, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(),
                            None if val is None else val.data_ptr(),
                            do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), B, H, L, S, Dh)
        if err:
            _build.check(err, "packed_mhgsa_bwd")
        kp.packed_geodesic_attention_backward.launches += 1
        return dq, dk, dv
    return {"stats_alloc": stats_alloc, "one_alloc": one_alloc,
            "always_convert": always_convert}


def q_child(args) -> int:
    """One build's turn at Q: this process imports the working directory's
    package (with ``--lib``, Q's C entry from a variant's library), checks
    and times each case, prints one JSON line each and dumps the
    gradients to ``--dump``."""
    sys.path.insert(0, os.getcwd())
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
    if args.lib:
        kp._BWD.fn = load_variant(_build, WORK, args.q_child,
                                  ("packed_mhgsa_bwd",))["packed_mhgsa_bwd"]
    dev = torch.device("cuda")
    extra = q_host_variants(kp) if args.q_child == "change" else {}
    dumps = {}
    with torch.inference_mode():
        for i, (name, case) in enumerate(Q_CASES.items()):
            a = q_inputs(dev, *case, seed=40 + i)
            fns = {args.q_child: lambda a=a:
                   kp.packed_geodesic_attention_backward(*a)}
            fns.update({n: (lambda f=f, a=a: f(*a)) for n, f in extra.items()})
            want = kp.packed_geodesic_attention_backward_reference(*a)
            errs = {}
            for n, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                errs[n] = 0.0
                for g, w in zip(got, want):
                    e = float((g - w).abs().max())
                    tol = 5e-5 * max(1.0, float(w.abs().max()))
                    if not e <= tol:
                        raise AssertionError(f"Q {name} {n}: max abs err {e} "
                                             f"> {tol}")
                    errs[n] = max(errs[n], e)
                if a[3] is not None:
                    dead = ~(a[3] > 0).any(dim=-1)
                    if not all(bool((g[dead] == 0).all()) for g in got):
                        raise AssertionError(f"Q {name} {n}: an all-invalid "
                                             f"problem's gradients not 0")
                if n == args.q_child:
                    dumps[name] = [g.cpu() for g in got]
            res = interleaved(fns, list(fns), args.rounds)
            for n in fns:
                print(json.dumps(dict(
                    kernel="Q", build=args.q_child, variant=n, shape=name,
                    wrapper_ms=res[n][0], host_us=res[n][1],
                    ms_samples=res[n][2], device_us=device_us(fns[n]),
                    max_abs_err=errs[n])), flush=True)
    torch.save(dumps, args.dump)
    return 0


def q_compare(args, emit) -> None:
    """Q's parent, change and variants, each in child processes, in
    turns; then the registers, the bitwise identity with the parent and a
    summary per build, variant and shape."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
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
    build_variants(_build, Q_VARIANTS, WORK, load=False)
    lib = _build.build()
    out, _ = pbuild.communicate()
    if pbuild.returncode:
        raise RuntimeError(f"the parent's build failed:\n{out[-4000:]}")
    emit(build_s=time.perf_counter() - t0)
    logs = {"parent": max(glob.glob(os.path.join(
        parent, "sttode_tpu_torch", "_build", "*.so.log")),
        key=os.path.getmtime), "change": str(lib) + ".log"}
    logs.update({n: os.path.join(WORK, "variants", n, "build.log")
                 for n in Q_VARIANTS})
    for n, log in logs.items():
        name = None
        with open(log) as f:
            for line in f:
                if "Compiling entry function" in line:
                    mangled = line.split("'")[1]
                    name = (cs.sweep_name(mangled, Q_KERNELS)
                            if re.search(Q_KERNELS, mangled) else None)
                elif name and "Used" in line:
                    emit(build=n, ptxas=name, registers=int(re.search(
                        r"Used (\d+) registers", line).group(1)))
                    name = None
    for L, S, Dh in ((32, 32, 8), (8, 8, 8), (1, 1, 8), (16, 64, 8),
                     (8, 8, 16), (32, 32, 32), (1, 1024, 8), (1024, 1, 32)):
        emit(q_layout=f"{L}x{S}x{Dh}",
             small_body=kp.packed_bwd_small(L, S, Dh),
             **km.small_bwd_layout(L, S, Dh, val=True))
    os.makedirs(WORK, exist_ok=True)
    order = ["parent", "change", *Q_VARIANTS]
    lines = []
    for p in range(args.passes):
        for name in (order if p % 2 == 0 else order[::-1]):
            cmd = [sys.executable, os.path.abspath(__file__), "--q-child",
                   name, "--rounds", str(args.rounds),
                   "--dump", os.path.join(WORK, f"q_{name}.{p}.pt")]
            if name in Q_VARIANTS:
                cmd += ["--lib", variant_path(WORK, name)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  cwd=parent if name == "parent" else ROOT)
            if proc.returncode:
                raise RuntimeError(f"Q child {name}:\n{proc.stdout}\n"
                                   f"{proc.stderr[-4000:]}")
            for line in proc.stdout.splitlines():
                if line.startswith("{"):
                    rec = dict(json.loads(line), **{"pass": p})
                    lines.append(rec)
                    emit(**rec)
    dumps = {n: torch.load(os.path.join(WORK, f"q_{n}.0.pt")) for n in order}
    for n in order[1:]:
        for key in dumps[n]:
            emit(q_identical_to_parent=n, shape=key, max_abs_diff=max(
                float((a - b).abs().max()) for a, b in
                zip(dumps[n][key], dumps["parent"][key])),
                 bitwise=all(torch.equal(a, b) for a, b in
                             zip(dumps[n][key], dumps["parent"][key])))
    runs = {}
    for rec in lines:
        runs.setdefault((rec["build"], rec["variant"], rec["shape"]),
                        []).append(rec)
    for (b, var, shape), recs in runs.items():
        dev = [r["device_us"] for r in recs if r["device_us"] is not None]
        emit(q_summary=b, variant=var, shape=shape,
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
    ap.add_argument("--only", default="P1p,Q")
    ap.add_argument("--kinks", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--q-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lib", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dump", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_small_attn_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.q_child:
        return q_child(args)
    sys.path.insert(0, ROOT)
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import packed_mhgsa as kp
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

    parts = set(args.only.split(","))
    if "Q" in parts:
        if not os.path.isdir(args.parent):
            parent_package(args.parent, args.parent_rev)
        q_compare(args, emit)
    if "P1p" not in parts:
        if args.out:
            with open(args.out, "w") as f:
                f.write("\n".join(json.dumps(x) for x in lines) + "\n")
        return 0

    for L, S, Dh in ROUTE_SHAPES:
        emit(layout=f"{L}x{S}x{Dh}", **km.small_fwd_layout(L, S, Dh))

    t0 = time.perf_counter()
    pbuild, pkm, pkp = parent_package(args.parent, args.parent_rev)
    plib = pbuild.load()
    lib = _build.load()
    variants = build_variants(_build)
    emit(build_s=time.perf_counter() - t0)
    pbuild_lib = pbuild._lib

    dev = torch.device("cuda")
    if args.kinks:
        kink_sweep(km, {"change": None,
                        "parent": getattr(plib, "mhgsa_fwd"),
                        "ieee_epilogue":
                            variants["ieee_epilogue"]["mhgsa_fwd"]},
                   args.kinks, dev, emit)
        return 0
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    def ball(*shape):
        return to_ball(randn(*shape) * (0.5 / shape[-1] ** 0.5), 1.0)

    P = dict(metric="poincare", curvature=1.0)
    cases = {
        "P": dict(
            args=(randn(11, 8, 32, 8), randn(11, 8, 32, 8),
                  randn(11, 8, 32, 8)),
            change=lambda a: kp.packed_geodesic_attention(*a),
            parent=lambda a: pkp.packed_geodesic_attention(*a),
            plain=lambda a: kp.packed_geodesic_attention_reference(*a, None),
            entry=kp._FWD, name="packed_mhgsa_fwd"),
        "1p": dict(
            args=(ball(11, 8, 32, 8), ball(11, 8, 32, 8),
                  randn(11, 8, 32, 8)),
            change=lambda a: km.fused_geodesic_attention(*a, **P),
            parent=lambda a: pkm.fused_geodesic_attention(*a, **P),
            plain=lambda a: km.fused_geodesic_attention_reference(
                *(x.reshape(88, -1, 8) for x in a), None, "poincare", 1.0
            ).reshape(a[0].shape),
            entry=km._FWD, name="mhgsa_fwd"),
    }
    with torch.inference_mode():
        for kname, c in cases.items():
            a, entry, ename = c["args"], c["entry"], c["name"]
            old_fn = (getattr(plib, ename) if kname == "P"
                      else variants["old_mode"][ename])
            change = lambda c=c, a=a: c["change"](a)  # noqa: E731
            parent = lambda c=c, a=a: c["parent"](a)  # noqa: E731

            def with_fn(fn, c=c, a=a, entry=entry):
                def run():
                    with Swap(entry, fn):
                        return c["change"](a)
                return run

            def parent_on_change(c=c, a=a):
                pbuild._lib = lib
                try:
                    return c["parent"](a)
                finally:
                    pbuild._lib = pbuild_lib

            fns = {"parent": parent, "change": change,
                   "launch_path_only": with_fn(old_fn),
                   "kernels_only": parent_on_change,
                   "ieee_epilogue": with_fn(variants["ieee_epilogue"][ename]),
                   "one_slice": with_fn(variants["one_slice"][ename])}
            want = c["plain"](a)
            errs = {}
            for n, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                errs[n] = float((got - want).abs().max())
                if not errs[n] <= TOL:
                    raise AssertionError(f"{kname} {n}: max abs err "
                                         f"{errs[n]} > {TOL}")
            names = list(fns)
            res = interleaved(fns, names, args.rounds)
            for n in names:
                emit(kernel=kname, shape="88x32x32x8", variant=n,
                     wrapper_ms=res[n][0], host_us=res[n][1],
                     ms_samples=res[n][2], device_us=device_us(fns[n]),
                     max_abs_err=errs[n])
            # the launch-path floor: one problem of 1 × 1 × 8
            one = tuple(x[:1, :1, :1] .contiguous() for x in a)
            floor = {"parent": lambda c=c, one=one: c["parent"](one),
                     "change": lambda c=c, one=one: c["change"](one)}
            res = interleaved(floor, ["parent", "change"], args.rounds)
            for n in floor:
                emit(kernel=kname, shape="1x1x1x8", variant=n,
                     wrapper_ms=res[n][0], host_us=res[n][1],
                     ms_samples=res[n][2], device_us=device_us(floor[n]))

        # the small-S mode's crossover at 88 × S² × 8, both metrics
        for metric in ("oblique", "poincare"):
            kw = dict(metric=metric, curvature=1.0)
            for S, Dh in CROSSOVER:
                q, k = ((ball(88, S, Dh), ball(88, S, Dh)) if metric ==
                        "poincare" else (randn(88, S, Dh), randn(88, S, Dh)))
                v = randn(88, S, Dh)
                want = km.fused_geodesic_attention_reference(q, k, v, None,
                                                             **kw)
                fns = {mode: (lambda fn=variants[mode]["mhgsa_fwd"], q=q,
                              k=k, v=v, kw=kw: _run_with(km, fn, q, k, v,
                                                         kw))
                       for mode in ("old_mode", "small_all")}
                errs = {}
                for n, fn in fns.items():
                    errs[n] = float((fn() - want).abs().max())
                    if not errs[n] <= TOL:
                        raise AssertionError(f"crossover {metric} S={S} {n}: "
                                             f"max abs err {errs[n]}")
                res = interleaved(fns, list(fns), args.rounds)
                for n in fns:
                    emit(crossover=metric, shape=f"88x{S}x{S}x{Dh}", mode=n,
                         chosen=(n == "small_all") == km.small_s_mode(
                             S, S, Dh),
                         wrapper_ms=res[n][0], host_us=res[n][1],
                         device_us=device_us(fns[n]), max_abs_err=errs[n])
                del q, k, v, want, fns
                torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


def kink_sweep(km, fwds: dict, seeds: int, dev, emit) -> None:
    """The poincaré B = 32 step's gradients on the kernel route (1p as
    each of ``fwds`` builds it) against the dense route, for each seed."""
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.models import sttode as tm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tm.STTODEConfig(past_length=5, future_length=10, min_clip=0.0,
                          attn_metric="poincare",
                          select_impl="xla").validate()
    M = 32 * 11
    for seed in range(seeds):
        scenes = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                    pred_len=10, seed=seed)
        batch, _ = prepare_scene_group(
            np.stack([s_["obs"] for s_ in scenes]),
            np.stack([s_["pred"] for s_ in scenes]),
            np.ones((32, 11), np.float32), training=True,
            rng=np.random.default_rng(seed))
        batch = batch.to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        noise = tm.TrainNoise(
            torch.rand(M, 5, 64, device=dev, generator=gen) >= 0.1,
            torch.rand(M, 10, 64, device=dev, generator=gen) >= 0.1,
            torch.randn(M, 32, device=dev, generator=gen),
            torch.randn(M * 20, 32, device=dev, generator=gen))
        params0 = tm.sttode_init(seed, cfg)

        def grads(c):
            p = bridge.to_device(params0, dev)
            leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
            tm.sttode_forward(p, c, batch, noise=noise).total_loss.backward()
            return [t.grad.detach() for t in leaves]

        want = grads(cfg._replace(attn_impl="dense"))
        for name, fn in fwds.items():
            with Swap(km._FWD, fn):
                got = grads(cfg)
            worst, leaf, rows = 0.0, -1, 0
            for i, (a, b) in enumerate(zip(got, want)):
                d = (a - b).abs() / max(float(b.abs().max()), 1e-6)
                if float(d.max()) > worst:
                    worst, leaf = float(d.max()), i
                    big = (d > 1e-4).reshape(d.shape[0] if d.dim() else 1,
                                             -1)
                    rows = int(big.any(dim=-1).sum())
            emit(kinks_seed=seed, forward=name, worst_leaf=leaf,
                 worst_ratio=worst, rows_above_1e_4=rows)


def _run_with(km, fn, q, k, v, kw):
    saved, km._FWD.fn = km._FWD.fn, fn
    try:
        return km.fused_geodesic_attention(q, k, v, **kw)
    finally:
        km._FWD.fn = saved


if __name__ == "__main__":
    sys.exit(main())
