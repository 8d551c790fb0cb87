"""Time the flash attention's register backward sweeps on one NVIDIA GPU.

    python3 scripts/torch_flash_bench.py [--rounds 6] [--cycles] [--out FILE]

Times the dq and dk/dv sweeps of ``csrc/flash_mhgsa_bwd.cu`` through their
wrappers (``sttode_tpu_torch.kernels.mhgsa._launch_flash_dq`` and
``_launch_flash_dkv``: CUDA events around back-to-back calls, the median of
``--rounds`` samples) at the shapes of the port's paths: both metrics at the
NBA recipe's B = 2304 (88 problems of 2304 × 2304 × 8, as the Q3 swap hands
them over; poincaré at c = 1, the CLI's default, and at c = 0.7) and the
poincaré sweeps at the long-context 8 × 4096² × 64. For each: the wrapper
ms, the device µs per launch (the profiler's kernel time), the bound from
``chip_smoke.py``'s ``flash_dq_work`` and ``flash_dkv_work`` (operations at
the fp32 peak, or bytes at the memory rate), and the max abs error against
the plain version on the card (held to 5e-5 × max(1, max |g|), the port's
attention-gradient tolerance). Poincaré inputs are ball points of norm ~0.5
(the attention layer's map), the other operands standard normal, from a
numpy seed. One JSON line per sweep and shape.

``--cycles`` also builds a copy of the package (in the git-ignored
``.flash_bench/``, removed after) whose four register sweep kernels record
``clock64()`` and the SM of each block at its start and end, runs each sweep
once at the B = 2304 shape, and reports the mean cycles per block and the
SM-cycles per pair (each SM's busy span, summed over SMs, over the pairs).

It uses whichever ``sttode_tpu_torch`` (and ``chip_smoke.py``) the working
directory holds, so running it from an unpacked parent checkout and from
the repo in one call compares two commits. Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

# name: (B, L = S, Dh, metric, curvature)
SHAPES = {
    "nba_b2304_88x2304x8": (88, 2304, 8, "oblique", 1.0),
    "nba_b2304_88x2304x8_poincare_c1": (88, 2304, 8, "poincare", 1.0),
    "nba_b2304_88x2304x8_poincare_c0.7": (88, 2304, 8, "poincare", 0.7),
    "long_context_8x4096x64_poincare_c1": (8, 4096, 64, "poincare", 1.0),
}
KERNELS = ("flash_mhgsa_dq_kernel", "flash_mhgsa_dkv_kernel",
           "flash_poincare_dq_kernel", "flash_poincare_dkv_kernel")
NB = 1 << 16    # blocks recorded by --cycles


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


def instrument(src: str) -> str:
    """The sweep kernels of flash_mhgsa_bwd.cu with a (smid, start, end)
    record per block: clock64() at the body's start and end, thread 0."""
    head = ("__device__ long long g_cyc[%d * 3];\n\n" % NB)
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    found = 0
    for m in list(re.finditer(r"__global__ void __launch_bounds__\(kThreads\)"
                              r"\n(\w+)\(", src))[::-1]:
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


def inputs(B, L, Dh, metric, c, rng, dev):
    """The sweeps' operands: q, k (ball points of norm ~0.5 for poincaré),
    v, do, the forward's out and lse, δ, the metric and c."""
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.nn.attention import to_ball
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
    rng = np.random.default_rng(0)
    out = {}
    for name, (B, L, Dh, metric, c) in SHAPES.items():
        if B != 88:
            continue
        with torch.inference_mode():
            a = inputs(B, L, Dh, metric, c, rng, torch.device("cuda"))
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--cycles", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cycles-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 2
    if args.cycles_of:
        return cycles_child(args.cycles_of)
    root = os.getcwd()
    sys.path.insert(0, root)
    import chip_smoke as cs
    from sttode_tpu_torch.kernels import mhgsa as km

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    lines = []
    for name, (B, L, Dh, metric, c) in SHAPES.items():
        with torch.inference_mode():
            a = inputs(B, L, Dh, metric, c, rng, dev)
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
                del got, want
                ms, samples = time_ms(fn, args.rounds)
                bnd = cs.bound(*work(B, L, L, Dh, False, metric),
                               cs.FP32_FLOP_PER_S)
                line = {"shape": name, "sweep": part, "ms": ms,
                        "ms_samples": samples, "device_us": device_us(fn),
                        "bound_ms": bnd[0], "bound_by": bnd[1],
                        "max_abs_err": err, "card": card}
                lines.append(line)
                print(json.dumps(line), flush=True)
        del a
        torch.cuda.empty_cache()
    if args.cycles:
        cyc = cycles(root)
        for key, rec in cyc.items():
            line = {"cycles": key, **rec, "card": card}
            lines.append(line)
            print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
