"""Where kernel B's time goes inside a block, on one NVIDIA GPU.

    python3 scripts/torch_select_profile.py

Copies ``sttode_tpu_torch`` into a git-ignored directory of the checkout
(``.select_profile/``, removed after), instruments the copy's
``csrc/select_decode.cu`` with ``clock64()`` stamps — per phase of the main
kernel (the z load, block 0's decoder_y and decoder_x MLPs, the GRU, block
1's MLP) and, inside each weight stream, the cycles thread 0 spends waiting
for a stage (the mbarrier and the block barrier), issuing the next copy,
in the layers' bodies and in the segment ends (epilogues) — builds it and
runs the selection decode once per storage type at the bench recipe's
training shape (M = 1408, K = 20, 5 / 10 steps, mode "dist"). Prints the
mean cycles per block of each, one line per (dtype, phase). The stamps are
thread 0's view: its waits include the other warps' work. The instrumented
kernel is a diagnostic copy; the package's own kernel is not changed.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NB = 8192   # blocks recorded

# (anchor in select_decode.cu, text inserted after it)
PATCHES = [
    ("namespace {\n\nconstexpr int kThreads = 256;",
     None),   # replaced below: globals before the namespace
    ("  Cursor fill, use;\n",
     "  long long tw = 0, ti = 0, tb = 0, te = 0, c0;\n"),
    ("    bar_wait(ring.bars + slot, (used / kStages) & 1);\n"
     "    __syncthreads();   // this stage landed; every thread is done with "
     "the last\n",
     "    tw += clock64() - c0;\n    c0 = clock64();\n"),
    ("    const char* st = ring.buf + slot * kSB;\n",
     "    ti += clock64() - c0;\n    c0 = clock64();\n"),
    ("    for (int i = 0; i < kn; ++i) body(use.seg, k0 + i, st + i * "
     "use.s.tbytes);\n",
     "    tb += clock64() - c0;\n"),
    ("    if (++use.st == use.nst) {\n",
     "      c0 = clock64();\n"),
    ("      end(use.seg);\n",
     "      te += clock64() - c0;\n"),
    ("  ring.count = used;\n",
     "  if (threadIdx.x == 0 && gridDim.y == 1 && blockIdx.x < 8192) {\n"
     "    const int slot = g_calls[blockIdx.x]++;\n"
     "    if (slot < 4) {\n"
     "      long long* o = g_prof + 8192 * 8 + (blockIdx.x * 4 + slot) * 4;\n"
     "      o[0] = tw; o[1] = ti; o[2] = tb; o[3] = te;\n    }\n  }\n"),
]


def instrument(src: str) -> str:
    head = ("__device__ long long g_prof[8192 * 8 + 8192 * 16];\n"
            "__device__ int g_calls[8192];\n\n")
    anchor = PATCHES[0][0]
    if src.count(anchor) != 1:
        raise RuntimeError(f"anchor not found: {anchor!r}")
    src = src.replace(anchor, head + anchor)
    for anchor, text in PATCHES[1:]:
        if src.count(anchor) != 1:
            raise RuntimeError(f"anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + text)
    # the loop's first stamp, before the wait
    loop = "  while (use.seg < nseg) {\n    const int slot = used % kStages;\n"
    if src.count(loop) != 1:
        raise RuntimeError("stream loop not found")
    src = src.replace(loop, loop + "    c0 = clock64();\n")
    # per-phase stamps in the main kernel
    start = ("  const long long MK = (long long)d.M * d.K;\n"
             "  const long long gr0 = (long long)blockIdx.x * BM;\n")
    if src.count(start) != 1:
        raise RuntimeError("main kernel start not found")
    src = src.replace(start, "  const long long t0 = clock64();\n"
                      "  if (threadIdx.x == 0 && blockIdx.x < 8192) "
                      "g_calls[blockIdx.x] = 0;\n" + start)

    def stamp(i):
        return (f"  if (threadIdx.x == 0 && blockIdx.x < 8192) "
                f"g_prof[blockIdx.x * 8 + {i}] = clock64() - t0;\n")

    for i, anchor in enumerate((
            "  __syncthreads();\n\n  // block 0: decoder_y → Y, decoder_x → R\n",
            "              w.y0w3, w.y0_b3, tf2, Y, tf2, false, H, C, ring);\n",
            "              w.x0_b2, w.x0w3, w.x0_b3, tp2, R, tp2, false, H, C, "
            "ring);\n",
            "                              w.conv_w, w.conv_b, ring);\n",
            "              true, H, C, ring);\n")):
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase anchor not found: {anchor!r}")
        src = src.replace(anchor, anchor + stamp(i))
    end = 'extern "C" const char* sttode_error_string(int err) {'
    return src.replace(end, 'extern "C" int select_profile_read(long long* '
                       'dst, int n) {\n  return cudaMemcpyFromSymbol(dst, '
                       'g_prof, sizeof(long long) * n);\n}\n\n' + end)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_select_profile: no CUDA device", file=sys.stderr)
        return 2
    work = os.path.join(HERE, ".select_profile")
    shutil.rmtree(work, ignore_errors=True)
    try:
        shutil.copytree(os.path.join(HERE, "sttode_tpu_torch"),
                        os.path.join(work, "sttode_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        path = os.path.join(work, "sttode_tpu_torch", "csrc",
                            "select_decode.cu")
        with open(path) as f:
            src = instrument(f.read())
        with open(path, "w") as f:
            f.write(src)
        sys.path.insert(0, work)
        from sttode_tpu_torch import bridge
        from sttode_tpu_torch.kernels import _build
        from sttode_tpu_torch.kernels import select_decode as ks
        from sttode_tpu_torch.models import sttode as tm
        if not _build.__file__.startswith(work):
            raise RuntimeError(f"imported {_build.__file__}, not the copy")
        lib = _build.load()
        lib.select_profile_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        dev = torch.device("cuda")
        rng = np.random.default_rng(0)
        M, K, tp, tf = 1408, 20, 5, 10
        cfg = tm.STTODEConfig(past_length=tp, future_length=tf)
        params = bridge.to_device(tm.sttode_init(7, cfg), dev)

        def randn(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        past = randn(M, tp, 2)
        with torch.inference_mode():
            ops = [randn(M, 2 * cfg.hidden_dim), randn(K, M, cfg.zdim),
                   tm.decode_block0_state(params, past), past.reshape(M, -1),
                   randn(M, 2 * tf)]
            for dtype in (torch.float32, torch.bfloat16):
                ks.select_decode(params, *ops, mode="dist", dtype=dtype)
                torch.cuda.synchronize()
                buf = np.zeros(NB * 24, np.int64)
                lib.select_profile_read(buf.ctypes.data, NB * 24)
                nb = min(NB, -(-M * K // 64))
                stamps = buf[:NB * 8].reshape(NB, 8)[:nb, :5].astype(float)
                phase = np.diff(np.concatenate(
                    [np.zeros((nb, 1)), stamps], 1), axis=1).mean(0)
                parts = buf[NB * 8:].reshape(NB, 4, 4)[:nb].mean(0)
                name = str(dtype).split(".")[-1]
                print(f"{name}: {nb} blocks, {stamps[:, 4].mean():.0f} "
                      f"cycles per block  [{card}]")
                for i, ph in enumerate(("z load", "block 0 decoder_y",
                                        "block 0 decoder_x", "GRU",
                                        "block 1 decoder_y")):
                    line = f"  {ph}: {phase[i]:.0f} cycles"
                    if i:
                        line += (" (wait {:.0f}, issue {:.0f}, bodies {:.0f},"
                                 " ends {:.0f})".format(*parts[i - 1]))
                    print(line)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
