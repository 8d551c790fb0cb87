"""Write copies of the port that each take one part out of the flash
backward sweeps' design, to time each part alone.

    python3 scripts/torch_flash_variants.py DEST

Each variant is a directory ``DEST/<name>`` holding ``chip_smoke.py`` and a
copy of ``sttode_tpu_torch`` whose ``csrc/flash_mhgsa_bwd.cu``,
``csrc/flash_tile.cuh`` or ``csrc/poincare.cuh`` differs from the working
tree's in one respect. The oblique register sweeps' variants
(``OBLIQUE_VARIANTS``, named ``oblique_<name>`` here) set the compile-time
defines of ``flash_mhgsa_bwd.cu``, off by default:

- ``ieee_epilogue``: acosf, expf and rsqrtf, the sweeps' arithmetic of
  before, in place of ``oblique::sweep_p``
  (``STTODE_FLASH_BWD_IEEE_EPILOGUE``);
- ``reg_staging``: each row of the other axis staged through a thread's
  registers and normalized there, in place of cp.async
  (``STTODE_FLASH_BWD_REG_STAGING``);
- ``rows<R>_minb<M>``: at head dims up to 16, R rows (dq) or keys (dk/dv)
  a thread and launch bounds asking for M resident blocks an SM, which
  caps the registers at 65,536 / (128·M) (``STTODE_FLASH_BWD_ROWS``,
  ``STTODE_FLASH_BWD_MIN_BLOCKS``; M = 1: no cap).

``scripts/torch_flash_bench.py --variants`` builds these from the working
tree's sources alone (one nvcc of ``flash_mhgsa_bwd.cu`` each) and times
them in child processes; the copies here serve a run of the whole package.

The poincaré sweeps' variants:

- ``ring2``: a ring of two stages, so that the next tile's copies overlap
  this tile's pairs;
- ``rows1``: one output row (dq) or key (dk/dv) per thread at every head
  dim;
- ``ieee_epilogue``: the sweeps' epilogue built from the IEEE functions
  (``poincare::pair``, ``score``, ``grad`` and ``expf``);
- ``no_c1``: the general form at c = 1 too;
- ``rows2_dh64``: two rows per thread up to head dim 64;
- ``dkv_min4``: the dk/dv sweep at Dh ≤ 8 held to four resident blocks
  per SM (at most 128 registers a thread).

Run ``scripts/torch_flash_bench.py`` from each directory (and from the
repo, and from a parent checkout) in one call to compare them. DEST should
be a git-ignored directory of the checkout (e.g. ``.flash_variants``).
"""

from __future__ import annotations

import os
import shutil
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD = "flash_mhgsa_bwd.cu"
HDR = "poincare.cuh"
TILE = "flash_tile.cuh"

IEEE_ROW = """template <bool C1>
__device__ __forceinline__ float sweep_row(float lse) {
  return lse;
}
"""
IEEE_GRAD = """  const Pair pp = pair(g, x2, y2, k);
  *p = expf(score(pp, k) - row);
  return grad(pp, *p * (dp - delta), k, a, b);
}
"""

# the oblique register sweeps' variants: name → {define suffix: value}
# (-DSTTODE_FLASH_BWD_<suffix>=<value>)
OBLIQUE_VARIANTS = {
    "ieee_epilogue": {"IEEE_EPILOGUE": 1},
    "reg_staging": {"REG_STAGING": 1},
    **{f"rows{r}_minb{m}": {"ROWS": r, "MIN_BLOCKS": m}
       for r in (1, 2) for m in (1, 4, 6, 8)},
}


def oblique_patches(defines: dict) -> list:
    """(file, text, replacement) patches that turn the defines' defaults."""
    return [(BWD, f"#define STTODE_FLASH_BWD_{k} 0",
             f"#define STTODE_FLASH_BWD_{k} {v}") for k, v in defines.items()]


# name: [(file, text, replacement), ...]
VARIANTS = {
    "ring2": [(BWD, "constexpr int kStages = 1;",
               "constexpr int kStages = 2;")],
    "rows1": [(TILE, "return dh <= 16 ? 2 : 1;", "return 1;")],
    "ieee_epilogue": [(HDR, None, None)],     # built in ieee() below
    "no_c1": [(BWD, "return c == 1.f ? dispatch_poincare_dq<true>",
               "return false ? dispatch_poincare_dq<true>"),
              (BWD, "return c == 1.f ? dispatch_poincare_dkv<true>",
               "return false ? dispatch_poincare_dkv<true>")],
    "rows2_dh64": [(TILE, "return dh <= 16 ? 2 : 1;",
                    "return dh <= 64 ? 2 : 1;")],
    "dkv_min4": [(BWD, "__global__ void __launch_bounds__(kThreads)\n"
                  "flash_poincare_dkv_kernel(",
                  "__global__ void __launch_bounds__(kThreads, DH <= 8 ? 4 : 1)"
                  "\nflash_poincare_dkv_kernel(")],
    **{f"oblique_{name}": oblique_patches(defs)
       for name, defs in OBLIQUE_VARIANTS.items()},
}


def ieee(src: str) -> str:
    """poincare.cuh with sweep_row the identity and sweep_grad's body the
    IEEE epilogue of pair(), score() and grad()."""
    a = src.index("template <bool C1>\n__device__ __forceinline__ float "
                  "sweep_row")
    b = src.index("}\n", a) + 2
    src = src[:a] + IEEE_ROW + src[b:]
    a = src.index("  const float raw = x2 - 2.f * g + y2;",
                  src.index("float sweep_grad("))
    b = src.index("}\n", a) + 2
    return src[:a] + IEEE_GRAD + src[b:]


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    dest = os.path.abspath(sys.argv[1])
    for name, patches in VARIANTS.items():
        root = os.path.join(dest, name)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(os.path.join(HERE, "sttode_tpu_torch"),
                        os.path.join(root, "sttode_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(os.path.join(HERE, "chip_smoke.py"), root)
        for fname, old, new in patches:
            path = os.path.join(root, "sttode_tpu_torch", "csrc", fname)
            with open(path) as f:
                src = f.read()
            if old is None:
                src = ieee(src)
            elif src.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} not found once in "
                                   f"{fname}")
            else:
                src = src.replace(old, new)
            with open(path, "w") as f:
                f.write(src)
        print(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
