"""Where the time goes in the PyTorch/CUDA port's serving path, on one GPU.

    python3 scripts/torch_serving_profile.py [--calls 10]

For the two serving configurations of ``chip_smoke.py`` (agent-axis
``Predictor`` with 64 scenes × 8 agents per call; reference-compat
``sttode_inference`` on 32 scenes × 11 agents) and for both routes
(hand-written kernels; plain PyTorch), it traces ``--calls`` steady-state
calls with ``torch.profiler`` and prints: host wall time per call, device
busy time per call (sum of kernel durations), the device idle share
(1 − busy / wall), the number of kernel launches per call, and the kernels
that take the most device time. Needs a CUDA device; random weights from a
seed, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sttode_tpu_torch import bridge  # noqa: E402
from sttode_tpu_torch.data.preprocess import prepare_scene_group  # noqa: E402
from sttode_tpu_torch.data.synthetic import make_social_scenes  # noqa: E402
from sttode_tpu_torch.models import sttode as tm  # noqa: E402
from sttode_tpu_torch.serving import Predictor  # noqa: E402


def trace(fn, calls: int, label: str, top: int = 8) -> None:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / calls / 1e3
    launches = sum(e.count for e in kernels) / calls
    print(f"{label}: wall {wall:.3f} ms/call, device busy {busy:.3f} ms/call, "
          f"idle share {1 - busy / wall:.3f}, {launches:.0f} kernels/call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / calls / 1e3:8.4f} ms "
              f"x{e.count // calls:<4d} {e.key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))

    cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent").validate()
    params = tm.sttode_init(0, cfg)
    scenes = [s["obs"] for s in make_social_scenes(64, agents_range=(8, 8),
                                                   seed=0)]
    for route, c in (("kernels", cfg), ("plain", cfg._replace(
            attn_impl="dense", select_impl="xla"))):
        pred = Predictor(params, c, device=dev, max_group=64)
        trace(lambda: pred.predict_many(scenes, seed=11), args.calls,
              f"agent-axis Predictor 64x8, {route}")

    cfg5 = tm.STTODEConfig(past_length=5, future_length=10).validate()
    params5 = bridge.to_device(tm.sttode_init(1, cfg5), dev)
    obs = np.stack([s["obs"] for s in make_social_scenes(
        32, agents_range=(11, 11), obs_len=5, pred_len=10, seed=1)])
    batch, _ = prepare_scene_group(obs, np.zeros((32, 11, 10, 2), np.float32),
                                   np.ones((32, 11), np.float32),
                                   training=False)
    batch = batch.to(dev)
    z = torch.randn(32 * 11 * 20, cfg5.zdim, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    for route, c in (("kernels", cfg5), ("plain", cfg5._replace(
            attn_impl="dense", select_impl="xla"))):
        with torch.inference_mode():
            trace(lambda: tm.sttode_inference(params5, c, batch, z=z),
                  args.calls, f"reference-compat sttode_inference 32x11, "
                  f"{route}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
