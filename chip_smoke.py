"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``sttode_tpu_torch/csrc`` (nvcc,
sm_90a), holds each against its plain PyTorch version at the shapes of the
serving path, then drives the serving path itself at the full width of the
repo's model (hidden 64, 8 heads, ff 1024, zdim 32, K = 20, random weights
from a seed):

  phase 4  agent-axis server: ``Predictor(max_group=64)`` answering 64
           synthetic scenes of 8 agents per call;
  phase 5  reference compat: ``sttode_inference`` on 32 scenes × 11 agents
           (5 past / 10 future steps), and a default-config ``Predictor``
           answering single-scene requests.

Each phase is compared with the same computation on the plain routes
(``attn_impl="dense"``, ``select_impl="xla"``) with the same latents, and
checks that both kernels were launched by the serving path. Every failure
raises; nothing is caught. The second-to-last line of the output is a JSON
object with each kernel's measurements, the last line the device summary.
Exits non-zero without a result when no CUDA device is present. Times are
medians taken with CUDA events (kernels) or the host clock around
synchronized calls (serving), the kernel and plain routes timed in
alternating rounds within the same run.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ATTN_TOL = 1e-5
SELECT_TOL = 1e-4
MODEL_TOL = 1e-4


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def paired_ms(kernel_fn, plain_fn, *, calls: int = 20,
              rounds: int = 8) -> tuple[float, float]:
    """Per-call ms of two routes, timed in alternating order (kernel, plain,
    plain, kernel, ...) so that drift on the shared host hits both alike:
    each sample is the mean of ``calls`` back-to-back calls between two CUDA
    events (it includes the host work of each call when the host is the
    slower side); returns the median sample of each route."""
    fns = (kernel_fn, plain_fn)
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times: tuple[list, list] = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[i]()
            end.record()
            torch.cuda.synchronize()
            times[i].append(start.elapsed_time(end) / calls)
    return statistics.median(times[0]), statistics.median(times[1])


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from sttode_tpu_torch import bridge
    from sttode_tpu_torch.data.preprocess import prepare_scene_group
    from sttode_tpu_torch.data.synthetic import make_social_scenes
    from sttode_tpu_torch.kernels import _build
    from sttode_tpu_torch.kernels import mhgsa as km
    from sttode_tpu_torch.kernels import select_decode as ks
    from sttode_tpu_torch.models import sttode as tm
    from sttode_tpu_torch.serving import Predictor

    # every plain matmul and conv in full fp32, as the kernels compute
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    t0 = time.perf_counter()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name})")

    def counts():
        return {"attn": km.fused_geodesic_attention.launches,
                "select": ks.select_decode.launches}

    def reset():
        km.fused_geodesic_attention.launches = 0
        ks.select_decode.launches = 0

    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(dev)

    # 2. kernel A against its plain version, at the slice's shapes
    def attn_plain(q, k, v, mask):
        *lead, L, Dh = q.shape
        S = k.shape[-2]
        B = int(np.prod(lead))
        m3 = None if mask is None else km._canonicalize_mask(
            torch.broadcast_to(mask, (*lead, L, S)).reshape(B, L, S))
        return km.fused_geodesic_attention_reference(
            q.reshape(B, L, Dh), k.reshape(B, S, Dh), v.reshape(B, S, Dh),
            m3).reshape(*lead, L, Dh)

    fmin = torch.finfo(torch.float32).min
    # reference compat, scene axis (32 scenes × 11 agents): q/k swapped
    qa, ka, va = randn(11, 8, 32, 8), randn(11, 8, 32, 8), randn(11, 8, 32, 8)
    # agent axis (64 scenes × 8 agents), key mask with padded agents
    valid = torch.from_numpy(rng.random((64, 8)) < 0.8).to(dev)
    valid[:, 0] = True
    qb, kb, vb = randn(64, 8, 8, 8), randn(64, 8, 8, 8), randn(64, 8, 8, 8)
    mask_b = torch.zeros(64, 1, 1, 8, device=dev).masked_fill(
        ~valid[:, None, None, :], fmin)
    # one scene with every key excluded (rows must output exactly 0)
    mask_c = torch.zeros(2, 1, 8, 8, device=dev)
    mask_c[1] = fmin
    qc, kc, vc = randn(2, 8, 8, 8), randn(2, 8, 8, 8), randn(2, 8, 8, 8)
    attn_cases = {
        "scene_axis_q11x8x32x8_swapped": (ka, qa, va, None),
        "agent_axis_q64x8x8x8_masked": (qb, kb, vb, mask_b),
        "all_excluded_scene": (qc, kc, vc, mask_c),
    }
    attn_err, attn_times = 0.0, {}
    with torch.inference_mode():
        for name, (q, k, v, mask) in attn_cases.items():
            got = km.fused_geodesic_attention(q, k, v, mask=mask)
            want = attn_plain(q, k, v, mask)
            torch.cuda.synchronize()
            err = max_err(got, want)
            require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
            require(err <= ATTN_TOL, f"{name}: max abs err {err} > {ATTN_TOL}")
            attn_err = max(attn_err, err)
            ms, plain_ms = paired_ms(
                lambda: km.fused_geodesic_attention(q, k, v, mask=mask),
                lambda: attn_plain(q, k, v, mask))
            attn_times[name] = (ms, plain_ms)
            print(f"attention {name}: max_abs_err {err:.3e}  kernel "
                  f"{ms:.4f} ms  plain {plain_ms:.4f} ms")
        require(bool((km.fused_geodesic_attention(qc, kc, vc, mask=mask_c)[1]
                      == 0).all()), "all-excluded rows must output 0")

    # 3. kernel B against its plain version
    select_cases = {}
    for name, (M, K, t_past, t_fut) in {
            "traj_M512_K20": (512, 20, 8, 12),
            "traj_M352_K20": (352, 20, 5, 10)}.items():
        cfg = tm.STTODEConfig(past_length=t_past, future_length=t_fut)
        select_cases[name] = (cfg, bridge.to_device(tm.sttode_init(7, cfg),
                                                    dev), M, K)
    select_err, select_times = 0.0, {}
    with torch.inference_mode():
        for name, (cfg, params, M, K) in select_cases.items():
            past = randn(M, cfg.past_length, 2)
            ops = [randn(M, 2 * cfg.hidden_dim), randn(K, M, cfg.zdim),
                   tm.decode_block0_state(params, past), past.reshape(M, -1),
                   randn(M, 2 * cfg.future_length)]
            weights = ks.prep_select_weights(params, 2 * cfg.hidden_dim,
                                             cfg.zdim, cfg.past_length,
                                             cfg.future_length)
            for mode in ("traj", "dist"):
                got = ks.select_decode(params, *ops, mode=mode)
                want = ks.select_decode_reference(weights, *ops, mode=mode)
                torch.cuda.synchronize()
                err = max_err(got, want)
                require(bool(torch.isfinite(got).all()), f"{name}: non-finite")
                require(err <= SELECT_TOL,
                        f"{name} {mode}: max abs err {err} > {SELECT_TOL}")
                select_err = max(select_err, err)
                if mode == "dist":
                    g_win, w_win = got.argmin(1), want.argmin(1)
                    gap = (want.gather(1, g_win[:, None])
                           - want.gather(1, w_win[:, None])).abs()
                    ties = int((g_win != w_win).sum())
                    require(bool((gap <= 2 * SELECT_TOL).all()),
                            f"{name}: argmin winners differ beyond near-ties")
                    print(f"select {name.replace('traj', 'dist')}: max_abs_err "
                          f"{err:.3e}, winners differ at {ties} near-ties")
                    continue
                ms, plain_ms = paired_ms(
                    lambda: ks.select_decode(params, *ops, mode=mode),
                    lambda: ks.select_decode_reference(
                        ks.prep_select_weights(params, 2 * cfg.hidden_dim,
                                               cfg.zdim, cfg.past_length,
                                               cfg.future_length),
                        *ops, mode=mode))
                select_times[name] = (ms, plain_ms)
                print(f"select {name}: max_abs_err {err:.3e}  kernel "
                      f"{ms:.4f} ms  plain {plain_ms:.4f} ms")

    def serve_ab(kernel_pred, plain_pred, scenes, rounds, single=False):
        """Serve ``rounds`` rounds of requests from each Predictor, the two
        alternating (kernel, plain, plain, kernel, ...): a round is one
        ``predict_many`` of all ``scenes``, or with ``single`` one ``predict``
        per scene. Returns, per route, (outputs of its last round, p50 ms
        per request, scenes/s over the time spent in that route)."""
        preds = (kernel_pred, plain_pred)
        lat, busy, out = ([], []), [0.0, 0.0], [None, None]
        for r in range(rounds):
            for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                res = []
                for batch in ([[s] for s in scenes] if single else [scenes]):
                    t = time.perf_counter()
                    res += preds[i].predict_many(batch, seed=11)
                    dt = time.perf_counter() - t
                    lat[i].append(dt * 1e3)
                    busy[i] += dt
                out[i] = res
        return [(out[i], statistics.median(lat[i]),
                 len(scenes) * rounds / busy[i]) for i in (0, 1)]

    def compare(out, ref, shape_of, what):
        err = 0.0
        for o, r, s in zip(out, ref, shape_of):
            require(o.shape == s, f"{what}: shape {o.shape} != {s}")
            require(bool(np.isfinite(o).all()), f"{what}: non-finite")
            err = max(err, float(np.abs(o - r).max()))
        require(err <= MODEL_TOL, f"{what}: max abs err {err} > {MODEL_TOL}")
        return err

    # 4. the serving path, agent axis (64 scenes × 8 agents per call)
    cfg4 = tm.STTODEConfig(compat="tpu", attn_axis="agent").validate()
    params4 = tm.sttode_init(0, cfg4)
    scenes4 = [s["obs"] for s in make_social_scenes(
        64, agents_range=(8, 8), seed=0)]
    kernel4 = Predictor(params4, cfg4, device=dev, max_group=64)
    plain4 = Predictor(params4, cfg4._replace(attn_impl="dense",
                                              select_impl="xla"),
                       device=dev, max_group=64)
    kernel4.warmup([8], scenes_per=64)
    plain4.warmup([8], scenes_per=64)
    reset()   # the plain routes launch no kernel: the counts are the path's
    (out4, p50_4, rate_4), (ref4, p50_4p, rate_4p) = serve_ab(
        kernel4, plain4, scenes4, 20)
    torch.cuda.synchronize()
    launches4 = counts()
    require(launches4["attn"] > 0 and launches4["select"] > 0,
            f"phase 4: a kernel was not launched by the serving path "
            f"{launches4}")
    err4 = compare(out4, ref4, [(20, 8, 12, 2)] * 64, "phase 4")
    print(f"phase 4 agent-axis server, 64 scenes x 8 agents/call: "
          f"max_abs_err vs plain {err4:.3e}; kernels p50 {p50_4:.3f} ms, "
          f"{rate_4:.1f} scenes/s; plain p50 {p50_4p:.3f} ms, "
          f"{rate_4p:.1f} scenes/s; launches {launches4}")

    # 5. reference compat: sttode_inference on 32 scenes × 11 agents, and a
    #    default-config Predictor answering single-scene requests
    cfg5 = tm.STTODEConfig(past_length=5, future_length=10).validate()
    params5 = bridge.to_device(tm.sttode_init(1, cfg5), dev)
    sc5 = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                             pred_len=10, seed=1)
    obs5 = np.stack([s["obs"] for s in sc5])
    batch5, _ = prepare_scene_group(obs5, np.zeros((32, 11, 10, 2),
                                                   np.float32),
                                    np.ones((32, 11), np.float32),
                                    training=False)
    batch5 = batch5.to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    z5 = torch.randn(32 * 11 * 20, cfg5.zdim, device=dev, generator=gen)
    plain_cfg5 = cfg5._replace(attn_impl="dense", select_impl="xla")
    cfg_def = tm.STTODEConfig().validate()
    params_def = tm.sttode_init(2, cfg_def)
    kernel_def = Predictor(params_def, cfg_def, device=dev)
    plain_def = Predictor(params_def, cfg_def._replace(
        attn_impl="dense", select_impl="xla"), device=dev)
    singles = [s["obs"] for s in make_social_scenes(
        8, agents_range=(3, 12), seed=3)]
    kernel_def.warmup([8, 12])
    plain_def.warmup([8, 12])
    with torch.inference_mode():
        tm.sttode_inference(params5, cfg5, batch5, z=z5)
        torch.cuda.synchronize()
        reset()
        got5 = tm.sttode_inference(params5, cfg5, batch5, z=z5)
        (out_def, p50_d, rate_d), (ref_def, p50_dp, rate_dp) = serve_ab(
            kernel_def, plain_def, singles, 6, single=True)
        torch.cuda.synchronize()
        launches5 = counts()
        want5 = tm.sttode_inference(params5, plain_cfg5, batch5, z=z5)
        ms5, ms5p = paired_ms(
            lambda: tm.sttode_inference(params5, cfg5, batch5, z=z5),
            lambda: tm.sttode_inference(params5, plain_cfg5, batch5, z=z5),
            calls=5)
    require(launches5["attn"] > 0 and launches5["select"] > 0,
            f"phase 5: a kernel was not launched {launches5}")
    require(tuple(got5.shape) == (20, 352, 10, 2), f"phase 5 shape {got5.shape}")
    require(bool(torch.isfinite(got5).all()), "phase 5: non-finite")
    err5 = max_err(got5, want5)
    require(err5 <= MODEL_TOL, f"phase 5: max abs err {err5} > {MODEL_TOL}")
    err_def = compare(out_def, ref_def,
                      [(20, len(s), 12, 2) for s in singles], "phase 5 server")
    print(f"phase 5 reference compat, sttode_inference 32 scenes x 11 agents: "
          f"max_abs_err vs plain {err5:.3e}; kernels {ms5:.3f} ms/call "
          f"({32e3 / ms5:.1f} scenes/s), plain {ms5p:.3f} ms/call "
          f"({32e3 / ms5p:.1f} scenes/s)")
    print(f"phase 5 default-config server, single-scene requests: "
          f"max_abs_err vs plain {err_def:.3e}; kernels p50 {p50_d:.3f} ms, "
          f"{rate_d:.1f} scenes/s; plain p50 {p50_dp:.3f} ms, "
          f"{rate_dp:.1f} scenes/s; launches {launches5}")

    a_ms, a_plain = attn_times["agent_axis_q64x8x8x8_masked"]
    s_ms, s_plain = select_times["traj_M512_K20"]
    print(json.dumps({"kernels": [
        {"name": "fused_geodesic_attention", "route": "cuda",
         "source": "sttode_tpu_torch/csrc/mhgsa_fwd.cu",
         "replaces": "sttode_tpu/kernels/mhgsa.py:407",
         "launches": launches4["attn"] + launches5["attn"],
         "max_abs_err": attn_err, "ms": a_ms, "plain_ms": a_plain},
        {"name": "select_decode", "route": "cuda",
         "source": "sttode_tpu_torch/csrc/select_decode.cu",
         "replaces": "sttode_tpu/kernels/select_decode.py:270",
         "launches": launches4["select"] + launches5["select"],
         "max_abs_err": select_err, "ms": s_ms, "plain_ms": s_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
