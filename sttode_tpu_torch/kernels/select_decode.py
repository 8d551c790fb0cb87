"""Best-of-K selection decode: the CUDA kernel's wrapper and its plain version.

Port of ``sttode_tpu/kernels/select_decode.py::select_decode`` (fp32, modes
"traj" and "dist"). The kernel is ``csrc/select_decode.cu``; its source note
says which TPU kernel it replaces, what bounds it on the H100 and what its
design does about it.

For each scene agent m and latent sample k it runs the two-block decompose
decode (num_decompose = 2) with block 0's conv + GRU state precomputed by the
caller (``models.sttode.decode_block0_state``), and returns the relative
trajectories [K, M, 2·T_f] ("traj") or Σ(future_rel − pred)² [M, K]
("dist"). Per-agent operands are passed unrepeated; only z is per (k, m), in
the k-major layout z_km [K, M, Z].

On a CPU tensor ``select_decode`` runs ``select_decode_reference``, the same
function in plain torch; on a CUDA tensor it launches the kernel or raises.
The kernel fixes the decoder's inner widths (MLP 512/256, GRU 96, conv 32,
kernel 3) and computes in fp32.
"""

from __future__ import annotations

import ctypes

import torch

from sttode_tpu_torch.kernels import _build
from sttode_tpu_torch.nn.recurrent import (Conv1dParams, GRUParams, conv1d,
                                           gru)

GRU_H = 96
CONV_C = 32
MLP_HIDDEN = (512, 256)
_MODES = {"dist": 0, "traj": 1}


def prep_select_weights(params: dict, pf_width: int, z_width: int,
                        t_past: int, t_fut: int) -> tuple:
    """The kernel's 24 fp32 weight tensors, in the order of the C struct
    ``Weights``: block-0 decoder_y and decoder_x (w1, b1, w2, b2, w3, b3
    each), block-1 conv (w, b) and GRU (w_ih, w_hh, b_ih, b_hh), block-1
    decoder_y. Shapes are checked against the widths the kernel fixes. The
    first layers are used whole: the kernel addresses their pf | z | state
    row blocks (rows [0, 2D), [2D, 2D+Z), [2D+Z, 2D+Z+96)) by offset."""
    if len(params["decoder"]) != 2:
        raise NotImplementedError(
            "the select_decode kernel supports num_decompose=2 only")
    b0, b1 = params["decoder"]
    feat = pf_width + z_width + GRU_H

    def mlp(p, d_out):
        layers = p["layers"]
        dims = [feat, *MLP_HIDDEN, d_out]
        if len(layers) != 3:
            raise ValueError("decoder MLPs must have 3 layers")
        out = []
        for lp, a, b in zip(layers, dims[:-1], dims[1:]):
            if tuple(lp["w"].shape) != (a, b) or tuple(lp["b"].shape) != (b,):
                raise ValueError(f"decoder layer {tuple(lp['w'].shape)} != "
                                 f"({a}, {b})")
            out += [lp["w"], lp["b"]]
        return out

    conv, g = b1["conv_past"], b1["gru"]
    if tuple(conv.w.shape) != (3, 2, CONV_C) or \
            tuple(g.w_ih.shape) != (CONV_C, 3 * GRU_H) or \
            tuple(g.w_hh.shape) != (GRU_H, 3 * GRU_H):
        raise ValueError("block-1 conv must be [3, 2, 32] and GRU 32→96")
    ws = (mlp(b0["decoder_y"], 2 * t_fut) + mlp(b0["decoder_x"], 2 * t_past)
          + [conv.w, conv.b, g.w_ih, g.w_hh, g.b_ih, g.b_hh]
          + mlp(b1["decoder_y"], 2 * t_fut))
    return tuple(w.to(torch.float32).contiguous() for w in ws)


def select_decode_reference(weights: tuple, past_feature: torch.Tensor,
                            z_km: torch.Tensor, state0: torch.Tensor,
                            x_true_flat: torch.Tensor,
                            future_rel_flat: torch.Tensor | None,
                            mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same operands and outputs)."""
    (y0w1, y0b1, y0w2, y0b2, y0w3, y0b3, x0w1, x0b1, x0w2, x0b2, x0w3, x0b3,
     cw, cb, w_ih, w_hh, b_ih, b_hh,
     y1w1, y1b1, y1w2, y1b2, y1w3, y1b3) = weights
    d2, zw = past_feature.shape[1], z_km.shape[2]
    K, M = z_km.shape[:2]
    t_past = x_true_flat.shape[1] // 2

    def first(w, b, state):
        # [pf | z | state] @ w + b with the K-repeat left to broadcasting
        out = past_feature @ w[:d2] + b
        if state is not None:
            out = out + state @ w[d2 + zw:]
        return out + z_km @ w[d2:d2 + zw]

    relu = torch.relu
    a_y = relu(first(y0w1, y0b1, state0))                    # [K, M, 512]
    a_x = relu(first(x0w1, x0b1, state0))
    y0 = relu(a_y @ y0w2 + y0b2) @ y0w3 + y0b3               # [K, M, 2T_f]
    x0 = relu(a_x @ x0w2 + x0b2) @ x0w3 + x0b3               # [K, M, 2T_p]
    res = (x_true_flat - x0).reshape(K * M, t_past, 2)
    h = relu(conv1d(Conv1dParams(cw, cb), res, padding=1))
    _, st = gru(GRUParams(w_ih, w_hh, b_ih, b_hh), h)        # [K·M, 96]
    a1 = relu(first(y1w1, y1b1, None)
              + st.reshape(K, M, GRU_H) @ y1w1[d2 + zw:])
    y1 = relu(a1 @ y1w2 + y1b2) @ y1w3 + y1b3
    pred = y0 + y1
    if mode == "traj":
        return pred
    return torch.sum(torch.square(future_rel_flat - pred), dim=-1).T


def select_decode(params: dict, past_feature: torch.Tensor,
                  z_km: torch.Tensor, state0: torch.Tensor,
                  x_true_flat: torch.Tensor,
                  future_rel_flat: torch.Tensor | None = None, *,
                  mode: str = "dist") -> torch.Tensor:
    """Selection decode over M agents × K samples.

    past_feature [M, 2D] and state0 [M, 96] unrepeated; z_km [K, M, Z]
    (k-major — the transpose of the sampler's [M·K, Z] layout); x_true_flat
    [M, 2·T_p]; future_rel_flat [M, 2·T_f] (future − cur_location), needed
    in mode "dist" only. Returns dist [M, K] ("dist") or relative
    trajectories [K, M, 2·T_f] ("traj"; the caller re-adds cur_location)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'dist' or 'traj', got {mode!r}")
    M, d2 = past_feature.shape
    K, Mz, zw = z_km.shape
    t_past = x_true_flat.shape[1] // 2
    t_fut2 = params["decoder"][0]["decoder_y"]["layers"][-1]["w"].shape[1]
    if Mz != M or tuple(state0.shape) != (M, GRU_H) or \
            tuple(x_true_flat.shape) != (M, 2 * t_past):
        raise ValueError("inconsistent operand shapes: past_feature "
                         f"{tuple(past_feature.shape)}, z_km {tuple(z_km.shape)}, "
                         f"state0 {tuple(state0.shape)}, x_true "
                         f"{tuple(x_true_flat.shape)}")
    if mode == "dist" and (future_rel_flat is None or
                           tuple(future_rel_flat.shape) != (M, t_fut2)):
        raise ValueError(f"mode 'dist' needs future_rel_flat [M, {t_fut2}]")
    weights = prep_select_weights(params, d2, zw, t_past, t_fut2 // 2)
    if past_feature.device.type == "cpu":
        return select_decode_reference(weights, past_feature, z_km, state0,
                                       x_true_flat, future_rel_flat, mode)
    if past_feature.device.type != "cuda":
        raise ValueError(f"unsupported device {past_feature.device}")
    return _launch(weights, past_feature, z_km, state0, x_true_flat,
                   future_rel_flat, mode, t_fut2)


def _launch(weights, past_feature, z_km, state0, x_true_flat,
            future_rel_flat, mode, t_fut2) -> torch.Tensor:
    dev = past_feature.device
    ops = [past_feature, z_km, state0, x_true_flat] + (
        [future_rel_flat] if mode == "dist" else [])
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in ops + list(weights)):
        raise NotImplementedError(
            "the CUDA selection-decode kernel is forward-only (run under "
            "torch.no_grad()/inference_mode(), or use select_impl='xla')")
    ops = [t.to(torch.float32).contiguous() for t in ops]
    for t in ops + list(weights):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, past_feature on {dev}")
    pf, z_km, state0, x_true_flat = ops[:4]
    fut = ops[4] if mode == "dist" else None
    M, d2 = pf.shape
    K, _, zw = z_km.shape
    t_past = x_true_flat.shape[1] // 2
    m_pad = -(-M // 16) * 16                  # the kernel's 16-row agent tiles
    base = torch.empty((m_pad, 3 * MLP_HIDDEN[0]), device=dev,
                       dtype=torch.float32)
    out = torch.empty((M, K) if mode == "dist" else (K, M, t_fut2),
                      device=dev, dtype=torch.float32)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.select_decode_fwd(
            pf.data_ptr(), z_km.data_ptr(), state0.data_ptr(),
            x_true_flat.data_ptr(), None if fut is None else fut.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p), base.data_ptr(),
            out.data_ptr(), M, K, d2, zw, t_past, t_fut2 // 2, _MODES[mode],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _build.check(err, f"select_decode_fwd(M={M}, K={K}, mode={mode})")
    select_decode.launches += 1
    return out


select_decode.launches = 0   # kernel launches, counted in _launch
