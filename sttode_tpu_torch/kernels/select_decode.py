"""Best-of-K selection decode: the CUDA kernel's wrapper and its plain version.

Port of ``sttode_tpu/kernels/select_decode.py::select_decode`` (modes
"traj" and "dist", ``dtype`` float32 or bfloat16). The kernel is
``csrc/select_decode.cu``; its source note says which TPU kernel it
replaces, what bounds it on the H100 and what its design does about it.

For each scene agent m and latent sample k it runs the two-block decompose
decode (num_decompose = 2) with block 0's conv + GRU state precomputed by the
caller (``models.sttode.decode_block0_state``), and returns the relative
trajectories [K, M, 2·T_f] ("traj") or Σ(future_rel − pred)² [M, K]
("dist"). Per-agent operands are passed unrepeated; only z is per (k, m), in
the k-major layout z_km [K, M, Z].

``dtype=torch.bfloat16`` is the TPU kernel's bf16 numerics: weight matrices
and the pf, z and state0 operands stored in bf16, products accumulated in
fp32, activations rounded to bf16 where the TPU kernel rounds them (see
``select_decode_reference``). It is forward-only by design, as on the TPU:
the training step runs it without gradients to pick the argmin winner.

On a CPU tensor ``select_decode`` runs ``select_decode_reference``, the same
function in plain torch; on a CUDA tensor it launches the kernel or raises.
The kernel fixes the decoder's inner widths (MLP 512/256, GRU 96, conv 32,
kernel 3) and takes 2·T_f, 2·T_p ≤ 64. It runs its matrix products on the
tensor cores and reads the weight matrices in the order of the MMA
fragments: ``pack_select_weights`` lays out what ``prep_select_weights``
gives (the kernel splits fp32 into TF32 hi and lo parts for 3xTF32 as it
loads them), and
``unpack_select_weight`` inverts one matrix. The packed weights are kept
for the parameter tensors they were made from until one of them changes
(its version counter moves) or is freed.
"""

from __future__ import annotations

import ctypes
import weakref

import torch
import torch.nn.functional as F

from sttode_tpu_torch.kernels import _build
from sttode_tpu_torch.nn.recurrent import Conv1dParams, _gru_gates, conv1d

GRU_H = 96
CONV_C = 32
MLP_HIDDEN = (512, 256)
_MODES = {"dist": 0, "traj": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# positions in the weight tuple of the biases the TPU kernel rounds to the
# storage type (tail layers and conv); the first-layer and GRU biases stay fp32
_ROUNDED_BIASES = (3, 5, 9, 11, 13, 21, 23)
_FP32_BIASES = (1, 7, 16, 17, 19)


def prep_select_weights(params: dict, pf_width: int, z_width: int,
                        t_past: int, t_fut: int,
                        dtype: torch.dtype = torch.float32) -> tuple:
    """The decode's 24 weight tensors in the kernel's storage types:
    block-0 decoder_y and decoder_x (w1, b1, w2, b2, w3, b3 each), block-1
    conv (w, b) and GRU (w_ih, w_hh, b_ih, b_hh), block-1 decoder_y. Weight
    matrices are stored in ``dtype``; biases are fp32, those of the tail
    layers and the conv rounded through ``dtype`` first (the TPU kernel's
    ``_mlp_tail`` and ``_band_conv_matrix``). Shapes are checked against the
    widths the kernel fixes. The first layers are whole; their pf | z |
    state row blocks are rows [0, 2D), [2D, 2D+Z), [2D+Z, 2D+Z+96).
    ``select_decode_reference`` takes these; ``pack_select_weights`` lays
    them out for the kernel."""
    return _convert(_select_sources(params, pf_width, z_width, t_past,
                                    t_fut), dtype)


def _select_sources(params: dict, pf_width: int, z_width: int, t_past: int,
                    t_fut: int) -> list:
    """The 24 parameter tensors of ``prep_select_weights``, unconverted,
    their shapes checked."""
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
    return ws


def _convert(ws, dtype: torch.dtype) -> tuple:
    """The parameter tensors ``ws`` in the kernel's storage types."""
    out = []
    for i, w in enumerate(ws):
        if i in _FP32_BIASES:
            w = w.to(torch.float32)
        elif i in _ROUNDED_BIASES:
            w = w.to(dtype).to(torch.float32)
        else:
            w = w.to(dtype)
        out.append(w.contiguous())
    return tuple(out)


# --------------------------------------------------------------------------- #
# the kernel's weight layout                                                  #
# --------------------------------------------------------------------------- #

def _fragments(w: torch.Tensor) -> torch.Tensor:
    """w [..., K, N] in MMA B-fragment order, K padded with zero rows to the
    MMA depth and N with zero columns to a multiple of 8, lane = 4·g + t
    reading column g of an n-tile. fp32 (3xTF32 m16n8k8, depth 8):
    [..., K/8, N/8, 32, 2], rows (t, t + 4) — the kernel splits them into
    TF32 hi and lo parts as it loads them; bf16 (m16n8k16, depth 16):
    [..., K/16, N/8, 32, 4], rows (2t, 2t + 1, 2t + 8, 2t + 9). Either way
    a lane's fragment is 8 bytes."""
    tf32 = w.dtype == torch.float32
    kk = 8 if tf32 else 16
    *lead, K, N = w.shape
    w = F.pad(w, (0, -N % 8, 0, -K % kk))
    kt, nt = w.shape[-2] // kk, w.shape[-1] // 8
    d = len(lead)
    # [.., kt, k_in, nt, g] -> [.., kt, nt, g, k_in]
    w = w.reshape(*lead, kt, kk, nt, 8).permute(
        *range(d), d, d + 2, d + 3, d + 1)
    if tf32:
        # k_in = 4·half + t -> [.., g, t, half]
        return w.reshape(*lead, kt, nt, 8, 2, 4).transpose(-1, -2) \
            .reshape(*lead, kt, nt, 32, 2).contiguous()
    # k_in = 8·half + 2t + e -> [.., g, t, half, e]
    return w.reshape(*lead, kt, nt, 8, 2, 4, 2).permute(
        *range(d + 3), d + 4, d + 3, d + 5).reshape(
        *lead, kt, nt, 32, 4).contiguous()


def _chunked(w: torch.Tensor) -> torch.Tensor:
    """A first layer [K, 512] as 8 chunks of 64 columns, each in fragment
    order: [8, K/kk, 8, 32, 2 (fp32) or 4 (bf16)]."""
    return _fragments(w.reshape(w.shape[0], 8, 64).transpose(0, 1))


def _pad_rows(w: torch.Tensor) -> torch.Tensor:
    kk = 8 if w.dtype == torch.float32 else 16
    return F.pad(w, (0, 0, 0, -w.shape[0] % kk))


def unpack_select_weight(frag: torch.Tensor, rows: int,
                         cols: int) -> torch.Tensor:
    """The inverse of the layout: the [rows, cols] fp32 matrix that
    ``_fragments`` (4-d) or ``_chunked`` (5-d, 512 columns) packed."""
    if frag.ndim == 5:
        return torch.cat([unpack_select_weight(c, rows, 64) for c in frag],
                         dim=1)
    kt, nt = frag.shape[:2]
    if frag.dtype == torch.float32:
        x = frag.reshape(kt, nt, 8, 4, 2)            # [.., g, t, half]
        w = x.transpose(-1, -2).reshape(kt, nt, 8, 8)  # [.., g, k_in]
        kk = 8
    else:
        x = frag.reshape(kt, nt, 8, 4, 2, 2)         # [.., g, t, half, e]
        w = x.permute(0, 1, 2, 4, 3, 5).reshape(kt, nt, 8, 16)
        kk = 16
    w = w.permute(0, 3, 1, 2).reshape(kt * kk, nt * 8)
    return w[:rows, :cols].to(torch.float32)


def pack_select_weights(weights: tuple, pf_width: int, z_width: int) -> tuple:
    """The kernel's 26 operands, in the order of the C struct ``Packed``,
    from ``prep_select_weights``' 24 tensors: the weight matrices in MMA
    fragment order (``_fragments``; first layers ``_chunked``) — block 0's
    decoder_y and decoder_x z rows, their second and third layers, the GRU
    (w_ih then w_hh), block 1's decoder_y z | state rows and its second and
    third layers, then the prologue's pf | state rows of both block-0 first
    layers and pf rows of block 1's — then the conv weight and the 12
    biases in fp32. Each row block is padded to the MMA depth on its own."""
    (y0w1, y0b1, y0w2, y0b2, y0w3, y0b3, x0w1, x0b1, x0w2, x0b2, x0w3, x0b3,
     cw, cb, w_ih, w_hh, b_ih, b_hh,
     y1w1, y1b1, y1w2, y1b2, y1w3, y1b3) = weights
    d2, zw = pf_width, z_width

    def rows(w, *blocks):
        return torch.cat([_pad_rows(w[a:b]) for a, b in blocks])

    z, st, pf = (d2, d2 + zw), (d2 + zw, d2 + zw + GRU_H), (0, d2)
    mats = (_chunked(rows(y0w1, z)), _chunked(rows(x0w1, z)),
            _fragments(y0w2), _fragments(y0w3),
            _fragments(x0w2), _fragments(x0w3),
            torch.cat([_fragments(w_ih), _fragments(w_hh)]),
            _chunked(rows(y1w1, z, st)), _fragments(y1w2), _fragments(y1w3),
            _chunked(rows(y0w1, pf, st)), _chunked(rows(x0w1, pf, st)),
            _chunked(rows(y1w1, pf)))
    fp32 = [t.to(torch.float32).contiguous()
            for t in (cw, y0b1, y0b2, y0b3, x0b1, x0b2, x0b3, cb, b_ih, b_hh,
                      y1b1, y1b2, y1b3)]
    return mats + tuple(fp32)


# packed weights by their source parameter tensors: key -> (weak references
# to the sources, their versions, the packed tuple)
_PACKED: dict = {}
_PACKED_MAX = 8


def _packed_weights(sources: list, dtype: torch.dtype, d2: int,
                    zw: int) -> tuple:
    """``pack_select_weights`` of ``sources`` (the 24 parameter tensors) in
    ``dtype``, kept while every source is alive and unchanged in place.
    While a CUDA graph is being captured the packing is always done and
    never cached: the hit-or-miss decision is the host's, and a replay
    after an in-place update of the weights must repack them."""
    if any(t.is_inference() for t in sources) or (
            sources[0].is_cuda and torch.cuda.is_current_stream_capturing()):
        return pack_select_weights(_convert(sources, dtype), d2, zw)
    key = (dtype, d2, zw, tuple(id(t) for t in sources))
    hit = _PACKED.get(key)
    versions = tuple(t._version for t in sources)
    if hit is not None and hit[1] == versions and all(
            r() is t for r, t in zip(hit[0], sources)):
        return hit[2]
    packed = pack_select_weights(_convert(sources, dtype), d2, zw)
    if len(_PACKED) >= _PACKED_MAX:
        _PACKED.pop(next(iter(_PACKED)))
    _PACKED[key] = ([weakref.ref(t) for t in sources], versions, packed)
    return packed


def select_decode_reference(weights: tuple, past_feature: torch.Tensor,
                            z_km: torch.Tensor, state0: torch.Tensor,
                            x_true_flat: torch.Tensor,
                            future_rel_flat: torch.Tensor | None,
                            mode: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same operands and outputs). The
    storage type is that of the weight matrices in ``weights``
    (``prep_select_weights``): with bf16, pf, z and state0 are rounded to
    bf16, products accumulate in fp32, and the values the TPU kernel rounds
    are rounded to bf16: the first- and second-layer activations, the
    residual x_true − x0, the conv output, the GRU input projection (before
    its bias) and the GRU state after each step."""
    store = weights[0].dtype

    def rnd(t):
        return t if store == torch.float32 else t.to(store).to(torch.float32)

    (y0w1, y0b1, y0w2, y0b2, y0w3, y0b3, x0w1, x0b1, x0w2, x0b2, x0w3, x0b3,
     cw, cb, w_ih, w_hh, b_ih, b_hh,
     y1w1, y1b1, y1w2, y1b2, y1w3, y1b3) = [w.to(torch.float32)
                                           for w in weights]
    pf, z_km, state0 = (rnd(t.to(torch.float32))
                        for t in (past_feature, z_km, state0))
    d2, zw = pf.shape[1], z_km.shape[2]
    K, M = z_km.shape[:2]
    t_past = x_true_flat.shape[1] // 2

    def first(w, b, state):
        # [pf | z | state] @ w + b with the K-repeat left to broadcasting
        out = pf @ w[:d2] + b
        if state is not None:
            out = out + state @ w[d2 + zw:]
        return out + z_km @ w[d2:d2 + zw]

    relu = torch.relu
    a_y = rnd(relu(first(y0w1, y0b1, state0)))                  # [K, M, 512]
    a_x = rnd(relu(first(x0w1, x0b1, state0)))
    y0 = rnd(relu(a_y @ y0w2 + y0b2)) @ y0w3 + y0b3             # [K, M, 2T_f]
    x0 = rnd(relu(a_x @ x0w2 + x0b2)) @ x0w3 + x0b3             # [K, M, 2T_p]
    res = rnd(x_true_flat - x0).reshape(K * M, t_past, 2)
    h = rnd(relu(conv1d(Conv1dParams(cw, cb), res, padding=1)))
    gi = rnd(h @ w_ih) + b_ih                                   # [K·M, T, 288]
    st = h.new_zeros((K * M, GRU_H))
    for t in range(t_past):
        st = rnd(_gru_gates(gi[:, t], st @ w_hh + b_hh, st))
    a1 = rnd(relu(first(y1w1, y1b1, None)
                  + st.reshape(K, M, GRU_H) @ y1w1[d2 + zw:]))
    y1 = rnd(relu(a1 @ y1w2 + y1b2)) @ y1w3 + y1b3
    pred = y0 + y1
    if mode == "traj":
        return pred
    return torch.sum(torch.square(future_rel_flat - pred), dim=-1).T


def select_decode(params: dict, past_feature: torch.Tensor,
                  z_km: torch.Tensor, state0: torch.Tensor,
                  x_true_flat: torch.Tensor,
                  future_rel_flat: torch.Tensor | None = None, *,
                  mode: str = "dist",
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Selection decode over M agents × K samples.

    past_feature [M, 2D] and state0 [M, 96] unrepeated; z_km [K, M, Z]
    (k-major — the transpose of the sampler's [M·K, Z] layout); x_true_flat
    [M, 2·T_p]; future_rel_flat [M, 2·T_f] (future − cur_location), needed
    in mode "dist" only. ``dtype`` is the storage type (float32 or
    bfloat16). Returns fp32 dist [M, K] ("dist") or relative trajectories
    [K, M, 2·T_f] ("traj"; the caller re-adds cur_location)."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'dist' or 'traj', got {mode!r}")
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
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
    sources = _select_sources(params, d2, zw, t_past, t_fut2 // 2)
    if past_feature.device.type == "cpu":
        return select_decode_reference(_convert(sources, dtype), past_feature,
                                       z_km, state0, x_true_flat,
                                       future_rel_flat, mode)
    if past_feature.device.type != "cuda":
        raise ValueError(f"unsupported device {past_feature.device}")
    return _launch(sources, past_feature, z_km, state0, x_true_flat,
                   future_rel_flat, mode, t_fut2, dtype)


_FWD = _build.Entry("select_decode_fwd")


def _launch(sources, past_feature, z_km, state0, x_true_flat,
            future_rel_flat, mode, t_fut2, dtype) -> torch.Tensor:
    dev = past_feature.device
    ops = [past_feature, z_km, state0, x_true_flat] + (
        [future_rel_flat] if mode == "dist" else [])
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in ops + list(sources)):
        raise NotImplementedError(
            "the CUDA selection-decode kernel is forward-only (run under "
            "torch.no_grad()/inference_mode(), or use select_impl='xla')")
    ops = [t.to(torch.float32).contiguous() for t in ops]
    for t in ops + list(sources):
        if t.device != dev:
            raise ValueError(f"operand on {t.device}, past_feature on {dev}")
    pf, z_km, state0, x_true_flat = ops[:4]
    fut = ops[4] if mode == "dist" else None
    M, d2 = pf.shape
    K, _, zw = z_km.shape
    t_past = x_true_flat.shape[1] // 2
    if max(2 * t_past, t_fut2) > 64:
        raise ValueError(f"the selection-decode kernel takes 2·T_p and 2·T_f "
                         f"up to 64 (got {2 * t_past}, {t_fut2}); use "
                         f"select_impl='xla'")
    weights = _packed_weights(sources, dtype, d2, zw)
    base = torch.empty((M, 3 * MLP_HIDDEN[0]), device=dev,
                       dtype=torch.float32)
    out = torch.empty((M, K) if mode == "dist" else (K, M, t_fut2),
                      device=dev, dtype=torch.float32)
    ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
    err = _build.launch(
        _FWD, dev, pf.data_ptr(), z_km.data_ptr(), state0.data_ptr(),
        x_true_flat.data_ptr(), None if fut is None else fut.data_ptr(),
        ctypes.cast(ptrs, ctypes.c_void_p), base.data_ptr(), out.data_ptr(),
        M, K, d2, zw, t_past, t_fut2 // 2, _MODES[mode], _DTYPES[dtype])
    if err:
        _build.check(err, f"select_decode_fwd(M={M}, K={K}, mode={mode}, "
                          f"dtype={dtype})")
    select_decode.launches += 1
    select_decode.launches_by_dtype[dtype] += 1
    select_decode.launches_by_mode[mode] += 1
    return out


# kernel launches, counted in _launch: all of them, per storage type and per
# mode
select_decode.launches = 0
select_decode.launches_by_dtype = {torch.float32: 0, torch.bfloat16: 0}
select_decode.launches_by_mode = dict.fromkeys(_MODES, 0)
