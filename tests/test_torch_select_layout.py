"""The selection-decode kernel's weight layout and its 3xTF32 numerics, on
the CPU.

Kernel B (``csrc/select_decode.cu``) reads every weight matrix in the order
of its tensor-core MMA fragments, which ``pack_select_weights`` produces in
Python: a k-tile of a matrix is [n-tile][lane][values], lane = 4·g + t
reading column g of the n-tile; fp32 matrices for 3xTF32 m16n8k8 (rows t
and t + 4; the kernel splits each value into TF32 hi = tf32(w) and lo =
tf32(w − hi) as it loads it, and accumulates hi·hi + hi·lo + lo·hi), bf16
matrices for m16n8k16 (rows 2t, 2t + 1, 2t + 8, 2t + 9). These tests hold
the layout to the PTX fragment definitions entry by entry, the inverse
``unpack_select_weight`` to the matrices (exactly), the 26 packed operands
to the prepared weights, the cache of packed weights to in-place parameter
updates, and a model of the kernel's split (``cvt.rna.tf32.f32``) to what
the design needs of it: hi + lo within 2⁻²¹ relative of fp32, and 512-long
3xTF32 sums within the 1e-4 tolerance where one TF32 product is not. The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from sttode_tpu_torch.kernels import select_decode as ks
from sttode_tpu_torch.models import sttode as tm

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero: the device's ``cvt.rna.tf32.f32``."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return (np.trunc(m * 2.0 ** 11 + np.sign(m) * 0.5) / 2.0 ** 11
            * 2.0 ** e).astype(np.float32)


def test_tf32_split_keeps_fp32_accuracy():
    """The kernel's split: hi + lo is within 2⁻²¹ relative of the fp32
    value; over 512-long sums (the decoder's widest product) the three
    TF32 products stay within the decode's 1e-4 of the fp32 sum, one TF32
    product does not."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(100_000) * 10.0 ** rng.integers(
        -6, 6, size=100_000)).astype(np.float32)
    hi = _rna_tf32(x)
    lo = _rna_tf32(x - hi)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -21
    a = rng.standard_normal((64, 512)).astype(np.float32)
    w = (rng.standard_normal((512, 64)) / 16).astype(np.float32)
    exact = a.astype(np.float64) @ w
    ah, wh = _rna_tf32(a), _rna_tf32(w)
    al, wl = _rna_tf32(a - ah), _rna_tf32(w - wh)
    three = ((al.astype(np.float64) @ wh + ah.astype(np.float64) @ wl)
             + ah.astype(np.float64) @ wh)
    one = ah.astype(np.float64) @ wh
    assert np.abs(three - exact).max() <= 1e-5
    assert np.abs(one - exact).max() > 1e-4


@pytest.mark.parametrize("K,N", [(32, 288), (40, 300), (3, 20), (512, 256)])
def test_fp32_fragments_follow_the_ptx_layout(K, N):
    rng = np.random.default_rng(K + N)
    w = rng.standard_normal((K, N)).astype(np.float32)
    frag = ks._fragments(torch.from_numpy(w)).numpy()
    kt, nt = -(-K // 8), -(-N // 8)
    assert frag.shape == (kt, nt, 32, 2)
    wp = np.zeros((kt * 8, nt * 8), np.float32)
    wp[:K, :N] = w
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for a in range(kt):
        for b in range(nt):
            cols = b * 8 + g
            np.testing.assert_array_equal(frag[a, b, :, 0], wp[a * 8 + t, cols])
            np.testing.assert_array_equal(frag[a, b, :, 1],
                                          wp[a * 8 + t + 4, cols])


@pytest.mark.parametrize("K,N", [(96, 288), (37, 64), (256, 24)])
def test_bf16_fragments_follow_the_ptx_layout(K, N):
    rng = np.random.default_rng(K * N)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)) \
        .to(torch.bfloat16)
    frag = ks._fragments(w).float().numpy()
    kt, nt = -(-K // 16), -(-N // 8)
    assert frag.shape == (kt, nt, 32, 4)
    wp = np.zeros((kt * 16, nt * 8), np.float32)
    wp[:K, :N] = w.float().numpy()
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for a in range(kt):
        for b in range(nt):
            for i, dk in enumerate((0, 1, 8, 9)):
                np.testing.assert_array_equal(
                    frag[a, b, :, i], wp[a * 16 + 2 * t + dk, b * 8 + g])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [37, 224])
def test_chunked_layout_round_trips(dtype, K):
    """A first layer [K, 512] as 8 chunks of 64 columns (chunk c, n-tile b,
    lane 4g + t holds column 64c + 8b + g); its inverse gives the matrix
    back exactly."""
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.standard_normal((K, 512)).astype(np.float32)
                         ).to(dtype)
    frag = ks._chunked(w)
    kk, vals = (8, 2) if dtype == torch.float32 else (16, 4)
    assert tuple(frag.shape) == (8, -(-K // kk), 8, 32, vals)
    torch.testing.assert_close(ks.unpack_select_weight(frag, K, 512),
                               w.float(), rtol=0, atol=0)
    np.testing.assert_array_equal(frag[3, 0, 5, 4 * 1 + 0, 0].float().numpy(),
                                  w[0, 3 * 64 + 5 * 8 + 1].float().numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hidden,zdim,tp,tf", [(64, 32, 5, 10), (6, 3, 8, 12)])
def test_pack_select_weights_inverts_to_the_prepared_weights(dtype, hidden,
                                                             zdim, tp, tf):
    """Every packed matrix unpacks exactly to its rows of the prepared
    weights (each row block padded to the MMA depth on its own), and the
    conv weight and the biases pass as fp32 in the kernel's struct order."""
    cfg = tm.STTODEConfig(hidden_dim=hidden, num_heads=1 if hidden < 8 else 8,
                          zdim=zdim, past_length=tp, future_length=tf)
    params = tm.sttode_init(3, cfg)
    d2 = 2 * hidden
    w = ks.prep_select_weights(params, d2, zdim, tp, tf, dtype)
    packed = ks.pack_select_weights(w, d2, zdim)
    assert len(packed) == 26
    f32 = [x.to(torch.float32) for x in w]
    (y0w1, _, y0w2, _, y0w3, _, x0w1, _, x0w2, _, x0w3, _,
     cw, _, w_ih, w_hh, _, _, y1w1, _, y1w2, _, y1w3, _) = f32
    kk = 8 if dtype == torch.float32 else 16
    zp, dp = -(-zdim // kk) * kk, -(-d2 // kk) * kk
    z, st, pf = slice(d2, d2 + zdim), slice(d2 + zdim, None), slice(0, d2)

    def blocks(m, *parts):
        out = []
        for sl, pad in parts:
            x = m[sl]
            out.append(torch.cat([x, x.new_zeros(pad - x.shape[0],
                                                 x.shape[1])]))
        return torch.cat(out)

    want = [blocks(y0w1, (z, zp)), blocks(x0w1, (z, zp)), y0w2, y0w3, x0w2,
            x0w3, torch.cat([w_ih, w_hh]),
            blocks(y1w1, (z, zp), (st, 96)), y1w2, y1w3,
            blocks(y0w1, (pf, dp), (st, 96)), blocks(x0w1, (pf, dp), (st, 96)),
            blocks(y1w1, (pf, dp))]
    for i, (frag, m) in enumerate(zip(packed[:13], want)):
        if i == 6:   # w_ih and w_hh: k-tiles of 288 columns, one after other
            back = ks.unpack_select_weight(frag, 128, 288)
        else:
            back = ks.unpack_select_weight(frag, *m.shape)
        torch.testing.assert_close(back, m, rtol=0, atol=0, msg=str(i))
        assert frag.dtype == dtype, i
    rest = [w[i] for i in (12, 1, 3, 5, 7, 9, 11, 13, 16, 17, 19, 21, 23)]
    for got, src in zip(packed[13:], rest):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), src.float().numpy())


def test_packed_weights_follow_in_place_updates():
    """The packed weights are kept for the same parameter tensors, and made
    anew once one of them changes in place (as Adam's step does)."""
    cfg = tm.STTODEConfig(hidden_dim=6, num_heads=1, zdim=3, past_length=4,
                          future_length=5)
    params = tm.sttode_init(4, cfg)
    src = ks._select_sources(params, 12, 3, 4, 5)
    a = ks._packed_weights(src, torch.float32, 12, 3)
    assert ks._packed_weights(src, torch.float32, 12, 3) is a
    assert ks._packed_weights(src, torch.bfloat16, 12, 3) is not a
    with torch.no_grad():
        src[2].add_(1.0)                       # decoder_y's second layer
    b = ks._packed_weights(src, torch.float32, 12, 3)
    assert b is not a
    np.testing.assert_array_equal(
        ks.unpack_select_weight(b[2], 512, 256).numpy(), src[2].numpy())
