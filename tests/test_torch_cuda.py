"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (Hopper: the kernels are built for
sm_90a) and nvcc, and skips without one. The file imports neither JAX nor
the JAX package, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: attention 1e-5, selection
decode and the model 1e-4 (fp32 with different summation orders);
attention gradients 5e-5 × max(1, max |gradient|) (the acos' factor, up to
~70 at the clip, amplifies the Gram's summation-order differences); the bf16
selection decode 1e-3 relative to the distance scale, with winner flips only
at near-ties (both sides round to bf16 at the same points; a different fp32
summation order can move a value across a bf16 rounding boundary).
"""

import re

import numpy as np
import pytest
import torch

from sttode_tpu_torch import bridge
from sttode_tpu_torch.bridge import to_device
from sttode_tpu_torch.data.preprocess import prepare_scene_group
from sttode_tpu_torch.data.synthetic import make_social_scenes
from sttode_tpu_torch.kernels import mhgsa as tmhgsa
from sttode_tpu_torch.kernels import packed_mhgsa as tpacked
from sttode_tpu_torch.kernels import select_decode as tsd
from sttode_tpu_torch.models import sampler as ts
from sttode_tpu_torch.models import sttode as tm
from sttode_tpu_torch.nn.attention import to_ball
from sttode_tpu_torch.serving import Predictor
from sttode_tpu_torch.train import make_sampler_train_step, make_train_step


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _sweep(n, seed, draw):
    rng = np.random.default_rng(seed)
    return [draw(rng) for _ in range(n)]


def _attn_inputs(shape_q, S, mask_kind, seed):
    rng = np.random.default_rng(seed)
    *lead, L, Dh = shape_q
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v = arr(*shape_q), arr(*lead, S, Dh), arr(*lead, S, Dh)
    mask = None
    if mask_kind == "finite":
        mask = 3.0 * arr(*lead, L, S) + 2.0
    elif mask_kind == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((*lead, L, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0)
        mask[..., 0, :] = torch.finfo(torch.float32).min   # all excluded
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("shape_q,S,mask_kind", [
    ((11, 8, 32, 8), 32, None),           # scene axis, reference compat
    ((64, 8, 8, 8), 8, "finfo_min"),      # agent axis with padded keys
    ((3, 5, 40, 16), 70, "finite"),
    ((2, 2, 6, 64), 300, "finfo_min")])
def test_attention_kernel_matches_plain(cuda_device, shape_q, S, mask_kind):
    q, k, v, mask = _attn_inputs(shape_q, S, mask_kind, seed=4)
    want = tmhgsa.fused_geodesic_attention(q, k, v, mask=mask)
    before = tmhgsa.fused_geodesic_attention.launches
    got = tmhgsa.fused_geodesic_attention(
        q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
        mask=None if mask is None else mask.to(cuda_device))
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    if mask_kind == "finfo_min":
        assert torch.all(got[..., 0, :] == 0)


@pytest.mark.cuda
def test_attention_kernel_refuses_grad_and_oversized_keys(cuda_device):
    """Gradients are taken through the backward kernel (and equal the plain
    backward's); keys that do not fit in shared memory, which the forward
    kernel refused before its key-streaming mode, now run in that mode and
    equal the plain forward, and the backward kernel stages such a problem
    in a device workspace and equals its plain version."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(np.float32))
    q = x.to(cuda_device).requires_grad_()
    before = tmhgsa.fused_geodesic_attention_backward.launches
    out = tmhgsa.fused_geodesic_attention(q, q, q)
    (g,) = torch.autograd.grad(out.sum(), q)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention_backward.launches == before + 1
    xc = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        tmhgsa.fused_geodesic_attention(xc, xc, xc).sum(), xc)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(g.cpu().numpy(), want.numpy(), rtol=0,
                               atol=5e-5)
    q = torch.randn(1, 8, 64, device=cuda_device)
    kv = torch.randn(1, 100_000, 64, device=cuda_device)
    assert max(tmhgsa.whole_s_smem_bytes(8, 100_000, 64)) > \
        tmhgsa.SMEM_OPTIN_BYTES
    got = tmhgsa.fused_geodesic_attention(q, kv, kv)
    torch.cuda.synchronize()
    want = tmhgsa.fused_geodesic_attention_reference(q, kv, kv, None)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-5)
    got = tmhgsa.fused_geodesic_attention_backward(q, kv, kv, None, q)
    torch.cuda.synchronize()
    want = tmhgsa.fused_geodesic_attention_backward(
        q.cpu(), kv.cpu(), kv.cpu(), None, q.cpu())
    _grad_check([g if g is None else g.cpu() for g in got], want)


def _grad_check(got, want):
    for name, g, w in zip(("dq", "dk", "dv", "dmask"), got, want):
        if w is None:
            assert g is None, name
            continue
        scale = max(1.0, float(w.abs().max()))
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=0,
                                   atol=5e-5 * scale, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=88, L=128, S=128, Dh=8, mask="none"),      # the training shape
    dict(B=64, L=8, S=8, Dh=8, mask="finfo_min"),     # agent axis
    dict(B=3, L=5, S=9, Dh=8, mask="all_excluded"),
    dict(B=2, L=6, S=6, Dh=8, mask="identical_qk"),
    dict(B=512, L=8, S=8, Dh=8, mask="finfo_min"),    # 64·8 agent-axis problems
    dict(B=88, L=128, S=128, Dh=8, mask="all_excluded"),
    # the small-S mode's row rounds (L > the block's threads), its
    # bounds (S = 16 at Dh = 16) and the kernel of before just beyond them
    dict(B=4, L=700, S=40, Dh=16, mask="all_excluded"),
    dict(B=4, L=33, S=512, Dh=16, mask="finfo_min"),
    dict(B=5, L=16, S=16, Dh=16, mask="finite"),
    dict(B=5, L=12, S=8, Dh=16, mask="all_excluded")])
def test_attention_backward_kernel_matches_plain(cuda_device, case):
    rng = np.random.default_rng(case["B"] + case["L"])
    B, L, S, Dh = case["B"], case["L"], case["S"], case["Dh"]
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v, do = arr(B, L, Dh), arr(B, S, Dh), arr(B, S, Dh), arr(B, L, Dh)
    mask = None
    if case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((B, 1, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0) \
            .expand(B, L, S)
    elif case["mask"] == "all_excluded":
        mask = 2.0 * arr(B, L, S)
        mask[:, 0] = torch.finfo(torch.float32).min
    elif case["mask"] == "finite":
        mask = 3.0 * arr(B, L, S)
    elif case["mask"] == "identical_qk":
        k = q.clone()
    m3 = None if mask is None else tmhgsa._canonicalize_mask(mask)
    want = tmhgsa.fused_geodesic_attention_backward(q, k, v, m3, do,
                                                    need_dmask=True)
    before = tmhgsa.fused_geodesic_attention_backward.launches
    got = tmhgsa.fused_geodesic_attention_backward(
        *[t.to(cuda_device) for t in (q, k, v)],
        None if m3 is None else m3.to(cuda_device), do.to(cuda_device),
        need_dmask=True)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention_backward.launches == before + 1
    _grad_check(got, want)
    if case["mask"] == "all_excluded":
        assert torch.all(got[0][:, 0] == 0) and torch.all(got[3][:, 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(12, 13, lambda r: dict(
    lead=tuple(int(x) for x in r.integers(1, 5, size=int(r.integers(1, 3)))),
    L=int(r.integers(1, 70)), S=int(r.integers(1, 70)),
    Dh=int(r.choice([1, 3, 5, 8, 13, 32, 33, 64])),
    mask=str(r.choice(["none", "finite", "finfo_min"])))) + _sweep(
    # both sides of the small-S mode's bounds (kernels.mhgsa.small_bwd_mode:
    # Dh ≤ 8, Dh ≤ 16 from S = 16, Dh ≤ 32 from S = 32, within shared memory)
    12, 23, lambda r: dict(
        lead=(int(r.integers(1, 4)),), L=int(r.integers(1, 700)),
        S=int(r.integers(1, 700)), Dh=int(r.choice([5, 8, 9, 16, 17, 32])),
        mask=str(r.choice(["none", "finite", "finfo_min"])))))
def test_attention_backward_kernel_randomized_sweep(cuda_device, case):
    """Random shapes (odd head dims, L ≠ S, one leading dim or two; on both
    sides of the small-S mode's bounds) and mask kinds: gradients of q, k, v
    and a mask that requires grad, through the autograd Function, against
    the plain backward on the CPU."""
    rng = np.random.default_rng(case["L"] * 137 + case["S"])
    lead, L, S, Dh = case["lead"], case["L"], case["S"], case["Dh"]
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    ins = [arr(*lead, L, Dh), arr(*lead, S, Dh), arr(*lead, S, Dh)]
    w = arr(*lead, L, Dh)
    if case["mask"] == "finite":
        ins.append(20 * arr(*lead, L, S))
    elif case["mask"] == "finfo_min":
        ins.append(torch.where(torch.from_numpy(rng.random((*lead, L, S)))
                               < 0.4, torch.finfo(torch.float32).min, 0.0))

    def grads(dev):
        leaves = [t.to(dev).requires_grad_() for t in ins]
        out = tmhgsa.fused_geodesic_attention(
            *leaves[:3], mask=leaves[3] if len(leaves) > 3 else None)
        return torch.autograd.grad((out * w.to(dev)).sum(), leaves)

    want = grads("cpu")
    got = grads(cuda_device)
    torch.cuda.synchronize()
    _grad_check(got, want)


def _packed_inputs(rng, B, H, L, S, Dh, valid):
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v, do = arr(B, H, L, Dh), arr(B, H, S, Dh), arr(B, H, S, Dh), \
        arr(B, H, L, Dh)
    kv = None
    if valid == "random":
        kv = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))
    elif valid == "all_invalid":
        kv = torch.ones(B, S)
        kv[0] = 0.0
    return q, k, v, do, kv


def _packed_both(q, k, v, do, kv, dev):
    """(out, dq, dk, dv) through the public wrapper and autograd."""
    leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
    out = tpacked.packed_geodesic_attention(
        *leaves, kv_valid=None if kv is None else kv.to(dev))
    grads = torch.autograd.grad(out, leaves, do.to(dev))
    return [out.detach(), *grads]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=11, H=8, L=32, S=32, Dh=8, valid="none"),     # the NBA recipe
    dict(B=88, H=8, L=1, S=1, Dh=8, valid="none"),       # single scenes
    dict(B=4, H=8, L=11, S=11, Dh=8, valid="all_invalid"),
    dict(B=2, H=16, L=8, S=8, Dh=8, valid="random"),     # H·Dh = 128
    dict(B=2, H=1, L=1, S=1024, Dh=8, valid="random"),   # L·S = 32², S > 32
    dict(B=3, H=2, L=40, S=25, Dh=16, valid="random"),   # L > 32
    dict(B=2, H=1, L=7, S=13, Dh=128, valid="random"),   # widest head
    dict(B=2, H=2, L=6, S=6, Dh=8, valid="identical_qk")])
def test_packed_kernels_match_plain(cuda_device, case):
    rng = np.random.default_rng(case["L"] * 7 + case["S"])
    q, k, v, do, kv = _packed_inputs(
        rng, *(case[x] for x in ("B", "H", "L", "S", "Dh", "valid")))
    if case["valid"] == "identical_qk":
        k = q.clone()
    want = _packed_both(q, k, v, do, kv, "cpu")
    before = (tpacked.packed_geodesic_attention.launches,
              tpacked.packed_geodesic_attention_backward.launches)
    got = _packed_both(q, k, v, do, kv, cuda_device)
    torch.cuda.synchronize()
    assert (tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    _grad_check(got[1:], want[1:])
    if case["valid"] == "all_invalid":
        assert all(bool(torch.all(t[0] == 0)) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(24, 15, lambda r: dict(
    B=int(r.integers(1, 6)), H=int(r.choice([1, 2, 4, 8, 16])),
    L=int(r.integers(1, 33)), S=int(r.integers(1, 33)),
    Dh=int(r.choice([1, 3, 5, 8, 13, 16, 32])),
    valid=str(r.choice(["none", "random"])))))
def test_packed_kernels_randomized_sweep(cuda_device, case):
    """Random problem counts, head counts, L, S ∈ 1..32 and head dims (odd
    ones too, H·Dh ≤ 128), with and without a random key validity: forward
    and q, k, v gradients against the plain versions."""
    if case["H"] * case["Dh"] > 128:
        case = dict(case, H=128 // case["Dh"])
    rng = np.random.default_rng(case["L"] * 131 + case["S"] * 7 + case["Dh"])
    ins = _packed_inputs(rng, *(case[x] for x in ("B", "H", "L", "S", "Dh",
                                                  "valid")))
    want = _packed_both(*ins, "cpu")
    got = _packed_both(*ins, cuda_device)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    _grad_check(got[1:], want[1:])


@pytest.mark.cuda
def test_packed_kernel_refuses_wide_heads(cuda_device):
    q = torch.randn(1, 1, 4, 130, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpacked._launch(q, q, q, None)
    with pytest.raises(RuntimeError, match="CUDA error"):
        tpacked.packed_geodesic_attention_backward(q, q, q, None, q)


@pytest.mark.cuda
def test_auto_route_sends_small_problems_to_packed(cuda_device):
    """Reference-compat inference at 32 scenes × 11 agents and the NBA
    training step's forward and backward go through the packed kernels;
    the step equals the dense route's. Each gradient leaf is held at 1e-4 of
    its largest magnitude: a ReLU whose input lies within rounding of 0 can
    switch between the routes and move a decoder leaf discretely (on an
    H100, at K = 6 on this batch one leaf moved by 7.4e-4 of its largest
    value, on both kernel routes alike; at the recipe's K = 20 no ReLU
    switches)."""
    cfg = tm.STTODEConfig(past_length=5, future_length=10,
                          min_clip=0.0).validate()
    scenes = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                pred_len=10, seed=6)
    batch, _ = prepare_scene_group(
        np.stack([s["obs"] for s in scenes]),
        np.stack([s["pred"] for s in scenes]), np.ones((32, 11), np.float32),
        training=True, rng=np.random.default_rng(1))
    batch = batch.to(cuda_device)
    M = 32 * 11
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    noise = tm.TrainNoise(
        torch.rand(M, 5, 64, device=cuda_device, generator=gen) < 0.9,
        torch.rand(M, 10, 64, device=cuda_device, generator=gen) < 0.9,
        torch.randn(M, 32, device=cuda_device, generator=gen),
        torch.randn(M * 20, 32, device=cuda_device, generator=gen))
    params0 = tm.sttode_init(5, cfg)

    def run(c):
        p = to_device(params0, cuda_device)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
        out = tm.sttode_forward(p, c, batch, noise=noise)
        out.total_loss.backward()
        return out, [t.grad for t in leaves]

    counts = (tpacked.packed_geodesic_attention.launches,
              tpacked.packed_geodesic_attention_backward.launches,
              tmhgsa.fused_geodesic_attention.launches)
    got, g_got = run(cfg)
    torch.cuda.synchronize()
    assert (tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches,
            tmhgsa.fused_geodesic_attention.launches) == \
        (counts[0] + 2, counts[1] + 2, counts[2])
    want, g_want = run(cfg._replace(attn_impl="dense"))
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        np.testing.assert_allclose(float(getattr(got, name).detach()),
                                   float(getattr(want, name).detach()),
                                   rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for a, b in zip(g_got, g_want):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-4 * scale
    before = tpacked.packed_geodesic_attention.launches
    with torch.inference_mode():
        tm.sttode_inference(to_device(params0, cuda_device), cfg, batch)
    assert tpacked.packed_geodesic_attention.launches == before + 1


def _flash_inputs(rng, lead, L, S, Dh, valid):
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k, v, do = arr(*lead, L, Dh), arr(*lead, S, Dh), arr(*lead, S, Dh), \
        arr(*lead, L, Dh)
    kv = None
    if valid == "random":
        kv = torch.from_numpy((rng.random((*lead, S)) < 0.7)
                              .astype(np.float32))
    elif valid == "all_invalid":
        kv = torch.ones(*lead, S)
        kv.view(-1, S)[0] = 0.0
    elif valid == "zero_rows":
        q[..., 0, :] = 0.0                # the norm floor: q̂ = 0, ‖q‖ < 1e-12
        k[..., 3, :] = 0.0
    return q, k, v, do, kv


def _flash_both(q, k, v, do, kv, dev):
    """(out, dq, dk, dv) through the public wrapper and autograd; on a CUDA
    device the kernels, on the CPU the plain versions."""
    leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
    out = tmhgsa.flash_geodesic_attention(
        *leaves, kv_valid=None if kv is None else kv.to(dev))
    grads = torch.autograd.grad(out, leaves, do.to(dev))
    return [out.detach(), *grads]


def _flash_plain_on(dev, q, k, v, do, kv):
    """The plain versions, forward and both sweeps, run on ``dev`` (the
    large shapes are too slow for the host)."""
    *lead, L, Dh = q.shape
    S = k.shape[-2]
    B = int(np.prod(lead))
    q3, k3, v3, do3 = (t.to(dev).reshape(B, -1, Dh) for t in (q, k, v, do))
    val = None if kv is None else kv.to(dev).reshape(B, S)
    out, lse = tmhgsa.flash_geodesic_attention_reference(q3, k3, v3, val)
    grads = tmhgsa.flash_geodesic_attention_backward_reference(
        q3, k3, v3, val, do3, lse, (do3 * out).sum(-1))
    return [t.reshape(*lead, -1, Dh) for t in (out, *grads)]


def _flash_launches():
    return (tmhgsa.flash_geodesic_attention.launches,
            tmhgsa.flash_geodesic_attention_backward.launches_dq,
            tmhgsa.flash_geodesic_attention_backward.launches_dkv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(lead=(11, 8), L=2304, S=2304, Dh=8, valid="none"),   # B = 2304
    dict(lead=(8,), L=4096, S=4096, Dh=64, valid="none"),     # long context
    dict(lead=(1,), L=300, S=1100, Dh=5, valid="none"),       # ragged
    dict(lead=(4, 2), L=90, S=700, Dh=8, valid="all_invalid"),
    dict(lead=(11, 8), L=1152, S=1152, Dh=8, valid="random"),  # B = 1152
    dict(lead=(2,), L=12, S=12, Dh=8, valid="identical_qk"),
    # rows (keys) a thread owns without a partner, tiles of the other axis
    # cut short, the norm floor, head dims 8 to 128
    dict(lead=(3,), L=1, S=333, Dh=8, valid="none"),
    dict(lead=(2,), L=255, S=131, Dh=8, valid="random"),
    dict(lead=(2,), L=257, S=385, Dh=16, valid="zero_rows"),
    dict(lead=(2,), L=131, S=200, Dh=64, valid="zero_rows"),
    dict(lead=(1,), L=77, S=515, Dh=128, valid="random")])
def test_flash_kernels_match_plain(cuda_device, case):
    """Forward, dq and dk/dv kernels against the plain versions on the same
    device: at the NBA recipe's B = 2304 (88 problems of 2304² × 8, as the
    Q3 swap hands them over), the long-context 8 × 4096² × 64, a ragged
    shape, a validity with an all-invalid problem (exact zeros), the
    B = 1152 of the whole-S kernels' fault, q = k, L = 1 and odd L and S
    (a thread's row or key without a partner when it owns two), S not a
    multiple of the staged tile, and zero rows of q and k. A zero row's
    gradient is its dx̂ over the norm floor 1e-12, so those rows are held
    on their own scale, apart from the rest."""
    rng = np.random.default_rng(case["L"] + case["S"])
    q, k, v, do, kv = _flash_inputs(
        rng, *(case[x] for x in ("lead", "L", "S", "Dh")),
        "none" if case["valid"] == "identical_qk" else case["valid"])
    if case["valid"] == "identical_qk":
        k = q.clone()
    before = _flash_launches()
    got = _flash_both(q, k, v, do, kv, cuda_device)
    torch.cuda.synchronize()
    assert _flash_launches() == tuple(b + 1 for b in before)
    with torch.no_grad():
        want = _flash_plain_on(cuda_device, q, k, v, do, kv)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    got, want = [g.cpu() for g in got], [w.cpu() for w in want]
    if case["valid"] == "zero_rows":
        rows = [torch.arange(t.shape[-2]) for t in got[1:3]]
        zero = [rows[0] == 0, rows[1] == 3]
        _grad_check([t[..., z, :] for t, z in zip(got[1:3], zero)],
                    [t[..., z, :] for t, z in zip(want[1:3], zero)])
        _grad_check([t[..., ~z, :] for t, z in zip(got[1:3], zero)]
                    + got[3:], [t[..., ~z, :] for t, z in zip(want[1:3], zero)]
                    + want[3:])
    else:
        _grad_check(got[1:], want[1:])
    if case["valid"] == "all_invalid":
        first = [t.reshape(-1, *t.shape[-2:])[0] for t in got]
        assert all(bool(torch.all(t == 0)) for t in first)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(16, 17, lambda r: dict(
    B=int(r.integers(1, 6)), L=int(r.integers(1, 400)),
    S=int(r.integers(1, 700)),
    Dh=int(r.choice([1, 3, 5, 8, 13, 16, 32, 33, 64, 100, 128])),
    valid=str(r.choice(["none", "random"])))) + _sweep(8, 18, lambda r: dict(
        B=int(r.integers(1, 4)),
        L=int(r.choice([1, 2 * int(r.integers(0, 200)) + 1])),
        S=int(r.choice([1, 2 * int(r.integers(0, 350)) + 1])),
        Dh=int(r.choice([8, 16, 64, 128])),
        valid=str(r.choice(["none", "random"])))))
def test_flash_kernels_randomized_sweep(cuda_device, case):
    """Random problem counts, L, S (not multiples of the staged tiles; the
    last eight cases odd L and S, 1 among them, so that a thread's second
    row or key has no partner) and head dims up to 128, with and without a
    random key validity: forward and q, k, v gradients against the plain
    versions on the CPU."""
    rng = np.random.default_rng(case["L"] * 131 + case["S"] * 7 + case["Dh"])
    ins = _flash_inputs(rng, (case["B"],),
                        *(case[x] for x in ("L", "S", "Dh", "valid")))
    want = _flash_both(*ins, "cpu")
    got = _flash_both(*ins, cuda_device)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=1e-5)
    _grad_check(got[1:], want[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=3, L=301, S=517, Dh=8),       # L, S not multiples of the tiles
    dict(B=2, L=1, S=129, Dh=5),
    dict(B=2, L=257, S=131, Dh=16),
    dict(B=2, L=129, S=255, Dh=13),
    dict(B=2, L=131, S=97, Dh=32),
    dict(B=2, L=77, S=203, Dh=64),
    dict(B=1, L=63, S=129, Dh=100),
    dict(B=2, L=65, S=99, Dh=128)])
def test_flash_forward_lse_and_sweeps_from_it(cuda_device, case):
    """The flash forward (F) at odd L and S and head dims 5 to 128, with a
    key validity whose first problem has no valid key: out within 1e-5 of
    the plain forward and lse within 1e-6 × max(1, |lse|), row by row (the
    problem with no key: out exactly 0, lse = log(1e-30)); then the dq and
    dk/dv sweeps replayed from the kernel's lse against the plain sweeps
    from the plain lse, within 5e-5 × max(1, max |g|)."""
    B, L, S, Dh = (case[x] for x in ("B", "L", "S", "Dh"))
    rng = np.random.default_rng(L * 3 + S + Dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((B, n, Dh)).astype(
        np.float32)).to(cuda_device) for n in (L, S, S, L))
    val = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32)
                           ).to(cuda_device)
    val[0] = 0.0
    before = tmhgsa.flash_geodesic_attention.launches
    with torch.no_grad():
        out, lse = tmhgsa._launch_flash(q, k, v, val)
        want, wlse = tmhgsa.flash_geodesic_attention_reference(q, k, v, val)
        torch.cuda.synchronize()
    assert tmhgsa.flash_geodesic_attention.launches == before + 1
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-5)
    rel = (lse - wlse).abs() / wlse.abs().clamp(min=1.0)
    assert float(rel.max()) <= 1e-6
    assert bool(torch.all(out[0] == 0))
    np.testing.assert_allclose(lse[0].cpu().numpy(), np.log(1e-30), rtol=0,
                               atol=1e-5)
    with torch.no_grad():
        got = (tmhgsa._launch_flash_dq(q, k, v, val, do, lse,
                                       (do * out).sum(-1)),
               *tmhgsa._launch_flash_dkv(q, k, v, val, do, lse,
                                         (do * out).sum(-1)))
        plain = (wlse, (do * want).sum(-1))
        ref = (tmhgsa.flash_dq_reference(q, k, v, val, do, *plain),
               *tmhgsa.flash_dkv_reference(q, k, v, val, do, *plain))
        torch.cuda.synchronize()
    _grad_check([g.cpu() for g in got], [w.cpu() for w in ref])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=3, H=8, L=13, S=29, Dh=8, small=True),
    dict(B=3, H=8, L=32, S=32, Dh=16, small=True),
    dict(B=2, H=4, L=21, S=11, Dh=32, small=True),
    dict(B=2, H=1, L=1, S=1024, Dh=8, small=True),
    dict(B=2, H=2, L=9, S=31, Dh=64, small=False),    # the warp kernel
    dict(B=2, H=1, L=17, S=5, Dh=128, small=False),
    dict(B=2, H=4, L=1024, S=1, Dh=32, small=False)])  # beyond shared memory
def test_packed_backward_head_dim_branches(cuda_device, case):
    """Q at each head-dim branch (the small body at 8, 16, 32; the warp
    kernel above 32 and where the small body's staging passes shared
    memory), with a key validity whose first batch row has no valid key:
    dq, dk, dv against the plain backward within 5e-5 × max(1, max |g|),
    that batch row's gradients exactly 0."""
    B, H, L, S, Dh = (case[x] for x in ("B", "H", "L", "S", "Dh"))
    rng = np.random.default_rng(L * 5 + S + Dh)
    q, k, v, do, kv = _packed_inputs(rng, B, H, L, S, Dh, "random")
    kv[0] = 0.0
    assert tpacked.packed_bwd_small(L, S, Dh) is case["small"]
    args = [t.to(cuda_device) for t in (q, k, v, kv, do)]
    before = tpacked.packed_geodesic_attention_backward.launches
    with torch.no_grad():
        got = tpacked.packed_geodesic_attention_backward(*args)
        torch.cuda.synchronize()
    assert tpacked.packed_geodesic_attention_backward.launches == before + 1
    want = tpacked.packed_geodesic_attention_backward_reference(
        q, k, v, kv, do)
    got = [g.cpu() for g in got]
    _grad_check(got, want)
    assert all(bool(torch.all(g[0] == 0)) for g in got)


@pytest.mark.cuda
def test_flash_kernel_refuses_wide_heads(cuda_device):
    """A head dim of 130, which the flash forward refused before its wide
    mode, now runs and equals the plain forward (out and lse)."""
    q = torch.randn(1, 4, 130, device=cuda_device)
    got = tmhgsa._launch_flash(q, q, q, None)
    torch.cuda.synchronize()
    want = tmhgsa.flash_geodesic_attention_reference(q, q, q, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
def test_train_step_at_1152_scenes_runs_on_flash(cuda_device):
    """The scene-axis training forward and backward at B = 1152 scenes × 11
    agents, beyond the whole-S backward kernel's shared memory: on the
    kernel route it goes through the flash kernels (both trunks) and none of
    the whole-S ones, and equals the dense route with the same parameters,
    batch and noise (plain selection decode on both, as the CLI runs it):
    every loss term within 1e-4 × max(1, |loss|); every gradient leaf
    within 1e-4 in relative L2 and every element within 1e-3 of the leaf's
    largest magnitude. Per element, 1e-4 is too tight at this size: among
    25,344 decoder rows a ReLU whose input lies within rounding of 0 can
    switch between the routes and move a few elements of one leaf
    discretely (on an H100 at this batch, two elements of a bias moved by
    1.3e-4 of its largest value while the rest agreed to 1e-8; no winner of
    the best-of-K selection differed)."""
    B, N = 1152, 11
    cfg = tm.STTODEConfig(past_length=5, future_length=10, min_clip=0.0,
                          select_impl="xla").validate()
    scenes = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                pred_len=10, seed=9)
    batch, _ = prepare_scene_group(
        np.stack([s["obs"] for s in scenes]),
        np.stack([s["pred"] for s in scenes]), np.ones((B, N), np.float32),
        training=True, rng=np.random.default_rng(9))
    batch = batch.to(cuda_device)
    M = B * N
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    noise = tm.TrainNoise(
        torch.rand(M, 5, 64, device=cuda_device, generator=gen) >= 0.1,
        torch.rand(M, 10, 64, device=cuda_device, generator=gen) >= 0.1,
        torch.randn(M, 32, device=cuda_device, generator=gen),
        torch.randn(M * 20, 32, device=cuda_device, generator=gen))
    params0 = tm.sttode_init(9, cfg)

    def run(c):
        p = to_device(params0, cuda_device)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
        out = tm.sttode_forward(p, c, batch, noise=noise)
        out.total_loss.backward()
        return out, [t.grad for t in leaves]

    before = (*_flash_launches(), tmhgsa.fused_geodesic_attention.launches,
              tmhgsa.fused_geodesic_attention_backward.launches)
    got, g_got = run(cfg)
    torch.cuda.synchronize()
    after = (*_flash_launches(), tmhgsa.fused_geodesic_attention.launches,
             tmhgsa.fused_geodesic_attention_backward.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (2, 2, 2, 0, 0)
    want, g_want = run(cfg._replace(attn_impl="dense"))
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        a = float(getattr(got, name).detach())
        b = float(getattr(want, name).detach())
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (name, a, b)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert bool(torch.isfinite(a).all()), i
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-3 * scale, i
        assert float(torch.linalg.vector_norm(a - b)) <= \
            1e-4 * max(float(torch.linalg.vector_norm(b)), 1e-6), i


@pytest.fixture(scope="module")
def decoder():
    cfg = tm.STTODEConfig(past_length=5, future_length=10).validate()
    return cfg, tm.sttode_init(0, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["traj", "dist"])
@pytest.mark.parametrize("M,K", [(37, 5), (16, 1)])
def test_select_decode_kernel_matches_plain(cuda_device, decoder, mode, M, K):
    cfg, params = decoder
    rng = np.random.default_rng(M * K)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    past = arr(M, cfg.past_length, 2)
    ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
           tm.decode_block0_state(params, past), past.reshape(M, -1),
           arr(M, 2 * cfg.future_length)]
    want = tsd.select_decode(params, *ops, mode=mode)
    before = tsd.select_decode.launches
    got = tsd.select_decode(to_device(params, cuda_device),
                            *[o.to(cuda_device) for o in ops], mode=mode)
    torch.cuda.synchronize()
    assert tsd.select_decode.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    leaf = ops[0].to(cuda_device).requires_grad_()
    with pytest.raises(NotImplementedError, match="forward-only"):
        tsd.select_decode(to_device(params, cuda_device), leaf,
                          *[o.to(cuda_device) for o in ops[1:]], mode=mode)


@pytest.fixture(scope="module")
def decoders():
    """The full-width decoder at (T_p, T_f) = (5, 10) and (8, 12)."""
    out = {}
    for tp, tf in ((5, 10), (8, 12)):
        cfg = tm.STTODEConfig(past_length=tp, future_length=tf).validate()
        out[tp, tf] = (cfg, tm.sttode_init(tp * 10 + tf, cfg))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["dist", "traj"])
@pytest.mark.parametrize("horizon", [(5, 10), (8, 12)])
@pytest.mark.parametrize("K", [1, 3, 20])
@pytest.mark.parametrize("M", [1, 17, 353, 1409])
def test_select_decode_tensor_core_kernel_matches_plain(cuda_device, decoders,
                                                        dtype, mode, horizon,
                                                        K, M):
    """Kernel B on the tensor cores (3xTF32 for fp32, bf16 MMA) against its
    plain version on the card at full width: agent counts that are not
    multiples of the 32- or 64-row tiles (M·K from 1 to 28,180, so both
    tiles run), K = 1, 3, 20, both horizons, both modes. fp32 within 1e-4;
    bf16 within 1e-3 of the distance (or trajectory) scale; in mode "dist"
    a winner differs from the plain version's only where the plain
    version's two distances are within twice that."""
    cfg, params = decoders[horizon]
    tp, tf = horizon
    rng = np.random.default_rng(M * 31 + K * 7 + tp)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    p = to_device(params, cuda_device)
    past = arr(M, tp, 2)
    with torch.no_grad():
        ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
               tm.decode_block0_state(p, past), past.reshape(M, -1),
               arr(M, 2 * tf)]
        want = tsd.select_decode_reference(
            tsd.prep_select_weights(p, 2 * cfg.hidden_dim, cfg.zdim, tp, tf,
                                    dtype), *ops, mode=mode)
        before = tsd.select_decode.launches_by_dtype[dtype]
        got = tsd.select_decode(p, *ops, mode=mode, dtype=dtype)
        torch.cuda.synchronize()
    assert tsd.select_decode.launches_by_dtype[dtype] == before + 1
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    tol = 1e-4 if dtype == torch.float32 else \
        1e-3 * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol, (err, tol)
    if mode == "dist":
        rows = torch.arange(M, device=cuda_device)
        g_win, w_win = got.argmin(1), want.argmin(1)
        gap = (want[rows, g_win] - want[rows, w_win]).abs()
        assert bool(((g_win == w_win) | (gap <= 2 * tol)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(16, 11, lambda r: dict(
    lead=tuple(int(x) for x in r.integers(1, 4, size=int(r.integers(1, 3)))),
    L=int(r.choice([r.integers(1, 70), r.integers(1, 2049)])),
    S=int(r.choice([r.integers(1, 70), r.integers(1, 2049)])),
    Dh=int(r.choice([1, 3, 5, 8, 13, 32, 33, 64, 129, 256])),
    mask=str(r.choice(["none", "finite", "finfo_min"])))))
def test_attention_kernel_randomized_sweep(cuda_device, case):
    """Random shapes (odd head dims up to 256, L ≠ S up to 2048, one leading
    dim or two) and mask kinds against the plain version on the card: the
    whole-S forward in shared memory and, where the keys do not fit, in its
    key-streaming mode."""
    rng = np.random.default_rng(case["L"] * 131 + case["S"])
    lead, L, S, Dh = case["lead"], case["L"], case["S"], case["Dh"]
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(cuda_device)
    q, k, v = arr(*lead, L, Dh), arr(*lead, S, Dh), arr(*lead, S, Dh)
    mask = None
    if case["mask"] == "finite":
        mask = 20 * arr(*lead, L, S)
    elif case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((*lead, 1, S)))
                           .to(cuda_device) < 0.4,
                           torch.finfo(torch.float32).min, 0.0)
    got = tmhgsa.fused_geodesic_attention(q, k, v, mask=mask)
    torch.cuda.synchronize()
    B = int(np.prod(lead))
    m3 = None if mask is None else tmhgsa._canonicalize_mask(
        torch.broadcast_to(mask, (*lead, L, S)).reshape(B, L, S))
    with torch.no_grad():
        want = tmhgsa.fused_geodesic_attention_reference(
            q.reshape(B, L, Dh), k.reshape(B, S, Dh), v.reshape(B, S, Dh),
            m3).reshape(*lead, L, Dh)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(8, 12, lambda r: dict(
    hidden=int(r.choice([2, 6, 10, 64])), zdim=int(r.choice([1, 3, 8, 32])),
    t_past=int(r.integers(1, 10)), t_fut=int(r.integers(1, 14)),
    M=int(r.integers(1, 70)), K=int(r.integers(1, 7)))))
@pytest.mark.parametrize("mode", ["traj", "dist"])
def test_select_decode_kernel_randomized_sweep(cuda_device, case, mode):
    """Random decoder widths (pf and z widths not multiples of 4), horizons,
    agent counts (not multiples of the 16-row tile) and sample counts."""
    cfg = tm.STTODEConfig(hidden_dim=case["hidden"], num_heads=1,
                          zdim=case["zdim"], past_length=case["t_past"],
                          future_length=case["t_fut"])
    params = tm.sttode_init(case["M"], cfg)
    M, K = case["M"], case["K"]
    rng = np.random.default_rng(M * 7 + K)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    past = arr(M, cfg.past_length, 2)
    ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
           tm.decode_block0_state(params, past), past.reshape(M, -1),
           arr(M, 2 * cfg.future_length)]
    want = tsd.select_decode(params, *ops, mode=mode)
    got = tsd.select_decode(to_device(params, cuda_device),
                            *[o.to(cuda_device) for o in ops], mode=mode)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(8, 14, lambda r: dict(
    hidden=int(r.choice([2, 6, 10, 64])), zdim=int(r.choice([1, 3, 8, 32])),
    t_past=int(r.integers(1, 10)), t_fut=int(r.integers(1, 14)),
    M=int(r.integers(1, 300)), K=int(r.integers(1, 21)))))
def test_select_decode_bf16_kernel_randomized_sweep(cuda_device, case):
    """The bf16 storage variant over random widths, horizons, agent and
    sample counts, mode "dist": distances within 1e-3 of the distance
    scale, and a different winner only where the plain version's two
    candidates are that close."""
    cfg = tm.STTODEConfig(hidden_dim=case["hidden"], num_heads=1,
                          zdim=case["zdim"], past_length=case["t_past"],
                          future_length=case["t_fut"])
    params = tm.sttode_init(case["M"] + 1, cfg)
    M, K = case["M"], case["K"]
    rng = np.random.default_rng(M * 5 + K)
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    past = arr(M, cfg.past_length, 2)
    ops = [arr(M, 2 * cfg.hidden_dim), arr(K, M, cfg.zdim),
           tm.decode_block0_state(params, past), past.reshape(M, -1),
           arr(M, 2 * cfg.future_length)]
    want = tsd.select_decode(params, *ops, dtype=torch.bfloat16)
    before = tsd.select_decode.launches_by_dtype[torch.bfloat16]
    got = tsd.select_decode(to_device(params, cuda_device),
                            *[o.to(cuda_device) for o in ops],
                            dtype=torch.bfloat16).cpu()
    torch.cuda.synchronize()
    assert tsd.select_decode.launches_by_dtype[torch.bfloat16] == before + 1
    scale = max(1.0, float(want.abs().max()))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-3 * scale)
    rows = torch.arange(M)
    g_win, w_win = got.argmin(1), want.argmin(1)
    gap = (want[rows, g_win] - want[rows, w_win]).abs()
    assert bool(((g_win == w_win) | (gap <= 2e-3 * scale)).all())


@pytest.mark.cuda
def test_train_step_kernel_route_matches_plain_route(cuda_device):
    """One fp32 training forward and backward on the kernel route (attention
    forward and backward kernels — the packed ones at 16 scenes × 6 agents —
    and the selection kernel) against the plain route with the same
    parameters, batch and injected noise; then a few bf16 recipe steps on
    the kernel route stay finite."""
    cfg = tm.STTODEConfig(past_length=5, future_length=10, sample_k=6,
                          min_clip=0.0).validate()
    scenes = make_social_scenes(16, agents_range=(6, 6), obs_len=5,
                                pred_len=10, seed=3)
    obs = np.stack([s["obs"] for s in scenes])
    pred = np.stack([s["pred"] for s in scenes])
    batch, _ = prepare_scene_group(obs, pred, np.ones((16, 6), np.float32),
                                   training=True,
                                   rng=np.random.default_rng(0))
    batch = batch.to(cuda_device)
    M = 16 * 6
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    noise = tm.TrainNoise(
        torch.rand(M, 5, 64, device=cuda_device, generator=gen) < 0.9,
        torch.rand(M, 10, 64, device=cuda_device, generator=gen) < 0.9,
        torch.randn(M, 32, device=cuda_device, generator=gen),
        torch.randn(M * 6, 32, device=cuda_device, generator=gen))
    params0 = tm.sttode_init(4, cfg)

    def run(c):
        p = to_device(params0, cuda_device)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
        out = tm.sttode_forward(p, c, batch, noise=noise)
        out.total_loss.backward()
        return out, [t.grad for t in leaves]

    counts = (tpacked.packed_geodesic_attention_backward.launches,
              tsd.select_decode.launches)
    got, g_got = run(cfg)
    want, g_want = run(cfg._replace(attn_impl="dense", select_impl="xla"))
    torch.cuda.synchronize()
    assert tpacked.packed_geodesic_attention_backward.launches > counts[0]
    assert tsd.select_decode.launches == counts[1] + 1
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        np.testing.assert_allclose(float(getattr(got, name)),
                                   float(getattr(want, name)), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for a, b in zip(g_got, g_want):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-4 * scale

    rcfg = cfg._replace(select_dtype="bfloat16", decode_dtype="bfloat16")
    step = make_train_step(rcfg, 1e-4, device=cuda_device)
    params, opt_state = step.init(params0)
    for _ in range(3):
        params, opt_state, metrics = step(params, opt_state, batch, gen)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["agent", "reference"])
def test_inference_kernel_route_matches_plain_route(cuda_device, kind):
    if kind == "agent":
        cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent", sample_k=6)
        n_agents = (3, 8)
    else:
        cfg = tm.STTODEConfig(past_length=5, future_length=10, sample_k=6)
        n_agents = (6, 6)
    cfg = cfg.validate()
    params = to_device(tm.sttode_init(1, cfg), cuda_device)
    scenes = make_social_scenes(5, agents_range=n_agents,
                                obs_len=cfg.past_length,
                                pred_len=cfg.future_length, seed=2)
    N = max(len(s["obs"]) for s in scenes)
    obs = np.zeros((5, N, cfg.past_length, 2), np.float32)
    valid = np.zeros((5, N), np.float32)
    for j, s in enumerate(scenes):
        obs[j, :len(s["obs"])] = s["obs"]
        valid[j, :len(s["obs"])] = 1.0
    batch, _ = prepare_scene_group(
        obs, np.zeros((5, N, cfg.future_length, 2), np.float32), valid,
        training=False)
    batch = batch.to(cuda_device)
    z = torch.randn(5 * N * cfg.sample_k, cfg.zdim, device=cuda_device)
    # the agent axis carries a key mask (the whole-S kernel); reference
    # compat's 5 scenes × 6 agents are small problems (the packed kernel)
    attn = tmhgsa.fused_geodesic_attention if kind == "agent" else \
        tpacked.packed_geodesic_attention
    counts = (attn.launches, tsd.select_decode.launches)
    with torch.inference_mode():
        got = tm.sttode_inference(params, cfg, batch, z=z)
        plain_cfg = cfg._replace(attn_impl="dense", select_impl="xla")
        want = tm.sttode_inference(params, plain_cfg, batch, z=z)
    torch.cuda.synchronize()
    assert attn.launches > counts[0]
    assert tsd.select_decode.launches == counts[1] + 1
    assert got.shape == (cfg.sample_k, 5 * N, cfg.future_length, 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_predictor_on_card_is_deterministic(cuda_device):
    """The card's Predictor answers every scene with finite samples of the
    right shape, and the same (seed, scenes) gives the same samples."""
    cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent", sample_k=4)
    params = tm.sttode_init(3, cfg)
    scenes = [s["obs"] for s in make_social_scenes(6, agents_range=(2, 9),
                                                   seed=5)]
    pred = Predictor(params, cfg, device=cuda_device, max_group=4)
    out = pred.predict_many(scenes, seed=7)
    again = pred.predict_many(scenes, seed=7)
    for a, b, s in zip(out, again, scenes):
        assert a.shape == (4, len(s), cfg.future_length, 2)
        assert np.isfinite(a).all()
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# the poincaré metric (ball points; tolerances as for the oblique kernels)     #
# --------------------------------------------------------------------------- #

def _ball_inputs(rng, lead, L, S, Dh, c, scale=0.5):
    """q, k as ball points (the map the attention layer applies before the
    kernels, to rows of norm ~scale/√c: mid-ball, since near the edge
    artanh amplifies the fp32 Gram's summation-order differences), v and
    the output cotangent."""
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    q, k = (to_ball(scale / (c * Dh) ** 0.5 * arr(*lead, n, Dh), c)
            for n in (L, S))
    return q, k, arr(*lead, S, Dh), arr(*lead, L, Dh)


def _poincare_launches():
    f = tmhgsa.flash_geodesic_attention_backward
    return (tmhgsa.fused_geodesic_attention.launches_by_metric["poincare"],
            tmhgsa.fused_geodesic_attention_backward.launches_by_metric[
                "poincare"],
            tmhgsa.flash_geodesic_attention.launches_by_metric["poincare"],
            f.launches_dq_by_metric["poincare"],
            f.launches_dkv_by_metric["poincare"])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    dict(B=88, L=32, S=32, c=1.0, mask="none"),     # NBA training, B = 32
    dict(B=88, L=128, S=128, c=1.0, mask="none"),   # NBA evaluation
    dict(B=512, L=8, S=8, c=1.0, mask="finfo_min"),  # agent-axis serving
    dict(B=3, L=5, S=9, c=0.7, mask="all_excluded"),
    dict(B=2, L=40, S=70, c=2.0, mask="finite"),
    dict(B=2, L=6, S=6, c=1.0, mask="identical_qk")])
def test_poincare_whole_s_kernels_match_plain(cuda_device, case):
    """The poincaré forward and backward kernels (csrc/mhgsa_fwd.cu,
    csrc/mhgsa_bwd.cu) against their plain versions on the same inputs:
    forward 1e-5, gradients and dmask 5e-5 × max(1, max |g|); an
    all-excluded row outputs 0 and gets zero gradients; q = k is held to
    finiteness only: its diagonal x2 − 2g + y2 cancels to rounding noise,
    which the 1e-15 guard keeps finite and √ turns into ~1e-4 distances
    that differ between any two summation orders."""
    rng = np.random.default_rng(case["B"] * 7 + case["S"])
    B, L, S, c = case["B"], case["L"], case["S"], case["c"]
    q, k, v, do = _ball_inputs(rng, (B,), L, S, 8, c)
    mask = None
    if case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((B, 1, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0) \
            .expand(B, L, S)
    elif case["mask"] == "all_excluded":
        mask = 2.0 * torch.from_numpy(
            rng.standard_normal((B, L, S)).astype(np.float32))
        mask[:, 0] = torch.finfo(torch.float32).min
    elif case["mask"] == "finite":
        mask = 3.0 * torch.from_numpy(
            rng.standard_normal((B, L, S)).astype(np.float32))
    elif case["mask"] == "identical_qk":
        k = q.clone()
    m3 = None if mask is None else tmhgsa._canonicalize_mask(mask)
    kw = dict(metric="poincare", curvature=c)
    want = tmhgsa.fused_geodesic_attention_reference(q, k, v, m3, **kw)
    want_b = tmhgsa.fused_geodesic_attention_backward(q, k, v, m3, do,
                                                      need_dmask=True, **kw)
    before = _poincare_launches()
    dev = [t.to(cuda_device) for t in (q, k, v)]
    md = None if m3 is None else m3.to(cuda_device)
    got = tmhgsa._forward(*dev, md, "poincare", c)
    got_b = tmhgsa.fused_geodesic_attention_backward(
        *dev, md, do.to(cuda_device), need_dmask=True, **kw)
    torch.cuda.synchronize()
    assert _poincare_launches() == (before[0] + 1, before[1] + 1,
                                    *before[2:])
    assert torch.isfinite(got).all()
    assert all(bool(torch.isfinite(g).all()) for g in got_b if g is not None)
    if case["mask"] == "identical_qk":
        return   # a diagonal distance is fp32 cancellation noise: finite only
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    _grad_check([None if g is None else g.cpu() for g in got_b], want_b)
    if case["mask"] == "all_excluded":
        assert torch.all(got[:, 0] == 0)
        assert torch.all(got_b[0][:, 0] == 0) and torch.all(got_b[3][:, 0] == 0)


def _grid(x, c):
    """x truncated to a grid of 2^-b with 2^2b/c < 2²⁴, on which the Gram,
    the squared norms and x2 − 2g + y2 of ball rows are exact in fp32 in
    any summation order (tests/test_torch_poincare_sweep.py)."""
    s = 2.0 ** np.floor(12 + np.log2(c) / 2)
    return torch.trunc(x * s) / s


def _edge_inputs(rng, lead, L, S, Dh, c):
    """Ball rows at the edge, q in one cone and k in the opposite one, so
    that every pair's zc clamps at 1 − 1e-5; v and do standard normal."""
    arr = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    axis = torch.zeros(Dh)
    axis[0] = 1.0
    q, k = (_grid(to_ball(40.0 * (sign * axis + 0.2 / Dh ** 0.5
                                  * arr(*lead, n, Dh)), c), c)
            for sign, n in ((1.0, L), (-1.0, S)))
    return q, k, arr(*lead, S, Dh), arr(*lead, L, Dh)


_POINCARE_FLASH_CASES = [
    dict(lead=(88,), L=2304, S=2304, Dh=8, c=1.0, valid="none"),  # B = 2304
    dict(lead=(8,), L=4096, S=4096, Dh=64, c=1.0, valid="none"),
    dict(lead=(1,), L=300, S=1100, Dh=5, c=0.7, valid="none"),    # ragged
    dict(lead=(4, 2), L=90, S=700, Dh=8, c=2.0, valid="all_invalid"),
    dict(lead=(2,), L=12, S=12, Dh=8, c=1.0, valid="identical_qk")] + [
    # ragged row and key counts around the sweeps' 128 and 256 rows per
    # block, head dims 8, 16, 64, the c = 1 form and the general one
    dict(lead=(3,), L=L, S=S, Dh=Dh, c=c,
         valid="random" if L == 129 else "none")
    for L, S in ((1, 257), (127, 129), (129, 127), (257, 1))
    for Dh in (8, 16, 64) for c in (1.0, 0.7, 0.05)] + [
    # rows at the ball's edge (every zc clamped) and close pairs
    # (k = q + 1e-4·noise)
    dict(lead=(3,), L=129, S=257 if valid == "edge" else 129, Dh=Dh, c=c,
         valid=valid)
    for valid in ("edge", "close") for Dh in (8, 16, 64)
    for c in (1.0, 0.7, 0.05)] + [
    # the forward's register kernel at head dim 128, odd L (a thread's
    # second row without a partner at Dh ≤ 16) and ragged validity
    dict(lead=(3,), L=L, S=S, Dh=Dh, c=c,
         valid="random" if L == 255 else "none")
    for L, S in ((1, 257), (255, 300), (129, 127)) for Dh in (8, 16, 128)
    for c in (1.0, 0.7, 0.05) if Dh == 128 or L == 255] + [
    dict(lead=(3,), L=129, S=257 if valid == "edge" else 129, Dh=128, c=c,
         valid=valid)
    for valid in ("edge", "close") for c in (1.0, 0.7)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _POINCARE_FLASH_CASES)
def test_poincare_flash_kernels_match_plain(cuda_device, case):
    """The poincaré flash forward, dq and dk/dv kernels against the plain
    versions on the same device: forward 1e-5, gradients 5e-5 ×
    max(1, max |g|); a problem with no valid key gets exact zeros; q = k is
    held to finiteness only (as in the whole-S test). At the ball's edge
    and for close pairs (rows on an exact-Gram grid) dq and dk are held to
    finiteness only too, and the forward and dv to the tolerances: there
    the plain formulas' own dq and dk move by more than the tolerance when
    one fp32 rounding moves (tests/test_torch_poincare_sweep.py)."""
    rng = np.random.default_rng(case["L"] + case["S"] + case["Dh"])
    lead, L, S, Dh, c = (case[x] for x in ("lead", "L", "S", "Dh", "c"))
    if case["valid"] == "edge":
        q, k, v, do = _edge_inputs(rng, lead, L, S, Dh, c)
    else:
        q, k, v, do = _ball_inputs(rng, lead, L, S, Dh, c)
    kv = None
    if case["valid"] == "all_invalid":
        kv = torch.from_numpy((rng.random((*lead, S)) < 0.7)
                              .astype(np.float32))
        kv.view(-1, S)[0] = 0.0
    elif case["valid"] == "random":
        kv = torch.from_numpy((rng.random((*lead, S)) < 0.7)
                              .astype(np.float32))
    elif case["valid"] == "identical_qk":
        k = q.clone()
    elif case["valid"] == "close":
        q = _grid(q, c)
        k = _grid(q + 1e-4 * torch.from_numpy(
            rng.standard_normal(q.shape).astype(np.float32)), c)
    before = _poincare_launches()
    leaves = [t.to(cuda_device).requires_grad_() for t in (q, k, v)]
    out = tmhgsa.flash_geodesic_attention(
        *leaves, kv_valid=None if kv is None else kv.to(cuda_device),
        metric="poincare", curvature=c)
    got = [out.detach(), *torch.autograd.grad(out, leaves, do.to(cuda_device))]
    torch.cuda.synchronize()
    assert _poincare_launches() == (*before[:2],
                                    *(b + 1 for b in before[2:]))
    B = int(np.prod(lead))
    with torch.no_grad():
        q3, k3, v3, do3 = (t.to(cuda_device).reshape(B, -1, Dh)
                           for t in (q, k, v, do))
        val = None if kv is None else kv.to(cuda_device).reshape(B, S)
        w_out, lse = tmhgsa.flash_geodesic_attention_reference(
            q3, k3, v3, val, "poincare", c)
        want = [w_out, *tmhgsa.flash_geodesic_attention_backward_reference(
            q3, k3, v3, val, do3, lse, (do3 * w_out).sum(-1), "poincare", c)]
    got = [t.reshape(B, -1, Dh).cpu() for t in got]
    want = [t.cpu() for t in want]
    assert all(bool(torch.isfinite(t).all()) for t in got)
    if case["valid"] == "identical_qk":
        return   # a diagonal distance is fp32 cancellation noise: finite only
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5)
    if case["valid"] in ("edge", "close"):
        _grad_check([None, None, got[3]], [None, None, want[3]])
        return
    _grad_check(got[1:], want[1:])
    if case["valid"] == "all_invalid":
        assert all(bool(torch.all(t[0] == 0)) for t in got)
        with torch.no_grad():
            _, lse_k = tmhgsa._flash_forward(q3, k3, v3, val, "poincare", c)
        assert float((lse_k[0] - np.log(1e-30)).abs().max()) <= 1e-5
        np.testing.assert_allclose(lse_k.cpu().numpy(), lse.cpu().numpy(),
                                   rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", _sweep(12, 19, lambda r: dict(
    B=int(r.integers(1, 5)), L=int(r.integers(1, 300)),
    S=int(r.integers(1, 300)), Dh=int(r.choice([1, 3, 8, 16, 33, 64])),
    c=float(r.choice([0.05, 0.7, 1.0, 2.0])),
    kind=str(r.choice(["fused", "flash"])))))
def test_poincare_kernels_randomized_sweep(cuda_device, case):
    """Random shapes, head dims and curvatures down to near the maxless
    bound, through the public wrappers and autograd (the whole-S kernels
    with a finite mask, the flash kernels with a random key validity),
    against the plain versions on the CPU."""
    rng = np.random.default_rng(case["L"] * 131 + case["S"] * 7 + case["Dh"])
    B, L, S, Dh, c = (case[x] for x in ("B", "L", "S", "Dh", "c"))
    q, k, v, do = _ball_inputs(rng, (B,), L, S, Dh, c)
    mask = torch.from_numpy(rng.standard_normal((B, L, S)).astype(np.float32))
    kv = torch.from_numpy((rng.random((B, S)) < 0.7).astype(np.float32))

    def run(dev):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        if case["kind"] == "fused":
            out = tmhgsa.fused_geodesic_attention(
                *leaves, mask=mask.to(dev), metric="poincare", curvature=c)
        else:
            out = tmhgsa.flash_geodesic_attention(
                *leaves, kv_valid=kv.to(dev), metric="poincare", curvature=c)
        return [out.detach().cpu(),
                *(g.cpu() for g in torch.autograd.grad(out, leaves,
                                                       do.to(dev)))]

    want = run("cpu")
    got = run(cuda_device)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5)
    _grad_check(got[1:], want[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_masked_backward_beyond_shared_memory(cuda_device, metric):
    """A masked 8 × 1500² × 8 problem, whose whole-S backward staging
    (224·S + 256 bytes) passes the block's shared memory: the backward
    kernel stages it in a device workspace and equals its plain version
    (gradients and dmask 5e-5 × max(1, max |g|)), with exact zeros for an
    all-excluded row. Before the workspace mode the kernel refused it."""
    rng = np.random.default_rng(15)
    B, L, c = 8, 1500, 1.0
    _, staged = tmhgsa.whole_s_smem_bytes(L, L, 8, metric)
    assert staged > tmhgsa.SMEM_OPTIN_BYTES
    if metric == "poincare":
        q, k, v, do = _ball_inputs(rng, (B,), L, L, 8, c)
    else:
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, L, 8))
                                        .astype(np.float32))
                       for _ in range(4))
    mask = torch.where(torch.from_numpy(rng.random((B, L, L))) < 0.2,
                       torch.finfo(torch.float32).min,
                       torch.from_numpy(rng.standard_normal((B, L, L))
                                        .astype(np.float32)))
    mask[:, 0] = torch.finfo(torch.float32).min
    m3 = tmhgsa._canonicalize_mask(mask).to(cuda_device)
    dev = [t.to(cuda_device) for t in (q, k, v, do)]
    kw = dict(metric=metric, curvature=c)
    before = tmhgsa.fused_geodesic_attention_backward.launches_by_metric[
        metric]
    got = tmhgsa.fused_geodesic_attention_backward(*dev[:3], m3, dev[3],
                                                   need_dmask=True, **kw)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention_backward.launches_by_metric[
        metric] == before + 1
    with torch.no_grad():
        want = tmhgsa.fused_geodesic_attention_backward_reference(
            *dev[:3], m3, dev[3], True, metric, c)
    _grad_check([g.cpu() for g in got], [w.cpu() for w in want])
    assert torch.all(got[0][:, 0] == 0) and torch.all(got[3][:, 0] == 0)


def _masked_problem(rng, B, S, Dh, metric, c=1.0):
    """q, k, v, do of B problems of S × S × Dh (ball points for poincaré)
    and a canonicalized mask: a fifth of the entries excluded, the rest
    finite, row 0 of every problem all excluded."""
    if metric == "poincare":
        q, k, v, do = _ball_inputs(rng, (B,), S, S, Dh, c)
    else:
        q, k, v, do = (torch.from_numpy(rng.standard_normal((B, S, Dh))
                                        .astype(np.float32))
                       for _ in range(4))
    mask = torch.where(torch.from_numpy(rng.random((B, S, S))) < 0.2,
                       torch.finfo(torch.float32).min,
                       torch.from_numpy(rng.standard_normal((B, S, S))
                                        .astype(np.float32)))
    mask[:, 0] = torch.finfo(torch.float32).min
    return q, k, v, do, tmhgsa._canonicalize_mask(mask)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
@pytest.mark.parametrize("S", [436, 841, 1569, 2048])
@pytest.mark.parametrize("Dh", [16, 64, 256])
def test_masked_forward_beyond_shared_memory(cuda_device, S, Dh, metric):
    """The masked whole-S forward at 8 × S² × Dh, the route's masked range
    (S ≤ 2048) at head dims whose keys and values pass the block's shared
    memory (all but 436 at Dh = 16), where the kernel refused to run before
    its key-streaming mode: equal to the plain forward within 1e-5, and an
    all-excluded row outputs exactly 0, as in the plain version."""
    rng = np.random.default_rng(S * 3 + Dh)
    c = 1.0
    q, k, v, _, m3 = (t.to(cuda_device)
                      for t in _masked_problem(rng, 8, S, Dh, metric, c))
    before = tmhgsa.fused_geodesic_attention.launches_by_metric[metric]
    got = tmhgsa.fused_geodesic_attention(q, k, v, mask=m3, metric=metric,
                                          curvature=c)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention.launches_by_metric[metric] == \
        before + 1
    with torch.no_grad():
        want = tmhgsa.fused_geodesic_attention_reference(q, k, v, m3, metric,
                                                         c)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=0, atol=1e-5)
    assert torch.all(got[:, 0] == 0) and torch.all(want[:, 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
@pytest.mark.parametrize("Dh", [129, 192, 256])
def test_flash_kernels_wide_heads(cuda_device, Dh, metric):
    """The flash forward, dq and dk/dv sweeps at head dims above 128, which
    they refused before their wide modes, through the public wrapper and
    autograd, against the plain versions on the same device: a ragged
    L = 300, S = 700 with a random key validity and one problem with no
    valid key (exact zeros); forward 1e-5, gradients 5e-5 × max(1, max
    |g|)."""
    rng = np.random.default_rng(Dh)
    lead, L, S, c = (3,), 300, 700, 1.0
    if metric == "poincare":
        q, k, v, do = _ball_inputs(rng, lead, L, S, Dh, c)
    else:
        q, k, v, do, _ = _flash_inputs(rng, lead, L, S, Dh, "none")
    kv = torch.from_numpy((rng.random((*lead, S)) < 0.7).astype(np.float32))
    kv[0] = 0.0
    before = _flash_launches()
    leaves = [t.to(cuda_device).requires_grad_() for t in (q, k, v)]
    out = tmhgsa.flash_geodesic_attention(
        *leaves, kv_valid=kv.to(cuda_device), metric=metric, curvature=c)
    got = [out.detach(), *torch.autograd.grad(out, leaves, do.to(cuda_device))]
    torch.cuda.synchronize()
    assert _flash_launches() == tuple(b + 1 for b in before)
    with torch.no_grad():
        q3, k3, v3, do3 = (t.to(cuda_device) for t in (q, k, v, do))
        val = kv.to(cuda_device)
        w_out, lse = tmhgsa.flash_geodesic_attention_reference(
            q3, k3, v3, val, metric, c)
        want = [w_out, *tmhgsa.flash_geodesic_attention_backward_reference(
            q3, k3, v3, val, do3, lse, (do3 * w_out).sum(-1), metric, c)]
    got, want = [t.cpu() for t in got], [t.cpu() for t in want]
    assert all(bool(torch.isfinite(t).all()) for t in got)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=0,
                               atol=1e-5)
    _grad_check(got[1:], want[1:])
    assert all(bool(torch.all(t[0] == 0)) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["oblique", "poincare"])
def test_masked_backward_wide_heads(cuda_device, metric):
    """The masked whole-S backward at 8 × 512² × 256, beyond shared memory
    (its device-workspace mode): equal to its plain version (gradients and
    dmask 5e-5 × max(1, max |g|)), exact zeros for an all-excluded row."""
    rng = np.random.default_rng(256)
    c = 1.0
    q, k, v, do, m3 = (t.to(cuda_device)
                       for t in _masked_problem(rng, 8, 512, 256, metric, c))
    assert tmhgsa.whole_s_smem_bytes(512, 512, 256, metric)[1] > \
        tmhgsa.SMEM_OPTIN_BYTES
    kw = dict(metric=metric, curvature=c)
    got = tmhgsa.fused_geodesic_attention_backward(q, k, v, m3, do,
                                                   need_dmask=True, **kw)
    torch.cuda.synchronize()
    with torch.no_grad():
        want = tmhgsa.fused_geodesic_attention_backward_reference(
            q, k, v, m3, do, True, metric, c)
    _grad_check([g.cpu() for g in got], [w.cpu() for w in want])
    assert torch.all(got[0][:, 0] == 0) and torch.all(got[3][:, 0] == 0)


@pytest.mark.cuda
def test_poincare_train_step_kernel_route_matches_dense(cuda_device):
    """The NBA recipe's scene-axis step (32 scenes × 11 agents, reference
    compat) with the poincaré metric: the forward and backward go through
    the poincaré whole-S kernels (never the packed ones) and equal the dense
    route with the same parameters, batch and noise: every loss term within
    1e-4 × max(1, |loss|), every gradient leaf within 1e-4 of its largest
    magnitude. The data are seed 9 of scripts/torch_route_agreement.py: on
    some batches a decoder ReLU whose input lies within rounding of 0
    switches between the routes and moves a row of one leaf discretely (on
    an H100, at B = 32 one of 11 seeds on the oblique routes, 9.7e-4 of a
    leaf's largest value; none of 7 seeds on the poincaré ones, where the
    routes agree within 1e-5)."""
    cfg = tm.STTODEConfig(past_length=5, future_length=10, min_clip=0.0,
                          attn_metric="poincare", select_impl="xla").validate()
    scenes = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                pred_len=10, seed=9)
    batch, _ = prepare_scene_group(
        np.stack([s["obs"] for s in scenes]),
        np.stack([s["pred"] for s in scenes]), np.ones((32, 11), np.float32),
        training=True, rng=np.random.default_rng(9))
    batch = batch.to(cuda_device)
    M = 32 * 11
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    noise = tm.TrainNoise(
        torch.rand(M, 5, 64, device=cuda_device, generator=gen) >= 0.1,
        torch.rand(M, 10, 64, device=cuda_device, generator=gen) >= 0.1,
        torch.randn(M, 32, device=cuda_device, generator=gen),
        torch.randn(M * 20, 32, device=cuda_device, generator=gen))
    params0 = tm.sttode_init(9, cfg)

    def run(c):
        p = to_device(params0, cuda_device)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(p)]
        out = tm.sttode_forward(p, c, batch, noise=noise)
        out.total_loss.backward()
        return out, [t.grad for t in leaves]

    before = (_poincare_launches(), tpacked.packed_geodesic_attention.launches)
    got, g_got = run(cfg)
    torch.cuda.synchronize()
    after = (_poincare_launches(), tpacked.packed_geodesic_attention.launches)
    assert tuple(a - b for a, b in zip(after[0], before[0])) == \
        (2, 2, 0, 0, 0)
    assert after[1] == before[1]
    want, g_want = run(cfg._replace(attn_impl="dense"))
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        a = float(getattr(got, name).detach())
        b = float(getattr(want, name).detach())
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (name, a, b)
    for i, (a, b) in enumerate(zip(g_got, g_want)):
        assert bool(torch.isfinite(a).all()), i
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a - b).abs().max()) <= 1e-4 * scale, i


_SMALL_LS = (1, 7, 31, 32, 33)
_SMALL_DH = (1, 8, 16, 64, 128)
# the packed route's L·S ≤ 32² extremes and the grid of L, S ∈ _SMALL_LS,
# the head dims cycling through _SMALL_DH (H·Dh ≤ 128)
_PACKED_SMALL_CASES = [
    dict(L=L, S=S, Dh=_SMALL_DH[n % 5],
         valid=("random", "all_invalid", "none")[n % 3])
    for n, (L, S) in enumerate([(L, S) for L in _SMALL_LS for S in _SMALL_LS]
                               + [(8, 128), (128, 8), (1024, 1), (1, 1024)])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _PACKED_SMALL_CASES)
def test_packed_forward_small_shapes(cuda_device, case):
    """Kernel P (the small-shape body: rows × key slices, the SFU epilogue)
    at L, S ∈ {1, 7, 31, 32, 33}, the route's L·S ≤ 32² extremes and head
    dims 1..128, with a random key validity or a problem with none: the
    forward within 1e-5 of its plain version, that problem exactly 0."""
    L, S, Dh = case["L"], case["S"], case["Dh"]
    H = max(1, min(4, 128 // Dh))
    rng = np.random.default_rng(L * 131 + S * 7 + Dh)
    q, k, v, _, kv = _packed_inputs(rng, 3, H, L, S, Dh, case["valid"])
    want = tpacked.packed_geodesic_attention_reference(q, k, v, kv)
    before = tpacked.packed_geodesic_attention.launches
    with torch.inference_mode():
        got = tpacked.packed_geodesic_attention(
            q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
            kv_valid=None if kv is None else kv.to(cuda_device))
    torch.cuda.synchronize()
    assert tpacked.packed_geodesic_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    if case["valid"] == "all_invalid":
        assert bool(torch.all(got[0] == 0))


# the whole-S forward's small-S mode: L, S ∈ _SMALL_LS in both metrics (c = 1
# takes the epilogue's c = 1 form, 0.7 the general one), with and without an
# additive mask holding an all-excluded row; then S on either side of the
# mode's range (kernels.mhgsa.small_s_mode)
_FUSED_SMALL_CASES = [
    dict(L=L, S=S, Dh=_SMALL_DH[n % 5] if Dh is None else Dh, metric=metric,
         c=c, mask=("finfo_min", "finite", "none")[n % 3])
    for n, (L, S, Dh, (metric, c)) in enumerate(
        [(L, S, None, mc) for L in _SMALL_LS for S in _SMALL_LS
         for mc in (("oblique", 1.0), ("poincare", 1.0), ("poincare", 0.7))]
        + [(32, S, Dh, mc) for S, Dh in ((2048, 8), (2049, 8), (31, 64),
                                         (32, 64), (256, 64), (257, 64))
           for mc in (("oblique", 1.0), ("poincare", 1.0))]
        + [(64, 8, 8, ("poincare", 1.0))])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", _FUSED_SMALL_CASES)
def test_fused_forward_small_shapes(cuda_device, case):
    """The whole-S forward at small S in both metrics, with and without a
    mask (finfo.min exclusions, one all-excluded row, or finite entries):
    within 1e-5 of its plain version, the all-excluded row exactly 0."""
    L, S, Dh, c = case["L"], case["S"], case["Dh"], case["c"]
    rng = np.random.default_rng(L * 131 + S * 7 + Dh + int(c * 10))
    if case["metric"] == "poincare":
        q, k, v, _ = _ball_inputs(rng, (5,), L, S, Dh, c)
    else:
        q, k, v, _ = _attn_inputs((5, L, Dh), S, None, seed=L * 7 + S)
    mask = None
    if case["mask"] == "finite":
        mask = torch.from_numpy(
            3.0 * rng.standard_normal((5, L, S)).astype(np.float32) + 2.0)
    elif case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((5, L, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0)
        mask[:, 0, :] = torch.finfo(torch.float32).min   # all excluded
    kw = dict(metric=case["metric"], curvature=c)
    want = tmhgsa.fused_geodesic_attention(q, k, v, mask=mask, **kw)
    before = tmhgsa.fused_geodesic_attention.launches
    with torch.inference_mode():
        got = tmhgsa.fused_geodesic_attention(
            q.to(cuda_device), k.to(cuda_device), v.to(cuda_device),
            mask=None if mask is None else mask.to(cuda_device), **kw)
    torch.cuda.synchronize()
    assert tmhgsa.fused_geodesic_attention.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-5)
    if case["mask"] == "finfo_min":
        assert bool(torch.all(got[:, 0] == 0))


# the poincaré whole-S backward's small-S mode (2p on csrc/small_bwd.cuh):
# odd L and S, head dims 1–32, the c = 1 form and the general one down to
# near the maxless bound, additive masks with dmask and an all-excluded row,
# rows at the ball's edge (finite only); Dh = 64, and Dh 9–32 below the
# crossover's S (9 keys at Dh = 16), stay on the kernel of before
_POINCARE_SMALL_BWD_CASES = [
    dict(B=88, L=32, S=32, Dh=8, c=1.0, mask="none"),      # NBA, B = 32
    dict(B=88, L=32, S=32, Dh=8, c=0.7, mask="none"),
    dict(B=88, L=128, S=128, Dh=8, c=1.0, mask="none"),    # NBA evaluation
    dict(B=512, L=8, S=8, Dh=8, c=1.0, mask="finfo_min"),  # agent axis
    dict(B=1, L=1, S=1, Dh=8, c=1.0, mask="none"),
    dict(B=3, L=17, S=33, Dh=1, c=0.7, mask="finite"),
    dict(B=2, L=31, S=29, Dh=5, c=0.05, mask="all_excluded"),
    dict(B=2, L=45, S=77, Dh=13, c=1.0, mask="finfo_min"),
    dict(B=2, L=63, S=9, Dh=16, c=0.7, mask="all_excluded"),
    dict(B=2, L=33, S=65, Dh=32, c=0.05, mask="finite"),
    dict(B=2, L=21, S=19, Dh=27, c=1.0, mask="all_excluded"),
    dict(B=3, L=700, S=40, Dh=16, c=1.0, mask="none"),     # row rounds
    dict(B=2, L=129, S=127, Dh=8, c=0.7, mask="all_excluded"),
    dict(B=2, L=1100, S=1100, Dh=8, c=1.0, mask="finfo_min"),
    dict(B=2, L=33, S=47, Dh=8, c=1.0, mask="edge"),
    dict(B=2, L=33, S=47, Dh=32, c=0.7, mask="edge"),
    dict(B=2, L=40, S=40, Dh=64, c=1.0, mask="finite"),    # kernel of before
    dict(B=2, L=40, S=40, Dh=64, c=0.7, mask="all_excluded")]


def _bwd_kernels(fn, calls: int = 20):
    """``fn()``'s output, the names of the whole-S backward kernels it
    launches and the number of calls made: one untraced warm-up call, then
    one profiler trace of ``calls`` calls, whose names are those of any
    traced call. A trace can miss the launches at its ends: traces of one
    cold call, and of one or three calls after a warm-up call under a
    profiler schedule, came back empty at times; 20-call windows have
    not."""
    out = fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            out = fn()
        torch.cuda.synchronize()
    names = {m.group(1) for m in (
        re.search(r"(mhgsa_\w*bwd_kernel)", e.key)
        for e in prof.key_averages()) if m}
    return out, names, 1 + calls


@pytest.mark.cuda
@pytest.mark.parametrize("case", _POINCARE_SMALL_BWD_CASES + _sweep(
    12, 29, lambda r: dict(
        B=int(r.integers(1, 5)), L=int(r.integers(1, 200)),
        S=int(r.integers(1, 200)), Dh=int(r.integers(1, 33)),
        c=float(r.choice([0.05, 0.7, 1.0])),
        mask=str(r.choice(["none", "finite", "finfo_min",
                           "all_excluded"])))))
def test_poincare_small_bwd_matches_plain(cuda_device, case):
    """2p's small-S mode (and, where small_bwd_mode does not take the
    problem, the kernel of before) against the plain backward on the CPU:
    dq, dk, dv and dmask within 5e-5 × max(1, max |g|); an all-excluded
    row's gradients and dmask exactly 0;
    rows at the ball's edge finite (dq and dk are ill-conditioned there in
    fp32, tests/test_torch_poincare_sweep.py). The profiler shows which
    kernel ran: the small body wherever small_bwd_mode takes the problem."""
    B, L, S, Dh, c = (case[x] for x in ("B", "L", "S", "Dh", "c"))
    rng = np.random.default_rng(L * 131 + S * 7 + Dh + int(c * 100))
    if case["mask"] == "edge":
        q, k, v, do = _edge_inputs(rng, (B,), L, S, Dh, c)
    else:
        q, k, v, do = _ball_inputs(rng, (B,), L, S, Dh, c)
    mask = None
    if case["mask"] in ("finite", "all_excluded"):
        mask = torch.from_numpy(
            3.0 * rng.standard_normal((B, L, S)).astype(np.float32))
        if case["mask"] == "all_excluded":
            mask[:, 0] = torch.finfo(torch.float32).min
    elif case["mask"] == "finfo_min":
        mask = torch.where(torch.from_numpy(rng.random((B, 1, S))) < 0.3,
                           torch.finfo(torch.float32).min, 0.0) \
            .expand(B, L, S)
    m3 = None if mask is None else tmhgsa._canonicalize_mask(mask)
    kw = dict(metric="poincare", curvature=c)
    want = tmhgsa.fused_geodesic_attention_backward(q, k, v, m3, do,
                                                    need_dmask=True, **kw)
    dev = [t.to(cuda_device) for t in (q, k, v, do)]
    md = None if m3 is None else m3.to(cuda_device)
    before = tmhgsa.fused_geodesic_attention_backward.launches_by_metric[
        "poincare"]
    got, names, calls = _bwd_kernels(
        lambda: tmhgsa.fused_geodesic_attention_backward(
            *dev[:3], md, dev[3], need_dmask=True, **kw))
    assert tmhgsa.fused_geodesic_attention_backward.launches_by_metric[
        "poincare"] == before + calls
    small = tmhgsa.small_bwd_mode(L, S, Dh, metric="poincare")
    assert small or Dh > 8
    assert names == {"mhgsa_small_bwd_kernel" if small
                     else "mhgsa_bwd_kernel"}, names
    got = [None if g is None else g.cpu() for g in got]
    assert all(bool(torch.isfinite(g).all()) for g in got if g is not None)
    if case["mask"] == "edge":
        return      # ill-conditioned in fp32: finite only
    _grad_check(got, want)
    if case["mask"] == "all_excluded":
        assert torch.all(got[0][:, 0] == 0) and torch.all(got[3][:, 0] == 0)


@pytest.mark.cuda
def test_prefetch_copies_on_a_side_stream_that_the_consumer_waits_for(
        cuda_device):
    """The prefetch thread's pinned, non-blocking copies on its side stream
    arrive whole before the consumer's stream reads them, even while that
    stream is busy, and in order."""
    from sttode_tpu_torch.data.batching import scene_batches
    from sttode_tpu_torch.data.prefetch import prefetch

    scenes = make_social_scenes(24, agents_range=(3, 30), seed=3)
    want = list(scene_batches(scenes, training=False, scenes_per_batch=4))
    busy = torch.randn(2048, 2048, device=cuda_device)
    got = []
    for batch, origs in prefetch(iter(want), size=2, device=cuda_device):
        busy = busy @ busy * 1e-3           # keep the consumer's stream busy
        got.append((batch.past.sum(), batch.future.clone(), batch.valid,
                    origs))
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for (s, fut, valid, origs), (wb, wo) in zip(got, want):
        assert fut.is_cuda and valid.device == fut.device
        assert torch.equal(fut.cpu(), wb.future)
        assert torch.equal(valid.cpu(), wb.valid)
        assert float(s) == float(wb.past.to(cuda_device).sum())
        assert origs is wo


@pytest.mark.cuda
def test_train_epoch_prefetch_gives_the_losses_of_no_prefetch(cuda_device):
    from sttode_tpu_torch.data.batching import scene_batches
    from sttode_tpu_torch.train import train_epoch

    cfg = tm.STTODEConfig(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8,
                          sample_k=4, select_impl="auto")
    scenes = make_social_scenes(24, agents_range=(3, 14), seed=5)
    means = []
    for depth in (2, 0):
        step = make_train_step(cfg, 1e-3, device=cuda_device)
        params, opt = step.init(tm.sttode_init(2, cfg))
        _, _, m = train_epoch(
            step, params, opt, scene_batches(
                scenes, training=True, rng=np.random.default_rng(7)),
            torch.Generator(device=cuda_device).manual_seed(7),
            prefetch_depth=depth)
        means.append(m)
    assert means[0] == means[1]
    assert np.isfinite(list(means[0].values())).all()


# --------------------------------------------------------------------------- #
# stage 2, the DLow sampler: the frozen net's encoder runs forward only       #
# --------------------------------------------------------------------------- #

def _sampler_case(kind, device):
    """(net cfg, sampler cfg, net params, sampler params, batch) at full
    width: the NBA recipe's scene axis at 32 × 11 (kernel P) or the ETH
    agent-axis recipe at 32 scenes padded to 16 agents (kernel A, key
    masks)."""
    from sttode_tpu_torch.data.batching import scene_batches
    if kind == "nba_scene":
        cfg = tm.STTODEConfig(past_length=5, future_length=10).validate()
        scenes = make_social_scenes(32, agents_range=(11, 11), obs_len=5,
                                    pred_len=10, seed=21)
        batch, _ = prepare_scene_group(
            np.stack([s["obs"] for s in scenes]),
            np.stack([s["pred"] for s in scenes]),
            np.ones((32, 11), np.float32), training=True,
            rng=np.random.default_rng(21))
    else:
        cfg = tm.STTODEConfig(compat="tpu", attn_axis="agent").validate()
        scenes = make_social_scenes(32, agents_range=(9, 16), seed=22)
        (batch, _), = scene_batches(scenes, training=True,
                                    rng=np.random.default_rng(22),
                                    scenes_per_batch=32, compat="tpu")
        assert batch.agent_num == 16 and float(batch.valid.min()) == 0.0
    scfg = ts.SamplerConfig()
    return (cfg, scfg, to_device(tm.sttode_init(21, cfg), device),
            ts.sampler_init(22, scfg), batch.to(device))


def _sampler_step_launches():
    f = tmhgsa.flash_geodesic_attention_backward
    return {"A": tmhgsa.fused_geodesic_attention.launches,
            "P": tpacked.packed_geodesic_attention.launches,
            "backward": (tmhgsa.fused_geodesic_attention_backward.launches
                         + tpacked.packed_geodesic_attention_backward.launches
                         + f.launches_dq + f.launches_dkv),
            "flash": tmhgsa.flash_geodesic_attention.launches,
            "B": tsd.select_decode.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nba_scene", "eth_agent"])
def test_sampler_step_kernel_route_matches_plain(cuda_device, kind):
    """The stage-2 forward, losses and every sampler gradient leaf on the
    kernel route against the plain route (attn_impl="dense") with the same
    weights and batch: losses and dec_motion within 1e-4 × max(1, |x|).
    The sampler's gradient is ill-conditioned in fp32 on either route (the
    KL's −log(A² + 1e-8) gives q_A a 1/A gradient where A is a cancelling
    sum near 0: the fp32 plain route is ~1.5e-4 of q_A's largest magnitude
    from float64 at full width on an H100, chip_smoke.py phase 16), so
    each leaf is held within 1e-3 of its
    largest magnitude between the routes (PERF.md §2's large-batch limit),
    and against the plain route in float64 the kernel route at most 3× as
    far off as the fp32 plain route."""
    cfg, scfg, net, sp0, batch = _sampler_case(kind, cuda_device)
    f64 = torch.float64

    def run(c, dtype=torch.float32):
        sp = bridge.tree_map(lambda t: t.to(cuda_device, dtype, copy=True),
                             sp0)
        leaves = [t.requires_grad_() for t in bridge.tree_leaves(sp)]
        n = bridge.tree_map(lambda t: t.to(dtype), net)
        b = batch.to(dtype)
        out = ts.sampler_forward(sp, n, scfg, c, b)
        total, parts = ts.sampler_loss(out, scfg, b)
        total.backward()
        return ([float(total.detach())] + [float(v.detach())
                                           for v in parts.values()],
                out.dec_motion.detach(), [t.grad for t in leaves])

    got, dec, g_got = run(cfg)
    dense = cfg._replace(attn_impl="dense")
    want, dec_p, g_want = run(dense)
    _, _, g_64 = run(dense, f64)
    for a, b in zip(got, want):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (a, b)
    scale = max(1.0, float(dec_p.abs().max()))
    assert float((dec - dec_p).abs().max()) <= 1e-4 * scale
    err = {"routes": [], "kernel": [], "plain": []}
    for i, (a, b, o) in enumerate(zip(g_got, g_want, g_64)):
        if b is None:             # q_c: only the reconstruction reads it
            assert a is None and o is None, i
            continue
        assert bool(torch.isfinite(a).all()), i
        for key, x, y in (("routes", a, b), ("kernel", a, o),
                          ("plain", b, o)):
            err[key].append(float((x.to(f64) - y).abs().max())
                            / max(float(y.abs().max()), 1e-30))
    assert max(err["routes"]) <= 1e-3, err
    assert max(err["kernel"]) <= min(1e-3, 3 * max(err["plain"])), err


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nba_scene", "eth_agent"])
def test_sampler_step_launches_no_backward_kernel(cuda_device, kind):
    """One stage-2 training step launches the encoder's forward kernel (P
    on the scene axis, A on the agent axis) and no attention backward
    (C, 2p, Q, Fdq, Fdkv, 4p), no flash kernel and no kernel B; the frozen
    net's leaves get no gradient and do not move."""
    cfg, scfg, net, sp, batch = _sampler_case(kind, cuda_device)
    step = make_sampler_train_step(cfg, scfg, 1e-4, net, device=cuda_device)
    params, opt = step.init(sp)
    before = _sampler_step_launches()
    params, opt, metrics = step(params, opt, batch)
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in _sampler_step_launches().items()}
    fwd = "P" if kind == "nba_scene" else "A"
    assert moved[fwd] > 0 and moved["A" if fwd == "P" else "P"] == 0, moved
    assert moved["backward"] == moved["flash"] == moved["B"] == 0, moved
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    for a, b in zip(bridge.tree_leaves(step.net_params),
                    bridge.tree_leaves(net)):
        assert a.grad is None and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["scene", "agent"])
def test_sampler_predictor_on_card_matches_cpu_plain(cuda_device, axis):
    """``Predictor(sampler_params=…)`` on the card (kernels A or P) equals
    the same Predictor on the CPU (plain paths) within 1e-4, for 64 scenes
    of 8 agents."""
    kw = {} if axis == "scene" else dict(compat="tpu", attn_axis="agent")
    cfg = tm.STTODEConfig(**kw).validate()
    scfg = ts.SamplerConfig()
    params, sp = tm.sttode_init(23, cfg), ts.sampler_init(24, scfg)
    scenes = [s["obs"] for s in make_social_scenes(64, agents_range=(8, 8),
                                                   seed=23)]
    card = Predictor(params, cfg, device=cuda_device, max_group=64,
                     sampler_params=sp, sampler_cfg=scfg)
    cpu = Predictor(params, cfg, device="cpu", max_group=64,
                    sampler_params=sp, sampler_cfg=scfg)
    before = _sampler_step_launches()
    got = card.predict_many(scenes, seed=3)
    moved = {k: v - before[k] for k, v in _sampler_step_launches().items()}
    assert moved["P" if axis == "scene" else "A"] > 0, moved
    assert moved["backward"] == moved["B"] == 0, moved
    for g, w in zip(got, cpu.predict_many(scenes, seed=4)):
        assert g.shape == w.shape == (20, 8, 12, 2)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# the adaptive and adjoint ODE encoder, learn_prior and dropout              #
# --------------------------------------------------------------------------- #

def _trunk_field_solve(layers, x, cfg, rtol, atol):
    from sttode_tpu_torch.nn import transformer as ttr
    from sttode_tpu_torch.ode import odeint
    return odeint(lambda t, y, p: ttr.encoder_stack(p, y, cfg), x,
                  torch.tensor([0.0, 12.0]), layers, method="dopri5",
                  rtol=rtol, atol=atol, return_stats=True)


@pytest.mark.cuda
@pytest.mark.parametrize("rtol,atol", [(1e-5, 1e-7), (1e-3, 1e-6)])
def test_dopri5_kernel_route_counts_match_cpu(cuda_device, rtol, atol):
    """dopri5 over the NBA trunk field at full width (P in every RHS
    evaluation): the kernel route's step counts equal the CPU plain
    route's, its solution within 1e-4 of the solution's largest magnitude,
    one P launch an evaluation."""
    from sttode_tpu_torch.nn import transformer as ttr
    cfg = ttr.LayerConfig(d_model=64, num_heads=8, ff_dim=1024)
    layers = ttr.encoder_stack_init(torch.Generator().manual_seed(17), cfg,
                                    1)
    x = torch.from_numpy(np.random.default_rng(17).standard_normal(
        (32, 11, 1, 64)).astype(np.float32))
    with torch.no_grad():
        want, st_c = _trunk_field_solve(layers, x,
                                        cfg._replace(attn_impl="dense"),
                                        rtol, atol)
        before = tpacked.packed_geodesic_attention.launches
        got, st_k = _trunk_field_solve(to_device(layers, cuda_device),
                                       x.to(cuda_device), cfg, rtol, atol)
        torch.cuda.synchronize()
    assert st_k == st_c
    assert tpacked.packed_geodesic_attention.launches - before == \
        st_k["rhs_evals"]
    scale = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale


def _ode_nba_batch(device, B=8):
    sc = make_social_scenes(B, agents_range=(11, 11), obs_len=5, pred_len=10,
                            seed=6)
    batch, _ = prepare_scene_group(
        np.stack([s["obs"] for s in sc]), np.stack([s["pred"] for s in sc]),
        np.ones((B, 11), np.float32), training=True,
        rng=np.random.default_rng(6))
    return batch.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["adjoint", "scan_budget", "learn_prior"])
def test_ode_model_step_on_card_launches_p_and_q(cuda_device, kind):
    """One training step of each ODE option on the card: P and Q launch
    (the adjoint runs Q inside its backward solve's VJPs), the losses equal
    the CPU plain route's, every gradient leaf is finite."""
    kw = {"adjoint": dict(ode_method="dopri5", ode_adjoint=True,
                          ode_rtol=1e-3, ode_atol=1e-6),
          "scan_budget": dict(ode_method="dopri5", ode_rtol=1e-3,
                              ode_atol=1e-6, ode_scan_budget=16),
          "learn_prior": dict(learn_prior=True)}[kind]
    cfg = tm.STTODEConfig(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8,
                          sample_k=4, past_length=5, future_length=10,
                          select_impl="xla", **kw).validate()
    params = tm.sttode_init(6, cfg)
    batch = _ode_nba_batch(cuda_device)
    M = batch.batch_size * batch.agent_num
    g = torch.Generator().manual_seed(6)
    noise = tm.TrainNoise(torch.rand(M, 5, 16, generator=g) >= 0.1,
                          torch.rand(M, 10, 16, generator=g) >= 0.1,
                          torch.randn(M, 8, generator=g),
                          torch.randn(M * 4, 8, generator=g))
    want = tm.sttode_forward(params, cfg._replace(attn_impl="dense"),
                             batch.to("cpu"), noise=noise)
    p = bridge.tree_map(lambda t: t.to(cuda_device).requires_grad_(),
                        params)
    before = (tpacked.packed_geodesic_attention.launches,
              tpacked.packed_geodesic_attention_backward.launches)
    out = tm.sttode_forward(p, cfg, batch, noise=tm.TrainNoise(
        *(t.to(cuda_device) for t in noise[:4])))
    out.total_loss.backward()
    torch.cuda.synchronize()
    assert tpacked.packed_geodesic_attention.launches > before[0]
    assert tpacked.packed_geodesic_attention_backward.launches > before[1]
    for name in ("total_loss", "loss_pred", "loss_recover", "loss_kl",
                 "loss_diverse"):
        a, b = float(getattr(out, name).detach()), float(getattr(want, name))
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), name
    assert all(bool(torch.isfinite(t.grad).all())
               for t in bridge.tree_leaves(p))


@pytest.mark.cuda
def test_dropout_step_on_card_runs_no_attention_kernel(cuda_device):
    cfg = tm.STTODEConfig(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8,
                          sample_k=4, past_length=5, future_length=10,
                          dropout=0.1).validate()
    step = make_train_step(cfg, 1e-3, device=cuda_device)
    params, opt = step.init(tm.sttode_init(6, cfg))
    before = (tpacked.packed_geodesic_attention.launches,
              tpacked.packed_geodesic_attention_backward.launches,
              tmhgsa.fused_geodesic_attention.launches,
              tmhgsa.fused_geodesic_attention_backward.launches)
    batch = _ode_nba_batch(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    _, _, metrics = step(params, opt, batch, gen)
    torch.cuda.synchronize()
    assert (tpacked.packed_geodesic_attention.launches,
            tpacked.packed_geodesic_attention_backward.launches,
            tmhgsa.fused_geodesic_attention.launches,
            tmhgsa.fused_geodesic_attention_backward.launches) == before
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    with pytest.raises(ValueError, match="does not implement attention "
                                         "dropout"):
        tm.sttode_forward(to_device(tm.sttode_init(6, cfg), cuda_device),
                          cfg._replace(attn_impl="packed"), batch,
                          generator=gen)


@pytest.mark.cuda
def test_dopri5_predictor_on_card_matches_plain_route(cuda_device):
    """A dopri5 learn_prior model served on the card (the while form under
    inference mode, A with key masks) gives the plain route's forecasts on
    the card (the same seeded draws)."""
    cfg = tm.STTODEConfig(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8,
                          sample_k=4, compat="tpu", attn_axis="agent",
                          ode_method="dopri5", ode_rtol=1e-5, ode_atol=1e-7,
                          learn_prior=True).validate()
    params = tm.sttode_init(6, cfg)
    scenes = [s["obs"] for s in make_social_scenes(6, agents_range=(3, 8),
                                                   seed=6)]
    before = tmhgsa.fused_geodesic_attention.launches_masked
    got = Predictor(params, cfg, device=cuda_device).predict_many(scenes,
                                                                  seed=2)
    assert tmhgsa.fused_geodesic_attention.launches_masked > before
    want = Predictor(params, cfg._replace(attn_impl="dense",
                                          select_impl="xla"),
                     device=cuda_device).predict_many(scenes, seed=2)
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------- #
# scan_steps: S optimizer steps captured as one CUDA graph                    #
# --------------------------------------------------------------------------- #

_SCAN_SMALL = dict(hidden_dim=16, num_heads=2, ff_dim=32, zdim=8, sample_k=4,
                   past_length=5, future_length=10, min_clip=0.0)


def _scan_batches(device, n, B=4, N=8, seed=30):
    out = []
    for i in range(n):
        scenes = make_social_scenes(B, agents_range=(N, N), obs_len=5,
                                    pred_len=10, seed=seed + i)
        valid = np.ones((B, N), np.float32)
        valid[i % B, N - 1] = 0.0
        batch, _ = prepare_scene_group(
            np.stack([s["obs"] for s in scenes]),
            np.stack([s["pred"] for s in scenes]), valid, training=True,
            rng=np.random.default_rng(seed + i))
        out.append(batch.to(device))
    return out


def _scan_noise(cfg, batch, gen):
    M, D = batch.batch_size * batch.agent_num, cfg.hidden_dim
    dev = batch.past.device
    return tm.TrainNoise(
        torch.rand(M, cfg.past_length, D, device=dev, generator=gen) >= 0.1,
        torch.rand(M, cfg.future_length, D, device=dev, generator=gen) >= 0.1,
        torch.randn(M, cfg.zdim, device=dev, generator=gen),
        torch.randn(M * cfg.sample_k, cfg.zdim, device=dev, generator=gen))


def _scan_runs(make, params, batches, noises, S):
    """Eager single steps and calls of the step captured over S steps from
    the same parameters and noise (the first call runs its chunk eagerly as
    the capture's warm-up, the others replay): (eager metrics, graph
    metrics, eager (params, opt), graph (params, opt), the graph step). The
    eager steps run on the graph's Adam form (capturable: the bias
    correction on the device), so that both sides compute the same
    updates; a plain Adam rounds them apart."""
    from sttode_tpu_torch.train import stack_batches, stack_noise
    eager, graph = make(1), make(S)
    assert graph.mode == "graph" and eager.mode == "eager"
    pe, oe = graph.init(params)
    pg, og = graph.init(params)
    gen = torch.Generator(device=batches[0].past.device).manual_seed(3)
    me = [eager(pe, oe, b, gen, noise=n)[2] for b, n in zip(batches, noises)]
    mg = [graph(pg, og, stack_batches(batches[i:i + S]), gen,
                noise=None if noises[0] is None
                else stack_noise(noises[i:i + S]))[2]
          for i in range(0, len(batches), S)]
    torch.cuda.synchronize()
    return me, mg, (pe, oe), (pg, og), graph


def _assert_same_runs(me, mg, run_e, run_g):
    """Losses, parameters and Adam moments within 1e-4 × max(1, |x|) (the
    eager and captured steps run the same kernels and the same Adam form
    on the same inputs: measured equal bit for bit)."""
    for k in me[0]:
        a = torch.cat([m[k] for m in mg])
        b = torch.stack([m[k] for m in me])
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max())), k
    for (pa, oa), (pb, ob) in ((run_g, run_e),):
        for a, b in zip(bridge.tree_leaves(pa), bridge.tree_leaves(pb)):
            assert float((a - b).abs().max()) <= 1e-4 * max(
                1.0, float(b.abs().max()))
        for a, b in zip(oa.param_groups[0]["params"],
                        ob.param_groups[0]["params"]):
            # a leaf no step reaches has no state on either side
            assert oa.state.get(a, {}).keys() == ob.state.get(b, {}).keys()
            for key in oa.state.get(a, {}):
                x, y = oa.state[a][key], ob.state[b][key]
                assert float((x - y).abs().max()) <= 1e-4 * max(
                    1.0, float(y.abs().max())), key


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fused_bf16", "packed", "stage2",
                                  "dopri5_scan"])
def test_captured_step_equals_eager_steps(cuda_device, kind):
    """The warm-up chunk and two replays of the captured S-step call give
    the losses, parameters and Adam moments of 3·S eager steps with the
    same injected noise:
    stage 1 on the whole-S kernels with kernel B bf16 and on the packed
    kernels with kernel B fp32, stage 2 (P forward only), and the
    scan-budget dopri5 step."""
    S = 2 if kind == "dopri5_scan" else 4
    batches = _scan_batches(cuda_device, 3 * S)
    if kind == "stage2":
        cfg = tm.STTODEConfig(**_SCAN_SMALL).validate()
        scfg = ts.SamplerConfig(nk=4, nz=8, qnet_mlp=(32, 16),
                                train_w_mean=False)
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        noises = [torch.randn(1, 8, device=cuda_device, generator=gen)
                  for _ in batches]
        net = tm.sttode_init(4, cfg)
        params = ts.sampler_init(5, scfg, pred_model_dim=16,
                                 past_feature_dim=32)

        def make(steps):
            return make_sampler_train_step(cfg, scfg, 1e-3, net,
                                           device=cuda_device,
                                           scan_steps=steps)
    else:
        kw = {"fused_bf16": dict(attn_impl="fused", select_impl="auto",
                                 select_dtype="bfloat16",
                                 decode_dtype="bfloat16"),
              "packed": dict(attn_impl="packed", select_impl="auto"),
              "dopri5_scan": dict(ode_method="dopri5", ode_scan_budget=12,
                                  ode_rtol=1e-3, ode_atol=1e-6,
                                  select_impl="auto")}[kind]
        cfg = tm.STTODEConfig(**_SCAN_SMALL, **kw).validate()
        gen = torch.Generator(device=cuda_device).manual_seed(4)
        noises = [_scan_noise(cfg, b, gen) for b in batches]
        params = tm.sttode_init(4, cfg)

        def make(steps):
            return make_train_step(cfg, 1e-3, device=cuda_device,
                                   scan_steps=steps)
    me, mg, run_e, run_g, graph = _scan_runs(make, params, batches, noises, S)
    _assert_same_runs(me, mg, run_e, run_g)
    stats = graph.graph_stats()
    assert stats["graphs"] == 1 and stats["replays"] == 2
    assert stats["pool_bytes"] > 0


@pytest.mark.cuda
def test_replays_draw_fresh_noise_and_count_launches(cuda_device):
    """Without injected noise each replay draws anew from the registered
    generator, and its draws are those of eager steps from the same seed
    (the rate set to 0, so the parameters stay); the launch counters add
    the captured launches once a replay."""
    from sttode_tpu_torch.train import set_lr, stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="packed",
                          select_impl="auto").validate()
    batches = _scan_batches(cuda_device, 3)
    stacked = stack_batches(batches)
    eager = make_train_step(cfg, 0.0, device=cuda_device)
    graph = make_train_step(cfg, 0.0, device=cuda_device, scan_steps=3)
    pe, oe = eager.init(tm.sttode_init(7, cfg))
    pg, og = graph.init(tm.sttode_init(7, cfg))
    set_lr(oe, 0.0)
    ge = torch.Generator(device=cuda_device)
    gg = torch.Generator(device=cuda_device)
    graph(pg, og, stacked, gg)                    # warm-up and capture
    ge.manual_seed(9)
    gg.manual_seed(9)
    got = []
    for _ in range(2):
        want = torch.stack([eager(pe, oe, b, ge)[2]["total"]
                            for b in batches])
        before = (tpacked.packed_geodesic_attention.launches,
                  tpacked.packed_geodesic_attention_backward.launches,
                  tsd.select_decode.launches)
        got.append(graph(pg, og, stacked, gg)[2]["total"])
        torch.cuda.synchronize()
        assert (tpacked.packed_geodesic_attention.launches - before[0],
                tpacked.packed_geodesic_attention_backward.launches
                - before[1], tsd.select_decode.launches - before[2]) == \
            (2 * 3, 2 * 3, 3)
        assert torch.equal(got[-1], want)
    assert not torch.equal(got[0], got[1])


@pytest.mark.cuda
def test_set_lr_between_replays_takes_effect(cuda_device):
    from sttode_tpu_torch.train import set_lr, stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="packed").validate()
    batches = _scan_batches(cuda_device, 2)
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    params, opt = step.init(tm.sttode_init(8, cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    stacked = stack_batches(batches)
    step(params, opt, stacked, gen)
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.is_cuda
    set_lr(opt, 0.0)
    assert opt.param_groups[0]["lr"] is lr
    before = [t.detach().clone() for t in bridge.tree_leaves(params)]
    step(params, opt, stacked, gen)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in
               zip(bridge.tree_leaves(params), before))
    set_lr(opt, 1e-3)
    step(params, opt, stacked, gen)
    torch.cuda.synchronize()
    assert not all(torch.equal(a, b) for a, b in
                   zip(bridge.tree_leaves(params), before))
    assert step.graph_stats()["graphs"] == 1


@pytest.mark.cuda
def test_kernel_b_packs_inside_the_capture(cuda_device, monkeypatch):
    """Kernel B's packed-weight cache decides on the host: under capture
    the packing is always recorded and never cached, so replays after
    Adam's in-place updates select with the current weights (the
    captured losses equal eager ones over several replays)."""
    from sttode_tpu_torch.train import stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="packed",
                          select_impl="fused").validate()
    batches = _scan_batches(cuda_device, 2)
    real = tsd.pack_select_weights
    captured = []

    def pack(*a, **kw):
        out = real(*a, **kw)
        if torch.cuda.is_current_stream_capturing():
            captured.append(out)
        return out

    monkeypatch.setattr(tsd, "pack_select_weights", pack)
    step = make_train_step(cfg, 1e-1, device=cuda_device, scan_steps=2)
    params, opt = step.init(tm.sttode_init(9, cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    step(params, opt, stack_batches(batches), gen)
    assert len(captured) == 2                    # one packing a step
    assert not any(v[2] is c for v in tsd._PACKED.values() for c in captured)
    # with a large rate the weights move far each step; replays still match
    # eager steps, which repack after each update
    noises = [_scan_noise(cfg, b, gen) for b in batches * 3]
    me, mg, run_e, run_g, _ = _scan_runs(
        lambda s: make_train_step(cfg, 1e-2, device=cuda_device,
                                  scan_steps=s),
        tm.sttode_init(9, cfg), batches * 3, noises, 2)
    _assert_same_runs(me, mg, run_e, run_g)


@pytest.mark.cuda
def test_eager_select_decode_after_replays_packs_the_replayed_weights(
        cuda_device):
    """A replay writes the parameters without moving their versions unless
    the step marks them changed: an eager kernel-B call after replays must
    pack the weights the replays wrote, not those of an earlier eager
    call (its cache is keyed on versions)."""
    from sttode_tpu_torch.train import stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="packed",
                          select_impl="fused").validate()
    batches = _scan_batches(cuda_device, 2)
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    params, opt = step.init(tm.sttode_init(12, cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    stacked = stack_batches(batches)
    b = batches[0]
    M = b.batch_size * b.agent_num
    z_km = torch.randn(cfg.sample_k, M, cfg.zdim, device=cuda_device,
                       generator=gen)

    def decode():
        with torch.inference_mode():
            return tsd.select_decode(
                params, tm.encode_past(params, cfg, b), z_km,
                tm.decode_block0_state(params, b.past),
                b.past.reshape(M, -1),
                (b.future - b.cur_location).reshape(M, -1))

    step(params, opt, stacked, gen)               # warm-up and capture
    first = decode()
    step(params, opt, stacked, gen)               # a replay
    after = decode()
    tsd._PACKED.clear()
    fresh = decode()
    assert step.graph_stats()["replays"] == 1
    assert torch.isfinite(after).all()
    assert torch.equal(after, fresh) and not torch.equal(after, first)


@pytest.mark.cuda
def test_replayed_scan_budget_exhaustion_warns(cuda_device):
    """dopri5's scan form under capture keeps its exhaustion on the device:
    after replays whose budget ran out, the step's ``check_budget`` (which
    ``train_epoch`` calls at its log lines and its end) warns, once."""
    import warnings
    from sttode_tpu_torch.train import stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, ode_method="dopri5",
                          ode_scan_budget=1, ode_rtol=1e-7,
                          ode_atol=1e-9).validate()
    stacked = stack_batches(_scan_batches(cuda_device, 2))
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    assert step.mode == "graph"
    params, opt = step.init(tm.sttode_init(13, cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    with pytest.warns(RuntimeWarning, match="scan_budget=1 exhausted"):
        step(params, opt, stacked, gen)           # the eager warm-up warns
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step(params, opt, stacked, gen)           # a replay reads nothing
    with pytest.warns(RuntimeWarning, match="scan_budget=1 exhausted"):
        step.check_budget()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        step.check_budget()


@pytest.mark.cuda
def test_while_form_steps_run_eagerly(cuda_device):
    from sttode_tpu_torch.train import stack_batches, stack_noise
    cfg = tm.STTODEConfig(**_SCAN_SMALL, ode_method="dopri5",
                          ode_adjoint=True, ode_rtol=1e-3,
                          ode_atol=1e-6).validate()
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    assert step.mode == "eager"
    assert make_train_step(cfg, 1e-3, device=cuda_device).mode == "eager"
    batches = _scan_batches(cuda_device, 2)
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    noises = [_scan_noise(cfg, b, gen) for b in batches]
    one = make_train_step(cfg, 1e-3, device=cuda_device)
    p1, o1 = one.init(tm.sttode_init(10, cfg))
    p2, o2 = step.init(tm.sttode_init(10, cfg))
    want = [one(p1, o1, b, noise=n)[2]["total"]
            for b, n in zip(batches, noises)]
    got = step(p2, o2, stack_batches(batches), noise=stack_noise(noises))
    assert torch.equal(got[2]["total"], torch.stack(want))
    assert step.graphs == {}


def _grads_close(got, want, what, tol=1e-4):
    """Each gradient leaf within ``tol`` × its largest magnitude."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), f"{what}: leaf {i}"
        scale = max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= tol * scale, f"{what}: leaf {i} {err:.3e} of {scale:.3e}"


def _decoder_launches():
    return {"packed": (tpacked.packed_geodesic_attention.launches,
                       tpacked.packed_geodesic_attention_backward.launches),
            "fused": (tmhgsa.fused_geodesic_attention.launches,
                      tmhgsa.fused_geodesic_attention_backward.launches),
            "flash": (tmhgsa.flash_geodesic_attention.launches,
                      tmhgsa.flash_geodesic_attention_backward.launches_dq,
                      tmhgsa.flash_geodesic_attention_backward.launches_dkv)}


@pytest.mark.cuda
@pytest.mark.parametrize("route,L,Lm,compat", [
    ("packed", 32, 24, "reference"), ("packed", 16, 16, "reference"),
    ("packed", 12, 30, "tpu"), ("fused", 128, 96, "reference"),
    ("fused", 64, 64, "reference"), ("fused", 40, 200, "tpu"),
    ("flash", 256, 2304, "reference"), ("flash", 100, 300, "tpu")])
def test_decoder_kernel_routes_match_plain(cuda_device, route, L, Lm,
                                           compat):
    """``decoder_stack`` (d_model 64, 8 heads, ff 256, one layer) forced
    onto each kernel route at L != L_mem (and the square cross, Q3 swapped
    under reference compat) against the plain route on the card: the
    output within 1e-4, every gradient leaf (the layer's, tgt's, memory's)
    within 1e-4 × its largest magnitude; None weights; the route's
    kernels launched."""
    from sttode_tpu_torch.nn import transformer as ttr
    cfg = ttr.LayerConfig(d_model=64, num_heads=8, ff_dim=256, compat=compat)
    layers = bridge.to_device(ttr.decoder_stack_init(
        torch.Generator().manual_seed(L + Lm), cfg, 1), cuda_device)
    rng = np.random.default_rng(L * 7 + Lm)
    x, m, cot = (torch.from_numpy(rng.standard_normal((n, 3, 1, 64)).astype(
        np.float32)).to(cuda_device) for n in (L, Lm, L))

    def run(impl):
        p = bridge.tree_map(lambda t: t.detach().clone().requires_grad_(),
                            layers)
        xx, mm = x.clone().requires_grad_(), m.clone().requires_grad_()
        out, sw, cw = ttr.decoder_stack(p, xx, mm,
                                        cfg._replace(attn_impl=impl))
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), (sw, cw), [t.grad for t in bridge.tree_leaves(
            p)] + [xx.grad, mm.grad]

    before = _decoder_launches()[route]
    out_k, w_k, g_k = run(route)
    after = _decoder_launches()[route]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    out_p, w_p, g_p = run("dense")
    assert w_k == (None, None) and w_p[1].shape == (3, L, Lm)
    assert float((out_k - out_p).abs().max()) <= 1e-4
    _grads_close(g_k, g_p, f"decoder {route} {L}x{Lm}")


@pytest.mark.cuda
@pytest.mark.parametrize("route,L", [("packed", 16), ("packed", 9),
                                     ("fused", 128), ("fused", 50)])
@pytest.mark.parametrize("bias,zero", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_mhgsa_bias_kv_kernel_routes_match_plain(cuda_device, route, L,
                                                 bias, zero):
    """``mhgsa`` with ``bias_kv`` / ``add_zero_attn`` on the packed and
    fused kernels against the plain route (square without the options:
    swapped; with them S = L + 1 or + 2, unswapped), forward and every
    gradient (the projections, bias_k, bias_v, the query)."""
    from sttode_tpu_torch.nn import attention as tattn
    gen = torch.Generator().manual_seed(L + 2 * bias + zero)
    mp = tattn.mhgsa_init(gen, 64)
    mp = to_device(mp._replace(
        in_proj_b=0.1 * torch.randn(192, generator=gen),
        out_proj_b=0.1 * torch.randn(64, generator=gen)), cuda_device)
    bkv = tuple(torch.randn(64, generator=gen).to(cuda_device)
                for _ in range(2))
    x0 = torch.randn(5, L, 64, generator=gen).to(cuda_device)
    cot = torch.randn(5, L, 64, generator=gen).to(cuda_device)

    def run(fused):
        p = bridge.tree_map(lambda t: t.detach().clone().requires_grad_(),
                            mp)
        b = tuple(t.detach().clone().requires_grad_() for t in bkv)
        x = x0.clone().requires_grad_()
        out, w = tattn.mhgsa(p, x, x, x, 8, compat="reference", fused=fused,
                             bias_kv=b if bias else None, add_zero_attn=zero)
        (out * cot).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), [t.grad for t in bridge.tree_leaves(p)] + (
            [t.grad for t in b] if bias else []) + [x.grad]

    before = _decoder_launches()[route][:2]
    out_k, g_k = run(True if route == "fused" else "packed")
    assert all(a > b for a, b in zip(_decoder_launches()[route][:2], before))
    out_p, g_p = run(False)
    assert float((out_k - out_p).abs().max()) <= 1e-4
    _grads_close(g_k, g_p, f"mhgsa {route} L {L} bias {bias} zero {zero}")


@pytest.mark.cuda
def test_rollback_under_a_captured_step(cuda_device, tmp_path):
    """A NaN parameter under ``scan_steps`` 2: ``Supervisor.after_epoch``
    rolls back in place (the graph stays bound: no recapture), and the
    next replay equals eager steps from the last-good checkpoint on the
    same Adam form and noise."""
    from sttode_tpu_torch.train import (load_checkpoint, set_lr,
                                        stack_batches, stack_noise)
    from sttode_tpu_torch.train.checkpoint import checkpoint_path
    from sttode_tpu_torch.train.supervisor import Supervisor
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="packed",
                          select_impl="auto").validate()
    batches = _scan_batches(cuda_device, 8)
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    noises = [_scan_noise(cfg, b, gen) for b in batches]
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    params, opt = step.init(tm.sttode_init(12, cfg))

    def chunk(i):
        return step(params, opt, stack_batches(batches[2 * i:2 * i + 2]), gen,
                    noise=stack_noise(noises[2 * i:2 * i + 2]))[2]

    sup = Supervisor(str(tmp_path), cfg, save_every=1)
    m0, m1 = chunk(0), chunk(1)
    assert sup.after_epoch(0, float(torch.cat([m0["total"], m1["total"]])
                                    .mean()), params, opt)[3] == "ok"
    with torch.no_grad():
        bridge.tree_leaves(params)[3].view(-1)[0] = float("nan")
    loss = float(chunk(2)["total"].mean())
    _, _, epoch, action = sup.after_epoch(1, loss, params, opt)
    assert (action, epoch, sup.lr_scale) == ("rollback", 1, 0.5)
    saved_p, saved_o, _, _ = load_checkpoint(checkpoint_path(str(tmp_path),
                                                             1))
    for a, b in zip(bridge.tree_leaves(params), bridge.tree_leaves(saved_p)):
        assert torch.equal(a.detach().cpu(), b)
    set_lr(opt, 5e-4)
    m3 = chunk(3)
    assert step.graph_stats()["graphs"] == 1
    assert step.graph_stats()["replays"] == 3
    eager = make_train_step(cfg, 1e-3, device=cuda_device)
    pe, oe = step.init(saved_p, saved_o)
    set_lr(oe, 5e-4)
    me = [eager(pe, oe, b, gen, noise=n)[2] for b, n in
          zip(batches[6:], noises[6:])]
    torch.cuda.synchronize()
    for k in m3:
        b = torch.stack([m[k] for m in me])
        assert float((m3[k] - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max())), k
    for a, b in zip(bridge.tree_leaves(params), bridge.tree_leaves(pe)):
        assert float((a - b).abs().max()) <= 1e-4 * max(
            1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_captured_step_makes_no_host_sync(cuda_device, monkeypatch):
    """The warm-up chunk, the capture and the replays run under
    ``set_sync_debug_mode("error")``; a host read put into the step makes
    the capture raise, and the error propagates. Last in the file: a
    failed capture is left to the CUDA runtime."""
    from sttode_tpu_torch.train import stack_batches
    cfg = tm.STTODEConfig(**_SCAN_SMALL, attn_impl="fused",
                          select_impl="auto").validate()
    stacked = stack_batches(_scan_batches(cuda_device, 2))
    step = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    params, opt = step.init(tm.sttode_init(11, cfg))
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            step(params, opt, stacked, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    real = tm.loss_kl

    def synced(*a, **kw):
        out = real(*a, **kw)
        float(out)                                # a host read
        return out

    monkeypatch.setattr(tm, "loss_kl", synced)
    bad = make_train_step(cfg, 1e-3, device=cuda_device, scan_steps=2)
    p2, o2 = bad.init(tm.sttode_init(11, cfg))
    with pytest.raises(RuntimeError):
        bad(p2, o2, stacked, gen)
    torch.cuda.synchronize()
