"""The port's dot-product attention, Gumbel dictionaries, ``RelaxedOneHot``,
the analysis toolbox and the last leftover names against the JAX package on
the CPU.

The same numpy-seeded inputs go through both frameworks; parameters in
JAX's structure are carried across by ``bridge`` and JAX's random draws are
injected (the
attention dropout's keep-mask, the Gumbel noise, the categorical's Gumbel-
max noise). Values and the gradients of Σ w·out with respect to every input
and parameter leaf agree within 1e-5 × max(1, |reference|) in fp32 (the
SVD's gradients within 1e-4: they divide by gaps between singular values).
The leftover names: ``train.prune_checkpoints`` (the same epochs removed as
JAX's, on the port's files; crash debris swept after the grace window),
``nn.recurrent.gru_cell`` and ``gru``, ``nn.core.
kaiming_normal_fan_out`` and ``zeros``, ``train.adam_with_schedule``,
``native.native_available`` and the package exports.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sttode_tpu.nn import attention as jattn
from sttode_tpu.nn import core as jcore
from sttode_tpu.nn import dot_attention as jdot
from sttode_tpu.nn import gumbel as jgum
from sttode_tpu.nn import recurrent as jrec
from sttode_tpu.train import checkpoint as jck
from sttode_tpu.train import schedulers as jsched
from sttode_tpu.utils import analysis as jan
from sttode_tpu.utils import distributions as jdist
from sttode_tpu_torch import bridge
from sttode_tpu_torch.nn import core as tcore
from sttode_tpu_torch.nn import dot_attention as tdot
from sttode_tpu_torch.nn import gumbel as tgum
from sttode_tpu_torch.nn import recurrent as trec
from sttode_tpu_torch.train import checkpoint as tck
from sttode_tpu_torch.train import schedulers as tsched
from sttode_tpu_torch.utils import analysis as tan
from sttode_tpu_torch.utils import distributions as tdist

# one intra-op thread: pytest-xdist runs 6 workers on 8 cores, and
# torch's default of one thread a core each oversubscribes them
torch.set_num_threads(1)


def _t(a, grad=False, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _check(jfn, tfn, args, *, tol=1e-5, grads=True):
    """jfn(*args) against tfn(*port args), args numpy trees (integer
    leaves are passed through and not differentiated); with ``grads`` the
    gradients of Σ w·out with respect to every float leaf."""
    def is_float(a):
        return np.issubdtype(np.asarray(a).dtype, np.floating)

    with jax.default_matmul_precision("highest"):
        jargs = jax.tree_util.tree_map(jnp.asarray, args)
        w = np.random.default_rng(11).standard_normal(
            jax.eval_shape(jfn, *jargs).shape)
        floats = [i for i, a in enumerate(args)
                  if all(map(is_float, jax.tree_util.tree_leaves(a)))]

        def value(*fa):
            full = list(jargs)
            for i, a in zip(floats, fa):
                full[i] = a
            return jfn(*full)

        def value_and_grads(w, *fa):
            out, vjp = jax.vjp(value, *fa)
            return out, vjp(w.astype(out.dtype))

        # one compiled program a case: cheaper than JAX's eager dispatch
        if grads:
            jout, jgrads = jax.jit(value_and_grads)(
                w, *[jargs[i] for i in floats])
        else:
            jout = jax.jit(value)(*[jargs[i] for i in floats])
    targs = bridge.tree_map(
        lambda a: _t(a, grad=grads) if is_float(a)
        else torch.from_numpy(np.asarray(a)), list(args))
    tout = tfn(*targs)
    want = np.asarray(jout)
    assert tuple(tout.shape) == want.shape
    np.testing.assert_allclose(tout.detach().numpy(), want, rtol=0,
                               atol=tol * max(1.0, np.abs(want).max()))
    if not grads:
        return
    (tout * _t(w)).sum().backward()
    got = [t for i in floats for t in bridge.tree_leaves(targs[i])]
    for k, (t, g) in enumerate(zip(got, jax.tree_util.tree_leaves(jgrads))):
        g = np.asarray(g)
        grad = np.zeros_like(g) if t.grad is None else t.grad.numpy()
        np.testing.assert_allclose(grad, g, rtol=0, atol=tol * max(
            1.0, np.abs(g).max()), err_msg=f"gradient leaf {k}")


# --------------------------------------------------------------------------- #
# dot-product attention                                                       #
# --------------------------------------------------------------------------- #

E, H = 16, 4


def _like(shapes, seed, scale=0.3):
    """Seeded numpy leaves U(±scale) in the structure of ``shapes`` (a
    tree of shapes from ``jax.eval_shape`` of a JAX init, which does not
    run JAX's random ops eagerly)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32),
        shapes)


@pytest.fixture(scope="module")
def attn_params():
    return _like(jax.eval_shape(lambda k: jdot.dot_mhsa_init(k, E),
                                jax.random.PRNGKey(1)), 1)


@pytest.mark.parametrize("self_attn", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("need_weights", [False, True])
def test_dot_mhsa_matches_jax(rng, attn_params, self_attn, masked,
                              need_weights):
    """Self-attention (JAX's packed projection: query is key is value) and
    cross-attention (L = 5, S = 7), an additive mask shared by the heads,
    and the heads' mean weights."""
    L, S = (6, 6) if self_attn else (5, 7)
    q = rng.standard_normal((2, L, E)).astype(np.float32)
    kv = q if self_attn else rng.standard_normal((2, S, E)).astype(
        np.float32)
    mask = np.where(rng.uniform(size=(2, L, S)) < 0.3, -1e9, 0.0).astype(
        np.float32) if masked else None
    out_index = 1 if need_weights else 0

    def call(mod, params, q, kv, mask, same):
        key = value = q if same else kv
        out = mod.dot_mhsa(mod_params(mod, params), q, key, value, H,
                           mask=mask, need_weights=need_weights)
        return out[out_index]

    def mod_params(mod, params):
        cls = jattn.MHGSAParams if mod is jdot else tdot.MHGSAParams
        return cls(*params) if not isinstance(params, cls) else params

    args = (tuple(attn_params), q, kv) + ((mask,) if masked else ())

    def jfn(p, q, kv, *m):
        return call(jdot, p, q, kv, m[0] if m else None, self_attn)

    def tfn(p, q, kv, *m):
        return call(tdot, p, q, kv, m[0] if m else None, self_attn)

    _check(jfn, tfn, args)


def test_dot_attention_dropout_with_jax_s_mask_matches_jax(rng):
    """dot_attention with dropout 0.3: JAX's bernoulli keep-mask injected;
    output and weights, forward and backward; rate 0 is JAX's
    deterministic."""
    q, k, v = (rng.standard_normal((2, H, 5, 4)).astype(np.float32)
               for _ in range(3))
    key = jax.random.PRNGKey(3)
    keep = np.array(jax.random.bernoulli(key, 0.7, (2, H, 5, 5)))
    for part in (0, 1):
        _check(lambda q, k, v: jdot.dot_attention(
                   q, k, v, dropout_rate=0.3, dropout_key=key,
                   deterministic=False)[part],
               lambda q, k, v: tdot.dot_attention(
                   q, k, v, dropout_rate=0.3,
                   dropout_mask=torch.from_numpy(keep))[part], (q, k, v))
    _check(lambda q, k, v: jdot.dot_attention(q, k, v)[0],
           lambda q, k, v: tdot.dot_attention(q, k, v)[0], (q, k, v))
    assert tdot.dot_mhsa_init is not None and \
        tdot.dot_mhsa_init.__name__ == "mhgsa_init"


def test_dot_mhsa_dropout_draws_from_the_generator():
    p = tdot.dot_mhsa_init(torch.Generator().manual_seed(0), E)
    x = torch.randn(2, 6, E, generator=torch.Generator().manual_seed(1))
    outs = [tdot.dot_mhsa(p, x, x, x, H, dropout_rate=0.5,
                          generator=torch.Generator().manual_seed(s))[0]
            for s in (2, 2, 3)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])


# --------------------------------------------------------------------------- #
# Gumbel dictionaries and RelaxedOneHot                                       #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax_with_jax_s_draw_matches_jax(rng, hard):
    """JAX's Gumbel draw injected; hard is straight-through: the one-hot
    forward, the relaxed draw's gradient."""
    logits = rng.standard_normal((6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(0)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (6, 5))))
    _check(lambda lg: jgum.gumbel_softmax(key, lg, temperature=0.5,
                                          hard=hard),
           lambda lg: tgum.gumbel_softmax(lg, gumbel=g, temperature=0.5,
                                          hard=hard), (logits,))
    y = tgum.gumbel_softmax(torch.from_numpy(logits),
                            generator=torch.Generator().manual_seed(0),
                            hard=hard)
    np.testing.assert_allclose(y.sum(-1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(ValueError, match="gumbel shape"):
        tgum.gumbel_softmax(torch.from_numpy(logits), gumbel=g[:3])


def test_gumbel_draw_is_standard_gumbel():
    g = tdist.draw_gumbel((200_000,), generator=torch.Generator()
                          .manual_seed(0))
    assert torch.isfinite(g).all()
    # mean γ ≈ 0.5772, variance π²/6
    assert abs(float(g.mean()) - 0.5772) < 0.01
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.03


@pytest.fixture(scope="module")
def dict_params():
    return _like(jax.eval_shape(lambda k: jgum.mlp_dict_init(
        k, 12, [16], edge_types=4, embed_dim=6), jax.random.PRNGKey(0)), 2)


@pytest.mark.parametrize("part", [0, 1])
@pytest.mark.parametrize("hard", [True, False])
def test_mlp_dict_with_jax_s_params_and_draw_matches_jax(rng, dict_params,
                                                         part, hard):
    x = rng.standard_normal((7, 12)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, (7, 4))))
    _check(lambda p, x: jgum.mlp_dict(p, x, key, hard=hard)[part],
           lambda p, x: tgum.mlp_dict(p, x, gumbel=g, hard=hard)[part],
           (dict_params, x))


@pytest.mark.parametrize("part", [0, 1])
def test_mlp_dict_softmax_matches_jax(rng, dict_params, part):
    x = rng.standard_normal((7, 12)).astype(np.float32)
    _check(lambda p, x: jgum.mlp_dict_softmax(p, x)[part],
           lambda p, x: tgum.mlp_dict_softmax(p, x)[part], (dict_params, x))


def test_mlp_dict_init_matches_jax_s_structure():
    want = jax.tree_util.tree_leaves_with_path(jax.eval_shape(
        lambda k: jgum.mlp_dict_init(k, 12, [16, 8], edge_types=5),
        jax.random.PRNGKey(0)))
    got = bridge.tree_leaves_with_path(tgum.mlp_dict_init(
        torch.Generator().manual_seed(0), 12, [16, 8], edge_types=5))
    assert [(jax.tree_util.keystr(p), w.shape) for p, w in want] == \
        [("".join(f"[{k}]" if isinstance(k, int) else f"['{k}']"
                  for k in p), tuple(g.shape)) for p, g in got]


RELAXED = ["probs", "rsample", "sample", "kl_uniform", "kl", "mode"]


@pytest.mark.parametrize("what", RELAXED)
def test_relaxed_one_hot_matches_jax(rng, what):
    """Each member on the same logits [3, 4, 6] (temperature 0.3), JAX's
    Gumbel draw injected into rsample and sample (JAX's categorical is the
    Gumbel-max argmax of the same draw)."""
    logits = rng.standard_normal((3, 4, 6)).astype(np.float32)
    other = rng.standard_normal((3, 4, 6)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    g = torch.from_numpy(np.array(jax.random.gumbel(key, logits.shape)))

    def jfn(lg, o):
        d = jdist.RelaxedOneHot(lg, 0.3)
        return {"probs": lambda: d.probs, "rsample": lambda: d.rsample(key),
                "sample": lambda: d.sample(key), "mode": d.mode,
                "kl_uniform": d.kl,
                "kl": lambda: d.kl(jdist.RelaxedOneHot(o))}[what]()

    def tfn(lg, o):
        d = tdist.RelaxedOneHot(lg, 0.3)
        return {"probs": lambda: d.probs,
                "rsample": lambda: d.rsample(gumbel=g),
                "sample": lambda: d.sample(gumbel=g), "mode": d.mode,
                "kl_uniform": d.kl,
                "kl": lambda: d.kl(tdist.RelaxedOneHot(o))}[what]()

    _check(jfn, tfn, (logits, other),
           grads=what not in ("sample", "mode"))
    if what in ("sample", "rsample"):
        drawn = getattr(tdist.RelaxedOneHot(torch.from_numpy(logits)),
                        what)(torch.Generator().manual_seed(0))
        assert drawn.shape == logits.shape
        np.testing.assert_allclose(drawn.sum(-1).numpy(), 1.0, atol=1e-5)


# --------------------------------------------------------------------------- #
# the analysis toolbox                                                        #
# --------------------------------------------------------------------------- #

SIMILARITY = [("euclidean", True, True), ("euclidean", False, True),
              ("euclidean", True, False), ("cosine", True, True),
              ("cosine_v2", True, True)]


@pytest.mark.parametrize("metric,normalize,centering", SIMILARITY)
def test_compute_similarity_matches_jax(rng, metric, normalize, centering):
    x1 = rng.standard_normal((2, 5, 8)).astype(np.float32)
    x2 = rng.standard_normal((2, 7, 8)).astype(np.float32)
    kw = dict(metric=metric, normalize=normalize, centering=centering)
    _check(lambda a, b: jan.compute_similarity(a, b, **kw),
           lambda a, b: tan.compute_similarity(a, b, **kw), (x1, x2))


def test_compute_similarity_refuses_unknown_metrics():
    with pytest.raises(NotImplementedError, match="manhattan"):
        tan.compute_similarity(torch.zeros(1, 2, 3), torch.zeros(1, 2, 3),
                               metric="manhattan")


@pytest.mark.parametrize("fn", ["smooth_one_hot", "cross_entropy",
                                "compute_acc", "loss", "acc",
                                "loss_softmaxed"])
def test_label_smoothing_functions_match_jax(rng, fn):
    logits = rng.standard_normal((9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 9)
    soft = np.asarray(jax.nn.softmax(logits, axis=-1))
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 9)]
    jt, tt = {
        "smooth_one_hot": (lambda lb: jan.smooth_one_hot(lb, 5, 0.2),
                           lambda lb: tan.smooth_one_hot(lb, 5, 0.2)),
        "cross_entropy": (jan.cross_entropy, tan.cross_entropy),
        "compute_acc": (jan.compute_acc, tan.compute_acc),
        "loss": (lambda lg, lb: jan.label_smoothing_loss_acc(lg, lb, 5)[0],
                 lambda lg, lb: tan.label_smoothing_loss_acc(lg, lb, 5)[0]),
        "acc": (lambda lg, lb: jan.label_smoothing_loss_acc(lg, lb, 5)[1],
                lambda lg, lb: tan.label_smoothing_loss_acc(lg, lb, 5)[1]),
        "loss_softmaxed": (
            lambda lg, lb: jan.label_smoothing_loss_acc(
                lg, lb, 5, softmaxed=True)[0],
            lambda lg, lb: tan.label_smoothing_loss_acc(
                lg, lb, 5, softmaxed=True)[0]),
    }[fn]
    args = {"smooth_one_hot": (labels,), "cross_entropy": (logits, onehot),
            "compute_acc": (logits, onehot), "loss": (logits, labels),
            "acc": (logits, labels), "loss_softmaxed": (soft, labels)}[fn]
    _check(jt, tt, args, grads=fn not in ("smooth_one_hot", "compute_acc",
                                          "acc"))


def test_compute_confidence_interval_matches_jax(rng):
    data = rng.uniform(size=40)
    assert tan.compute_confidence_interval(data) == \
        jan.compute_confidence_interval(data)
    assert tan.compute_confidence_interval(list(data[:3])) == \
        jan.compute_confidence_interval(list(data[:3]))


@pytest.mark.parametrize("p", [2, 5])
def test_grassmann_distance_matches_jax(rng, p):
    x1 = rng.standard_normal((20, 8)).astype(np.float32)
    x2 = (x1 + 0.3 * rng.standard_normal((20, 8))).astype(np.float32)
    _check(lambda a, b: jan.grassmann_distance(a, b, p),
           lambda a, b: tan.grassmann_distance(a, b, p), (x1, x2), tol=1e-4)


# --------------------------------------------------------------------------- #
# the leftover names                                                          #
# --------------------------------------------------------------------------- #

def _jax_ckpt_dir(root, epochs, orphans=(), age=0.0):
    """JAX's layout: committed model_%04d directories with a config.json
    sidecar; orphans lack it."""
    for e in (*epochs, *orphans):
        d = os.path.join(root, jck.CKPT_FMT.format(e))
        os.makedirs(d)
        if e in epochs:
            open(os.path.join(d, "config.json"), "w").close()
        if age:
            os.utime(d, (time.time() - age,) * 2)


def _port_ckpt_dir(root, epochs, orphans=(), age=0.0):
    """The port's layout: model_%04d.pt files; a crashed save leaves its
    model_%04d.pt.tmp.<pid> behind."""
    os.makedirs(root, exist_ok=True)
    for e in epochs:
        open(tck.checkpoint_path(root, e), "w").close()
    for e in orphans:
        p = tck.checkpoint_path(root, e) + ".tmp.4242"
        open(p, "w").close()
        if age:
            os.utime(p, (time.time() - age,) * 2)


@pytest.mark.parametrize("keep_last", [0, 1, 2, 5, 9])
@pytest.mark.parametrize("age", [0.0, 3600.0])
def test_prune_checkpoints_removes_what_jax_removes(tmp_path, keep_last,
                                                    age):
    """The same epochs kept and removed as JAX's prune over its
    directories; crash debris (a JAX directory without sidecar, a port
    temporary file) swept only once older than the grace window."""
    epochs, orphans = [1, 2, 3, 5, 8], [9]
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_ckpt_dir(jdir, epochs, orphans, age)
    _port_ckpt_dir(tdir, epochs, orphans, age)
    jremoved = jck.prune_checkpoints(jdir, keep_last)
    tremoved = tck.prune_checkpoints(tdir, keep_last)

    def epochs_of(paths):
        return sorted(int(os.path.basename(p)[6:10]) for p in paths)

    assert epochs_of(tremoved) == epochs_of(jremoved)
    assert tck.checkpoint_epochs(tdir) == jck.checkpoint_epochs(jdir)
    assert all(not os.path.exists(p) for p in tremoved)
    assert (tck.checkpoint_path(tdir, 9) + ".tmp.4242" in tremoved) == \
        (age > tck.ORPHAN_GRACE_S)


def test_save_checkpoint_prunes_through_prune_checkpoints(tmp_path,
                                                          monkeypatch):
    from sttode_tpu_torch.models.sttode import STTODEConfig

    calls = []
    real = tck.prune_checkpoints
    monkeypatch.setattr(tck, "prune_checkpoints",
                        lambda d, k: calls.append(k) or real(d, k))
    opt = torch.optim.Adam([torch.zeros(2, requires_grad=True)], lr=1e-3)
    for e in range(1, 5):
        tck.save_checkpoint(str(tmp_path), e, {"w": torch.zeros(2)}, opt,
                            STTODEConfig(), keep_last=0 if e == 4 else 2)
    assert calls == [2, 2, 2, 1]
    assert tck.checkpoint_epochs(str(tmp_path)) == [4]


def _gru_cell_steps(mod, p, xs, h):
    """``mod.gru_cell`` stepped over the time axis: [B, T, H]."""
    ys = []
    for t in range(xs.shape[1]):
        h = mod.gru_cell(mod.GRUParams(*p), h, xs[:, t])
        ys.append(h)
    return ys


@pytest.mark.parametrize("form", ["cell", "cell_steps", "gru"])
def test_gru_cell_and_gru_match_jax(rng, form):
    """``gru_cell`` against JAX's ``gru_cell`` (one step, and stepped over
    the sequence against JAX's ``gru``), and ``gru`` against JAX's."""
    p = _like(jax.eval_shape(lambda k: jrec.gru_init(k, 6, 5),
                             jax.random.PRNGKey(0)), 3)
    xs = rng.standard_normal((4, 7, 6)).astype(np.float32)
    h = rng.standard_normal((4, 5)).astype(np.float32)
    if form == "cell":
        _check(lambda p, h, x: jrec.gru_cell(jrec.GRUParams(*p), h, x[:, 0]),
               lambda p, h, x: trec.gru_cell(trec.GRUParams(*p), h, x[:, 0]),
               (tuple(p), h, xs))
    elif form == "cell_steps":
        _check(lambda p, x, h: jrec.gru(jrec.GRUParams(*p), x, h)[0],
               lambda p, x, h: torch.stack(_gru_cell_steps(trec, p, x, h),
                                           dim=1),
               (tuple(p), xs, h))
    else:
        for part in (0, 1):
            _check(lambda p, x, h: jrec.gru(jrec.GRUParams(*p), x, h)[part],
                   lambda p, x, h: trec.gru(trec.GRUParams(*p), x, h)[part],
                   (tuple(p), xs, h))


def test_kaiming_normal_fan_out_and_zeros_match_jax():
    """The fan-out std √(2 / d_out) (JAX's and the port's samples agree in
    distribution: std within 3 %), and zeros in the initializers' call
    shape."""
    want = np.asarray(jcore.kaiming_normal_fan_out(jax.random.PRNGKey(0),
                                                   300, 200))
    got = tcore.kaiming_normal_fan_out(torch.Generator().manual_seed(0), 300,
                                       200)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    std = np.sqrt(2.0 / 200)
    assert abs(float(got.std()) / std - 1) < 0.03
    assert abs(float(want.std()) / std - 1) < 0.03
    assert abs(float(got.mean())) < 3 * std / np.sqrt(got.numel())
    z = tcore.zeros(None, 3, 4, dtype=torch.float64)
    assert z.dtype == torch.float64 and torch.equal(
        z, torch.from_numpy(np.asarray(jcore.zeros(None, 3, 4, dtype=
                                                   jnp.float32),
                                       np.float64)))


def test_adam_with_schedule_matches_jax_s(rng):
    """Two epochs of Adam at schedule(epoch), set_lr between them, moments
    kept: the same parameters as JAX's inject_hyperparams Adam (1e-6)."""
    sched = tsched.step_lr(1e-2, 1, 0.5)
    jsch = jsched.step_lr(1e-2, 1, 0.5)
    w0 = rng.standard_normal(5).astype(np.float32)
    grads = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    jopt = jsched.adam_with_schedule(jsch, epoch=0)
    jp, state = jnp.asarray(w0), None
    state = jopt.init(jp)
    tw = torch.tensor(w0, requires_grad=True)
    topt = tsched.adam_with_schedule(sched, epoch=0)([tw])
    for i, g in enumerate(grads):
        if i == 2:
            state = jsched.set_lr(state, jsch(1))
            tsched.set_lr(topt, sched(1))
        up, state = jopt.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, up)
        tw.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(jp),
                               atol=1e-6)


def test_native_available_and_kernel_exports():
    from sttode_tpu_torch import kernels, native

    assert native.native_available() is True
    assert set(kernels.__all__) == {"flash_geodesic_attention",
                                    "fused_geodesic_attention"}
