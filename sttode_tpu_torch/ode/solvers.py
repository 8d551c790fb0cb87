"""ODE solvers of the port (port of ``sttode_tpu/ode/solvers.py``).

The API is torchdiffeq's (``func(t, y, *args) -> dy/dt``; the solution is
stacked over a new leading time axis, ``ys[0] == y0``). States and args are
tensors or trees of them (dicts, lists, tuples, NamedTuples; leaves in the
JAX package's order, dict keys sorted).

- Fixed grid (euler, midpoint, rk4): the ``ts`` grid itself is the step
  grid (reference quirk Q1: Euler over [0, 12] is one step);
  ``checkpoint=True`` recomputes each step in the backward pass.
- dopri5: Dormand–Prince RK45 with FSAL, a PI step-size controller and the
  Hairer starting step, adaptive within each output interval. Time, step
  size and error ratio are float32 tensors on the state's device, as JAX
  keeps them, so the accept decisions and step counts follow JAX's. Two
  forms: the while form reads one accept/end decision to the host per
  attempt and cannot be differentiated through (as JAX's
  ``lax.while_loop``); the scan-budget form runs exactly ``scan_budget``
  attempts per interval with masked updates, never synchronizes until the
  end, and keeps t and h on the autograd graph, so its gradient is JAX's
  scan-form gradient.
- ``odeint_adjoint``: O(1)-memory gradients by the continuous adjoint (the
  augmented system integrated backward in time, interval by interval), a
  ``torch.autograd.Function`` over y0 and the args' leaves.

Under data parallelism (``group``: the process group over whose ranks the
state's rows are split, every rank holding an equal block) dopri5's error
norms are those of the whole state: each rank's sum of squares is summed
over the group (``collectives.psum``, whose backward sums the cotangent's
shares) and the count is every rank's. Every rank then takes the same
step sizes, accept decisions and RHS evaluations, which keeps the
collectives inside the RHS in step (a rank that decided otherwise would
wait at the next one). The adjoint's parameter cotangent is a sum over
every rank's rows: its VJP is all-reduced at each evaluation, so that
every rank integrates the whole sum, whose norm counts it once; the
backward returns it on the group's rank 0 and zeros elsewhere, so that
the gradient shares still sum to it.

Adaptive solves pin float32 matmuls (no TF32) unless told otherwise: low
precision RHS matmuls put a noise floor under the embedded-pair error
estimate, and at tight tolerances the controller then shrinks h against
noise that does not shrink with h. The JAX package measured its TPU's
bf16 matmuls inflating the step count about 110× at rtol 1e-7. The scope
covers the solve; a backward pass that autograd runs after it uses the
ambient setting (float32 by default in PyTorch).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint as _checkpoint

from sttode_tpu_torch.parallel import collectives

Tree = Any

_FIXED_METHODS = ("euler", "midpoint", "rk4")
_ADAPTIVE_METHODS = ("dopri5",)
_ADAPTIVE_DEFAULT_PRECISION = "float32"
# JAX precision names → torch.set_float32_matmul_precision
_PRECISIONS = {"float32": "highest", "highest": "highest",
               "tensorfloat32": "high", "high": "high",
               "bfloat16": "medium"}


@contextlib.contextmanager
def matmul_precision(precision: str):
    """Scope the float32 matmul precision: "float32" (also "highest") turns
    TF32 off for cuBLAS and cuDNN, "tensorfloat32" ("high") allows TF32,
    "bfloat16" maps to "medium", "inherit" changes nothing. The previous
    settings are restored on exit, exceptions included."""
    if precision == "inherit":
        yield
        return
    if precision not in _PRECISIONS:
        raise ValueError(f"matmul_precision {precision!r}: expected one of "
                         f"{sorted(_PRECISIONS) + ['inherit']}")
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision(_PRECISIONS[precision])
        if _PRECISIONS[precision] == "highest":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.backends.cudnn.allow_tf32 = saved[2]


def _precision_scope(precision: str | None, method: str):
    if precision is None:
        precision = (_ADAPTIVE_DEFAULT_PRECISION
                     if method in _ADAPTIVE_METHODS else "inherit")
    return matmul_precision(precision)


# --------------------------------------------------------------------------- #
# trees as flat lists of tensors                                              #
# --------------------------------------------------------------------------- #

def _flatten(tree) -> tuple[list, Any]:
    """(leaves, spec); ``_unflatten(spec, leaves)`` rebuilds the tree."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        subs = [_flatten(tree[k]) for k in keys]
        return [x for s in subs for x in s[0]], (dict, keys,
                                                 [s[1] for s in subs])
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v) for v in tree]
        return [x for s in subs for x in s[0]], (type(tree), None,
                                                 [s[1] for s in subs])
    return [tree], None


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return next(it)
        kind, keys, subs = sp
        vals = [build(s) for s in subs]
        if kind is dict:
            return dict(zip(keys, vals))
        if hasattr(kind, "_fields"):
            return kind(*vals)
        return kind(vals)
    return build(spec)


def _flat_func(func: Callable, spec, args: tuple) -> Callable:
    def f(t, ys: list) -> list:
        return _flatten(func(t, _unflatten(spec, ys), *args))[0]
    return f


def _axpy(a, xs: list, ys: list) -> list:
    """ys + a·xs, leaf by leaf."""
    return [y + a * x for x, y in zip(xs, ys)]


# --------------------------------------------------------------------------- #
# fixed grid                                                                  #
# --------------------------------------------------------------------------- #

def _euler_step(f, t0, dt, y0):
    return _axpy(dt, f(t0, y0), y0)


def _midpoint_step(f, t0, dt, y0):
    k1 = f(t0, y0)
    k2 = f(t0 + dt / 2, _axpy(dt / 2, k1, y0))
    return _axpy(dt, k2, y0)


def _rk4_step(f, t0, dt, y0):
    k1 = f(t0, y0)
    k2 = f(t0 + dt / 2, _axpy(dt / 2, k1, y0))
    k3 = f(t0 + dt / 2, _axpy(dt / 2, k2, y0))
    k4 = f(t0 + dt, _axpy(dt, k3, y0))
    incr = [a + 2.0 * b + 2.0 * c + d for a, b, c, d in zip(k1, k2, k3, k4)]
    return _axpy(dt / 6, incr, y0)


_STEPPERS = {"euler": _euler_step, "midpoint": _midpoint_step,
             "rk4": _rk4_step}
_FIXED_EVALS = {"euler": 1, "midpoint": 2, "rk4": 4}


def _fixed_odeint(f, y0: list, ts: torch.Tensor, method: str,
                  checkpoint: bool) -> list:
    """Each step size is the float32 difference of neighbouring grid
    points, as in the JAX solver; the grid is read on the host, and ``func``
    sees t as a 0-dim CPU tensor."""
    stepper = _STEPPERS[method]
    t_host = ts.detach().to("cpu")
    t = list(t_host)
    dts = (t_host[1:] - t_host[:-1]).tolist()
    ys = [list(y0)]
    for t0, dt in zip(t[:-1], dts):
        if checkpoint:
            def step(*y, t0=t0, dt=dt):
                return tuple(stepper(f, t0, dt, list(y)))
            ys.append(list(_checkpoint(step, *ys[-1], use_reentrant=False)))
        else:
            ys.append(stepper(f, t0, dt, ys[-1]))
    return [torch.stack(leaf) for leaf in zip(*ys)]


# --------------------------------------------------------------------------- #
# dopri5 (Dormand–Prince RK45, FSAL, PI controller)                           #
# --------------------------------------------------------------------------- #

_DOPRI_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DOPRI_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DOPRI_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DOPRI_E = (71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525,
            -1 / 40)

_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
_ORDER = 5.0


def _dopri5_single_step(f, t0, h, y0: list, k1: list):
    """One RK45 step → (y5, err, k7), k7 = f(t0 + h, y5) for FSAL. The
    5th-order solution is the stage-7 state (row 7 of A is B), and a zero
    coefficient adds nothing, so both are skipped."""
    ks = [k1]
    y_stage = y0
    for stage in range(1, 7):
        y_stage = y0
        for a_coef, k in zip(_DOPRI_A[stage], ks):
            if a_coef:
                y_stage = _axpy(h * a_coef, k, y_stage)
        ks.append(f(t0 + _DOPRI_C[stage] * h, y_stage))
    err = None
    for e_coef, k in zip(_DOPRI_E, ks):
        if e_coef:
            err = [(h * e_coef) * x for x in k] if err is None else \
                _axpy(h * e_coef, k, err)
    return y_stage, err, ks[6]


def _mean_square(rs: list, group, shared: int) -> torch.Tensor:
    """Σ r² / count over every element of ``rs``. With ``group`` the leaves
    but the last ``shared`` are each rank's rows of the state, summed and
    counted over the group's ranks; the last ``shared`` are alike on every
    rank and counted once."""
    own = len(rs) - shared if group is not None else len(rs)
    total = None
    count = 0
    for r in rs[:own]:
        s = torch.sum(r * r)
        total = s if total is None else total + s
        count += r.numel()
    if group is not None:
        total = collectives.psum(total, group)
        count *= dist.get_world_size(group)
        for r in rs[own:]:
            total = total + torch.sum(r * r)
            count += r.numel()
    return total / count


def _error_ratio(err: list, y0: list, y1: list, rtol: float, atol: float,
                 group=None, shared: int = 0) -> torch.Tensor:
    """RMS of err / (atol + rtol·max(|y0|, |y1|)) over every element (of
    every rank's rows under ``group``, see ``_mean_square``)."""
    rs = [(e / (atol + rtol * torch.maximum(a.abs(), b.abs())))
          .to(torch.float32) for e, a, b in zip(err, y0, y1)]
    # the 1e-30 keeps sqrt's derivative finite at err == 0 (a discarded
    # where-branch of the scan form would otherwise poison the gradient)
    return torch.sqrt(_mean_square(rs, group, shared) + 1e-30)


def _rms(xs: list, y_ref: list, rtol: float, atol: float, group=None,
         shared: int = 0) -> torch.Tensor:
    rs = [(x / (atol + rtol * yr.abs())).to(torch.float32)
          for x, yr in zip(xs, y_ref)]
    # same guard as _error_ratio: a constant field makes the probe's
    # difference exactly 0 on the differentiated path
    return torch.sqrt(_mean_square(rs, group, shared) + 1e-30)


def _initial_step(f, t0, y0: list, f0: list, direction, rtol: float,
                  atol: float, group=None, shared: int = 0) -> torch.Tensor:
    """Hairer/Nørsett/Wanner starting step (Solving ODEs I, §II.4): one
    extra RHS evaluation probes the local Lipschitz scale."""
    d0 = _rms(y0, y0, rtol, atol, group, shared)
    d1 = _rms(f0, y0, rtol, atol, group, shared)
    h0 = torch.where(torch.minimum(d0, d1) < 1e-5, 1e-6,
                     0.01 * d0 / (d1 + 1e-30))
    y1 = _axpy(h0 * direction, f0, y0)
    f1 = f(t0 + h0 * direction, y1)
    d2 = _rms([a - b for a, b in zip(f1, f0)], y0, rtol, atol, group,
              shared) / h0
    dm = torch.maximum(d1, d2)
    # floored so that the discarded branch's power stays finite
    h1 = torch.where(dm <= 1e-15, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.clamp(dm, min=1e-15)) ** (1.0 / _ORDER))
    return torch.minimum(100.0 * h0, h1)


def _factor(ratio: torch.Tensor) -> torch.Tensor:
    return torch.clamp(
        _SAFETY * torch.clamp(ratio, min=1e-10) ** (-1.0 / _ORDER),
        _MIN_FACTOR, _MAX_FACTOR)


def _end_tol(t1: torch.Tensor) -> torch.Tensor:
    # 1e-6 relative keeps the loop terminating under float32 time arithmetic
    return 1e-6 * torch.clamp(t1.abs(), min=1.0)


def _dopri5_interval(f, y0: list, k1: list, t0, t1, rtol, atol,
                     max_steps: int, group=None, shared: int = 0):
    """The while form over one output interval [t0, t1] (either direction):
    one host read per attempt (its accept decision and whether the interval
    would then be done; under ``group`` read off the all-reduced norm, alike
    on every rank). Returns (y(t1), k1 at t1, (attempted, accepted, done))
    with host counts."""
    direction = torch.sign(t1 - t0)
    h = torch.minimum(_initial_step(f, t0, y0, k1, direction, rtol, atol,
                                    group, shared), (t1 - t0).abs())
    tol = _end_tol(t1)
    t, y = t0, y0
    active = bool((t1 - t).abs() > tol)
    n = n_acc = 0
    while active and n < max_steps:
        h_clip = torch.minimum(h, (t1 - t).abs()) * direction
        y_new, err, k7 = _dopri5_single_step(f, t, h_clip, y, k1)
        ratio = _error_ratio(err, y, y_new, rtol, atol, group, shared)
        h = h_clip.abs() * _factor(ratio)
        t_new = t + h_clip
        accept, still = torch.stack(
            [ratio <= 1.0, (t1 - t_new).abs() > tol]).tolist()
        n += 1
        if accept:
            t, y, k1 = t_new, y_new, k7
            n_acc += 1
            active = still
    return y, k1, (n, n_acc, not active)


def _dopri5_interval_scan(f, y0: list, k1: list, t0, t1, rtol, atol,
                          budget: int, group=None, shared: int = 0):
    """The scan-budget form: exactly ``budget`` attempts with masked
    updates once the interval is done; the same control law as the while
    form, so the accepted steps are the same. No host read; t, h and the
    ratio stay on the autograd graph. Returns (y(t1), k1 at t1,
    (attempted, accepted, done)) as device tensors."""
    direction = torch.sign(t1 - t0)
    h = torch.minimum(_initial_step(f, t0, y0, k1, direction, rtol, atol,
                                    group, shared), (t1 - t0).abs())
    tol = _end_tol(t1)
    t, y = t0, y0
    n = n_acc = torch.zeros((), dtype=torch.int32, device=t0.device)
    for _ in range(budget):
        active = (t1 - t).abs() > tol
        # double where: once done, a safe nonzero h feeds the discarded
        # step, so that its error ratio and gradient stay finite
        h_clip = torch.where(active, torch.minimum(h, (t1 - t).abs()),
                             1.0) * direction
        y_new, err, k7 = _dopri5_single_step(f, t, h_clip, y, k1)
        ratio = _error_ratio(err, y, y_new, rtol, atol, group, shared)
        accept = torch.logical_and(ratio <= 1.0, active)
        t = torch.where(accept, t + h_clip, t)
        h = torch.where(active, h_clip.abs() * _factor(ratio), h)
        y = [torch.where(accept, b, a) for a, b in zip(y, y_new)]
        k1 = [torch.where(accept, b, a) for a, b in zip(k1, k7)]
        n = n + active.to(torch.int32)
        n_acc = n_acc + accept.to(torch.int32)
    return y, k1, (n, n_acc, (t1 - t).abs() <= tol)


def _capturing(t: torch.Tensor) -> bool:
    """Whether ``t``'s device stream is being captured into a CUDA graph."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


# the bool device tensor that a capture's scan-form solves OR their
# exhaustion into (module-wide: autograd runs a captured backward, the
# adjoint's solves included, on its own thread)
_EXHAUSTED: torch.Tensor | None = None


@contextlib.contextmanager
def exhaustion_flag(flag: torch.Tensor):
    """Inside, a scan-form dopri5 solve that is captured into a CUDA graph
    ORs whether its budget ran out into ``flag`` (a 0-dim bool tensor on
    the device, made before the capture), in place and on the device; the
    graph's owner reads it after replays (``warn_exhausted``)."""
    global _EXHAUSTED
    prev, _EXHAUSTED = _EXHAUSTED, flag
    try:
        yield flag
    finally:
        _EXHAUSTED = prev


def warn_exhausted(kind: str, budget: int, stacklevel: int = 2) -> None:
    """The warning of a dopri5 solve whose ``kind`` budget ran out."""
    # otherwise silent: the state stops advancing mid-interval
    warnings.warn(
        f"sttode_tpu_torch.ode: dopri5 {kind}={budget} exhausted before "
        f"reaching an interval end — the returned trajectory (and any "
        f"gradients through it) is truncated mid-interval; raise {kind} "
        f"or loosen rtol/atol", RuntimeWarning, stacklevel=stacklevel + 1)


def _dopri5_odeint(f, y0: list, ts: torch.Tensor, rtol, atol,
                   max_steps: int, scan_budget: int | None, group=None,
                   shared: int = 0):
    """→ (per-leaf solutions stacked over ts, stats); ``group`` and
    ``shared`` as in ``_mean_square``."""
    k1 = f(ts[0], y0)
    ys = [y0]
    counts = []
    y = y0
    for i in range(ts.shape[0] - 1):
        if scan_budget is not None:
            y, k1, c = _dopri5_interval_scan(f, y, k1, ts[i], ts[i + 1],
                                             rtol, atol, scan_budget, group,
                                             shared)
        else:
            y, k1, c = _dopri5_interval(f, y, k1, ts[i], ts[i + 1], rtol,
                                        atol, max_steps, group, shared)
        ys.append(y)
        counts.append(c)
    if scan_budget is not None and _capturing(ts):
        # under a CUDA graph capture the counts stay on the device: the
        # steps are not read, and exhaustion is ORed into the capture's
        # flag (``exhaustion_flag``) for its owner to warn of
        exhausted = torch.logical_not(torch.stack([c[2] for c in counts])
                                      .all())
        if _EXHAUSTED is not None:
            _EXHAUSTED.logical_or_(exhausted)
        n_intervals = ts.shape[0] - 1
        return [torch.stack(leaf) for leaf in zip(*ys)], {
            "attempted_steps": None, "accepted_steps": None,
            "rhs_evals": 1 + n_intervals * (1 + 6 * scan_budget),
            "budget_exhausted": exhausted}
    if scan_budget is not None:
        # the one host read of the scan form
        flat = torch.stack([torch.stack([a, b, d.to(torch.int32)])
                            for a, b, d in counts]).tolist()
        counts = [(a, b, bool(d)) for a, b, d in flat]
    att = sum(c[0] for c in counts)
    exhausted = not all(c[2] for c in counts)
    budget = scan_budget if scan_budget is not None else max_steps
    kind = "scan_budget" if scan_budget is not None else "max_steps"
    if exhausted:
        warn_exhausted(kind, budget, stacklevel=3)
    n_intervals = ts.shape[0] - 1
    # 1 initial k1, per interval 1 starting-step probe, and 6 per attempt
    # (FSAL reuses k7 only on accept); the scan form evaluates all 6 stages
    # of every attempt in its budget, done or not
    evals = (6 * scan_budget * n_intervals if scan_budget is not None
             else 6 * att)
    stats = {"attempted_steps": att,
             "accepted_steps": sum(c[1] for c in counts),
             "rhs_evals": 1 + n_intervals + evals,
             "budget_exhausted": exhausted}
    return [torch.stack(leaf) for leaf in zip(*ys)], stats


# --------------------------------------------------------------------------- #
# public API                                                                  #
# --------------------------------------------------------------------------- #

def _as_ts(ts, like: torch.Tensor, method: str) -> torch.Tensor:
    """``ts`` in float32 (float64 for a float64 state, as JAX's x64 mode
    keeps it); on the state's device for dopri5's time arithmetic, where it
    is for the fixed grid, which reads it on the host."""
    dtype = torch.float64 if like.dtype == torch.float64 else torch.float32
    ts = torch.as_tensor(ts, dtype=dtype)
    return ts.to(like.device) if method in _ADAPTIVE_METHODS else ts


def _requires_grad(*trees) -> bool:
    return any(isinstance(x, torch.Tensor) and x.requires_grad
               for tree in trees for x in _flatten(tree)[0])


def odeint(func: Callable, y0: Tree, ts, *args, method: str = "euler",
           rtol: float = 1e-7, atol: float = 1e-9, max_steps: int = 10_000,
           checkpoint: bool = False, return_stats: bool = False,
           scan_budget: int | None = None,
           matmul_precision: str | None = None, group=None):
    """Integrate ``dy/dt = func(t, y, *args)``, reporting y at each ``ts``.

    Fixed-grid methods (euler/midpoint/rk4) step on ``ts`` itself
    (``checkpoint=True`` recomputes each step in the backward pass).
    ``dopri5`` adapts within each output interval: the while form
    (``scan_budget=None``, at most ``max_steps`` attempts an interval) or
    exactly ``scan_budget`` attempts an interval, the form to differentiate
    through (the while form raises ValueError under autograd: use the scan
    form or :func:`odeint_adjoint`). ``return_stats=True`` returns
    ``(ys, stats)``: attempted and accepted steps, RHS evaluations and
    ``budget_exhausted`` (Python values; while a CUDA graph is captured,
    the scan form reads nothing: its steps are None, ``budget_exhausted``
    a 0-dim device tensor, also ORed into an ``exhaustion_flag``).
    Exhaustion also warns.
    ``matmul_precision``: None pins adaptive methods to "float32" and
    leaves fixed-grid ones on the ambient setting; or "float32",
    "tensorfloat32", "bfloat16" or "inherit" (see :func:`matmul_precision`).
    ``group``: the process group over whose ranks y's rows are split (data
    parallelism; each rank passes its block): dopri5's error norms are then
    the whole state's, and every rank takes the same steps.
    """
    y_leaves, spec = _flatten(y0)
    ts = _as_ts(ts, y_leaves[0], method)
    f = _flat_func(func, spec, args)
    if method in _FIXED_METHODS:
        with _precision_scope(matmul_precision, method):
            ys = _fixed_odeint(f, y_leaves, ts, method, checkpoint)
        n = ts.shape[0] - 1
        stats = {"attempted_steps": n, "accepted_steps": n,
                 "rhs_evals": _FIXED_EVALS[method] * n,
                 "budget_exhausted": False}
    elif method in _ADAPTIVE_METHODS:
        if scan_budget is None and torch.is_grad_enabled() and \
                _requires_grad(y0, args):
            raise ValueError(
                "dopri5's while form (scan_budget=None) cannot be "
                "differentiated through, as JAX's lax.while_loop cannot: "
                "set a scan budget (ode_scan_budget > 0) for direct "
                "gradients, use the adjoint (ode_adjoint=True), or run "
                "without gradients")
        if scan_budget is not None and scan_budget < 1:
            raise ValueError(f"scan_budget {scan_budget} must be >= 1")
        with _precision_scope(matmul_precision, method):
            ys, stats = _dopri5_odeint(f, y_leaves, ts, rtol, atol,
                                       max_steps, scan_budget, group)
    else:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_FIXED_METHODS + _ADAPTIVE_METHODS}")
    ys = _unflatten(spec, ys)
    return (ys, stats) if return_stats else ys


class _AdjointOdeint(torch.autograd.Function):
    """y0 leaves and args leaves → solution leaves stacked over ts; the
    backward integrates the augmented system (y, a_y, a_args)."""

    @staticmethod
    def forward(ctx, opts: dict, *tensors):
        n_y = opts["n_y"]
        y0, leaves = list(tensors[:n_y]), list(tensors[n_y:])
        f = _flat_func(opts["func"], opts["spec_y"],
                       _unflatten(opts["spec_args"], leaves))
        with torch.no_grad():
            ys = _solve_flat(f, y0, opts, opts["scan_budget"], 0)
        ctx.opts = opts
        ctx.save_for_backward(*ys, *leaves)
        return tuple(ys)

    @staticmethod
    def backward(ctx, *g):
        opts = ctx.opts
        n_y, ts = opts["n_y"], opts["ts"]
        saved = ctx.saved_tensors
        ys, leaves = saved[:n_y], [p.detach() for p in saved[n_y:]]
        func, spec_y, spec_args = (opts["func"], opts["spec_y"],
                                   opts["spec_args"])

        def aug_dynamics(t, state: list) -> list:
            # dy/dt = f, da/dt = −aᵀ ∂f/∂y, da_args/dt = −aᵀ ∂f/∂args; time
            # runs backward through a decreasing ts
            y, a_y = state[:n_y], state[n_y:2 * n_y]
            with torch.enable_grad():
                y_in = [v.detach().requires_grad_() for v in y]
                p_in = [p.requires_grad_() for p in map(torch.Tensor.detach,
                                                        leaves)]
                f_val = _flatten(func(t, _unflatten(spec_y, y_in),
                                      *_unflatten(spec_args, p_in)))[0]
                inputs = y_in + p_in
                if any(v.requires_grad for v in f_val):
                    vjp = torch.autograd.grad(
                        [v for v in f_val if v.requires_grad], inputs,
                        [-a for a, v in zip(a_y, f_val) if v.requires_grad],
                        allow_unused=True)
                else:
                    vjp = [None] * len(inputs)
            return [v.detach() for v in f_val] + [
                torch.zeros_like(x) if d is None else d
                for d, x in zip(vjp, inputs)]

        # the augmented state travels as one flat buffer, so that the
        # solver's arithmetic is a few launches an operation, not a few per
        # parameter leaf (its error ratio sums the same elements); under a
        # group as two, this rank's rows (y, a_y) and the parameter
        # cotangent that every rank holds alike
        group = opts["group"]
        parts = [y[0] for y in ys] * 2 + leaves
        sizes = [x.numel() for x in parts]
        shapes = [x.shape for x in parts]
        n_own = sum(sizes[:2 * n_y])

        def unpack(flat):
            return [c.view(sh) for c, sh in zip(torch.split(flat, sizes),
                                                shapes)]

        def pack(xs):
            return torch.cat([x.reshape(-1) for x in xs])

        def aug_flat(t, state: list) -> list:
            flat = state[0] if group is None else torch.cat(state)
            out = pack(aug_dynamics(t, unpack(flat)))
            if group is None:
                return [out]
            own, args = torch.split(out, [n_own, out.numel() - n_own])
            return [own, collectives.all_reduce(args.clone(), group)]

        def split(flat):
            return [flat] if group is None else list(torch.split(
                flat, [n_own, flat.numel() - n_own]))

        y_bar = [gi[-1] for gi in g]
        args_bar = [torch.zeros_like(p) for p in leaves]
        budget = opts["scan_budget"]
        for i in range(ts.shape[0] - 2, -1, -1):
            aug0 = split(pack([y[i + 1] for y in ys] + y_bar + args_bar))
            aug_opts = dict(opts, ts=torch.stack([ts[i + 1], ts[i]]))
            # the reversed augmented system is stiffer than the forward
            # solve and re-adapts from scratch: twice the budget
            with torch.no_grad():
                out = _solve_flat(aug_flat, aug0, aug_opts,
                                  None if budget is None else 2 * budget,
                                  len(aug0) - 1)
            final = unpack(torch.cat([o[-1] for o in out]))
            y_bar = [a + gi[i] for a, gi in zip(final[n_y:2 * n_y], g)]
            args_bar = final[2 * n_y:]
        if group is not None and dist.get_rank(group) != 0:
            # every rank holds the whole parameter cotangent: rank 0 gives
            # it, so that the ranks' gradient shares sum to it once
            args_bar = [torch.zeros_like(a) for a in args_bar]
        return (None, *y_bar, *args_bar)


def _solve_flat(f, y0: list, opts: dict, scan_budget, shared: int) -> list:
    with _precision_scope(opts["matmul_precision"], opts["method"]):
        if opts["method"] in _FIXED_METHODS:
            return _fixed_odeint(f, y0, opts["ts"], opts["method"], False)
        return _dopri5_odeint(f, y0, opts["ts"], opts["rtol"], opts["atol"],
                              opts["max_steps"], scan_budget, opts["group"],
                              shared)[0]


def odeint_adjoint(func: Callable, y0: Tree, ts, *args,
                   method: str = "dopri5", rtol: float = 1e-7,
                   atol: float = 1e-9, max_steps: int = 10_000,
                   scan_budget: int | None = None,
                   matmul_precision: str | None = None, group=None) -> Tree:
    """Like :func:`odeint`, with O(1)-memory continuous-adjoint gradients.

    Differentiable in ``y0`` and the tensors of ``*args`` (parameter
    trees, of y0's dtype); ``ts`` is a constant, and a tensor ``func``
    closes over gets no gradient. The forward solve runs without autograd;
    the backward pass integrates ``[y, a_y, a_args]`` backward in time one
    output interval at a time, each from the stored y at its end, with the
    same solver settings (the scan form with twice the budget), adding each
    output time's cotangent. Without a gradient to take it is
    :func:`odeint`. ``group`` as in :func:`odeint`; the args' cotangent is
    then the whole sum over the ranks, returned on the group's rank 0 and
    as zeros on the others (the module's docstring).
    """
    if method not in _FIXED_METHODS + _ADAPTIVE_METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{_FIXED_METHODS + _ADAPTIVE_METHODS}")
    kw = dict(method=method, rtol=rtol, atol=atol, max_steps=max_steps,
              scan_budget=scan_budget, matmul_precision=matmul_precision,
              group=group)
    if not (torch.is_grad_enabled() and _requires_grad(y0, args)):
        with torch.no_grad():
            return odeint(func, y0, ts, *args, **kw)
    y_leaves, spec_y = _flatten(y0)
    arg_leaves, spec_args = _flatten(args)
    opts = dict(kw, func=func, spec_y=spec_y, spec_args=spec_args,
                n_y=len(y_leaves), ts=_as_ts(ts, y_leaves[0], method))
    ys = _AdjointOdeint.apply(opts, *y_leaves, *arg_leaves)
    return _unflatten(spec_y, list(ys))
