"""The kernel wrappers' launch counters, read and moved as one.

Every wrapper counts its launches on function attributes whose names start
with ``launches``: an int, or a dict of ints (per metric, storage type or
mode). A wrapper counts where its host code launches, so a CUDA graph's
replay, which runs the recorded launches without the host code, counts
nothing by itself: ``train.graph`` takes a ``snapshot`` before and after a
capture, puts the counters back (a capture launches nothing) and ``add``s
the captured launches once a replay.
"""

from __future__ import annotations

from sttode_tpu_torch.kernels import mhgsa, packed_mhgsa, select_decode

WRAPPERS = (mhgsa.fused_geodesic_attention,
            mhgsa.fused_geodesic_attention_backward,
            mhgsa.flash_geodesic_attention,
            mhgsa.flash_geodesic_attention_backward,
            packed_mhgsa.packed_geodesic_attention,
            packed_mhgsa.packed_geodesic_attention_backward,
            select_decode.select_decode)


def snapshot() -> dict:
    """{(wrapper, attribute, key or None): count} of every counter."""
    out = {}
    for fn in WRAPPERS:
        for name, value in vars(fn).items():
            if not name.startswith("launches"):
                continue
            if isinstance(value, dict):
                out.update({(fn, name, k): v for k, v in value.items()})
            else:
                out[(fn, name, None)] = value
    return out


def delta(before: dict, after: dict) -> dict:
    """The counts ``after`` minus ``before``, nonzero entries only."""
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def add(counts: dict, times: int = 1) -> None:
    """Add ``counts`` × ``times`` to the counters."""
    for (fn, name, key), n in counts.items():
        if key is None:
            setattr(fn, name, getattr(fn, name) + n * times)
        else:
            getattr(fn, name)[key] += n * times


def restore(snap: dict) -> None:
    """Set every counter to its value in ``snap``."""
    add(delta(snapshot(), snap))
