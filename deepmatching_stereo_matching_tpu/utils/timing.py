"""One repo-wide device timing routine.

`steady_state` times a jitted call with the host clock around
`jax.block_until_ready`, after one warm-up call that compiles it.  Each
sample times `iters` back-to-back calls and ends when the last one's
outputs are ready, so the device work of every call in the sample is
inside the window.  A non-positive sample is an error, never a result.

Docs and artifacts quote `median` with its `min`/`max` spread; no
artifact quotes a single-shot number.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence


def steady_state(fn: Callable, args: Sequence, *, repeats: int = 5,
                 iters: int = 1) -> Dict[str, object]:
    """Median seconds per `fn(*args)` call on device.

    Returns {"median": s, "min": s, "max": s, "samples": [s, ...],
    "repeats": n, "iters": k}.  `fn` must return jax arrays (any
    pytree).  Raises RuntimeError if a sample is not positive.
    """
    import jax

    if repeats < 1 or iters < 1:
        raise ValueError("repeats and iters must be >= 1")
    jax.block_until_ready(fn(*args))  # compile + warm-up
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        if not dt > 0.0:
            raise RuntimeError(f"non-positive timing sample {dt!r} s")
        samples.append(dt)
    ordered = sorted(samples)
    n = len(ordered)
    median = ordered[n // 2] if n % 2 else (
        0.5 * (ordered[n // 2 - 1] + ordered[n // 2]))
    return {
        "median": median,
        "min": ordered[0],
        "max": ordered[-1],
        "samples": samples,
        "repeats": repeats,
        "iters": iters,
    }


def fmt(stats: Dict[str, object], unit_scale: float = 1e3,
        unit: str = "ms") -> str:
    """'median [min..max] unit' one-liner for logs."""
    return (f"{stats['median'] * unit_scale:.3f} "
            f"[{stats['min'] * unit_scale:.3f}.."
            f"{stats['max'] * unit_scale:.3f}] {unit}")
