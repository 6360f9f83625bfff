"""Wall-clock timing with proper device synchronization.

The reference brackets every init()/compute() with cudaEvent timers
(``NMCH_FE.cu:370-385,395-411``).  The equivalent here is wall timing
around ``jax.block_until_ready`` — dispatch is async, so the sync is
what makes the number honest (SURVEY.md §7 "honest timing").
"""

from __future__ import annotations

import time

import jax


class Timer:
    """Context manager: ``with Timer() as t: ...`` then ``t.ms``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self._t0) * 1e3
        return False


def timed_blocked(fn, *args, **kw):
    """Run fn, block on its outputs, return (result, elapsed_ms)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    out = jax.block_until_ready(out)
    return out, (time.perf_counter() - t0) * 1e3
