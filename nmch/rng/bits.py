"""Bit-level float construction shared by the RNG families.

Mosaic has no u32->f32 convert lowering, so every u32 -> f32 path
in the RNG layer goes through the exponent-bias bitcast below.  This
module is the single home for that trick; rng/mrg32k3a.py composes it
into a full-range u32 convert (two 16-bit halves), rng/xorwow.py uses
it directly on a 23-bit field.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

_F23 = np.float32(2.0 ** 23)


def splitmix64(x):
    """One splitmix64 step on host python ints: (new_x, output word).

    The shared (seed -> state-words) derivation for the stateful
    families' ``seed_state`` (rng/mrg32k3a.py, rng/xorwow.py) and the
    native validator's hashed per-path seeding
    (native/nmch_native.cpp::splitmix64_mix uses the same finalizer)."""
    x = (x + 0x9E3779B97F4A7C15) & (2**64 - 1)
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
    return x, z ^ (z >> 31)


def u23_to_f32(x):
    """Exact u32 (< 2^23) -> f32 without a convert op.

    ``x | 0x4B000000`` is the f32 bit pattern of ``2^23 + x`` for any
    ``x < 2^23`` (the implicit-one mantissa holds x verbatim at
    exponent 23); subtracting 2^23 is exact.  Bitwise-identical to
    XLA's own u32->f32 cast on this range, and it lowers through
    Mosaic where ``astype(float32)`` does not."""
    return (x | np.uint32(0x4B000000)).view(jnp.float32) - _F23
