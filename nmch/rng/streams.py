"""Persistent per-path RNG streams (the reference's curand-state contract).

In the reference, every simulation kernel loads its curand state from
global memory and writes it back at the end (``NMCH_FE.cu:29,81,303``;
``NMCH_EM.cu:154,280,368``) so that repeated ``compute()`` calls — e.g.
the exploration sweep (``exploration.cu:14-17``) — draw fresh,
non-overlapping randomness without re-initialization.

Counter-based equivalent: a stream is (seed, path_idx, epoch); the epoch
is bumped after every simulation call.  Nothing is stored per path — the
"state" is two integers — which is the whole point of counter-based RNG
on an accelerator: no state arrays to move through HBM (the reference
pays a 7 ms curand-init kernel + a state array read/write per launch;
we pay nothing).

Sharing note: two *methods* run with the same (seed, epoch) consume the
same stream plane — e.g. the batched sweeps assign point ``p`` epoch
``epoch0 + p``, so an FE and an EM sweep started at the same epoch0
overlap.  This matches the reference, where both methods init curand
with the same seed and subsequence layout (``exploration.cu:57-58``),
and is statistically harmless (the two estimators are never combined);
callers who want independence should give each method its own seed or
disjoint epoch ranges (``PathStreams.next_epoch`` does this within one
method object).
"""

from __future__ import annotations

import dataclasses

from .philox import split_seed


@dataclasses.dataclass
class PathStreams:
    """Tracks the epoch so successive compute() calls continue the streams."""

    seed: int
    n_paths: int
    epoch: int = 0

    def init(self, seed: int) -> None:
        """Reference ``init(seed)``: restart all streams from scratch."""
        self.seed = int(seed)
        self.epoch = 0

    def next_epoch(self) -> int:
        """Claim an epoch for one simulation call and advance."""
        e = self.epoch
        self.epoch += 1
        return e

    @property
    def key_words(self):
        return split_seed(self.seed)

    # -- checkpoint / resume ----------------------------------------------
    # The reference persists raw curand state arrays in device memory so
    # streams survive across kernel launches (NMCH_FE.cu:81,303); the
    # counter-based equivalent needs only (seed, epoch), so checkpointing
    # the RNG state of a billion-path run is two integers.
    def state_dict(self) -> dict:
        return {"seed": self.seed, "n_paths": self.n_paths,
                "epoch": self.epoch}

    @classmethod
    def from_state_dict(cls, d: dict) -> "PathStreams":
        return cls(seed=int(d["seed"]), n_paths=int(d["n_paths"]),
                   epoch=int(d["epoch"]))


def stateful_max_epoch(rng: str) -> int:
    """Per-family epoch bound for the skippable-stream (stateful)
    generators — both derive it from their own jump-exponent layout
    (PATH_LOG2 - EPOCH_LOG2 bits; 2^27 for both today, but each family
    owns its constant).  Single source for the method layer and the
    mesh sharding, so the bound cannot silently diverge between call
    sites."""
    if rng == "mrg32k3a":
        from .mrg32k3a import MAX_EPOCH
    elif rng == "xorwow":
        from .xorwow import MAX_EPOCH
    else:
        raise ValueError(f"{rng!r} is not a stateful family")
    return MAX_EPOCH
