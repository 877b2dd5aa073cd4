"""Sampler protocol: the path tracer's only interface to randomness.

The reference links the path-tracing kernel against a swappable RNG
compilation unit exposing one extern —
`float tinymt32_generate_floatOO(inout tinymt32_t)`
(l2n-renderer/src/shaders/sphere_pathtracing.cs.glsl:99, linked at
src/main.cpp:688). The analog here is a small Python object consumed while
tracing: `draw2`/`draw1` return float32 lane arrays strictly in (0, 1).

Stateful samplers (TinyMT, TausLCG) accept a `mask` so that only lanes that
would have consumed a draw in the reference's divergent control flow advance
their stream — this is what makes TinyMT parity mode produce the reference's
exact per-pixel sequences despite lockstep execution. The counter-based
threefry sampler ignores masks (draws are addressed, not consumed).
"""

from __future__ import annotations

import jax.numpy as jnp

from l2n.rng import tauslcg, tinymt
from l2n.rng.threefry import threefry2x32, uniform_oo_from_bits


class ThreefrySampler:
    """Counter-based: draw pair k of sample s of pixel p is
    threefry(key=(seed, stream), counter=(p, s * max_pairs + k)).

    `max_pairs` must bound the pairs drawn per sample (static, from config)
    so consecutive samples never collide.
    """

    stateful = False

    def __init__(self, seed, stream, pixel_index, sample_index, max_pairs: int):
        self._k0 = jnp.uint32(seed)
        self._k1 = jnp.uint32(stream)
        self._pixel = jnp.asarray(pixel_index, jnp.uint32)
        self._base = jnp.asarray(sample_index, jnp.uint32) * jnp.uint32(max_pairs)
        self._max_pairs = max_pairs
        self._pair = 0
        self._spare = None

    def draw2(self, mask=None):
        if self._pair >= self._max_pairs:
            raise RuntimeError(
                f"sampler budget exceeded: {self._pair + 1} pairs > max_pairs="
                f"{self._max_pairs}")
        b0, b1 = threefry2x32(self._k0, self._k1, self._pixel,
                              self._base + jnp.uint32(self._pair))
        self._pair += 1
        return uniform_oo_from_bits(b0), uniform_oo_from_bits(b1)

    def draw1(self, mask=None):
        # Single draws consume half a block; cache the sibling so paired
        # draw1 call sites (e.g. per-bounce Russian roulette) share one
        # threefry evaluation.
        if self._spare is not None:
            u, self._spare = self._spare, None
            return u
        u, self._spare = self.draw2(mask)
        return u

    def final_state(self):
        return None


def _masked(new, old, mask):
    if mask is None:
        return new
    return tuple(jnp.where(mask, n, o) for n, o in zip(new, old))


class TinyMTSampler:
    """Reference-parity sampler over per-pixel TinyMT32 states.

    Wraps `(status, params)` lane arrays; each draw steps only `mask` lanes,
    reproducing the reference's sequential, branch-dependent consumption
    (e.g. emissive lanes draw nothing, sphere_pathtracing.cs.glsl:285-309).
    """

    stateful = True

    def __init__(self, status: tinymt.State, params: tinymt.Params):
        self._status = status
        self._params = params

    def draw2(self, mask=None):
        return self.draw1(mask), self.draw1(mask)

    def draw1(self, mask=None):
        value, new_status = tinymt.generate_float_oo(self._status, self._params)
        self._status = _masked(new_status, self._status, mask)
        if mask is not None:
            # Unconsumed lanes must not see the value; zero is fine (they
            # also ignore it), but keep the draw well-defined.
            value = jnp.where(mask, value, jnp.float32(0.5))
        return value

    def final_state(self):
        return self._status


class TausLCGSampler:
    """Alternative stateful sampler (rand_TausLCG.cs.glsl:16-24)."""

    stateful = True

    def __init__(self, state: tauslcg.State):
        self._state = state

    def draw2(self, mask=None):
        return self.draw1(mask), self.draw1(mask)

    def draw1(self, mask=None):
        value, new_state = tauslcg.rand1(self._state)
        self._state = _masked(new_state, self._state, mask)
        if mask is not None:
            value = jnp.where(mask, value, jnp.float32(0.5))
        return value

    def final_state(self):
        return self._state


class MaskedSampler:
    """Wrap a sampler so every draw is additionally gated by `lane_mask` —
    used to restrict consumption to the pixels scheduled this step (only
    dispatched tiles execute in the reference, src/main.cpp:924)."""

    def __init__(self, inner, lane_mask):
        self._inner = inner
        self._mask = lane_mask
        self.stateful = inner.stateful

    def _and(self, mask):
        if mask is None:
            return self._mask
        return mask & self._mask

    def draw2(self, mask=None):
        return self._inner.draw2(self._and(mask))

    def draw1(self, mask=None):
        return self._inner.draw1(self._and(mask))

    def final_state(self):
        return self._inner.final_state()


def max_pairs_per_sample(max_bounces: int, nee: bool = False,
                         fog: bool = False) -> int:
    """Static threefry draw budget: 1 pair of pixel jitter + per bounce one
    hemisphere pair and one RR pair (the RR draw wastes its sibling), with
    one spare pair for AOV modes (ambient occlusion). NEE adds a light pick
    plus a surface-point pair per bounce; fog adds one collision-distance
    draw per path segment (max_bounces + 1 of them, budgeted one pair
    each)."""
    return (2 + (4 if nee else 2) * max_bounces
            + (max_bounces + 1 if fog else 0))
