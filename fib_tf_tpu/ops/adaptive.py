"""Adaptive-dt substeps via step-doubling (beyond reference parity).

The reference integrated explicit Euler at a fixed dt and silently rode
through blowups (its NaN check existed but was commented out,
reference ionic.py:208-212).  `SimConfig.dv_max` reproduces the pragmatic
guard (a |ΔV| clip, the court analog of BR's reference V-clip); THIS
module is the *correct* alternative: when a substep attempt is rejected,
it is re-taken as two half-dt substeps, recursively down to
dt / 2**adaptive_depth.  The refinement is a `lax.cond`, so the
half-dt branch only executes (and only costs) when triggered — during a
well-resolved run the adaptive step computes the same substeps as the
plain integrator (identical to within XLA fusion rounding: wrapping the
solve in a cond changes its fusion context, observed ≤1 ulp/step on a
single plane).

An attempt is rejected when any of:
  * the potential moved more than `adaptive_dv` millivolts anywhere;
  * any committed plane went non-finite (a substep can overflow straight
    to NaN within one evaluation — NaN compares false against any
    threshold, so finiteness is checked explicitly);
  * any committed plane in `model.positive_states` (ionic concentrations
    that feed Nernst logs) went non-positive.

The half-dt evaluations come from *clones* of the model built at the
scaled dt (`IonicModel.adaptive_clones`), so every dt-baked constant —
Chebyshev-folded Rush-Larsen multipliers, multi-rate dt_for schedules,
the w-gate quirk — is re-derived consistently rather than patched.
Courtemanche's slow-plane commit (effective dt x10) is wrapped too: the
Ca-release subsystem it carries is exactly where long fibrillatory runs
went stiff in the reference.

Single-chip feature: the shard_map halo exchange happens once per
*committed* substep, so a shard that refines locally would read stale
neighbor halos; `SimConfig.__post_init__` rejects adaptive_dv + mesh.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import jax
import jax.numpy as jnp

State = Dict[str, jnp.ndarray]


def default_accept(
    pot_key: str,
    thresh: float,
    committed: Sequence[str],
    positive: Sequence[str],
) -> Callable[[State, State], jnp.ndarray]:
    """Acceptance test for one substep attempt: ΔV bound + finiteness of
    every committed plane + positivity of committed concentration
    planes.  Returns a scalar bool (True = accept)."""
    pos = tuple(k for k in positive if k in committed)

    def accept(old: State, new: State) -> jnp.ndarray:
        ok = jnp.asarray(True)
        if pot_key in committed:
            dv = jnp.max(jnp.abs(new[pot_key] - old[pot_key]))
            ok = ok & (dv <= thresh)
        for k in committed:
            ok = ok & jnp.isfinite(new[k]).all()
        for k in pos:
            ok = ok & (new[k] > 0.0).all()
        return ok

    return accept


def make_adaptive_substep(
    models: Sequence,
    thresh: float,
    solve_fn: Optional[Callable] = None,
    commit_keys: Optional[Sequence[str]] = None,
) -> Callable[[State], State]:
    """Build a substep function with step-doubling refinement.

    `models` is `[full-dt model, dt/2 clone, dt/4 clone, ...]`;
    `solve_fn(model, state) -> new-state dict` evaluates one substep at
    that model's dt (default: the caller binds the geometry via a
    lambda); `commit_keys` restricts which planes commit (the
    Courtemanche fast/slow schedule commits only the fast planes on fast
    substeps and only the slow planes on the slow commit) — None commits
    everything `solve_fn` returns.

    The acceptance test applies at every level except the deepest, which
    commits unconditionally (raise `adaptive_depth` if it still fails —
    the engine's per-chunk finiteness check will catch it).
    """
    if solve_fn is None:
        raise ValueError("solve_fn must be provided (bind the geometry)")
    depth = len(models) - 1
    model = models[0]
    committed = tuple(commit_keys) if commit_keys is not None else tuple(
        model.state_keys()
    )
    accept = default_accept(
        model.pot_key, thresh, committed,
        getattr(model, "positive_states", ()),
    )

    def commit(state: State, s1: State) -> State:
        if commit_keys is None:
            return {**state, **s1}
        return {**state, **{k: s1[k] for k in commit_keys}}

    def substep(state: State, level: int = 0) -> State:
        new = commit(state, solve_fn(models[level], state))
        if level == depth:
            return new

        def refine(s):
            return substep(substep(s, level + 1), level + 1)

        return jax.lax.cond(accept(state, new), lambda s: new, refine, state)

    return substep
