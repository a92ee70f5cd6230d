"""Time integrators: explicit Euler and Rush-Larsen exponential gates.

Parity notes:
  * `rush_larsen` reproduces the reference's actually-implemented form
    (ionic.py:122-123), which is `g + (g - g_inf)*expm1(-dt/tau)` clipped to
    [1e-5, 0.99999] — NOT the textbook `g_inf - (g_inf - g)*exp(-dt/tau)`
    shown in its comment.  The two are algebraically equal but differ in
    float32 rounding; the clip floor matters (e.g. Courtemanche's `_u_` gate
    rests at 0 and is immediately clipped up to 1e-5).
  * The native CUDA sibling expresses the same update as a rate,
    `(g - g_inf)*expm1(-dt/tau)/dt` (courtemanche.h:287-292), calling it the
    NSFD method; `rush_larsen` is that rate pre-multiplied by dt.
"""

from __future__ import annotations

import jax.numpy as jnp

GATE_MIN = 0.00001
GATE_MAX = 0.99999


def euler(g, rate, dt):
    """Forward Euler step (reference court.py:115-116)."""
    return g + rate * dt


def adams_bashforth2(g, rate, rate_prev, dt):
    """Second-order Adams-Bashforth step:

        g' = g + dt * (3/2 * f_n - 1/2 * f_{n-1})

    The reference's native traits reserve 2x-VARIABLES parameter storage
    for exactly this scheme behind `#ifdef ADAMS_BASHFORTH`
    (ionic.h:15-19) but never implement it; here it is a real opt-in
    integrator (`SimConfig.ab2`) for the explicit-Euler state updates.
    Rush-Larsen gates keep their exponential form (AB2 does not apply).
    Models bootstrap f_{-1} with the reaction derivative of the initial
    state, so the first substep reduces to Euler up to the (initially
    tiny) diffusion term."""
    return g + dt * (1.5 * rate - 0.5 * rate_prev)


def rush_larsen(g, g_inf, g_tau, dt):
    """Rush-Larsen exponential integration of a gating variable.

    g' = clip(g + (g - g_inf) * expm1(-dt / tau), 1e-5, 0.99999)
    (reference ionic.py:115-123)
    """
    return jnp.clip(
        g + (g - g_inf) * jnp.expm1(-dt / g_tau), GATE_MIN, GATE_MAX
    )


def heaviside(x):
    """H(x) = (1 + sign(x)) / 2 — note H(0) = 0.5 (reference fenton.py:73-76)."""
    return (1.0 + jnp.sign(x)) * 0.5


def heaviside_neg(x):
    """G(x) = (1 - sign(x)) / 2 — note G(0) = 0.5 (reference fenton.py:78-79)."""
    return (1.0 - jnp.sign(x)) * 0.5
