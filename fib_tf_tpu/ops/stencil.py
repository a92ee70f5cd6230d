"""Finite-difference grid operators.

Pure `jnp` functions over `[H, W]` arrays; everything here traces into a
single fused XLA computation under `jax.jit` (the equivalent of the
reference's `experimental_jit_scope` fusion clusters).

Behavioral parity targets (see SURVEY.md appendix):
  * `laplace`      — 9-point stencil, diagonals x0.5, center -6, REFLECT
                     padding (reference ionic.py:44-60).
  * `enforce_boundary` — SYMMETRIC pad of the interior; border cells are
                     overwritten by their inner neighbors every step
                     (reference ionic.py:107-113).
  * `phase_field_correction` — (∇X·∇ϕ)/(4ϕ) central-difference term on
                     REFLECT-padded arrays (reference ionic.py:70-81).
  * `add_hole_to_phase_field` — tanh-profile holes, floor 1e-5
                     (reference ionic.py:83-105).
  * `pace_mask` / `apply_pace` — stimulation masks for the 8 named locations
                     and `max(pot, mask)` firing (reference ionic.py:125-163).
  * `gaussian_mask` — virtual-electrode sensor mask (reference egm.py:5-12).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _reflect_pad(x: jnp.ndarray) -> jnp.ndarray:
    """1-cell REFLECT pad (mirror excluding the edge), as tf.pad 'REFLECT'."""
    return jnp.pad(x, 1, mode="reflect")


def laplace(
    x: jnp.ndarray,
    phase: Optional[jnp.ndarray] = None,
    phase_padded: Optional[jnp.ndarray] = None,
    dmap_padded: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """2D 9-point Laplacian with REFLECT boundary handling.

    Equivalent to reference ionic.py:44-60: pad REFLECT, then
      l = N + S + W + E + 0.5*(NW + NE + SW + SE) - 6*C
    with an optional phase-field correction added when `phase` is given.

    `dmap_padded` is an optional REFLECT-padded per-pixel RELATIVE
    diffusion map d (dimensionless, 1 = nominal `diff`): the operator
    becomes the heterogeneous-conductivity form
        d*lap9(x) + (∇x · ∇(ϕ d)) / ϕ
    so that `diff * laplace(...)` discretizes (1/ϕ)∇·(ϕ d diff ∇x) —
    patchy fibrosis, regional slow-conduction substrates, gray-zone
    borders.  At d ≡ 1 this reduces EXACTLY to the phase-field form
    (and with no phase, to ∇·(d∇x) with the reference's correction
    -weighting quirk preserved — see conduction_correction).

    Args:
      x: `[H, W]` field.
      phase: optional `[H, W]` phase field ϕ (static across the run).
      phase_padded: optional precomputed REFLECT-padded ϕ of shape
        `[H+2, W+2]`; pass this from the engine to avoid re-padding a
        constant every substep (the values are identical).
      dmap_padded: optional REFLECT-padded `[H+2, W+2]` diffusion map.
    """
    xp = _reflect_pad(x)
    l = (
        xp[:-2, 1:-1] + xp[2:, 1:-1] + xp[1:-1, :-2] + xp[1:-1, 2:]
        + 0.5 * (xp[:-2, :-2] + xp[2:, :-2] + xp[:-2, 2:] + xp[2:, 2:])
        - 6.0 * xp[1:-1, 1:-1]
    )
    if phase is not None and phase_padded is None:
        phase_padded = _reflect_pad(phase)
    if dmap_padded is not None:
        l = dmap_padded[1:-1, 1:-1] * l
        q = (dmap_padded * phase_padded if phase_padded is not None
             else dmap_padded)
        phi_c = (phase_padded[1:-1, 1:-1] if phase_padded is not None
                 else 1.0)
        return l + conduction_correction(xp, q, phi_c)
    if phase_padded is not None:
        l = l + phase_field_correction(xp, phase_padded)
    return l


def laplace_conv(x: jnp.ndarray) -> jnp.ndarray:
    """Convolution-kernel variant of the 9-point Laplacian with zero
    ('SAME') padding — the pedagogical baseline path (reference
    fenton_simple.py:32-49 used a depthwise conv), kept for the
    fenton_simple example's parity.  The contraction is pinned to full
    float32 precision: a GPU may otherwise run it in TF32, which keeps
    about three decimal digits.
    """
    kernel = jnp.asarray(
        [[0.5, 1.0, 0.5], [1.0, -6.0, 1.0], [0.5, 1.0, 0.5]],
        dtype=x.dtype,
    )
    return jax.lax.conv_general_dilated(
        x[None, None, :, :],
        kernel[None, None, :, :],
        window_strides=(1, 1),
        padding="SAME",
        precision=jax.lax.Precision.HIGHEST,
    )[0, 0]


def anisotropic_laplace(
    x: jnp.ndarray,
    dxx: float,
    dxy: float,
    dyy: float,
    phase_padded: Optional[jnp.ndarray] = None,
    dmap_padded: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Anisotropic diffusion operator dxx*Vxx + 2*dxy*Vxy + dyy*Vyy with
    REFLECT boundary handling (constant diffusion tensor).

    The reference carried a fiber `normal` in its native Config for
    anisotropic conduction (common.h:21-24) but its Python side never used
    it; this is the 2D framework realization.  Build (dxx, dxy, dyy) from
    a fiber angle with `fiber_tensor`.  Second derivatives use the
    standard central stencils; the mixed term uses the 4-corner form.
    Note the axis convention: rows (axis 0) are y, columns (axis 1) x.

    The whole operator is scaled x2 to match the reference's isotropic
    9-point stencil, which evaluates to 2*laplacian (on V = x^2 it
    returns 4, ionic.py:49-53) — so fiber_ratio=1 reproduces the
    isotropic conduction speed at the same `diff` coefficient.

    `dmap_padded` composes a per-pixel relative diffusion map d with the
    fiber tensor: d·(tensor operator) + (∇x · D∇(ϕd))/ϕ — fibrotic
    patches inside anisotropic tissue (see `laplace` / the
    conduction_correction weighting convention).
    """
    xp = _reflect_pad(x)
    c = xp[1:-1, 1:-1]
    vxx = xp[1:-1, :-2] - 2.0 * c + xp[1:-1, 2:]
    vyy = xp[:-2, 1:-1] - 2.0 * c + xp[2:, 1:-1]
    vxy = 0.25 * (
        xp[2:, 2:] + xp[:-2, :-2] - xp[2:, :-2] - xp[:-2, 2:]
    )
    l = 2.0 * (dxx * vxx + 2.0 * dxy * vxy + dyy * vyy)
    if dmap_padded is not None:
        l = dmap_padded[1:-1, 1:-1] * l
        q = (dmap_padded * phase_padded if phase_padded is not None
             else dmap_padded)
        phi_c = (phase_padded[1:-1, 1:-1] if phase_padded is not None
                 else 1.0)
        gx = xp[1:-1, 2:] - xp[1:-1, :-2]
        gy = xp[2:, 1:-1] - xp[:-2, 1:-1]
        qx = q[1:-1, 2:] - q[1:-1, :-2]
        qy = q[2:, 1:-1] - q[:-2, 1:-1]
        return l + (
            gx * (dxx * qx + dxy * qy) + gy * (dxy * qx + dyy * qy)
        ) / (4.0 * phi_c)
    if phase_padded is not None:
        l = l + anisotropic_phase_correction(
            xp, phase_padded, dxx, dxy, dyy
        )
    return l


def anisotropic_phase_correction(
    x_padded: jnp.ndarray,
    phase_padded: jnp.ndarray,
    dxx: float,
    dxy: float,
    dyy: float,
) -> jnp.ndarray:
    """Tensor form of the phase-field no-flux correction:
    (∇V · D∇ϕ)/ϕ via central differences, = (Gx(dxx Px + dxy Py) +
    Gy(dxy Px + dyy Py))/(4ϕ) where G/P are the x2-scaled central
    differences.  At D = I this reduces EXACTLY to
    `phase_field_correction` — deliberately keeping the reference's
    weighting quirk, where the correction enters at half the relative
    weight of its 2x-normalized Laplacian (ionic.py:70-81 vs :49-53)."""
    X, p = x_padded, phase_padded
    gx = X[1:-1, 2:] - X[1:-1, :-2]
    gy = X[2:, 1:-1] - X[:-2, 1:-1]
    px = p[1:-1, 2:] - p[1:-1, :-2]
    py = p[2:, 1:-1] - p[:-2, 1:-1]
    return (
        gx * (dxx * px + dxy * py) + gy * (dxy * px + dyy * py)
    ) / (4.0 * p[1:-1, 1:-1])


def fiber_tensor(angle_rad: float, ratio: float):
    """Unit diffusion tensor for fibers at `angle_rad` from the x axis:
    D = R diag(1, ratio) R^T, i.e. conduction 1 along fibers and `ratio`
    across them (multiply by the scalar `diff` coefficient at use site).
    Returns (dxx, dxy, dyy)."""
    c, s = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    dxx = c * c + ratio * s * s
    dyy = s * s + ratio * c * c
    dxy = (1.0 - ratio) * c * s
    return dxx, dxy, dyy


def phase_field_correction(
    x_padded: jnp.ndarray, phase_padded: jnp.ndarray
) -> jnp.ndarray:
    """Phase-field no-flux correction ((∂xX·∂xϕ + ∂yX·∂yϕ) / 4ϕ).

    Both inputs are REFLECT-padded `[H+2, W+2]` arrays; the reference
    (ionic.py:70-81) pads ϕ inside `phase_field` and receives X already
    padded by `laplace`.
    """
    X, p = x_padded, phase_padded
    return (
        (X[2:, 1:-1] - X[:-2, 1:-1]) * (p[2:, 1:-1] - p[:-2, 1:-1])
        + (X[1:-1, 2:] - X[1:-1, :-2]) * (p[1:-1, 2:] - p[1:-1, :-2])
    ) / (4.0 * p[1:-1, 1:-1])


def conduction_correction(
    x_padded: jnp.ndarray,
    q_padded: jnp.ndarray,
    phi_center,
) -> jnp.ndarray:
    """Generalized no-flux/heterogeneity correction (∇x · ∇q) / ϕ via
    central differences on padded arrays, where q = ϕ·d is the product
    of the phase field and the relative diffusion map (either may be
    identically 1).  `phi_center` is ϕ at the cell centers (`[H, W]`
    array, or the scalar 1.0 without a phase field).

    With d ≡ 1 (q = ϕ, phi_center = ϕ) this is EXACTLY
    `phase_field_correction` — including the reference's weighting
    quirk, where the correction enters at half the relative weight of
    the 2x-normalized 9-point Laplacian (ionic.py:70-81 vs :49-53); the
    heterogeneous-d form keeps the same convention so a uniform-d patch
    conducts exactly like a globally scaled `diff`."""
    X, q = x_padded, q_padded
    return (
        (X[2:, 1:-1] - X[:-2, 1:-1]) * (q[2:, 1:-1] - q[:-2, 1:-1])
        + (X[1:-1, 2:] - X[1:-1, :-2]) * (q[1:-1, 2:] - q[1:-1, :-2])
    ) / (4.0 * phi_center)


def enforce_boundary(x: jnp.ndarray) -> jnp.ndarray:
    """No-flux (Neumann) boundary: SYMMETRIC pad of the interior.

    Border rows/columns are replaced by their immediate interior neighbors
    (reference ionic.py:107-113).
    """
    return jnp.pad(x[1:-1, 1:-1], 1, mode="symmetric")


# -----------------------------------------------------------------------------
# Phase field construction (host-side numpy; definition time)
# -----------------------------------------------------------------------------

def add_hole_to_phase_field(
    phase: Optional[np.ndarray],
    height: int,
    width: int,
    x: float,
    y: float,
    radius: float,
    neg: bool = False,
) -> np.ndarray:
    """Multiply a circular hole into a phase field, creating it if needed.

    `neg=False`: a disk obstacle at (x, y) — ϕ = 0.5*(tanh(dist - r) + 1).
    `neg=True`:  everything OUTSIDE radius is excluded —
                 ϕ = 0.5*(tanh(0.1*(r - dist)) + 1).
    Floor at 1e-5 to avoid division by zero in the correction term.
    (reference ionic.py:83-105)
    """
    if phase is None:
        phase = np.ones([height, width], dtype=np.float32)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    dist = np.hypot(xx - x, yy - y)
    if neg:
        phase = phase * np.asarray(
            0.5 * (np.tanh(0.1 * (radius - dist)) + 1.0), dtype=np.float32
        )
    else:
        phase = phase * np.asarray(
            0.5 * (np.tanh(dist - radius) + 1.0), dtype=np.float32
        )
    return np.maximum(phase, 1e-5).astype(np.float32)


def fibrosis_map(
    height: int,
    width: int,
    density: float = 0.25,
    strength: float = 0.8,
    seed: int = 0,
    patch: int = 4,
) -> np.ndarray:
    """Patchy fibrotic relative-diffusion map (host-side, definition
    time): 1.0 in healthy tissue, `1 - strength` inside fibrotic patches
    covering ~`density` of the area, generated as thresholded
    coarse-grained uniform noise with `patch`-cell correlation length —
    the standard percolation-style substrate for fibrotic conduction
    slowing / micro-reentry studies.  Feed to
    `Simulation.set_diffusion_map` (beyond reference parity: the
    reference's only spatial structure was the binary hole,
    ionic.py:83-105)."""
    if not 0.0 <= density <= 1.0:
        raise ValueError("density must be in [0, 1]")
    if not 0.0 <= strength <= 1.0:
        raise ValueError("strength must be in [0, 1] (1 = full block)")
    d = np.ones((height, width), np.float32)
    if density <= 0.0 or strength == 0.0:
        return d
    if density >= 1.0:
        return np.full_like(d, 1.0 - strength)
    rng = np.random.RandomState(seed)
    ch = -(-height // patch)
    cw = -(-width // patch)
    noise = rng.rand(ch, cw)
    thr = np.quantile(noise, 1.0 - density)
    fib = np.kron(noise >= thr, np.ones((patch, patch), dtype=bool))
    d[fib[:height, :width]] = 1.0 - strength
    return d


# -----------------------------------------------------------------------------
# Pacing / stimulation
# -----------------------------------------------------------------------------

PACE_LOCATIONS = (
    "left", "right", "top", "bottom", "luq", "llq", "ruq", "rlq",
)


def pace_mask(
    height: int, width: int, loc: str, v: float, min_v: float
) -> np.ndarray:
    """Stimulus mask for one of the 8 named locations.

    Background is `min_v` so that `max(pot, mask)` leaves unstimulated cells
    untouched (reference ionic.py:125-163).
    """
    s = np.full([height, width], min_v, dtype=np.float32)
    if loc == "left":
        s[:, :5] = v
    elif loc == "right":
        s[:, -5:] = v
    elif loc == "top":
        s[:5, :] = v
    elif loc == "bottom":
        s[-5:, :] = v
    elif loc == "luq":
        s[1 : height // 2, 1 : width // 2] = v
    elif loc == "llq":
        s[height // 2 : -1, 1 : width // 2] = v
    elif loc == "ruq":
        s[1 : height // 2, width // 2 : -1] = v
    elif loc == "rlq":
        s[height // 2 : -1, width // 2 : -1] = v
    else:
        raise ValueError(f"undefined pace location: {loc!r}")
    return s


def apply_pace(pot: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Fire a pacing op: pot <- max(pot, mask) (reference ionic.py:163)."""
    return jnp.maximum(pot, mask)


# -----------------------------------------------------------------------------
# Virtual electrodes (pseudo-electrogram)
# -----------------------------------------------------------------------------

def gaussian_mask(
    height: int, width: int, x: float, y: float, radius: float
) -> np.ndarray:
    """Circular Gaussian sensor mask exp(-(dist/radius)^2) centered at (x, y)
    (reference egm.py:5-12)."""
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    dist = np.hypot(xx - x, yy - y)
    return np.asarray(np.exp(-((dist / radius) ** 2)), dtype=np.float32)


def electrogram_sample(image: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """One electrode sample: mean(image * mask), computed on-device
    (the reference did this on the host, egm.py:45-47)."""
    return jnp.mean(image * mask)


def ecg_weights(
    height: int, width: int, x: float, y: float, z: float = 5.0,
    r_min: float = 0.5,
) -> np.ndarray:
    """Lead-field weights `1/r` of a virtual unipolar electrode floating
    `z` cell units above the sheet at in-plane position (x, y).

    The pseudo-ECG of the monodomain model is
    Φ(e) ∝ −∫ ∇V·∇(1/r) dA, which integrates by parts (no-flux
    boundaries kill the edge term) to ∫ (1/r) ∇·(D∇V) dA — so the
    sampled signal is `sum(geom.laplace(enforce_boundary(V)) * w)`,
    reusing the exact discrete operator (incl. anisotropy and the
    phase-field correction) as the source term.  This is the true
    far-field signal where the reference's Gaussian-mask electrode
    (egm.py:5-12) sampled a local masked mean of the potential itself.
    `r_min` floors the distance so a z=0 electrode stays finite."""
    xx, yy = np.meshgrid(np.arange(width, dtype=np.float32),
                         np.arange(height, dtype=np.float32))
    r = np.sqrt((xx - x) ** 2 + (yy - y) ** 2 + float(z) ** 2)
    return (1.0 / np.maximum(r, r_min)).astype(np.float32)


_TWO_PI = 2.0 * np.pi


def rotor_metrics(
    img_now: jnp.ndarray,
    img_old: jnp.ndarray,
    v_star: float = 0.5,
    phase: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """On-device phase-singularity census of one frame: `[count, net]`.

    `img_now`/`img_old` are the normalized potential now and `tau` ago
    (time-delay embedding, same construction as the host-side
    utils/tips.phase_movie); the winding of
    theta = atan2(img_now - v_star, img_old - v_star) around each 2x2
    plaquette is the topological charge.  Returns a float32 [2] vector:
    `count` = number of singularities (the rotor count, the standard
    fibrillation-complexity metric) and `net` = total signed charge
    (immune to the tight +-1 noise pairs host-side `cancel_pairs`
    removes, which inflate only `count`).  Plaquettes touching
    `phase` < 0.5 (obstacles/boundary) are excluded.

    Pure jnp so it rides the compiled scan — the reference could only
    judge rotor content by eye from host-side Screen frames."""
    theta = jnp.arctan2(img_now - v_star, img_old - v_star)
    t00 = theta[:-1, :-1]
    t01 = theta[:-1, 1:]
    t11 = theta[1:, 1:]
    t10 = theta[1:, :-1]

    def wrap(x):
        return x - _TWO_PI * jnp.round(x / _TWO_PI)

    circ = (
        wrap(t01 - t00) + wrap(t11 - t01)
        + wrap(t10 - t11) + wrap(t00 - t10)
    )
    q = jnp.round(circ / _TWO_PI)
    if phase is not None:
        tissue = (
            (phase[:-1, :-1] >= 0.5) & (phase[:-1, 1:] >= 0.5)
            & (phase[1:, 1:] >= 0.5) & (phase[1:, :-1] >= 0.5)
        )
        q = jnp.where(tissue, q, 0.0)
    return jnp.stack([jnp.sum(jnp.abs(q)), jnp.sum(q)])


# -----------------------------------------------------------------------------
# Halo-extended block geometry (the shard_map wide-halo path)
# -----------------------------------------------------------------------------

def _col_reflect_west(x):
    return jnp.concatenate([x[:, 1:2], x[:, :-1]], axis=1)


def _col_reflect_east(x):
    return jnp.concatenate([x[:, 1:], x[:, -2:-1]], axis=1)


def _row_up(x):  # y[i] = x[i-1]; row 0 keeps itself (fixed by masks/halo)
    return jnp.concatenate([x[:1], x[:-1]], axis=0)


def _row_down(x):  # y[i] = x[i+1]; last row keeps itself
    return jnp.concatenate([x[1:], x[-1:]], axis=0)


def _col_left(x):   # y[:, j] = x[:, j-1]; col 0 keeps itself
    return jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)


def _col_right(x):  # y[:, j] = x[:, j+1]; last col keeps itself
    return jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)


def block_geometry(
    rg: jnp.ndarray,
    h_total: int,
    cg: Optional[jnp.ndarray] = None,
    w_total: Optional[int] = None,
    phase_ext: Optional[jnp.ndarray] = None,
    fiber: Optional[tuple] = None,
    dmap_ext: Optional[jnp.ndarray] = None,
) -> Geometry:
    """Geometry over a block extended with halo rows (and, when `cg` is
    given, halo columns) — the shard_map wide-halo path's operators
    (parallel/spmd.py), value-identical to `laplace` /
    `anisotropic_laplace` / `enforce_boundary` on the true grid.

    `rg` is the [ext_h, 1] int32 array of global row indices of the
    block's rows; rows outside [0, h_total) are halo garbage that shrinks
    away one ring per substep.  Without `cg`, columns span the full width
    and use plain REFLECT semantics; with `cg` ([1, ext_w] global column
    indices) the same global-edge masking applies along columns — the 2D
    wide-halo case.

    `dmap_ext` is the per-pixel relative diffusion map on the SAME
    extended block (fibrosis; stencil.conduction_correction convention),
    composable with both the phase field and the fiber tensor.
    """
    from fib_tf_tpu.models.base import Geometry

    top = rg == 0
    bottom = rg == h_total - 1

    def north(x):
        # reflect at the global top edge: row 0's north neighbor is row 1
        return jnp.where(top, _row_down(x), _row_up(x))

    def south(x):
        return jnp.where(bottom, _row_up(x), _row_down(x))

    if cg is None:
        west, east = _col_reflect_west, _col_reflect_east

        def col_fix(x):
            return jnp.concatenate(
                [x[:, 1:2], x[:, 1:-1], x[:, -2:-1]], axis=1
            )
    else:
        left_edge = cg == 0
        right_edge = cg == w_total - 1

        def west(x):
            return jnp.where(left_edge, _col_right(x), _col_left(x))

        def east(x):
            return jnp.where(right_edge, _col_left(x), _col_right(x))

        def col_fix(x):
            x = jnp.where(left_edge, _col_right(x), x)
            x = jnp.where(right_edge, _col_left(x), x)
            return x

    def laplace(x):
        n = north(x)
        s = south(x)
        w = west(x)
        e = east(x)
        nw = west(n)
        ne = east(n)
        sw = west(s)
        se = east(s)
        if fiber is not None:
            # anisotropic tensor operator (value-identical to
            # stencil.anisotropic_laplace incl. the x2 normalization)
            dxx, dxy, dyy = fiber
            vxx = w - 2.0 * x + e
            vyy = n - 2.0 * x + s
            vxy = 0.25 * (se + nw - sw - ne)
            l = 2.0 * (dxx * vxx + 2.0 * dxy * vxy + dyy * vyy)
            if dmap_ext is not None:
                l = dmap_ext * l
                q = (dmap_ext * phase_ext if phase_ext is not None
                     else dmap_ext)
                phi = phase_ext if phase_ext is not None else 1.0
                gx = e - w
                gy = s - n
                qx = east(q) - west(q)
                qy = south(q) - north(q)
                return l + (
                    gx * (dxx * qx + dxy * qy)
                    + gy * (dxy * qx + dyy * qy)
                ) / (4.0 * phi)
            if phase_ext is not None:
                p = phase_ext
                gx = e - w
                gy = s - n
                px = east(p) - west(p)
                py = south(p) - north(p)
                l = l + (
                    gx * (dxx * px + dxy * py)
                    + gy * (dxy * px + dyy * py)
                ) / (4.0 * p)
            return l
        l = n + s + w + e + 0.5 * (nw + ne + sw + se) - 6.0 * x
        if dmap_ext is not None:
            l = dmap_ext * l
            q = (dmap_ext * phase_ext if phase_ext is not None
                 else dmap_ext)
            phi = phase_ext if phase_ext is not None else 1.0
            return l + (
                (s - n) * (south(q) - north(q))
                + (e - w) * (east(q) - west(q))
            ) / (4.0 * phi)
        if phase_ext is not None:
            p = phase_ext
            pn = north(p)
            ps = south(p)
            pw = west(p)
            pe = east(p)
            l = l + ((s - n) * (ps - pn) + (e - w) * (pe - pw)) / (4.0 * p)
        return l

    def enforce_boundary(x):
        x = jnp.where(top, _row_down(x), x)       # row 0 <- row 1
        x = jnp.where(bottom, _row_up(x), x)      # row H-1 <- row H-2
        return col_fix(x)

    return Geometry(laplace=laplace, enforce_boundary=enforce_boundary)
