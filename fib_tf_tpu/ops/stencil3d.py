"""3D (volume) finite-difference operators — beyond reference parity.

The reference is strictly 2D (its `laplace` is the 9-point sheet stencil,
ionic.py:44-60; README line 1: "2D cardiac electrophysiology").  Scroll
waves — the 3D generalization of the spiral reentry every reference
experiment chases — need a volume operator.  This module lifts the
quirk-faithful 2D operators to `[D, H, W]` volumes BY CONSTRUCTION rather
than re-derivation:

  * `laplace3d` = the existing 2D 9-point stencil applied per z-slice
    (vmap) + a 2x-scaled second difference along z with REFLECT ends.
    The x2 matches the reference stencil's normalization (its 9-point
    form evaluates to 2x the analytic Laplacian: for a field varying
    only along x it reduces to exactly 2*(W + E - 2C), ionic.py:49-53),
    so planar waves conduct at the SAME speed along z as along x/y, and
    a z-uniform volume reproduces the 2D operator exactly (the z term is
    identically zero).
  * `enforce_boundary3d` = the SYMMETRIC border rewrite in all three
    axes (border voxels replaced by their interior neighbors, the 3D
    analog of ionic.py:107-113).
  * Phase fields stay 2D and are extruded along z (columnar obstacles);
    ∂zϕ = 0 exactly, so the reference's no-flux correction term needs no
    z component.

Everything is pure jnp over `[D, H, W]`; models consume these through the
same injected `Geometry` record they use in 2D and 0D (models/base.py),
so the entire ionic zoo runs in 3D unchanged.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fib_tf_tpu.ops import stencil


def laplace3d(
    x: jnp.ndarray,
    phase_padded: Optional[jnp.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
) -> jnp.ndarray:
    """9-point in-plane + 2x-scaled z second difference, REFLECT ends.

    `x` is `[D, H, W]`; `phase_padded` an optional REFLECT-padded 2D
    phase field `[H+2, W+2]` shared by every slice (extruded obstacles).
    `dz_ratio` scales conduction along z relative to in-plane (the
    transmural-anisotropy knob; 1.0 = isotropic).

    `fiber` is an optional `(dxx, dxy, dyy)` in-plane diffusion tensor —
    scalars (one fiber direction everywhere) or `[D]` arrays (a tensor
    PER SLICE) — or a FULL 3x3 6-tuple `(dxx, dxy, dyy, dxz, dyz, dzz)`
    (fiber_tensors3d; fibers tilted out of the sheet plane), which
    dispatches to the full-tensor operator and replaces `dz_ratio`.  Per-slice tensors realize ROTATIONAL anisotropy: the
    ventricular fiber direction twisting with depth, the geometry whose
    scroll-wave destabilization Fenton & Karma mapped (Chaos 1998,
    "Vortex dynamics in three-dimensional continuous myocardium with
    fiber rotation") — build the angles with `twist_angles` and the
    tensors with `stencil.fiber_tensor`.  The in-plane operator is the
    2D `stencil.anisotropic_laplace` vmapped with its slice's tensor
    (same 2x normalization, same phase-field correction), so a
    zero-twist volume reproduces the 2D anisotropic operator exactly.
    """
    if fiber is not None and len(fiber) == 6:
        if dz_ratio != 1.0:
            raise ValueError(
                "a full 3x3 fiber tensor carries its own dzz; "
                "dz_ratio must stay 1.0 (build the tensor with "
                "fiber_tensors3d)"
            )
        return _laplace3d_full(x, fiber, phase_padded)
    if fiber is None:
        planar = jax.vmap(
            lambda s: stencil.laplace(s, phase_padded=phase_padded)
        )(x)
    else:
        d = x.shape[0]
        dxx, dxy, dyy = (
            jnp.broadcast_to(jnp.asarray(c, jnp.float32), (d,))
            for c in fiber
        )
        planar = jax.vmap(
            lambda s, a, b, c: stencil.anisotropic_laplace(
                s, a, b, c, phase_padded=phase_padded
            )
        )(x, dxx, dxy, dyy)
    xp = jnp.pad(x, ((1, 1), (0, 0), (0, 0)), mode="reflect")
    z = xp[:-2] - 2.0 * x + xp[2:]
    return planar + (2.0 * dz_ratio) * z


def _laplace3d_full(
    x: jnp.ndarray,
    tensors: tuple,
    phase_padded: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """Full 3x3 anisotropic diffusion operator
    2*(dxx Vxx + 2 dxy Vxy + dyy Vyy + dzz Vzz + 2 dxz Vxz + 2 dyz Vyz)
    for fibers tilted OUT of the sheet plane (imbrication angle) —
    `tensors` = (dxx, dxy, dyy, dxz, dyz, dzz), scalars or `[D]`
    per-slice arrays (fiber_tensors3d).

    Conventions match the 2D tensor operator exactly (the 2x reference
    normalization, stencil.anisotropic_laplace's central/4-corner
    stencils, REFLECT ends on every axis): with dxz = dyz = 0 and
    dzz = dz_ratio this reduces to the in-plane-tensor laplace3d path
    to float precision.  The extruded phase field keeps dphi/dz = 0,
    so its no-flux correction gains exactly one term — the z gradient
    against the tensor's in-plane flux components,
    Gz*(dxz Px + dyz Py)/(4 phi) — and reduces to
    stencil.anisotropic_phase_correction when the tilt vanishes."""
    d = x.shape[0]
    dxx, dxy, dyy, dxz, dyz, dzz = (
        jnp.broadcast_to(jnp.asarray(c, jnp.float32), (d,)).reshape(
            d, 1, 1
        )
        for c in tensors
    )
    xp = jnp.pad(x, 1, mode="reflect")  # [D+2, H+2, W+2]
    c = xp[1:-1, 1:-1, 1:-1]
    vxx = xp[1:-1, 1:-1, :-2] - 2.0 * c + xp[1:-1, 1:-1, 2:]
    vyy = xp[1:-1, :-2, 1:-1] - 2.0 * c + xp[1:-1, 2:, 1:-1]
    vzz = xp[:-2, 1:-1, 1:-1] - 2.0 * c + xp[2:, 1:-1, 1:-1]
    vxy = 0.25 * (
        xp[1:-1, 2:, 2:] + xp[1:-1, :-2, :-2]
        - xp[1:-1, 2:, :-2] - xp[1:-1, :-2, 2:]
    )
    vxz = 0.25 * (
        xp[2:, 1:-1, 2:] + xp[:-2, 1:-1, :-2]
        - xp[2:, 1:-1, :-2] - xp[:-2, 1:-1, 2:]
    )
    vyz = 0.25 * (
        xp[2:, 2:, 1:-1] + xp[:-2, :-2, 1:-1]
        - xp[2:, :-2, 1:-1] - xp[:-2, 2:, 1:-1]
    )
    l = 2.0 * (
        dxx * vxx + dyy * vyy + dzz * vzz
        + 2.0 * (dxy * vxy + dxz * vxz + dyz * vyz)
    )
    if phase_padded is not None:
        p = phase_padded
        gx = xp[1:-1, 1:-1, 2:] - xp[1:-1, 1:-1, :-2]
        gy = xp[1:-1, 2:, 1:-1] - xp[1:-1, :-2, 1:-1]
        gz = xp[2:, 1:-1, 1:-1] - xp[:-2, 1:-1, 1:-1]
        px = (p[1:-1, 2:] - p[1:-1, :-2])[None]
        py = (p[2:, 1:-1] - p[:-2, 1:-1])[None]
        l = l + (
            gx * (dxx * px + dxy * py)
            + gy * (dxy * px + dyy * py)
            + gz * (dxz * px + dyz * py)
        ) / (4.0 * p[1:-1, 1:-1][None])
    return l


def fiber_tensors3d(angles: np.ndarray, ratio: float,
                    elevation=0.0) -> tuple:
    """Per-slice FULL 3x3 diffusion tensors
    D = ratio*I + (1 - ratio) * f f^T for unit fibers
    f = (cos e cos a, cos e sin a, sin e): in-plane angle `a` per slice
    (`angles`, [D] radians — twist_angles), elevation (imbrication)
    angle `e` out of the sheet plane (scalar or [D] radians).

    Returns (dxx, dxy, dyy, dxz, dyz, dzz) [D] arrays for laplace3d.
    At e = 0 the in-plane block reduces exactly to `fiber_tensors` and
    dzz = ratio — i.e. the classic twist model IS this tensor with
    dz_ratio = ratio; a nonzero elevation couples z into the fast
    conduction axis (dxz, dyz), which the separable
    in-plane-tensor + dz_ratio model cannot represent."""
    a = np.asarray(angles, np.float32)
    e = np.broadcast_to(np.asarray(elevation, np.float32), a.shape)
    fx = np.cos(e) * np.cos(a)
    fy = np.cos(e) * np.sin(a)
    fz = np.sin(e)
    k = np.float32(1.0 - ratio)
    return tuple(
        c.astype(np.float32)
        for c in (ratio + k * fx * fx, k * fx * fy, ratio + k * fy * fy,
                  k * fx * fz, k * fy * fz, ratio + k * fz * fz)
    )


def twist_angles(
    depth: int, angle0: float = 0.0, twist: float = 0.0
) -> np.ndarray:
    """Per-slice fiber angles for a linear transmural rotation: `twist`
    radians total across the depth, centered on `angle0` (the
    epicardium-to-endocardium fiber rotation, ~120 degrees in ventricle;
    Fenton & Karma 1998).  Returns `[depth]` float32 radians."""
    if depth < 2 or twist == 0.0:
        return np.full(depth, angle0, np.float32)
    frac = np.arange(depth, dtype=np.float32) / (depth - 1) - 0.5
    return (angle0 + twist * frac).astype(np.float32)


def fiber_tensors(angles: np.ndarray, ratio: float):
    """Per-slice `(dxx, dxy, dyy)` arrays from `[D]` fiber angles
    (vectorized `stencil.fiber_tensor`)."""
    a = np.asarray(angles, np.float32)
    c, s = np.cos(a), np.sin(a)
    dxx = c * c + ratio * s * s
    dyy = s * s + ratio * c * c
    dxy = (1.0 - ratio) * c * s
    return (dxx.astype(np.float32), dxy.astype(np.float32),
            dyy.astype(np.float32))


def enforce_boundary3d(x: jnp.ndarray) -> jnp.ndarray:
    """No-flux border rewrite in all three axes: every face voxel is
    replaced by its interior neighbor (SYMMETRIC pad of the interior,
    the 3D analog of reference ionic.py:107-113)."""
    return jnp.pad(x[1:-1, 1:-1, 1:-1], 1, mode="symmetric")


def ecg_weights(
    depth: int,
    height: int,
    width: int,
    pos: tuple,
    r_min: float = 0.5,
) -> np.ndarray:
    """Lead-field weights `1/r` of a virtual unipolar electrode at `pos`
    = (z, y, x) in cell units (floats; typically OFF the tissue, e.g.
    z = -5 for an electrode above the epicardial face).

    The pseudo-ECG of the monodomain model is the volume integral
    Φ(e) ∝ −∫ ∇V·∇(1/r) dv, which integrates by parts (no-flux
    boundaries kill the surface term) to ∫ (1/r) ∇·(D∇V) dv — so the
    sampled signal is `sum(geom.laplace(V) * ecg_weights(...))`,
    reusing the exact discrete operator (incl. anisotropy and the
    phase-field correction) as the source term.  This generalizes the
    reference's 2D Gaussian-mask electrode (egm.py:5-12), which sampled
    the potential itself rather than the field a dipole layer radiates.
    `r_min` floors the distance so an in-tissue electrode stays finite."""
    z, y, x = (float(c) for c in pos)
    zz = np.arange(depth, dtype=np.float32).reshape(-1, 1, 1)
    yy = np.arange(height, dtype=np.float32).reshape(1, -1, 1)
    xx = np.arange(width, dtype=np.float32).reshape(1, 1, -1)
    r = np.sqrt((zz - z) ** 2 + (yy - y) ** 2 + (xx - x) ** 2)
    return (1.0 / np.maximum(r, r_min)).astype(np.float32)


def ecg_sample(lap: jnp.ndarray, weights: jnp.ndarray) -> jnp.ndarray:
    """Electrode potentials `[E]` from a source term `lap` `[D, H, W]`
    and lead fields `weights` `[E, D, H, W]` (`ecg_weights`).  The float32
    contraction is pinned to full precision: a GPU may otherwise run it
    in TF32, which keeps about three decimal digits."""
    return jnp.einsum("dhw,edhw->e", lap, weights,
                      precision=jax.lax.Precision.HIGHEST)


def pace_mask3d(
    depth: int,
    height: int,
    width: int,
    loc: str,
    v: float,
    min_v: float,
    z0: int = 0,
    z1: Optional[int] = None,
) -> np.ndarray:
    """Extruded stimulus mask: the 2D `stencil.pace_mask` applied on
    z-slices `[z0:z1)` (default: the full depth), `min_v` elsewhere, for
    `max(pot, mask)` firing."""
    m2 = stencil.pace_mask(height, width, loc, v, min_v)
    m = np.full([depth, height, width], min_v, dtype=np.float32)
    m[z0:z1 if z1 is not None else depth] = m2
    return m


# -----------------------------------------------------------------------------
# z-halo block geometry (the z-sharded wide-halo path)
# -----------------------------------------------------------------------------

def _shift2(x: jnp.ndarray, dr: int, dc: int) -> jnp.ndarray:
    """y[i, j] = x[reflect(i+dr), reflect(j+dc)] for dr, dc in {-1, 0, 1}
    on a 2D `[H, W]` field (mirror excluding the edge, as a 1-cell
    REFLECT pad + slice)."""
    y = x
    if dr == -1:
        y = jnp.concatenate([y[1:2], y[:-1]], axis=0)
    elif dr == 1:
        y = jnp.concatenate([y[1:], y[-2:-1]], axis=0)
    if dc == -1:
        y = jnp.concatenate([y[:, 1:2], y[:, :-1]], axis=1)
    elif dc == 1:
        y = jnp.concatenate([y[:, 1:], y[:, -2:-1]], axis=1)
    return y


def _shift3(x: jnp.ndarray, dr: int, dc: int) -> jnp.ndarray:
    """In-plane shift of a `[D, H, W]` volume: y[z, i, j] =
    x[z, reflect(i+dr), reflect(j+dc)] — the 3D broadcast of `_shift2`
    (axes -2/-1 instead of 0/1)."""
    y = x
    if dr == -1:
        y = jnp.concatenate([y[:, 1:2], y[:, :-1]], axis=1)
    elif dr == 1:
        y = jnp.concatenate([y[:, 1:], y[:, -2:-1]], axis=1)
    if dc == -1:
        y = jnp.concatenate([y[:, :, 1:2], y[:, :, :-1]], axis=2)
    elif dc == 1:
        y = jnp.concatenate([y[:, :, 1:], y[:, :, -2:-1]], axis=2)
    return y


def _zup_raw(x: jnp.ndarray) -> jnp.ndarray:
    """y[z] = x[z-1]; slice 0 keeps itself (halo garbage, masked away)."""
    return jnp.concatenate([x[:1], x[:-1]], axis=0)


def _zdown_raw(x: jnp.ndarray) -> jnp.ndarray:
    """y[z] = x[z+1]; last slice keeps itself."""
    return jnp.concatenate([x[1:], x[-1:]], axis=0)


def zblock_geometry(
    zg: jnp.ndarray,
    d_total: int,
    phase: Optional[jnp.ndarray] = None,
    dz_ratio: float = 1.0,
    fiber: Optional[tuple] = None,
) -> Geometry:
    """Geometry over a volume block extended with K ghost z-slices — the
    3D analog of ops.stencil.block_geometry, for the z-sharded wide-halo
    path (parallel/volume_spmd.py).

    `zg` is the `[ext_d, 1, 1]` int32 array of global z indices of the
    block's slices; slices outside [0, d_total) are halo garbage that
    shrinks away one ring per substep.  In-plane each shard owns the full
    `[H, W]` sheet, so the in-plane operators are plain shifts
    (REFLECT/SYMMETRIC at the true edges, value-identical to
    `laplace3d`'s planar part); only the z direction needs global-edge
    masking (REFLECT at global z = 0 / d_total-1, ghost slices
    elsewhere).  `fiber` entries
    must already be halo-EXTENDED `[ext_d, 1, 1]` per-slice tensors
    (static — the caller ppermutes them once per chunk)."""
    from fib_tf_tpu.models.base import Geometry

    top = zg == 0
    bottom = zg == d_total - 1

    def z_term(x):
        # raw shifts computed once and reused by both edge selects.
        # Reflect at the global faces: slice 0's z-neighbor is slice 1,
        # etc.
        zu = _zup_raw(x)
        zd = _zdown_raw(x)
        zup = jnp.where(top, zd, zu)
        zdown = jnp.where(bottom, zu, zd)
        return zup - 2.0 * x + zdown

    def laplace(x):
        n = _shift3(x, -1, 0)
        s = _shift3(x, 1, 0)
        w = _shift3(x, 0, -1)
        e = _shift3(x, 0, 1)
        nw = _shift3(x, -1, -1)
        ne = _shift3(x, -1, 1)
        sw = _shift3(x, 1, -1)
        se = _shift3(x, 1, 1)
        if fiber is None:
            planar = n + s + w + e + 0.5 * (nw + ne + sw + se) - 6.0 * x
            if phase is not None:
                pn = _shift2(phase, -1, 0)
                ps = _shift2(phase, 1, 0)
                pw = _shift2(phase, 0, -1)
                pe = _shift2(phase, 0, 1)
                planar = planar + (
                    (s - n) * (ps - pn) + (e - w) * (pe - pw)
                ) / (4.0 * phase)
        else:
            dxx, dxy, dyy = fiber
            vxx = w - 2.0 * x + e
            vyy = n - 2.0 * x + s
            vxy = 0.25 * (se + nw - sw - ne)
            planar = 2.0 * (dxx * vxx + 2.0 * dxy * vxy + dyy * vyy)
            if phase is not None:
                gx = e - w
                gy = s - n
                px = _shift2(phase, 0, 1) - _shift2(phase, 0, -1)
                py = _shift2(phase, 1, 0) - _shift2(phase, -1, 0)
                planar = planar + (
                    gx * (dxx * px + dxy * py)
                    + gy * (dxy * px + dyy * py)
                ) / (4.0 * phase)
        return planar + (2.0 * dz_ratio) * z_term(x)

    def enforce_boundary(x):
        # SYMMETRIC z faces only at the global edges (interior neighbor
        # replaces the face slice), in-plane faces everywhere.  Raw
        # shifts from the pre-rewrite array, computed once — equivalent
        # for >= 3 slices between the global faces
        zd = _zdown_raw(x)
        zu = _zup_raw(x)
        x = jnp.where(top, zd, x)
        x = jnp.where(bottom, zu, x)
        x = jnp.concatenate([x[:, 1:2], x[:, 1:-1], x[:, -2:-1]], axis=1)
        x = jnp.concatenate(
            [x[:, :, 1:2], x[:, :, 1:-1], x[:, :, -2:-1]], axis=2
        )
        return x

    return Geometry(laplace=laplace, enforce_boundary=enforce_boundary)
