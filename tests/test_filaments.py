"""Scroll-wave filament detection (utils/filaments.py).

Synthetic volumes with analytically-known filament geometry: a phase
field phi(y, x) winding around a center produces, under the delay
embedding theta = atan2(now - v*, old - v*), exactly one singularity of
known charge at that center in every slice it threads."""

import numpy as np
import pytest

from fib_tf_tpu.utils.filaments import (
    Filament,
    census_movie,
    filament_census,
    link_filaments,
    slice_singularities,
)


def spiral_pair(centers, h=32, w=32, sign=1.0):
    """(now, old) [D, H, W] volumes whose embedding phase winds once
    around `centers[z]` (a (cy, cx) per slice; None = quiescent slice).
    With now = 0.5 + cos(phi), old = 0.5 + sin(phi) the embedding angle
    is atan2(cos, sin) = pi/2 - phi: winding -1 for phi's +1 — `sign`
    flips phi to pick the charge."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    now, old = [], []
    for c in centers:
        if c is None:
            now.append(np.full((h, w), 0.4, np.float32))
            old.append(np.full((h, w), 0.4, np.float32))
        else:
            cy, cx = c
            phi = sign * np.arctan2(yy - cy, xx - cx)
            now.append(0.5 + np.cos(phi).astype(np.float32))
            old.append(0.5 + np.sin(phi).astype(np.float32))
    return np.stack(now), np.stack(old)


class TestSliceSingularities:
    def test_finds_one_per_slice_at_the_center(self):
        now, old = spiral_pair([(16.0, 16.0)] * 4)
        per = slice_singularities(now, old, v_star=0.5)
        assert [len(p) for p in per] == [1, 1, 1, 1]
        y, x, q = per[0][0]
        assert abs(y - 16.0) < 1.5 and abs(x - 16.0) < 1.5
        assert q in (-1.0, 1.0)

    def test_quiescent_slices_are_empty(self):
        now, old = spiral_pair([None, (16.0, 16.0), None])
        per = slice_singularities(now, old, v_star=0.5)
        assert [len(p) for p in per] == [0, 1, 0]

    def test_charge_sign_follows_rotation_sense(self):
        now_p, old_p = spiral_pair([(16.0, 16.0)], sign=1.0)
        now_m, old_m = spiral_pair([(16.0, 16.0)], sign=-1.0)
        qp = slice_singularities(now_p, old_p, v_star=0.5)[0][0, 2]
        qm = slice_singularities(now_m, old_m, v_star=0.5)[0][0, 2]
        assert qp == -qm


class TestLinking:
    def test_transmural_filament(self):
        # a straight scroll threading all 8 slices with a 1-cell/slice
        # lateral drift
        centers = [(12.0 + z, 16.0) for z in range(8)]
        now, old = spiral_pair(centers)
        fils = filament_census(now, old, v_star=0.5)
        assert len(fils) == 1
        f = fils[0]
        assert f.z_span == 8
        # drift of 1 cell/slice over 7 gaps: arc length ~ 7 * sqrt(2)
        # (the z step is 1, lateral step 1) within plaquette resolution
        assert f.arc_length == pytest.approx(7 * np.sqrt(2.0), rel=0.15)

    def test_two_filaments_kept_apart(self):
        a = [(8.0, 8.0)] * 5
        now_a, old_a = spiral_pair(a, sign=1.0)
        b = [(24.0, 24.0)] * 5
        now_b, old_b = spiral_pair(b, sign=-1.0)
        # superpose by taking each field where its spiral dominates
        yy, xx = np.mgrid[0:32, 0:32]
        left = ((yy - 8.0) ** 2 + (xx - 8.0) ** 2
                < (yy - 24.0) ** 2 + (xx - 24.0) ** 2)
        now = np.where(left, now_a, now_b)
        old = np.where(left, old_a, old_b)
        fils = filament_census(now, old, v_star=0.5)
        assert len(fils) == 2
        charges = sorted(f.charge for f in fils)
        assert charges == [-1, 1]

    def test_z_gap_breaks_filament(self):
        centers = [(16.0, 16.0)] * 3 + [None, None] + [(16.0, 16.0)] * 3
        now, old = spiral_pair(centers)
        fils = filament_census(now, old, v_star=0.5)
        assert len(fils) == 2
        assert sorted(f.z_span for f in fils) == [3, 3]

    def test_min_span_drops_single_slice_flicker(self):
        now, old = spiral_pair([None, (16.0, 16.0), None])
        assert filament_census(now, old, v_star=0.5) == []
        fils = filament_census(now, old, v_star=0.5, min_span=1)
        assert len(fils) == 1 and fils[0].z_span == 1

    def test_link_dist_respected(self):
        # 10-cell jump between slices exceeds the 6-cell default
        centers = [(8.0, 8.0), (18.0, 8.0)]
        now, old = spiral_pair(centers)
        per = slice_singularities(now, old, v_star=0.5)
        fils = link_filaments(per)
        assert len(fils) == 2
        fils_loose = link_filaments(per, link_dist=12.0)
        assert len(fils_loose) == 1


class TestMovie:
    def test_census_movie_shapes(self):
        now, old = spiral_pair([(16.0, 16.0)] * 3)
        movie = np.stack([old, old, now, now])  # T=4, tau=2 pairs: (2,0),(3,1)
        per_t = census_movie(movie, tau=2, v_star=0.5)
        assert len(per_t) == 2
        assert all(isinstance(fs, list) for fs in per_t)
        assert len(per_t[0]) == 1 and per_t[0][0].z_span == 3

    def test_rejects_bad_rank(self):
        with pytest.raises(ValueError):
            census_movie(np.zeros((4, 8, 8)), tau=1)


class TestIntegrationWithRunVolume:
    def test_census_consumes_run_volume_frames(self):
        """census_movie accepts run_volume's [T, D, H, W] frame stack
        directly.  (A GENUINE rotating scroll core needs an in-plane
        domain comparable to the fenton wavelength, ~400 cells — an
        accelerator-scale run; examples/scroll_wave.py at its default
        size is that demonstration.  A 48-cell CPU box only re-excites globally,
        so this test pins the data path, not the physics.)"""
        import jax

        from fib_tf_tpu.config import SimConfig
        from fib_tf_tpu.engine.volume import VolumeEvent, run_volume
        from fib_tf_tpu.models import Fenton4v

        cfg = SimConfig(width=32, height=32, dt=0.05)
        m = Fenton4v(cfg)
        final, probes, frames = run_volume(
            m, depth=4, n_outer=60,
            events=[VolumeEvent(step=30, loc="luq", z1=2)],
            frames_every=10,
        )
        per_t = census_movie(frames, tau=1)
        assert len(per_t) == len(frames) - 1
        for fils in per_t:
            for f in fils:
                assert f.z_span <= 4 and f.charge in (-1, 1)
