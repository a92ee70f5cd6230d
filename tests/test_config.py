"""Config-system tests (reference: untyped dict splatted onto the model,
ionic.py:35-37; here a validated frozen dataclass)."""

import pytest

from fib_tf_tpu.config import SimConfig


class TestFromDict:
    def test_reference_style_dict(self):
        # the canonical reference config (fenton.py:156-166)
        d = {
            "width": 512, "height": 512, "dt": 0.1, "dt_per_plot": 10,
            "diff": 1.5, "duration": 1000, "timeline": False,
            "timeline_name": "timeline_4v.json", "save_graph": True,
        }
        cfg = SimConfig.from_dict(d)
        assert cfg.width == 512 and cfg.diff == 1.5
        assert cfg.timeline_name == "timeline_4v.json"
        assert cfg.save_graph is True

    def test_unknown_keys_ignored(self):
        cfg = SimConfig.from_dict({"width": 64, "height": 64,
                                   "samples": 10000, "s2_time": 210})
        assert cfg.width == 64

    def test_court_ultra_keys(self):
        cfg = SimConfig.from_dict({"ultra_slow": True, "skip": False,
                                   "cheby": True})
        assert cfg.ultra_slow is True


class TestValidation:
    def test_bad_grid(self):
        with pytest.raises(ValueError):
            SimConfig(width=2, height=2)

    def test_bad_dt(self):
        with pytest.raises(ValueError):
            SimConfig(dt=0.0)

    def test_from_dict_drops_removed_kernel_keys(self):
        """Saved configs from before the step had one implementation
        still load: from_dict ignores the retired kernel knobs."""
        cfg = SimConfig.from_dict({"width": 64, "height": 32,
                                   "kernel": "pallas",
                                   "substeps_per_launch": 2})
        assert (cfg.width, cfg.height) == (64, 32)
        assert not hasattr(cfg, "kernel")
        assert not hasattr(cfg, "substeps_per_launch")

    def test_fiber_flags_must_pair(self):
        import pytest

        # angle without anisotropy would run silently isotropic
        with pytest.raises(ValueError, match="isotropic"):
            SimConfig(width=8, height=8, fiber_angle=0.5)
        # ratio without a direction is meaningless
        with pytest.raises(ValueError, match="fiber_angle"):
            SimConfig(width=8, height=8, fiber_ratio=0.5)
        # valid pair passes
        SimConfig(width=8, height=8, fiber_angle=0.5, fiber_ratio=0.5)

    def test_frozen(self):
        cfg = SimConfig()
        with pytest.raises(Exception):
            cfg.width = 1024


class TestDerived:
    def test_samples(self):
        cfg = SimConfig(duration=1000, dt=0.1)
        assert cfg.samples(10) == 1000   # ionic.py:198
        assert cfg.samples(5) == 2000
        assert cfg.samples(1) == 10000

    def test_millisecond_to_step(self):
        cfg = SimConfig(dt=0.1)
        assert cfg.millisecond_to_step(210, 10) == 210
        assert cfg.millisecond_to_step(300, 5) == 600

    def test_plot_interval(self):
        cfg = SimConfig(dt=0.1, dt_per_plot=10)
        assert cfg.plot_interval(10) == 1
        assert cfg.plot_interval(5) == 2
        assert cfg.plot_interval(1) == 10

    def test_replace(self):
        cfg = SimConfig().replace(diff=0.809)
        assert cfg.diff == 0.809
