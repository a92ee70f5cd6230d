"""Tests for checkpointing, visualization, and profiling utilities."""

import os

import numpy as np
import pytest

from fib_tf_tpu.config import SimConfig
from fib_tf_tpu.utils import checkpoint, viz
from fib_tf_tpu.utils.sharedlib import find_shared_library


class TestCheckpoint:
    def test_roundtrip_with_config(self, tmp_path):
        state = {"V": np.random.rand(8, 8).astype(np.float32),
                 "m": np.zeros((8, 8), np.float32)}
        # cell_type_bands and g_scale are tuple fields: the JSON round
        # trip hands them back as lists and __post_init__ must re-tuple
        # them or equality/hashing break (regression: r5 smoke failure)
        cfg = SimConfig(width=8, height=8, duration=10,
                        g_scale={"g_fi": 0.5})
        p = str(tmp_path / "ckpt.npz")
        checkpoint.save_state(p, state, cfg)
        got, got_cfg = checkpoint.load_state(p)
        assert set(got) == {"V", "m"}
        np.testing.assert_array_equal(got["V"], state["V"])
        assert got_cfg == cfg
        assert hash(got_cfg) == hash(cfg)

    def test_config_with_retired_fields_loads(self, tmp_path):
        """A checkpoint whose saved config still carries the retired
        kernel options loads, the options dropped."""
        import dataclasses
        import json

        cfg = SimConfig(width=8, height=8, duration=10)
        raw = {**dataclasses.asdict(cfg), "kernel": "pallas",
               "substeps_per_launch": 2}
        p = str(tmp_path / "old.npz")
        np.savez(p, **{
            "state/V": np.zeros((8, 8), np.float32),
            "config_json": np.frombuffer(json.dumps(raw).encode(),
                                         dtype=np.uint8),
        })
        got, got_cfg = checkpoint.load_state(p)
        assert got_cfg == cfg
        assert set(got) == {"V"}

    def test_reference_style_npy_dict(self, tmp_path):
        # court_ultra.py:511-519 pattern: np.save of a dict, .item(0) load
        state = {"V": np.ones((4, 4), np.float32)}
        p = str(tmp_path / "state_small.npy")
        np.save(p, state)
        got, cfg = checkpoint.load_state(p)
        np.testing.assert_array_equal(got["V"], state["V"])
        assert cfg is None


class TestViz:
    def test_headless_screen_imshow_save(self, tmp_path):
        im = viz.Screen(16, 16, "test", backend="headless")
        im.imshow(np.linspace(0, 1, 256).reshape(16, 16))
        p = str(tmp_path / "frame.png")
        im.save(p)
        assert os.path.exists(p)

    def test_annotations(self):
        im = viz.Screen(32, 32, backend="headless")
        im.draw_text("hi", (1, 1))
        im.plot(np.sin(np.linspace(0, 6, 50)))
        im.imshow(np.zeros((32, 32)))
        assert im._backend.last_frame is not None
        # annotations consumed
        assert im._annotations == []

    def test_to_rgb_colormap(self):
        rgb = viz.to_rgb(np.zeros((4, 4)), cmap="viridis")
        assert rgb.shape == (4, 4, 3)
        assert rgb.dtype == np.uint8

    def test_play_cube(self, tmp_path):
        cube = np.random.rand(5, 8, 8).astype(np.float32)
        p = str(tmp_path / "cube.npy")
        viz.save_cube(p, cube)
        im = viz.Screen(8, 8, backend="headless", keep_all_frames=True)
        viz.play_cube(p, im=im)
        assert len(im._backend.frames) == 5

    def test_find_shared_library_missing(self):
        assert find_shared_library("definitely_not_a_real_lib_xyz") is None


FAKE_SDL_SRC = r"""
#include <stdint.h>
extern "C" {
static int inited = 0, presents = 0, updates = 0, quit_pending = 0;
int SDL_Init(uint32_t f){ inited = 1; return 0; }
void* SDL_CreateWindow(const char* t,int x,int y,int w,int h,uint32_t f){
    return (void*)0x1; }
void* SDL_CreateRenderer(void* w,int i,uint32_t f){ return (void*)0x2; }
void* SDL_CreateTexture(void* r,uint32_t fmt,int a,int w,int h){
    return (void*)0x3; }
int SDL_UpdateTexture(void* t,const void* rc,const void* px,int pitch){
    updates++; return 0; }
int SDL_RenderCopy(void* r,void* t,const void* a,const void* b){ return 0; }
void SDL_RenderPresent(void* r){ presents++; }
int SDL_PollEvent(void* ev){
    if (quit_pending) { quit_pending = 0; *(uint32_t*)ev = 0x100; return 1; }
    return 0; }
void SDL_DestroyWindow(void* w){}
void fib_stub_push_quit(void){ quit_pending = 1; }
int fib_stub_presents(void){ return presents; }
int fib_stub_updates(void){ return updates; }
int fib_stub_inited(void){ return inited; }
}
"""


@pytest.fixture(scope="module")
def fake_sdl(tmp_path_factory):
    """Compile a stub libSDL2.so exposing exactly the symbols the SDL
    backend binds, so the real ctypes code path runs headlessly
    (VERDICT r1 #8)."""
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    d = tmp_path_factory.mktemp("fakesdl")
    src = d / "fake_sdl.cpp"
    src.write_text(FAKE_SDL_SRC)
    lib = d / "libSDL2.so"
    subprocess.run(
        ["g++", "-shared", "-fPIC", "-o", str(lib), str(src)], check=True
    )
    return d


class TestSDLBackend:
    def test_full_sdl_path(self, fake_sdl, monkeypatch, tmp_path):
        import ctypes

        monkeypatch.setenv("FIB_LIBRARY_PATH", str(fake_sdl))
        # auto backend detection must now pick sdl
        assert viz.Screen._pick_backend() == "sdl"

        im = viz.Screen(16, 16, "fake", backend="sdl")
        stub = im._backend._lib.cdll
        assert stub.fib_stub_inited() == 1

        im.imshow(np.linspace(0, 1, 256).reshape(16, 16))
        assert stub.fib_stub_updates() == 1
        assert stub.fib_stub_presents() == 1

        # no events queued -> not quitting
        assert im.peek() is False
        # push an SDL_QUIT through the real event-pump ctypes path
        stub.fib_stub_push_quit()
        assert im.peek() is True

        # save() must work on the SDL backend (r1: only headless could)
        p = str(tmp_path / "sdl_frame.png")
        im.save(p)
        assert os.path.exists(p)
        im.close()

    def test_wait_returns_on_quit(self, fake_sdl, monkeypatch):
        monkeypatch.setenv("FIB_LIBRARY_PATH", str(fake_sdl))
        im = viz.Screen(8, 8, backend="sdl")
        im._backend._lib.cdll.fib_stub_push_quit()
        im.wait()  # must return, not hang
        im.close()


class TestProfiling:
    def test_time_fn_and_throughput(self):
        import jax.numpy as jnp
        from fib_tf_tpu.utils import profiling

        f = lambda x: x * 2  # noqa: E731
        t = profiling.time_fn(f, jnp.ones((32, 32)), iters=2)
        assert t >= 0.0
        rep = profiling.throughput(512, 512, 10000, 1.0, 0.1)
        assert rep["wall_s_per_sim_s"] == pytest.approx(1.0)
        assert rep["cell_updates_per_sec"] == pytest.approx(512 * 512 * 1e4)

    def test_dump_hlo(self, tmp_path):
        import jax.numpy as jnp
        from fib_tf_tpu.utils import profiling

        p = profiling.dump_hlo(
            lambda x: x + 1, (jnp.ones((4, 4)),), str(tmp_path / "f.hlo")
        )
        assert os.path.getsize(p) > 0
