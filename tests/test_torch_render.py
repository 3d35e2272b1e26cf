"""The port's render path against the JAX package's: the whole-frame parity
renderer seed-matched in Sobol mode, ``render()``'s API, its image against
the JAX ``render()`` statistically, and the CLI."""

import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest

from minipath_tpu import Camera as JaxCamera
from minipath_tpu import RenderSettings as JaxRenderSettings
from minipath_tpu import Scene as JaxScene
from minipath_tpu import TriangleBvh as JaxTriangleBvh
from minipath_tpu import render as jax_render
from minipath_tpu.render.frame import render_frame_pallas
from minipath_tpu.render.stratify import render_seed
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.camera import CameraSampler
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.render.kernels import prepare_scene
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import from_numpy

REPO = Path(__file__).resolve().parent.parent


def _mesh(P):
    return P.merge_meshes(
        [P.make_uv_sphere(1.0, center=(0, 1.5, 0), rings=12, segments=24), P.make_cube(1.0, center=(1.5, 0.5, 0))]
    )


def _camera(cls):
    return cls().look_at((0, 2, 10), (0, 1.5, 0)).f_number(4.8).focus_distance(10)


@pytest.fixture(scope="module")
def bvh():
    return TriangleBvh.build(_mesh(procedural))


def test_frame_parity_sobol_seed_matched():
    """Sobol mode makes every ray a pure function of (pixel, sample, seed),
    so the port's frame equals the JAX kernel's up to float32 rounding:
    >= 99.9% of pixels within 1e-5, and the frame means within 1e-5."""
    jb = JaxTriangleBvh.build(_mesh(jax_procedural))
    stack = jb.recommended_stack_size
    js = _camera(JaxCamera).build_sampler((32, 32))
    key = jax.random.key(3)
    want = np.asarray(
        render_frame_pallas(
            jb.arrays, js, key, width=32, height=32, spp=4, stack_size=stack, sobol=True, interpret=True
        )
    )
    scene = prepare_scene(from_numpy(jb.host_arrays._asdict(), "cpu"))
    sampler = CameraSampler.from_numpy({k: np.asarray(v) for k, v in js._asdict().items()}, "cpu")
    got = render_frame(
        scene, sampler, None, width=32, height=32, spp=4, stack_size=stack,
        sobol=True, strat_seed=int(render_seed(key)),
    ).numpy()
    assert got.shape == want.shape == (32, 32, 4)
    close = np.all(np.abs(got - want) <= 1e-5, axis=-1)
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)), rtol=0, atol=1e-5)
    assert 0.05 < want[..., 3].mean() < 0.95  # the frame has hits and misses


def _sobol_frame(bvh, generator, **kw):
    return render_frame(
        bvh.kernel_scene("cpu"), _camera(Camera).build_sampler((32, 24), "cpu"), generator,
        width=32, height=24, spp=4, stack_size=bvh.recommended_stack_size, sobol=True, **kw,
    )


def test_render_frame_draws_its_pairing_seed_from_the_generator(bvh):
    """One pairing seed a render, drawn from the generator as the JAX
    ``render_frame_pallas`` draws it from its key: two Sobol frames from
    generators with different seeds differ, one seed reproduces bit for bit,
    and a given ``strat_seed`` gives the image it always gave, whatever the
    generator."""
    import torch

    from minipath_tpu_torch.render.stratify import render_seed as torch_render_seed

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    a, b, a2 = _sobol_frame(bvh, gen(1)), _sobol_frame(bvh, gen(2)), _sobol_frame(bvh, gen(1))
    assert torch.equal(a, a2)
    assert not torch.equal(a, b) and (a - b).abs().max().item() > 1e-3
    # The drawn seed is render_seed's first draw; given outright it makes the same frame.
    drawn = torch_render_seed(gen(1))
    assert torch.equal(a, _sobol_frame(bvh, None, strat_seed=drawn))
    assert torch.equal(_sobol_frame(bvh, gen(1), strat_seed=99), _sobol_frame(bvh, gen(2), strat_seed=99))
    assert torch.equal(_sobol_frame(bvh, gen(1), strat_seed=99), _sobol_frame(bvh, None, strat_seed=99))
    # The seed 0 that frames had before the repair is now one seed among others.
    assert not torch.equal(a, _sobol_frame(bvh, None, strat_seed=0))


def test_render_frame_strata_pairings_follow_the_generator(bvh):
    """Jittered strata (no Sobol): frames from two generators differ, and so
    do two frames of one seed whose pairing seeds differ."""
    import torch

    def frame(seed, **kw):
        return render_frame(
            bvh.kernel_scene("cpu"), _camera(Camera).build_sampler((32, 24), "cpu"),
            torch.Generator().manual_seed(seed), width=32, height=24, spp=4,
            stack_size=bvh.recommended_stack_size, **kw,
        )

    assert torch.equal(frame(5), frame(5)) and not torch.equal(frame(5), frame(6))
    assert not torch.equal(frame(5, strat_seed=1), frame(5, strat_seed=2))


@pytest.mark.parametrize("kw", [dict(sobol=True), dict(strat_seed=3), dict(sobol=False, strat_seed=3)],
                         ids=["sobol_no_seed", "strata_with_seed", "strata"])
def test_render_frame_without_a_generator_needs_sobol_and_a_seed(bvh, kw):
    with pytest.raises(ValueError, match="generator=None"):
        render_frame(
            bvh.kernel_scene("cpu"), _camera(Camera).build_sampler((32, 24), "cpu"), None,
            width=32, height=24, spp=4, stack_size=bvh.recommended_stack_size, **kw,
        )


def test_render_api_surface(bvh):
    events = []
    lock = threading.Lock()

    def started(tile):
        with lock:
            events.append(("start", tuple(tile.min)))

    def finished(tile, snap):
        with lock:
            events.append(("finish", tuple(tile.min), snap.finished, snap.total))

    settings = RenderSettings(tile_size=16, sample_count=4, resolution=(40, 24))
    p = render(Scene(bvh), _camera(Camera), settings, started, finished, device="cpu")
    p.wait()
    assert p.is_finished()
    img = p.image()
    assert img.shape == (24, 40, 4) and img.dtype == np.uint8
    n_tiles = 3 * 2
    assert p.progress().finished == p.progress().total == n_tiles
    assert p.spp_effective == 4
    fin = [e for e in events if e[0] == "finish"]
    assert [e[2] for e in fin] == list(range(1, n_tiles + 1))
    assert all(e[3] == n_tiles for e in fin)
    # Every tile is started before it finishes.
    for e in fin:
        assert events.index(("start", e[1])) < events.index(e)
    assert p.elapsed() > 0 and p.elapsed() == p.elapsed()  # frozen once finished
    assert (img[..., 3] > 0).any()
    assert "dispatch" in p.timings().summary()


def test_render_abort_stops_new_tiles(bvh):
    """Aborted while its first batch of tiles is starting, the render
    finishes that batch and starts no other."""
    settings = RenderSettings(tile_size=4, sample_count=1, resolution=(48, 48))
    started, gate = threading.Event(), threading.Event()

    def on_start(tile):
        started.set()
        gate.wait(timeout=30)

    p = render(Scene(bvh), _camera(Camera), settings, on_start, lambda t, s: None, device="cpu")
    assert started.wait(timeout=30)
    p.abort()
    gate.set()
    p.wait()
    assert 0 < p.progress().finished < p.progress().total == 144
    assert p.image().shape == (48, 48, 4)


def test_render_matches_jax_render_statistically(bvh):
    """Independent random samples on each side: alpha coverage within 1%
    and mean value within 2% at 16 spp."""
    settings = dict(tile_size=16, sample_count=16, resolution=(64, 48))
    pj = jax_render(JaxScene(JaxTriangleBvh.build(_mesh(jax_procedural))), _camera(JaxCamera),
                    JaxRenderSettings(**settings), backend="xla")
    pt = render(Scene(bvh), _camera(Camera), RenderSettings(**settings), device="cpu", seed=7)
    pj.wait()
    pt.wait()
    want, got = pj.image().astype(np.float64) / 255, pt.image().astype(np.float64) / 255
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 0.01
    assert abs(got[..., 0].mean() - want[..., 0].mean()) <= 0.02 * want[..., 0].mean()
    assert want[..., 3].mean() > 0.05


def test_cli_cpu_writes_png(tmp_path):
    out = tmp_path / "cli.png"
    proc = subprocess.run(
        [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "sphere-mesh", "--width", "48",
         "--height", "32", "--spp", "2", "--tile-size", "16", "--device", "cpu", "-q", "-o", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (32, 48, 4)
    assert (img[..., 3] > 0).any()


def test_render_rejects_unsupported_object():
    with pytest.raises(TypeError):
        render(Scene(object()), _camera(Camera), RenderSettings(16, 1, (16, 16)), device="cpu")


def test_render_tile_rng_and_samples_per_pass(bvh, monkeypatch):
    """``tile_rng`` orders the tiles as the JAX ``render()`` orders them for
    the same NumPy generator, and by default the render seed's generator
    does. ``samples_per_pass`` caps each pass; the port renders the sample
    count exactly (5 as 2 + 2 + 1), where the JAX package rounds it up to
    equal passes (3 x 2)."""
    from minipath_tpu_torch.render import integrator

    settings = dict(tile_size=16, sample_count=5, resolution=(64, 48))
    jax_order = []
    pj = jax_render(JaxScene(JaxTriangleBvh.build(_mesh(jax_procedural))), _camera(JaxCamera),
                    JaxRenderSettings(**settings), lambda t: jax_order.append(tuple(t.min)), None,
                    samples_per_pass=2, tile_rng=np.random.default_rng(0), backend="xla")
    pj.wait()
    assert pj.spp_effective == 6

    passes = []
    inner = integrator.render_tile_batch_bvh

    def counted(*a, spp, **kw):
        passes.append(spp)
        return inner(*a, spp=spp, **kw)

    monkeypatch.setattr(integrator, "render_tile_batch_bvh", counted)

    def port_order(**kw):
        order = []
        p = render(Scene(bvh), _camera(Camera), RenderSettings(**settings), lambda t: order.append(tuple(t.min)),
                   None, device="cpu", **kw)
        p.wait()
        assert p.spp_effective == 5 and (p.image()[..., 3] > 0).any()
        return order

    got = port_order(samples_per_pass=2, tile_rng=np.random.default_rng(0), seed=3)
    assert got == jax_order and len(got) == 4 * 3
    assert passes == [2, 2, 1]  # one dispatch of all 12 tiles
    passes.clear()
    assert port_order(seed=0) == jax_order  # tile_rng defaults to default_rng(seed)
    assert passes == [5]
    assert port_order(seed=1) != jax_order


def _rgba_agree(got, want, rgb_share=1e-3):
    """Two engines' uint8 images of one seed: alpha equal, RGB within one
    8-bit level on at most ``rgb_share`` of the values (the normals of the
    two engines differ in the last bits)."""
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert np.array_equal(got[..., 3], want[..., 3])
    assert diff[..., :3].max() <= 1
    assert (diff[..., :3] > 0).mean() <= rgb_share


@pytest.fixture(scope="module")
def atrium_bvh():
    return TriangleBvh.build(procedural.make_atrium(0))


@pytest.mark.parametrize("mode", ["frame", "tile"])
def test_render_portable_matches_kernel(atrium_bvh, mode):
    """``render(backend="portable")`` traces the rays ``render()`` traces
    (the same draws and strata) with the portable engine: the same image up
    to one level, in frame and in tile mode."""
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    settings = RenderSettings(tile_size=16, sample_count=4, resolution=(32, 16))
    callback = None if mode == "frame" else (lambda tile, snapshot: None)
    images = {}
    for backend in ("kernel", "portable"):
        p = render(Scene(atrium_bvh), camera, settings, finished_tile_callback=callback, device="cpu", seed=5,
                   backend=backend)
        p.wait()
        assert p.progress().finished == p.progress().total == 2
        images[backend] = p.image()
    _rgba_agree(images["portable"], images["kernel"])
    assert (images["portable"][..., 3] > 0).mean() > 0.9


def test_render_portable_over_a_mesh_is_bit_for_bit(bvh):
    """Each shard traces whole packets, one by one: a two-device mesh gives
    the meshless image bit for bit."""
    settings = RenderSettings(tile_size=16, sample_count=3, resolution=(48, 32))
    images = []
    for mesh in (None, ("cpu",) * 2):
        p = render(Scene(bvh), _camera(Camera), settings, device=None if mesh else "cpu", seed=11,
                   backend="portable", mesh=mesh)
        p.wait()
        images.append(p.image())
    assert np.array_equal(images[0], images[1])
    assert (images[0][..., 3] > 0).any()


def test_render_portable_matches_jax_xla_statistically(bvh):
    """Against the JAX ``render(backend="xla")``, whose portable engine draws
    other random samples: alpha coverage within 1% and mean value within 2%
    at 16 spp."""
    settings = dict(tile_size=16, sample_count=16, resolution=(64, 48))
    pj = jax_render(JaxScene(JaxTriangleBvh.build(_mesh(jax_procedural))), _camera(JaxCamera),
                    JaxRenderSettings(**settings), backend="xla")
    pt = render(Scene(bvh), _camera(Camera), RenderSettings(**settings), device="cpu", seed=7, backend="portable")
    pj.wait()
    pt.wait()
    want, got = pj.image().astype(np.float64) / 255, pt.image().astype(np.float64) / 255
    assert abs(got[..., 3].mean() - want[..., 3].mean()) <= 0.01
    assert abs(got[..., 0].mean() - want[..., 0].mean()) <= 0.02 * want[..., 0].mean()
    assert want[..., 3].mean() > 0.05


@pytest.mark.parametrize("backend", ["auto", "xla", "pallas", "Portable", ""])
def test_render_rejects_an_unknown_backend(bvh, backend):
    """Only "kernel" and "portable": the JAX package's "auto" has no
    counterpart, and its "xla" and "pallas" are named otherwise here."""
    with pytest.raises(ValueError, match="kernel"):
        render(Scene(bvh), _camera(Camera), RenderSettings(16, 1, (16, 16)), device="cpu", backend=backend)


def test_sphere_ignores_backend():
    from minipath_tpu_torch import Sphere

    settings = RenderSettings(tile_size=16, sample_count=2, resolution=(32, 24))
    images = []
    for backend in ("kernel", "portable"):
        p = render(Scene(Sphere()), _camera(Camera), settings, device="cpu", seed=3, backend=backend)
        p.wait()
        images.append(p.image())
    assert np.array_equal(images[0], images[1]) and (images[0][..., 3] > 0).any()
