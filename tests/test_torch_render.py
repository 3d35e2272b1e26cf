"""The port's render path against the JAX package's: the whole-frame parity
renderer seed-matched in Sobol mode, ``render()``'s API, its image against
the JAX ``render()`` statistically, and the CLI."""

import math
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

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
from minipath_tpu_torch.render import machinery
from minipath_tpu_torch.render.frame import render_frame
from minipath_tpu_torch.render.kernels import prepare_scene
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.primitives import Sphere
from minipath_tpu_torch.scene.bvh.build import from_numpy
from minipath_tpu_torch.screen_block import ScreenBlock, divide_range

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


def _nan_on_miss(normal, hit):
    return torch.where(hit[..., None], normal, torch.nan)


@pytest.mark.parametrize("engine", ["kernel", "portable", "sphere"])
def test_tile_engines_shade_by_one_rule(bvh, monkeypatch, engine):
    """Each tile engine's image follows the one parity shader's rule on one
    seed: a hit sums ``|d.n|`` with alpha 1, a miss sums 0 with alpha 0. A
    miss's normal, made non-finite here, never reaches the image."""
    from minipath_tpu_torch.render import integrator

    seen = []  # (direction, normal, hit) of every lane, as the trace returned them
    stack = dict(stack_size=bvh.recommended_stack_size)
    if engine == "kernel":
        real_trace = integrator.trace_scene

        def trace(scene, rays9, **kw):
            kh = real_trace(scene, rays9, **kw)
            kh = kh._replace(normal=_nan_on_miss(kh.normal, kh.tri >= 0))
            seen.append((rays9[:, 3:6].transpose(1, 2), kh.normal, kh.tri >= 0))
            return kh

        monkeypatch.setattr(integrator, "trace_scene", trace)
        scene, fn = bvh.kernel_scene("cpu"), integrator.render_tile_batch_bvh
    elif engine == "portable":
        real_intersect = integrator.intersect_bvh

        def intersect(arrays, rays, **kw):
            hits = real_intersect(arrays, rays, **kw)
            hits = hits._replace(normal=_nan_on_miss(hits.normal, hits.hit))
            seen.append((rays.direction, hits.normal, hits.hit))
            return hits

        monkeypatch.setattr(integrator, "intersect_bvh", intersect)
        scene, fn = bvh.arrays("cpu"), integrator.render_tile_batch_bvh_portable
    else:
        class Recorded(Sphere):
            def intersect(self, rays, t_max=math.inf):
                hits = super().intersect(rays, t_max)
                hits = hits._replace(normal=_nan_on_miss(hits.normal, hits.hit))
                seen.append((rays.direction, hits.normal, hits.hit))
                return hits

        scene, fn, stack = Recorded(center=(0.0, 1.5, 0.0), radius=1.0), integrator.render_tile_batch_sphere, {}
    tile_shape, packet_shape = (16, 16), (8, 8)
    origins = torch.tensor([[0.0, 0.0], [16.0, 16.0], [32.0, 0.0]])
    sampler = _camera(Camera).build_sampler((48, 32), "cpu")
    # One sample a pixel: each pixel's sum is its one sample.
    got = fn(scene, sampler, origins, torch.Generator().manual_seed(9), 123, tile_shape=tile_shape,
             packet_shape=packet_shape, spp=1, **stack)

    (d, n, hit), = seen
    shaded = torch.where(hit, torch.abs(torch.sum(d * n, dim=-1)), 0.0)
    want = torch.stack([shaded, shaded, shaded, hit.to(torch.float32)], dim=-1)
    want = integrator.unpack_tile(want.reshape(3, -1, 64, 4), tile_shape, packet_shape)
    miss = want[..., 3] == 0
    assert got.shape == (3, 16, 16, 4) and torch.isfinite(got).all()
    assert 0.05 < miss.float().mean() < 0.95
    assert not got[miss].any() and (got[~miss][:, 3] == 1.0).all()
    assert torch.equal(got, want)


# Frame mode against tile mode: (tile_size, square resolution), one dispatch
# of at most 64 tiles either way, so both draw the same jitter.
TILE_SIZES_OFF_THE_PACKET = {40: 96, 24: 96, 8: 64}
PLACEMENT_SEED = 3


def _render_image(bvh, tile_size, resolution, callback=None, mesh=None):
    settings = RenderSettings(tile_size=tile_size, sample_count=4, resolution=(resolution, resolution))
    p = render(Scene(bvh), _camera(Camera), settings, finished_tile_callback=callback,
               device=None if mesh else "cpu", seed=PLACEMENT_SEED, mesh=mesh)
    p.wait()
    return p.image()


@pytest.mark.parametrize("mesh", [None, ("cpu",) * 3], ids=["one device", "mesh of 3"])
@pytest.mark.parametrize("tile_size", list(TILE_SIZES_OFF_THE_PACKET))
def test_frame_mode_equals_tile_mode_off_the_packet_size(bvh, tile_size, mesh):
    """A tile size that is not a multiple of 16 is traced at the
    packet-rounded shape; frame mode places only each tile's own extent, as
    tile mode writes it back, so the two images are equal bit for bit (the
    placement before, which wrote the padding over the neighbours, differed
    on hundreds of pixels here)."""
    resolution = TILE_SIZES_OFF_THE_PACKET[tile_size]
    frame = _render_image(bvh, tile_size, resolution, mesh=mesh)
    tiled = _render_image(bvh, tile_size, resolution, callback=lambda tile, snapshot: None)
    assert np.array_equal(frame, tiled)
    assert 0.05 < (frame[..., 3] > 0).mean() < 0.95


def _parent_placement(tiles, tiles_u8, width, height):
    """Frame mode's placement before the repair, as a plain function: each
    tile's whole packet-rounded block at its origin, in one scatter, into a
    frame padded by one tile, cropped once."""
    _, th, tw, _ = tiles_u8.shape
    frame = torch.zeros((height + th, width + tw, 4), dtype=torch.uint8)
    origins = torch.tensor(np.array([t.min for t in tiles]))
    yy = origins[:, 1][:, None, None] + torch.arange(th)[None, :, None]
    xx = origins[:, 0][:, None, None] + torch.arange(tw)[None, None, :]
    frame[yy, xx] = tiles_u8
    return frame[:height, :width].numpy()


@pytest.mark.parametrize("tile_size", [48, 64])
def test_frame_mode_keeps_its_image_at_packet_multiples(bvh, monkeypatch, tile_size):
    """At a tile size that is a multiple of 16 (the CLI's, the GUI's and the
    bench's 64) no tile has padding inside the frame: the image is the one
    the placement before the repair gave, edge tiles cropped at the frame's
    edge included."""
    batches = []
    finalize = machinery._finalize_u8

    def recording(acc, spp):
        batches.append(finalize(acc, spp))
        return batches[-1]

    monkeypatch.setattr(machinery, "_finalize_u8", recording)
    got = _render_image(bvh, tile_size, 96)
    tiles = ScreenBlock.with_size((0, 0), (96, 96)).tile_ordering(tile_size, rng=np.random.default_rng(PLACEMENT_SEED))
    assert len(batches) == 1 and batches[0].shape[0] == len(tiles)
    assert np.array_equal(got, _parent_placement(tiles, batches[0], 96, 96))


def _plain_tile_ordering(block, tile_size, rng):
    """``ScreenBlock.tile_ordering`` as one loop: each tile's center
    distance and its own draw, one after the other (``screen_block.rs:41-81``)."""
    center = block.center().astype(np.float64)
    tiles = [
        ScreenBlock((x0, y0), (x1, y1))
        for (y0, y1) in divide_range(int(block.min[1]), int(block.max[1]), tile_size)
        for (x0, x1) in divide_range(int(block.min[0]), int(block.max[0]), tile_size)
    ]
    scale = float(np.linalg.norm(center)) * 0.1
    keys = []
    for tile in tiles:
        jitter = rng.exponential(scale) if scale > 0 else 0.0
        keys.append(float(np.linalg.norm(center - tile.center())) + jitter)
    return [tiles[i] for i in np.argsort(keys, kind="stable")]


@pytest.mark.parametrize(
    "origin,size,tile",
    [((0, 0), (1920, 1080), 64), ((3, 5), (37, 51), 8), ((10, 20), (640, 480), 7), ((0, 0), (1, 1), 4)],
)
def test_tile_ordering_keeps_its_order_and_draws(origin, size, tile):
    """The grid and its distances, kept between calls, give the order and
    consume the draws that the per-tile loop does, seed by seed; each call's
    tiles are its own, so changing one leaves the next call's as they were."""
    block = ScreenBlock.with_size(origin, size)
    for seed in range(6):
        got_rng, want_rng = np.random.default_rng(seed), np.random.default_rng(seed)
        got = block.tile_ordering(tile, rng=got_rng)
        want = _plain_tile_ordering(block, tile, want_rng)
        assert [(t.min.tolist(), t.max.tolist()) for t in got] == [(t.min.tolist(), t.max.tolist()) for t in want]
        assert got_rng.random() == want_rng.random()
    first = block.tile_ordering(tile, rng=np.random.default_rng(0))
    first[0].extend_point(np.array([10**6, 10**6]))
    again = block.tile_ordering(tile, rng=np.random.default_rng(0))
    assert again[0] is not first[0] and again[0].max.tolist() != [10**6, 10**6]


def test_frame_mode_fetches_the_finished_frame_once(bvh):
    """The render thread pulls the finished frame down into the host image;
    ``image()`` then copies it and fetches nothing, however often it is
    called, and the image is tile mode's."""
    settings = RenderSettings(tile_size=16, sample_count=4, resolution=(48, 48))
    progress = render(Scene(bvh), _camera(Camera), settings, device="cpu", seed=PLACEMENT_SEED)
    progress.wait()
    first, second = progress.image(), progress.image()
    assert progress.timings().stats("fetch").count == 1
    assert first is not second and np.array_equal(first, second)
    assert np.array_equal(first, _render_image(bvh, 16, 48, callback=lambda tile, snapshot: None))


def test_a_failed_frame_mode_render_still_shows_its_placed_tiles(bvh, monkeypatch):
    """A render thread that fails after its first dispatch never fetched
    its frame: ``wait()`` raises, and ``image()`` fetches the tiles that were
    placed, as a render still running would show them."""
    monkeypatch.setattr(machinery, "MAX_RAYS_PER_DISPATCH", 2 * 16 * 16 * 4)  # two tiles a dispatch
    sound = _render_image(bvh, 16, 48)
    real = machinery.integrator.render_tile_batch_bvh
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("second dispatch")
        return real(*args, **kw)

    monkeypatch.setattr(machinery.integrator, "render_tile_batch_bvh", failing)
    settings = RenderSettings(tile_size=16, sample_count=4, resolution=(48, 48))
    progress = render(Scene(bvh), _camera(Camera), settings, device="cpu", seed=PLACEMENT_SEED)
    with pytest.raises(RuntimeError):
        progress.wait()
    assert progress.timings().stats("fetch").count == 0
    image = progress.image()
    assert progress.timings().stats("fetch").count == 1
    tiles = ScreenBlock.with_size((0, 0), (48, 48)).tile_ordering(16, rng=np.random.default_rng(PLACEMENT_SEED))
    for k, t in enumerate(tiles):
        x0, y0, x1, y1 = int(t.min[0]), int(t.min[1]), int(t.max[0]), int(t.max[1])
        want = sound[y0:y1, x0:x1] if k < 2 else np.zeros_like(sound[y0:y1, x0:x1])
        assert np.array_equal(image[y0:y1, x0:x1], want), k
