"""Render scheduler and progress control.

Behavioral counterpart of ``minipath/src/renderer/machinery.rs`` and port of
``minipath_tpu/render/machinery.py``. One *render thread* streams batches of
tiles to the device; the device is the parallel machine, so tile-level
parallelism becomes a batch of tiles inside one trace, and the host thread
exists to enqueue work and stream results back progressively.

``render()`` keeps the reference's non-blocking contract and the full
``RenderProgress`` surface (``machinery.rs:125-178``): ``progress()``,
``is_finished()``, ``elapsed()``, ``abort()`` (cooperative: running tiles
finish, new ones don't start), ``wait()``, ``image()``.

The device is explicit: there is no silent switch to another engine;
``render(backend="portable")`` asks for the portable one by name. The
sample count is rendered exactly, in passes of at most
:data:`SAMPLES_PER_PASS` samples or ``render(samples_per_pass=)``
(``spp_effective`` reports it), where the JAX package rounds it up to
equal passes.

While tracing is on (``utils/profiling.py``), a render records the spans
``render.start``, ``render.wait`` and ``render.image`` on the caller's
thread and, on the render thread, ``render.frame`` holding each dispatch's
``render.dispatch``, ``render.fetch`` and ``render.write_back``, all under
one request id, and counts the host time of the tile callbacks
(``render.callback_ns``). It never synchronizes the device: its host waits
are the fetches.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from minipath_tpu_torch.camera import Camera
from minipath_tpu_torch.parallel import replicate
from minipath_tpu_torch.render import integrator
from minipath_tpu_torch.scene import Scene
from minipath_tpu_torch.scene.primitives import Sphere
from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh
from minipath_tpu_torch.screen_block import ScreenBlock
from minipath_tpu_torch.utils.profiling import PhaseTimers, count, current, new_request, recording, span

# Pixel-block shape of one traversal packet. 16x16 = 256 pixels.
PACKET_SHAPE = (16, 16)
# Rays traced per dispatch at most (about 4 GB of rays, hits and shading
# temporaries); larger frames take several dispatches.
MAX_RAYS_PER_DISPATCH = 1 << 25
# Samples per pixel traced in one pass at most.
SAMPLES_PER_PASS = 32
# The engines that trace a TriangleBvh (render(backend=)).
BACKENDS = ("kernel", "portable")


def _finalize_u8(acc: torch.Tensor, spp: int) -> torch.Tensor:
    """Mean + uint8 conversion on the device (``worker.rs:69-76``:
    round(c*255), clamped)."""
    with span("render.finalize"):
        mean = acc / spp
        return torch.clamp(torch.round(mean * 255.0), 0.0, 255.0).to(torch.uint8)


def _callback(callback, *args) -> None:
    """Call a user's tile callback; while tracing, count its host time
    (``render.callback_ns``)."""
    if not recording():
        callback(*args)
        return
    t0 = time.perf_counter_ns()
    callback(*args)
    count("render.callback_ns", time.perf_counter_ns() - t0)


@dataclass(frozen=True)
class RenderSettings:
    """Counterpart of ``renderer/mod.rs:8-13``. ``resolution`` is (w, h)."""

    tile_size: int
    sample_count: int
    resolution: tuple

    def __post_init__(self):
        assert self.tile_size >= 1
        assert self.sample_count >= 1


@dataclass
class RenderProgressSnapshot:
    finished: int
    total: int

    def percent(self) -> float:
        return 100.0 * self.finished / self.total if self.total else 100.0


class _RenderState:
    def __init__(self, image: np.ndarray, tiles: list):
        self.image = image
        self.image_lock = threading.Lock()
        self.tiles = tiles
        self.finished_count = 0
        self.abort_flag = threading.Event()
        self.start_time = time.monotonic()
        self.end_time: float | None = None
        self.timers = PhaseTimers("render.")
        self.error: BaseException | None = None
        # Frame mode (no tile callbacks): tiles are placed into this device
        # frame and the host fetches ONE image at the end.
        self.frame_dev: torch.Tensor | None = None
        self.frame_fetch = None  # callable fetching frame_dev into .image; None once it is there whole


class RenderProgress:
    """Handle to an in-flight render (``machinery.rs:125-178``)."""

    def __init__(self, state: _RenderState, thread: threading.Thread, spp_effective: int, request: int):
        self._state = state
        self._thread = thread
        self._request = request  # the spans' request id
        #: Samples rendered per pixel (``RenderSettings.sample_count``).
        self.spp_effective = spp_effective

    def progress(self) -> RenderProgressSnapshot:
        return RenderProgressSnapshot(
            finished=self._state.finished_count, total=len(self._state.tiles)
        )

    def is_finished(self) -> bool:
        return not self._thread.is_alive()

    def elapsed(self) -> float:
        """Seconds since render start; stops counting when finished."""
        end = self._state.end_time
        return (end if end is not None else time.monotonic()) - self._state.start_time

    def abort(self) -> None:
        """Cooperative abort: in-flight tiles finish, no new tiles start."""
        self._state.abort_flag.set()

    def wait(self) -> None:
        """Block until the render ends; re-raises a failure of the render thread."""
        with span("render.wait", request=self._request):
            self._thread.join()
        if self._state.error is not None:
            raise RuntimeError("render failed") from self._state.error

    def image(self) -> np.ndarray:
        """Snapshot of the (possibly partial) RGBA uint8 image."""
        with span("render.image", request=self._request):
            fetch = self._state.frame_fetch
            if fetch is not None:
                fetch()  # frame mode, still rendering or failed: pull the device buffer down first
            with self._state.image_lock:
                return self._state.image.copy()

    def timings(self) -> PhaseTimers:
        """Per-phase accumulators of the host's time: ``dispatch`` (ray
        generation, traversal, shading and byte conversion of a batch of
        tiles, enqueued) and ``fetch`` (the copy to the host, which waits
        for that batch's device work). No phase synchronizes the device: a
        phase's device time comes from a trace of its span,
        ``render.dispatch`` or ``render.fetch``."""
        return self._state.timers


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def place_tiles(frame: torch.Tensor, tiles_u8: torch.Tensor, origins: torch.Tensor, tile_size: int) -> None:
    """Writes a batch of tiles into frame mode's device buffer ``frame``,
    ``(height + 1, width + 1, 4)``, in one scatter. ``tiles_u8`` ``(K, th,
    tw, 4)`` are traced at the packet-rounded shape; ``origins`` ``(K, 2)``
    are the tiles' ``min`` as (x, y). A tile covers ``tile_size`` pixels a
    side, clipped at the frame's edge (``ScreenBlock.tile_ordering``). The
    positions past that extent go to the pad row or column, which is never
    fetched: no tile writes over a neighbour, and the writes to the image
    are disjoint, which a CUDA scatter needs to be deterministic (it leaves
    the winner of a duplicate index unspecified)."""
    _, th, tw, _ = tiles_u8.shape
    height, width = frame.shape[0] - 1, frame.shape[1] - 1
    dy = torch.arange(th, device=frame.device)[None, :, None]
    dx = torch.arange(tw, device=frame.device)[None, None, :]
    yy = origins[:, 1].long()[:, None, None] + dy
    xx = origins[:, 0].long()[:, None, None] + dx
    yy = torch.where((dy < tile_size) & (yy < height), yy, height)
    xx = torch.where((dx < tile_size) & (xx < width), xx, width)
    frame[yy, xx] = tiles_u8


def render(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    started_tile_callback=None,
    finished_tile_callback=None,
    *,
    device=None,
    seed: int = 0,
    samples_per_pass: int | None = None,
    tile_rng=None,
    backend: str = "kernel",
    mesh=None,
) -> RenderProgress:
    """Start rendering on ``device`` (default ``cuda``); returns immediately
    with a :class:`RenderProgress`. The scene's object is a ``TriangleBvh``
    (traced by K1, or K3 over the quantized layout) or the analytic
    ``Sphere`` (intersected in closed form, no kernel); anything else raises
    ``TypeError``.

    ``backend`` picks the engine that traces a ``TriangleBvh``:
    ``"kernel"`` (K1, or K3 over the quantized layout) or ``"portable"``
    (the portable engine of ``render/traversal.py`` over the f32 tree, one
    host sync a traversal step: an independent check of the kernels' image,
    not a render path). For one seed both trace the same rays. A ``Sphere``
    ignores it; any other value raises ``ValueError``. The JAX package's
    ``"auto"`` has no counterpart: the device is explicit and nothing falls
    back.

    ``mesh``: an optional sequence of devices
    (``parallel.make_device_mesh``; it may repeat one). The render then runs
    on ``mesh[0]`` (``device`` must be None or that device): each dispatch's
    rays are made there as without a mesh, and each device traces and
    shades a contiguous share of them over its own copy of the scene, so
    the image is bit-identical to the single-device render's for the same
    seed.

    Callbacks fire on the render thread: ``started_tile_callback(tile)`` and
    ``finished_tile_callback(tile, snapshot)`` with a
    :class:`RenderProgressSnapshot`, mirroring ``machinery.rs:75,93-99``.
    Without callbacks the render runs in frame mode: tiles are placed into
    a frame on the device and fetched once. ``seed`` seeds the film and
    lens samples (a ``torch.Generator`` on ``device``), each pass's stratum
    seed and the tile order: one seed gives one image.

    ``samples_per_pass`` caps the samples traced in one pass (default
    :data:`SAMPLES_PER_PASS`); the last pass takes the remainder.
    ``tile_rng``, a NumPy ``Generator``, draws the tiles' order in place of
    ``np.random.default_rng(seed)``.
    """
    obj = scene.object
    if not isinstance(obj, (TriangleBvh, Sphere)):
        raise TypeError(f"Unsupported scene object: {type(obj)!r}")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if mesh is not None:
        mesh = tuple(torch.device(d) for d in mesh)
        if device is not None and torch.device(device) not in (mesh[0], torch.device(mesh[0].type)):
            raise ValueError(f"device {device} is not the mesh's first device {mesh[0]}")
        device = mesh[0]
    device = torch.device("cuda" if device is None else device)
    request = new_request()
    with span("render.start", request=request):
        width, height = settings.resolution
        # Tiles are traced at a packet-multiple shape; each is cropped to its own
        # extent where it is written back (tile mode) or placed (frame mode).
        tile_shape = (
            _round_up(settings.tile_size, PACKET_SHAPE[0]),
            _round_up(settings.tile_size, PACKET_SHAPE[1]),
        )
        th, tw = tile_shape

        screen = ScreenBlock.with_size((0, 0), (width, height))
        if tile_rng is None:
            tile_rng = np.random.default_rng(seed)
        tiles = screen.tile_ordering(settings.tile_size, rng=tile_rng)
        state = _RenderState(np.zeros((height, width, 4), np.uint8), tiles)

        spp_total = settings.sample_count
        max_pass = samples_per_pass or SAMPLES_PER_PASS
        passes = [min(max_pass, spp_total - s) for s in range(0, spp_total, max_pass)]

        sampler = camera.build_sampler(settings.resolution, device)
        batch_kw = dict(tile_shape=tile_shape, packet_shape=PACKET_SHAPE)
        if isinstance(obj, TriangleBvh):
            batch_kw["stack_size"] = obj.recommended_stack_size
            if backend == "portable":
                tree, batch_fn = obj.arrays(device), integrator.render_tile_batch_bvh_portable
            else:
                tree, batch_fn = obj.kernel_scene(device), integrator.render_tile_batch_bvh
        else:
            # The analytic sphere: no scene layout and no kernel launch.
            tree, batch_fn = obj, integrator.render_tile_batch_sphere
        if mesh is not None:
            tree = replicate(tree, mesh)

        def tile_batch(origins, spp, strat_seed):
            return batch_fn(tree, sampler, origins, generator, strat_seed, spp=spp, mesh=mesh, **batch_kw)

        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        # One stratum seed per pass, from the render seed.
        pass_seeds = [
            int(s) for s in np.random.default_rng(seed).integers(-(2**31), 2**31, len(passes))
        ]

        frame_mode = started_tile_callback is None and finished_tile_callback is None
        dispatch_cap = 1024 if frame_mode else 64
        by_memory = MAX_RAYS_PER_DISPATCH // (th * tw * max(passes))
        tiles_per_dispatch = max(1, min(dispatch_cap, by_memory, len(tiles)))

        def compute_batch(batch):
            origins = torch.tensor(
                np.array([t.min for t in batch], np.float32), device=device
            )
            acc = None
            with state.timers.phase("dispatch"):
                for spp, strat_seed in zip(passes, pass_seeds):
                    part = tile_batch(origins, spp, strat_seed)
                    acc = part if acc is None else acc + part
                return _finalize_u8(acc, spp_total), origins

        def write_batch(batch, tiles_u8):
            with state.timers.phase("fetch"):
                tiles_u8 = tiles_u8.cpu().numpy()
            with span("render.write_back"):
                for tile, tile_img in zip(batch, tiles_u8):
                    x0, y0 = int(tile.min[0]), int(tile.min[1])
                    x1, y1 = int(tile.max[0]), int(tile.max[1])
                    with state.image_lock:
                        state.image[y0:y1, x0:x1] = tile_img[: y1 - y0, : x1 - x0]
                    state.finished_count += 1
                    if finished_tile_callback is not None:
                        _callback(
                            finished_tile_callback,
                            tile,
                            RenderProgressSnapshot(finished=state.finished_count, total=len(tiles)),
                        )

        if frame_mode:
            # One pad row and column, never fetched (place_tiles).
            state.frame_dev = torch.zeros((height + 1, width + 1, 4), dtype=torch.uint8, device=device)
            def fetch_frame():
                with state.timers.phase("fetch"), state.image_lock:
                    torch.from_numpy(state.image).copy_(state.frame_dev[:height, :width])

            state.frame_fetch = fetch_frame

            def place_batch(batch, tiles_u8, origins):
                place_tiles(state.frame_dev, tiles_u8, origins, settings.tile_size)
                state.finished_count += len(batch)

        parent = current()  # render.start's span, the render thread's root's parent

        def run():
            try:
                with span("render.frame", request=request, parent=parent):
                    for start in range(0, len(tiles), tiles_per_dispatch):
                        if state.abort_flag.is_set():
                            break
                        batch = tiles[start : start + tiles_per_dispatch]
                        if started_tile_callback is not None:
                            for t in batch:
                                _callback(started_tile_callback, t)
                        tiles_u8, origins = compute_batch(batch)
                        if frame_mode:
                            place_batch(batch, tiles_u8, origins)
                        else:
                            write_batch(batch, tiles_u8)
                    if frame_mode:
                        fetch_frame()
                        state.frame_fetch = None  # the whole frame is on the host: image() copies it
            except Exception as e:  # re-raised by RenderProgress.wait()
                state.error = e
            finally:
                state.end_time = time.monotonic()

        thread = threading.Thread(target=run, name="minipath-render", daemon=True)
        thread.start()
    return RenderProgress(state, thread, spp_total, request)
