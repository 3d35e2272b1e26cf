"""Headless tests of the port's GUI controllers (no display), on the CPU.

The port of ``tests/test_gui.py`` case for case: there the controller's
renderer is stubbed with an instant fake, so those cases exercise only the
GUI logic (escalation, tile streaming, camera moves, cancellation). Two
cases more run the real thing, which the JAX file leaves to other tests: a
``GuiController`` over the port's ``render()`` whose final image equals
``render()``'s own for the same seed (exactly: the same generator, the same
dispatches), and the progressive path-traced controller that
``_make_pt_controller`` builds. Others pin what a controller does with a
render that failed or was aborted, and that a tile which lands while the
queue drains is not lost (the JAX controller snapshots at the first event
of a drain and can copy such a tile from before it landed). Every wait has a deadline.

``TestAgainstJax`` drives the JAX package's two controllers and the port's
with the same inputs: the same fake render of seeded noise tiles, the same
hand-queued tile events, and the same seeded noisy frames and guide buffers
for the progressive viewport, whose display (the cross-pass variance and the
filter it steers) must agree within one 8-bit level.
"""

import argparse
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import minipath_tpu.gui as jax_gui_mod
import minipath_tpu_torch.gui as gui_mod
from minipath_tpu_torch import Camera, RenderSettings, Scene, TriangleBvh, render
from minipath_tpu_torch.gui import GuiController, ProgressivePtController
from minipath_tpu_torch.render.machinery import RenderProgressSnapshot
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.screen_block import ScreenBlock


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The plain traversal is thousands of small ops, which gain nothing from
    many threads and lose a lot when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def noise_tile(tile, spp):
    """A tile of opaque noise that depends on its place and the render's spp."""
    (x0, y0), (x1, y1) = tile.min, tile.max
    px = np.random.default_rng([int(x0), int(y0), int(spp)]).integers(0, 256, (y1 - y0, x1 - x0, 4), dtype=np.uint8)
    px[..., 3] = 255
    return px


class FakeProgress:
    """Mimics RenderProgress: renders tiles on a thread via callbacks."""

    def __init__(self, settings, started_cb, finished_cb, delay=0.005, fail_after=None, noisy=False):
        w, h = settings.resolution
        self.image_arr = np.zeros((h, w, 4), np.uint8)
        self.spp = settings.sample_count
        screen = ScreenBlock.with_size((0, 0), (w, h))
        self.tiles = screen.tile_ordering(settings.tile_size, rng=np.random.default_rng(0))
        self.finished = 0
        self.error = None
        self._abort = threading.Event()

        def run():
            for i, tile in enumerate(self.tiles):
                if self._abort.is_set():
                    break
                if fail_after is not None and i >= fail_after:
                    self.error = ValueError("the device fell over")
                    break
                if started_cb:
                    started_cb(tile)
                time.sleep(delay)
                x0, y0 = tile.min
                x1, y1 = tile.max
                self.image_arr[y0:y1, x0:x1] = noise_tile(tile, self.spp) if noisy else (128, 128, 128, 255)
                self.finished = i + 1
                if finished_cb:
                    finished_cb(tile, RenderProgressSnapshot(i + 1, len(self.tiles)))

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def progress(self):
        return RenderProgressSnapshot(self.finished, len(self.tiles))

    def is_finished(self):
        return not self._thread.is_alive()

    def abort(self):
        self._abort.set()

    def wait(self):
        self._thread.join(timeout=30)
        if self.error is not None:
            raise RuntimeError("render failed") from self.error

    def image(self):
        return self.image_arr.copy()


@pytest.fixture
def fake_render(monkeypatch):
    calls = []

    def fake(scene, camera, settings, started_tile_callback=None, finished_tile_callback=None, **kw):
        calls.append((settings, kw))
        return FakeProgress(settings, started_tile_callback, finished_tile_callback)

    monkeypatch.setattr(gui_mod, "render", fake)
    return calls


def _controller(w=64, h=64, tile=32, scene=None):
    camera = Camera().look_at((0, 0, 4), (0, 0, 0))
    return GuiController(scene or Scene(object()), camera, (w, h), tile_size=tile, device="cpu")


def _pump(c, timeout=10.0, until=None):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        c.update()
        if until is not None and until():
            return True
        time.sleep(0.01)
    return False


def test_preview_escalates_to_full(fake_render):
    c = _controller()
    c.start()
    assert c.mode == "preview"
    assert fake_render[-1][0].sample_count == GuiController.PREVIEW_SPP
    assert fake_render[-1][1]["device"] == torch.device("cpu")  # the device is handed on
    assert _pump(c, until=lambda: c.mode == "full"), "never escalated to full"
    assert fake_render[-1][0].sample_count == c.full_spp  # gui.rs:216-224
    assert _pump(c, until=lambda: c.progress.is_finished())
    c.update()
    assert c.image[..., 3].max() == 255
    c.shutdown()


def test_camera_move_restarts_preview(fake_render):
    c = _controller()
    c.start()
    _pump(c, until=lambda: c.mode == "full")
    before = c.camera
    c.move_camera(1.0, 0.0, 0.0)
    assert c.mode == "preview"
    assert fake_render[-1][0].sample_count == GuiController.PREVIEW_SPP
    center_before, *_ = before.center_forward_up_right()
    center_after, *_ = c.camera.center_forward_up_right()
    np.testing.assert_allclose(center_after - center_before, [1, 0, 0], atol=1e-6)
    c.shutdown()


def test_display_image_composites(fake_render):
    c = _controller()
    img = c.display_image()  # all transparent -> checkerboard
    assert img.shape == (64, 64, 4)
    vals = np.unique(img[..., 0])
    assert len(vals) == 2  # two checker grays
    c.in_progress_tiles.append(ScreenBlock((0, 0), (32, 32)))
    img2 = c.display_image()
    assert (img2[0, :32, :3] == (255, 0, 0)).all()
    c.shutdown()


def test_cancel_drains_queue(fake_render):
    c = _controller()
    c.start()
    time.sleep(0.05)
    c.cancel_previous_render()
    assert c.pending.empty()
    assert c.progress is None
    c.shutdown()


def test_in_progress_tiles_tracked(fake_render):
    c = _controller()
    c.start()
    # While rendering, some tiles should appear as in-progress then clear.
    saw_in_progress = _pump(c, until=lambda: len(c.in_progress_tiles) > 0)
    assert saw_in_progress
    assert _pump(c, until=lambda: c.mode == "full" and c.progress.is_finished())
    c.update()
    assert c.in_progress_tiles == []
    c.shutdown()


def test_update_snapshots_after_the_drain():
    """A tile that finishes while ``update()`` drains its queue must not be
    copied from a snapshot taken before it landed: the one snapshot of a
    drain is taken after the queue is empty, and the late tile waits for
    the next drain."""
    c = _controller()
    a, b = ScreenBlock((0, 0), (32, 32)), ScreenBlock((32, 0), (64, 32))

    class Progress:
        def __init__(self):
            self.arr = np.zeros((64, 64, 4), np.uint8)
            self.arr[0:32, 0:32] = 255  # tile a has landed
            self.snapshots = 0

        def image(self):
            snap = self.arr.copy()
            self.snapshots += 1
            if self.snapshots == 1:
                # The render thread finishes tile b right after the snapshot.
                self.arr[0:32, 32:64] = 255
                c.pending.put((b, True))
            return snap

        def is_finished(self):
            return False

    c.progress, c.mode = Progress(), "full"
    c.pending.put((a, False))
    c.pending.put((a, True))
    assert c.update() is True
    assert c.progress.snapshots == 1 and c.image[0:32, 0:32].min() == 255
    assert c.update() is True  # the late tile, from a snapshot of its own
    assert c.progress.snapshots == 2 and c.image[0:32, 32:64].min() == 255
    assert c.update() is False and c.progress.snapshots == 2 and c.in_progress_tiles == []


def test_preview_ending_during_a_drain_keeps_its_last_tile(fake_render):
    """A preview that ends while ``update()`` drains: whether it has ended
    is asked before the drain, so its last finished tile is copied by the
    next drain before the escalation's cancel empties the queue."""
    c = _controller()
    a, b = ScreenBlock((0, 0), (32, 32)), ScreenBlock((32, 0), (64, 32))

    class Progress:
        def __init__(self):
            self.arr = np.zeros((64, 64, 4), np.uint8)
            self.arr[0:32, 0:32] = 255
            self.ended = False

        def image(self):
            snap = self.arr.copy()
            if not self.ended:  # the render's last tile lands, and it ends
                self.arr[0:32, 32:64] = 255
                c.pending.put((b, False))
                c.pending.put((b, True))
                self.ended = True
            return snap

        def is_finished(self):
            return self.ended

        def progress(self):
            return RenderProgressSnapshot(2, 2)

        def abort(self):
            pass

        def wait(self):
            pass

    c.progress, c.mode = Progress(), "preview"
    c.pending.put((a, True))
    assert c.update() is True and c.mode == "preview" and fake_render == []
    assert c.update() is True and c.mode == "full" and len(fake_render) == 1
    assert c.image[0:32, 0:64].min() == 255  # both tiles of the preview
    c.shutdown()


def test_failed_render_is_re_raised_and_let_go(monkeypatch):
    """A render that ends in an error neither escalates nor passes in
    silence: ``update()`` raises it, and so does the cancel of a restart,
    after which the controller holds no render and starts a new one."""
    fail = {"after": 1}

    def fake(scene, camera, settings, started_tile_callback=None, finished_tile_callback=None, **kw):
        return FakeProgress(settings, started_tile_callback, finished_tile_callback, fail_after=fail["after"])

    monkeypatch.setattr(gui_mod, "render", fake)
    c = _controller()
    c.start()
    deadline = time.monotonic() + 10
    while not c.progress.is_finished() and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="render failed") as err:
        c.update()
    assert isinstance(err.value.__cause__, ValueError)
    assert c.mode == "preview"  # a failed preview does not escalate
    with pytest.raises(RuntimeError, match="render failed"):
        c.move_camera(0.5, 0.0, 0.0)
    assert c.progress is None and c.pending.empty()
    fail["after"] = None
    c.start()
    assert _pump(c, until=lambda: c.mode == "full" and c.progress.is_finished())
    c.shutdown()


def test_aborted_render_is_no_error():
    """The real ``render()``: a controller that cancels a render in flight
    gets no error from it, drops its queue and its handle, and keeps the
    tiles that had streamed in."""
    bvh = TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=8, segments=12))
    c = GuiController(Scene(bvh), Camera().look_at((0, 0, 4), (0, 0, 0)), (64, 64), tile_size=4, full_spp=8,
                      device="cpu")
    c.start()
    assert _pump(c, timeout=60, until=lambda: c.mode == "full" and c.progress.progress().finished > 0)
    handle = c.progress
    c.cancel_previous_render()  # mid-render: 256 tiles at 8 spp, 64 a dispatch
    snap = handle.progress()
    assert handle.is_finished() and 0 < snap.finished < snap.total == 256
    assert c.progress is None and c.pending.empty()
    assert c.image[..., 3].max() == 255  # the preview's tiles stay on display
    c.shutdown()


def test_real_controller_reaches_full_and_equals_render():
    bvh = TriangleBvh.build(procedural.make_uv_sphere(1.0, rings=16, segments=32))
    c = _controller(tile=32, scene=Scene(bvh))
    c.start()
    assert _pump(c, timeout=60, until=lambda: c.mode == "full" and c.progress.is_finished()), "never finished"
    c.update()
    snap = c.progress.progress()
    assert snap.finished == snap.total == 4 and c.in_progress_tiles == []
    settings = RenderSettings(tile_size=32, sample_count=c.full_spp, resolution=(64, 64))
    p = render(Scene(bvh), c.camera, settings, device="cpu")  # frame mode, the same seed
    p.wait()
    np.testing.assert_array_equal(c.image, p.image())
    assert 0.1 < (c.image[..., 3] > 0).mean() < 0.9
    shown = c.display_image()
    assert shown.shape == (64, 64, 4) and (shown[32, 32, :3] == c.image[32, 32, :3]).all()
    c.shutdown()


class TestProgressivePt:
    """ProgressivePtController with a fake frame function."""

    def _controller(self, w=8, h=6):
        calls = {"made": 0}

        def make_frame(camera):
            calls["made"] += 1
            gen = calls["made"]

            def frame(i):
                time.sleep(0.002)
                # Distinguishable constant per generation; mean over chunks
                # of one generation equals that constant.
                return np.full((h, w, 4), 0.25 * gen, np.float32)

            return frame

        cam = Camera().look_at((0, 0, 5), (0, 0, 0))
        c = ProgressivePtController(make_frame, cam, (w, h))
        return c, calls

    def test_accumulates_and_displays_mean(self):
        c, calls = self._controller()
        c.start()
        deadline = time.time() + 20
        while c.samples() < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert c.samples() >= 3
        assert c.update() is True
        img = c.display_image()
        assert img.shape == (6, 8, 3) and img.dtype == np.uint8
        # Mean of constant 0.25 frames -> gamma(0.25)*255.
        want = int(0.25 ** (1 / 2.2) * 255 + 0.5)
        assert abs(int(img[0, 0, 0]) - want) <= 1
        c.shutdown()

    def test_camera_move_restarts_accumulation(self):
        c, calls = self._controller()
        c.start()
        deadline = time.time() + 20
        while c.samples() < 2 and time.time() < deadline:
            time.sleep(0.01)
        old_cam = c.camera
        c.move_camera(1.0, 0.0, 0.0)
        # Accumulation restarts with a new frame function + moved camera.
        deadline = time.time() + 20
        while (calls["made"] < 2 or c.samples() < 1) and time.time() < deadline:
            time.sleep(0.01)
        assert calls["made"] >= 2
        assert c.camera is not old_cam
        img = c.display_image()
        want = int(0.5 ** (1 / 2.2) * 255 + 0.5)  # generation 2 constant
        assert abs(int(img[0, 0, 0]) - want) <= 1
        c.shutdown()

    def test_display_denoise_blend(self):
        # With make_aux given, the display goes through the edge-avoiding
        # denoiser. On a constant image the filter is an identity (all
        # neighbor diffs are 0), so the displayed value must match the raw
        # mean: this checks that the aux wiring (torch tensors in, a NumPy
        # image out) does not corrupt the image.
        w, h = 8, 6

        def make_frame(camera):
            def frame(i):
                time.sleep(0.002)
                return np.full((h, w, 4), 0.25, np.float32)

            return frame

        def make_aux(camera):
            n = torch.zeros((h, w, 3))
            n[..., 1] = 1.0
            return n, torch.full((h, w), 3.0)

        cam = Camera().look_at((0, 0, 5), (0, 0, 0))
        c = ProgressivePtController(make_frame, cam, (w, h), make_aux)
        c.start()
        deadline = time.time() + 30
        while c.samples() < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert c.samples() >= 2  # from 2 passes on, the variance-guided branch
        img = c.display_image()
        want = int(0.25 ** (1 / 2.2) * 255 + 0.5)
        assert abs(int(img[0, 0, 0]) - want) <= 1
        assert abs(int(img[h // 2, w // 2, 0]) - want) <= 1
        c.shutdown()

    def test_update_reports_new_samples_only(self):
        c, _ = self._controller()
        assert c.update() is False  # nothing yet
        c.start()
        deadline = time.time() + 20
        while c.samples() < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert c.update() is True
        assert c.update() in (True, False)  # second call only if new frames
        c.shutdown()

    def test_worker_error_is_re_raised(self):
        def make_frame(camera):
            def frame(i):
                if i == 1:
                    raise ValueError("the device fell over")
                return np.zeros((6, 8, 4), np.float32)

            return frame

        c = ProgressivePtController(make_frame, Camera().look_at((0, 0, 5), (0, 0, 0)), (8, 6))
        c.start()
        c._thread.join(timeout=20)
        assert not c._thread.is_alive() and c.samples() == 1
        with pytest.raises(RuntimeError, match="worker failed") as err:
            c.update()
        assert isinstance(err.value.__cause__, ValueError)
        c.shutdown()


# ---- the port against the JAX package, on the same inputs ---------------------------

class TestAgainstJax:
    """Both packages' controllers, driven alike. The JAX ``GuiController``
    takes no ``device``; everything else is built the same way."""

    @staticmethod
    def _gui(mod):
        camera = mod.Camera().look_at((0, 0, 4), (0, 0, 0))
        kw = {"device": "cpu"} if mod is gui_mod else {}
        return mod.GuiController(mod.Scene(object()), camera, (96, 64), tile_size=32, **kw)

    def _drive_fake_render(self, mod, monkeypatch):
        spps = []

        def fake(scene, camera, settings, started_tile_callback=None, finished_tile_callback=None, **kw):
            spps.append(settings.sample_count)
            return FakeProgress(settings, started_tile_callback, finished_tile_callback, delay=0.002, noisy=True)

        monkeypatch.setattr(mod, "render", fake)
        c = self._gui(mod)
        modes, images = [], []

        def settle():
            def full_and_drained():
                if not modes or modes[-1] != c.mode:
                    modes.append(c.mode)
                return c.mode == "full" and c.progress.is_finished()

            assert _pump(c, until=full_and_drained), "never finished the full render"
            c.update()  # the last tiles of the full render
            images.append(c.image.copy())

        c.start()
        settle()
        c.move_camera(0.5, 0.0, 0.0)
        settle()
        out = dict(spps=spps, modes=modes, images=images, in_progress=list(c.in_progress_tiles),
                   shown=c.display_image(), center=c.camera.center_forward_up_right()[0])
        c.shutdown()
        return out

    def test_gui_controller_same_fake_render(self, monkeypatch):
        """Preview, full, a camera move, preview, full over the same fake
        render: the same renders are asked for in the same order, and the
        final image (the full render's noise, tile by tile) is the same."""
        jax_run = self._drive_fake_render(jax_gui_mod, monkeypatch)
        port = self._drive_fake_render(gui_mod, monkeypatch)
        assert port["spps"] == jax_run["spps"] == [1, 2, 1, 2]
        assert port["modes"] == jax_run["modes"] == ["preview", "full", "preview", "full"]
        for got, want in zip(port["images"], jax_run["images"]):
            np.testing.assert_array_equal(got, want)
        screen = ScreenBlock.with_size((0, 0), (96, 64))
        for tile in screen.tile_ordering(32, rng=np.random.default_rng(0)):
            (x0, y0), (x1, y1) = tile.min, tile.max
            np.testing.assert_array_equal(port["images"][-1][y0:y1, x0:x1], noise_tile(tile, 2))
        assert port["in_progress"] == jax_run["in_progress"] == []
        np.testing.assert_array_equal(port["shown"], jax_run["shown"])
        np.testing.assert_allclose(port["center"], jax_run["center"], atol=1e-6)

    @pytest.mark.parametrize("events", [
        "sa sb fa sc",  # a is done, b and c are in flight
        "sa sb sc fb fa",  # finished out of order
        "sa fa sb fb sc fc",  # all done
        "sa sb",  # nothing done: no snapshot is taken
    ])
    def test_gui_controller_same_queued_events(self, events):
        """Hand-queued tile events (s = started, f = finished) over a render
        that does not end: the image, the tiles in flight and the composite
        with their red borders are the JAX controller's."""
        tiles = {"a": ScreenBlock((0, 0), (32, 32)), "b": ScreenBlock((32, 0), (64, 32)),
                 "c": ScreenBlock((64, 32), (96, 64))}

        class Progress:
            snapshots = 0

            def image(self):
                Progress.snapshots += 1
                return np.random.default_rng(7).integers(1, 256, (64, 96, 4), dtype=np.uint8)

            def is_finished(self):
                return False

        seen = []
        for mod in (jax_gui_mod, gui_mod):
            Progress.snapshots = 0
            c = self._gui(mod)
            c.progress, c.mode = Progress(), "full"
            for e in events.split():
                c.pending.put((tiles[e[1]], e[0] == "f"))
            assert c.update() is True and c.update() is False
            seen.append(dict(image=c.image.copy(), shown=c.display_image(), snapshots=Progress.snapshots,
                             in_progress=[tuple(int(v) for v in t.min) for t in c.in_progress_tiles]))
        jax_seen, port = seen
        assert port["in_progress"] == jax_seen["in_progress"]
        assert port["snapshots"] == jax_seen["snapshots"] == (1 if "f" in events else 0)
        np.testing.assert_array_equal(port["image"], jax_seen["image"])
        np.testing.assert_array_equal(port["shown"], jax_seen["shown"])
        assert (port["image"][..., 3] > 0).any() == ("f" in events)

    # -- the progressive viewport ---------------------------------------------------

    W, H = 28, 20

    @classmethod
    def _guides(cls):
        """Two walls that meet at a crease, a block of misses and a few
        scattered ones; the depth ramps along x, a miss's is the largest."""
        h, w = cls.H, cls.W
        rng = np.random.default_rng(5)
        normal = np.zeros((h, w, 3), np.float32)
        normal[:, : w // 2] = (0.0, 1.0, 0.0)
        normal[:, w // 2 :] = (0.6, 0.0, 0.8)
        depth = np.broadcast_to(np.linspace(2.0, 9.0, w, dtype=np.float32), (h, w)).copy()
        depth += rng.uniform(0, 0.05, (h, w)).astype(np.float32)
        miss = np.zeros((h, w), bool)
        miss[2:7, 3:9] = True
        miss |= rng.random((h, w)) < 0.03
        normal[miss] = 0.0
        depth[miss] = depth[~miss].max()
        return normal, depth

    @classmethod
    def _frames(cls, passes, holder):
        """``make_frame``: seeded noisy passes of one picture; after
        ``passes`` of them the worker is held until the controller stops, so
        the display is computed from exactly that many."""
        h, w = cls.H, cls.W
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([0.2 + 0.5 * xx / w, 0.6 - 0.4 * yy / h, np.where(xx < w // 2, 0.15, 0.7)], -1)

        def make_frame(camera):
            def frame(i):
                if i >= passes:
                    deadline = time.monotonic() + 30
                    while not holder["c"]._stop.is_set() and time.monotonic() < deadline:
                        time.sleep(0.005)
                    return np.zeros((h, w, 4), np.float32)
                noise = np.random.default_rng(100 + i).normal(0.0, 0.15, (h, w, 3))
                rgb = np.clip(base + noise * (0.3 + base), 0.0, None)
                return np.concatenate([rgb, np.ones((h, w, 1))], -1).astype(np.float32)

            return frame

        return make_frame

    def _display(self, mod, passes, with_aux):
        import jax.numpy as jnp

        normal, depth = self._guides()
        if mod is gui_mod:
            guides = (torch.from_numpy(normal), torch.from_numpy(depth))
        else:
            guides = (jnp.asarray(normal), jnp.asarray(depth))
        holder = {}
        camera = mod.Camera().look_at((0, 0, 5), (0, 0, 0))
        c = mod.ProgressivePtController(self._frames(passes, holder), camera, (self.W, self.H),
                                        (lambda cam: guides) if with_aux else None)
        holder["c"] = c
        c.start()
        try:
            deadline = time.monotonic() + 60
            while c.samples() < passes and time.monotonic() < deadline:
                time.sleep(0.005)
            assert c.samples() == passes
            assert c.update() is True
            shown = c.display_image()
            assert c.display_image() is shown  # cached until a new pass lands
        finally:
            c.shutdown()
        assert not c._thread.is_alive()
        return shown

    @pytest.mark.parametrize("passes, with_aux", [(1, True), (2, True), (5, True), (16, True), (3, False)])
    def test_progressive_display_same_frames(self, passes, with_aux):
        """The same noisy passes and guide buffers through both viewports.
        One pass takes the fixed-sigma filter, two and more the
        variance-guided one with the variance of the mean from the cross-pass
        luminance squares. Within one 8-bit level: the two filters differ in
        the last bits of ``exp`` and ``pow`` (about 1e-5 on the linear
        image), which the display's rounding can turn into one level."""
        want = self._display(jax_gui_mod, passes, with_aux)
        got = self._display(gui_mod, passes, with_aux)
        assert got.shape == want.shape == (self.H, self.W, 3) and got.dtype == want.dtype == np.uint8
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1, f"{(diff > 1).sum()} values differ by more than one level, the worst by {diff.max()}"
        assert (diff == 0).mean() > 0.98
        raw = self._display(gui_mod, passes, False)
        moved = np.abs(got.astype(np.int32) - raw.astype(np.int32)).max()
        # Not vacuous: with the guides the filter really changes the picture.
        assert (moved > 8) if with_aux else (moved == 0)


def test_real_pt_controller_accumulates_with_aux():
    """``_make_pt_controller`` on the CPU device (K2's plain version behind
    the same tracer): three passes accumulate, the guide buffers come from
    ``render_aux``, the display is the filtered mean, and a camera move
    restarts the accumulation."""
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    bvh = TriangleBvh.build(mesh, materials=ids, leaf_max=24)
    camera = Camera().look_at((-16.0, 4.0, 0.0), (10.0, 3.0, 0.5)).f_number(8.0).sensor_width(36e-3)
    args = argparse.Namespace(width=32, height=24, device="cpu")
    c = gui_mod._make_pt_controller(args, bvh, camera, dicts)
    c.start()
    try:
        deadline = time.time() + 120
        while c.samples() < 3 and time.time() < deadline:
            time.sleep(0.02)
        assert c.samples() >= 3
        assert c.update() is True
        normal, depth = c._aux
        assert normal.shape == (24, 32, 3) and depth.shape == (24, 32) and normal.device.type == "cpu"
        assert bool(torch.any(normal != 0, dim=-1).all())  # inside the hall every ray hits
        img = c.display_image()
        assert img.shape == (24, 32, 3) and img.dtype == np.uint8 and 0 < img.mean() < 255
        c.move_camera(0.5, 0.0, 0.0)
        deadline = time.time() + 120
        while (c._gen != 1 or c.samples() < 1 or c._aux[0] is normal) and time.time() < deadline:
            time.sleep(0.02)
        assert c._aux[0] is not normal, "the guide buffers were not rebuilt for the moved camera"
        assert c._gen == 1 and c.samples() >= 1
    finally:
        c.shutdown()
    assert not c._thread.is_alive()


def test_gui_main_exits_2_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(gui_mod, "run_tk", lambda controller: pytest.fail("a window was opened"))
    assert gui_mod.main(["--device", "cuda", "--scene", "sphere-mesh"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_gui_main_builds_each_controller_on_the_cpu(monkeypatch):
    seen = []
    monkeypatch.setattr(gui_mod, "run_tk", seen.append)
    assert gui_mod.main(["--device", "cpu", "--scene", "sphere-mesh", "--width", "64", "--height", "48",
                         "--tile-size", "16", "--full-spp", "3"]) == 0
    assert gui_mod.main(["--device", "cpu", "--scene", "sphere-mesh", "--integrator", "pt", "--width", "64",
                         "--height", "48"]) == 0
    parity, pt = seen
    assert isinstance(parity, GuiController) and parity.full_spp == 3 and parity.tile_size == 16
    assert parity.device == torch.device("cpu") and parity.resolution == (64, 48)
    assert isinstance(pt, ProgressivePtController) and pt.make_aux is not None and pt.resolution == (64, 48)


# ---- the GUI benchmark ---------------------------------------------------------

BENCH_KEYS = ["workload", "cold_preview_s", "cold_first_tile_s", "warm_preview_s", "warm_first_tile_s", "tiles",
              "warm_tiles_per_s", "first_feedback_under_1s", "device_health"]


def test_bench_gui_main_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``tools/bench_gui.py``'s keys, in its order, over the real controller
    and ``render()`` at a small size; the probe's sizes are cut so that the
    CPU finishes it."""
    import json

    from minipath_tpu_torch.tools import bench_gui
    from minipath_tpu_torch.utils import calibrate

    monkeypatch.setattr(calibrate, "MATMUL_N", 64)
    monkeypatch.setattr(calibrate, "CHAIN_ITERS", 8)
    monkeypatch.setattr(calibrate, "FETCH_BYTES", 1 << 12)
    out = tmp_path / "gui.json"
    record = Path(bench_gui.__file__).resolve().parents[2] / "GUI_PREVIEW.json"  # the JAX tool's, of a TPU
    before = record.read_bytes()
    assert bench_gui.main(["--device", "cpu", "--scene", "sphere-mesh", "--out", str(out), "128", "96"]) == 0
    said = json.loads(capsys.readouterr().out)
    assert list(said) == BENCH_KEYS and json.loads(out.read_text()) == said
    assert said["workload"].startswith("sphere-mesh 128x96, preview 1 spp")
    assert said["tiles"] == 4 and said["warm_tiles_per_s"] > 0
    assert 0 < said["warm_first_tile_s"] <= said["warm_preview_s"] and 0 < said["cold_first_tile_s"]
    assert said["first_feedback_under_1s"] == (said["warm_first_tile_s"] < 1.0)
    assert said["device_health"]["device"] == "cpu"
    assert record.read_bytes() == before  # written only where --out says


def test_bench_gui_drive_raises_on_an_unfinished_render(fake_render):
    """A drive that times out before its render's tiles are done raises
    instead of reporting times."""
    from minipath_tpu_torch.tools import bench_gui

    c = _controller(w=256, h=256, tile=8)  # 1,024 fake tiles of 5 ms
    c.start()
    with pytest.raises(RuntimeError, match="of 1024 tiles"):
        bench_gui.drive(c, "preview", timeout=0.2)
    c.shutdown()


def test_bench_gui_exits_2_without_a_card(monkeypatch, capsys):
    from minipath_tpu_torch.tools import bench_gui

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_gui.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err and capsys.readouterr().out == ""
