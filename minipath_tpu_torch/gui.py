"""Interactive progressive viewer.

Port of ``minipath_tpu/gui.py``, the counterpart of the reference's egui
front-end (``minipath/src/gui.rs``): a preview render (1 spp)
auto-escalates to a full render (2 spp) on completion
(``gui.rs:171-173,216-224``), finished tiles stream into the displayed
image, in-progress tiles get a red border, a checkerboard shows through
transparent pixels (``gui.rs:244-282``), and arrow keys translate the
camera, aborting the current render and restarting the preview
(``gui.rs:181-198``).

All behavior lives in the two headless controllers (unit-testable without
a display); :func:`main` wraps one in a thin Tk shell. The controller polls
a thread-safe tile queue, the render thread drives the device, and the UI
thread just blits. The device is explicit (``--device``, default ``cuda``);
there is no fallback to another device. ``--layout`` picks the scene layout
as the CLI's does (``cli.py``).

A render that failed is not swallowed: :meth:`GuiController.update` and
:meth:`GuiController.cancel_previous_render` re-raise its error (through
``RenderProgress.wait``), and :meth:`ProgressivePtController.update`
re-raises what ended its worker thread. An aborted render is no error: its
partial image and its ``finished < total`` count are dropped with it.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading

import numpy as np
import torch

from minipath_tpu_torch.camera import Camera
from minipath_tpu_torch.cli import add_layout_argument
from minipath_tpu_torch.render import RenderSettings, render
from minipath_tpu_torch.scene import Scene
from minipath_tpu_torch.utils import LUMA_WEIGHTS
from minipath_tpu_torch.utils.image import checkerboard_under


class GuiController:
    """Headless progressive-render state machine."""

    PREVIEW_SPP = 1
    FULL_SPP = 2  # gui.rs:216-224

    def __init__(self, scene: Scene, camera: Camera, resolution, tile_size=64, full_spp=None, device="cuda"):
        self.scene = scene
        self.camera = camera
        self.resolution = tuple(resolution)
        self.tile_size = tile_size
        self.full_spp = full_spp or self.FULL_SPP
        self.device = torch.device(device)
        w, h = self.resolution
        self.image = np.zeros((h, w, 4), np.uint8)
        self.pending = queue.Queue()  # (tile, finished: bool)
        self.in_progress_tiles: list = []
        self.progress = None
        self.mode = None  # "preview" | "full"
        self._lock = threading.Lock()

    # -- render control (gui.rs:74-135) -----------------------------------------

    def start(self):
        self._start_render("preview", self.PREVIEW_SPP)

    def _start_render(self, mode, spp):
        self.cancel_previous_render()
        self.mode = mode
        settings = RenderSettings(
            tile_size=self.tile_size, sample_count=spp, resolution=self.resolution
        )
        # With both callbacks render() runs in tile mode: batches of at most
        # 64 tiles, each fetched to the host as it finishes.
        self.progress = render(
            self.scene,
            self.camera,
            settings,
            started_tile_callback=lambda t: self.pending.put((t, False)),
            finished_tile_callback=lambda t, s: self.pending.put((t, True)),
            device=self.device,
        )

    def cancel_previous_render(self):
        """Abort the render in flight, wait for its thread and drop its
        queued callbacks. An error that ended it is re-raised, after the
        controller has let go of it."""
        progress, self.progress = self.progress, None
        try:
            if progress is not None:
                progress.abort()
                progress.wait()
        finally:
            # Drain stale callbacks.
            while not self.pending.empty():
                try:
                    self.pending.get_nowait()
                except queue.Empty:
                    break

    # -- per-frame update (gui.rs:152-198) -----------------------------------------

    def update(self) -> bool:
        """Drain pending tiles into the image; escalate preview -> full.
        Returns True if the display should repaint. Re-raises the error of
        a render that failed."""
        dirty = False
        done = []
        # Asked before the drain: a render that has ended by now has queued
        # every event it will, so the drain below takes the last of them and
        # the escalation's cancel drops none.
        ended = self.progress is not None and self.progress.is_finished()
        while True:
            try:
                tile, finished = self.pending.get_nowait()
            except queue.Empty:
                break
            dirty = True
            if finished:
                self.in_progress_tiles = [
                    t for t in self.in_progress_tiles if not np.array_equal(t.min, tile.min)
                ]
                done.append(tile)
            else:
                self.in_progress_tiles.append(tile)
        if done:
            # One progress.image() snapshot per drain, taken after the queue
            # is empty: a tile is in the render's image before its finished
            # event is queued, so the snapshot holds every tile in `done`.
            # (Taken at the first event instead, it would miss the tiles that
            # finish while the rest of the queue drains.)
            full = self.progress.image()
            with self._lock:
                for tile in done:
                    x0, y0 = int(tile.min[0]), int(tile.min[1])
                    x1, y1 = int(tile.max[0]), int(tile.max[1])
                    self.image[y0:y1, x0:x1] = full[y0:y1, x0:x1]

        if ended:
            self.progress.wait()  # returns at once; raises if the render failed
            snap = self.progress.progress()
            if self.mode == "preview" and snap.finished == snap.total:
                self._start_render("full", self.full_spp)
                dirty = True
        return dirty

    def move_camera(self, dx: float, dy: float, dz: float):
        """Translate the camera in its own frame and restart the preview
        (``gui.rs:181-198``)."""
        m = np.eye(4)
        m[:3, 3] = [dx, dy, dz]
        self.camera = self.camera.transformed(m)
        self._start_render("preview", self.PREVIEW_SPP)

    def display_image(self) -> np.ndarray:
        """Composite: checkerboard under alpha + red borders on in-progress
        tiles (``gui.rs:244-282``)."""
        with self._lock:
            img = checkerboard_under(self.image)
        for tile in list(self.in_progress_tiles):
            x0, y0 = int(tile.min[0]), int(tile.min[1])
            x1, y1 = int(tile.max[0]), int(tile.max[1])
            b = 4
            img[y0 : y0 + b, x0:x1, :3] = (255, 0, 0)
            img[max(y1 - b, 0) : y1, x0:x1, :3] = (255, 0, 0)
            img[y0:y1, x0 : x0 + b, :3] = (255, 0, 0)
            img[y0:y1, max(x1 - b, 0) : x1, :3] = (255, 0, 0)
        return img

    def shutdown(self):
        self.cancel_previous_render()


class ProgressivePtController:
    """Progressive path-traced viewport (beyond the reference GUI, whose
    full mode is 2-spp parity shading, ``gui.rs:216-224``).

    A worker thread accumulates fixed-spp path-traced frames forever; the
    displayed image is the running mean (gamma 2.2). Camera moves bump a
    generation counter, which restarts accumulation with a freshly built
    frame function at the next loop iteration: the reference's
    abort-and-restart-preview semantics (``gui.rs:106-135``) at whole-frame
    granularity. Implements the same controller protocol ``run_tk`` drives
    (start/update/display_image/move_camera/shutdown).

    Two threads use the device: the worker's frames and, with ``make_aux``,
    the caller's filter in :meth:`display_image`. Both issue on the default
    stream, which orders them; the kernels' launch counters
    (``trace_packets_pt.launches`` and the like) are plain attributes, so
    read them only while one thread launches.
    """

    def __init__(self, make_frame, camera, resolution, make_aux=None):
        # make_frame(camera) -> callable(chunk_index) -> (H, W, >=3) float
        # linear-RGB mean image for that chunk, as a NumPy array.
        # make_aux(camera) -> (normal (H, W, 3), depth (H, W)) guide
        # buffers, torch tensors on one device; when given, the displayed
        # mean goes through the variance-guided a-trous denoiser on that
        # device (cross-pass noise sets the color tolerance, so the filter
        # self-limits as the accumulation converges; display-only: the
        # accumulator is untouched).
        self.make_frame = make_frame
        self.make_aux = make_aux
        self.camera = camera
        self.resolution = tuple(resolution)
        w, h = self.resolution
        self._acc = np.zeros((h, w, 3), np.float64)
        self._acc_sq = np.zeros((h, w), np.float64)  # per-pass luminance^2
        self._n = 0
        self._seen = 0
        self._gen = 0
        self._aux = None
        self._display_cache = None  # (gen, n, uint8 image)
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self):
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            self._accumulate()
        except Exception as e:  # re-raised by update()
            with self._lock:
                self._error = e

    def _accumulate(self):
        gen = -1
        frame = None
        i = 0
        while not self._stop.is_set():
            with self._lock:
                cur_gen, camera = self._gen, self.camera
            if cur_gen != gen:
                gen, i = cur_gen, 0
                frame = self.make_frame(camera)
                aux = self.make_aux(camera) if self.make_aux else None
                with self._lock:
                    self._acc[:] = 0.0
                    self._acc_sq[:] = 0.0
                    self._n = 0
                    self._aux = aux
            img = np.asarray(frame(i), np.float64)[..., :3]
            i += 1
            with self._lock:
                if self._gen != gen:
                    continue  # camera moved mid-frame; drop the result
                self._acc += img
                lum = img @ LUMA_WEIGHTS
                self._acc_sq += lum * lum
                self._n += 1

    # -- controller protocol -----------------------------------------------------

    def update(self) -> bool:
        with self._lock:
            if self._error is not None:
                raise RuntimeError("the path-tracing worker failed") from self._error
            dirty = self._n != self._seen
            self._seen = self._n
        return dirty

    def move_camera(self, dx: float, dy: float, dz: float):
        m = np.eye(4)
        m[:3, 3] = [dx, dy, dz]
        with self._lock:
            self.camera = self.camera.transformed(m)
            self._gen += 1

    def samples(self) -> int:
        with self._lock:
            return self._n

    def display_image(self) -> np.ndarray:
        w, h = self.resolution
        with self._lock:
            if self._n == 0:
                return np.zeros((h, w, 3), np.uint8)
            cache = self._display_cache
            if cache is not None and cache[0] == self._gen and cache[1] == self._n:
                return cache[2]  # no new samples since the last display
            gen = self._gen
            acc = self._acc.copy()
            mean = acc / self._n
            n, aux = self._n, self._aux
            acc_sq = self._acc_sq.copy()
        if aux is not None:
            # Display-side variance-guided denoise: the color tolerance
            # scales with the measured cross-pass noise, so the filter
            # tends to the identity as the accumulation converges: no
            # hard fade needed, and the raw accumulator stays unbiased.
            from minipath_tpu_torch.render.denoise import atrous_denoise

            dev = aux[0].device
            var = None
            if n >= 2:
                lum_sum = acc @ LUMA_WEIGHTS
                v = np.maximum(acc_sq - lum_sum * lum_sum / n, 0.0)
                var = torch.from_numpy((v / ((n - 1) * n)).astype(np.float32)).to(dev)
            mean = (
                atrous_denoise(torch.from_numpy(mean.astype(np.float32)).to(dev), aux[0], aux[1], var)
                .cpu()
                .numpy()
                .astype(np.float64)
            )
        srgb = np.clip(mean, 0.0, 1.0) ** (1.0 / 2.2)
        out = (srgb * 255.0 + 0.5).astype(np.uint8)
        with self._lock:
            self._display_cache = (gen, n, out)
        return out

    def shutdown(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)


def run_tk(controller, fps: int = 30):
    """Run the Tk event loop around a controller (requires a display)."""
    import tkinter as tk

    from PIL import Image, ImageTk

    root = tk.Tk()
    root.title("minipath")
    label = tk.Label(root)
    label.pack()

    step = 0.5

    def on_key(event):
        moves = {
            "Left": (-step, 0, 0),
            "Right": (step, 0, 0),
            "Up": (0, 0, -step),
            "Down": (0, 0, step),
            "Prior": (0, step, 0),
            "Next": (0, -step, 0),
        }
        if event.keysym in moves:
            controller.move_camera(*moves[event.keysym])
        elif event.keysym == "Escape":
            root.destroy()

    root.bind("<Key>", on_key)

    photo_ref = {}

    def tick():
        controller.update()
        img = controller.display_image()
        photo = ImageTk.PhotoImage(Image.fromarray(img))
        photo_ref["p"] = photo  # keep alive
        label.configure(image=photo)
        root.after(1000 // fps, tick)

    controller.start()
    tick()
    try:
        root.mainloop()
    finally:
        controller.shutdown()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="minipath-tpu-torch-gui", description="minipath interactive viewer on PyTorch/CUDA.")
    p.add_argument("--obj", default=None, help="OBJ file to view (default: a procedural sphere)")
    p.add_argument("--scene", choices=["obj", "sphere-mesh", "atrium"], default="obj", help="scene source")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--tile-size", type=int, default=64)
    p.add_argument("--full-spp", type=int, default=2)
    p.add_argument(
        "--integrator", choices=["parity", "pt"], default="parity",
        help="pt = progressive path-traced viewport (accumulates spp forever)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda", help="torch device to render on")
    add_layout_argument(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("--device cuda: no CUDA device is available", file=sys.stderr)
        return 2

    from minipath_tpu_torch.cli import load_scene, quantize_for_layout

    bvh, material_dicts = load_scene(args)
    if not quantize_for_layout(args, bvh):
        return 2
    camera = (
        Camera()
        .look_at((0.0, 2.0, 10.0), (0.0, 1.5, 0.0))
        .f_number(4.8)
        .focus_distance(10.0)
    )
    if args.integrator == "pt":
        controller = _make_pt_controller(args, bvh, camera, material_dicts)
    else:
        controller = GuiController(
            Scene(bvh),
            camera,
            (args.width, args.height),
            tile_size=args.tile_size,
            full_spp=args.full_spp,
            device=args.device,
        )
    run_tk(controller)
    return 0


def _make_pt_controller(args, bvh, camera, material_dicts):
    """Build a :class:`ProgressivePtController` over the lean tracer on
    ``args.device`` (``bvh.pt_scene`` takes the f32 or the quantized layout
    by ``--layout``; on the CPU the same tracer runs its plain version)."""
    from minipath_tpu_torch.render.denoise import render_aux
    from minipath_tpu_torch.render.wavefront import make_pt_tracer, render_frame_pt
    from minipath_tpu_torch.scene.materials import lambertian, material_table

    device = torch.device(args.device)
    table = material_table(
        material_dicts if material_dicts is not None else [lambertian((0.73, 0.73, 0.73))], device
    )
    tracer, tstate = make_pt_tracer(
        bvh.pt_scene(device), stack_size=bvh.recommended_stack_size, packet_size=2048
    )
    w, h = args.width, args.height

    def make_frame(cam):
        sampler = cam.build_sampler((w, h), device)

        def frame(i):
            # Strata tile across accumulation passes in 64-pass rounds:
            # the spp-1 viewport passes then converge like a 64-way
            # stratified render instead of iid frames. The pairing seed
            # is per ROUND (shared by the 64 passes of one window, fresh
            # for the next; render/stratify.py).
            return render_frame_pt(
                tracer, tstate, table, sampler,
                torch.Generator(device=device).manual_seed(i),
                width=w, height=h, spp=1, bounces=5,
                px_block=(16, 16), samples_per_packet=1,
                strat_total=64, strat_offset=i % 64,
                strat_seed=(i // 64) * 0x9E37 + 17,
            ).cpu().numpy()

        return frame

    def make_aux(cam):
        # First-hit guide buffers for the display-side denoiser (one
        # coherent 1-spp trace per camera generation).
        return render_aux(
            tracer, tstate, cam.build_sampler((w, h), device),
            torch.Generator(device=device).manual_seed(0),
            width=w, height=h,
        )

    return ProgressivePtController(make_frame, camera, (w, h), make_aux)


if __name__ == "__main__":
    sys.exit(main())
