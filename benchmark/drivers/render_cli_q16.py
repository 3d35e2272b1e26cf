"""``render()`` as the CLI calls it under ``--layout q16``: the tree asks for
the 16-bit quantized layout, so K3 does the traversal.

A request is ``render_cli``'s (``render_cli.request``): one frame in tile
mode with a finished-tile callback, a fresh render seed each, a closed
loop. Set-up builds the tree as ``cli.py::load_scene`` does with
``--layout q16`` and fails at once where the program has no layout choice.

The check holds the program twice. Its words, copied to the host before the
program is freed, are decoded by the published rule and held to the mesh
(``reference/q16.py``: ``vertex_ulps``, ``box_ulps``, ``box_fit_ulps``). The frames are held
to the reference's render of the decoded geometry, as ``render_cli`` holds
its frames to the mesh's: exactly, the frames the seed picks replayed draw
for draw (``off_share``); statistically, every frame against the iid
estimate (``render_cli.compare``: ``pixel_z2``, ``mean_gap``).
"""

from __future__ import annotations

import inspect

import numpy as np

from benchmark.drivers import common, render_cli
from benchmark.harness import scene
from benchmark.reference import parity, q16

State = render_cli.State
request = render_cli.request


def setup(config: dict, params: dict, seed: int, device) -> State:
    phases = common.Phases()
    from minipath_tpu_torch import RenderSettings, Scene
    from minipath_tpu_torch.render.kernels_q import QuantizedScene
    from minipath_tpu_torch.scene.obj_loader import MeshData
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    layout = config["tree"]["layout"]
    if "layout" not in inspect.signature(TriangleBvh.build).parameters:
        raise RuntimeError(f"the program has no layout choice: TriangleBvh.build takes no layout= ({layout!r} asked)")
    phases("import")
    s = State()
    s.config, s.params, s.device, s.phases = config, params, device, phases
    s.mesh = scene.mesh(config)
    s.phases("mesh")
    m = s.mesh
    data = MeshData(triangles=m.triangles, positions=m.positions, normals=m.normals, texcoords=m.texcoords)
    s.bvh = TriangleBvh.build(data, use_native=True, leaf_max=config["tree"]["leaf_max"], layout=layout)
    s.scene = Scene(s.bvh)
    s.phases("tree")
    if not isinstance(s.bvh.kernel_scene(device), QuantizedScene):
        raise RuntimeError(f"layout {layout!r}: the tree's kernel_scene is no QuantizedScene")
    s.phases("layout")
    s.camera = common.port_camera(config)
    s.size = (params["width"], params["height"])
    s.settings = RenderSettings(tile_size=params["tile_size"], sample_count=params["spp"], resolution=s.size)
    s.seeds = common.rng(seed, 0)
    s.pixels = common.check_pixels(seed, *s.size, params["check_pixels"])
    s.tiles = 0
    request(s)  # warm-up: builds the kernels
    s.phases("warm-up")
    return s


def program_words(s: State) -> q16.Words:
    """The program's quantized words on the host."""
    qs = s.bvh.kernel_scene(s.device)
    return q16.Words(qs.node_q.cpu().numpy(), qs.tri_q.cpu().numpy(), int(qs.root), qs.root_box.cpu().numpy())


def check(s: State, records: list, seed: int) -> dict:
    """The words against the mesh, then the window's frames at the checked
    pixels against the reference's render of the decoded words."""
    p = s.params
    pick = common.rng(seed, 2).choice(len(records), size=min(p["check_frames"], len(records)), replace=False)
    config, mesh, device, size = s.config, s.mesh, s.device, s.size
    words, lane_vidx = program_words(s), np.array(s.bvh.host_arrays.tri_vidx, copy=True)
    common.free_program(s, "bvh", "scene")
    decoded = q16.decode(words)
    lane_tri = q16.lane_triangles(lane_vidx, mesh.triangles)
    numbers = q16.check(decoded, lane_tri, mesh.positions, mesh.triangles)
    if lane_tri is None:  # no geometry to render: the words already fail
        return {name: (numbers.get(name, q16.UNMATCHED), limit) for name, limit in p["checks"].items()}
    ref, vnorm = q16.reference_scene(decoded, lane_tri, scene.reference_tree(config, mesh), device)
    lens = common.lens(config)
    got, want = [], []
    for i in sorted(pick):
        got.append(records[i]["sample"])
        want.append(parity.render_pixels(ref, vnorm, lens, size, p["tile_size"], p["spp"], records[i]["seed"],
                                         s.pixels))
    numbers["off_share"] = common.off_share(np.concatenate(got), np.concatenate(want))
    total, squares = parity.estimate_pixels(ref, vnorm, lens, size, s.pixels, p["reference_paths"],
                                            int(common.rng(seed, 3).integers(0, 2**62)))
    frames = np.stack([r["sample"][:, [0, 3]] for r in records]).astype(np.float64) / 255.0
    numbers.update(render_cli.compare(frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"]))
    return {name: (numbers[name], limit) for name, limit in p["checks"].items()}
