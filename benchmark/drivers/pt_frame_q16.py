"""``render_frame_pt`` as the CLI path traces under ``--layout q16``: the
tree asks for the 16-bit quantized layout, so its lean scene is a
``QPTScene`` and K3 traces the bounces (closest-hit) and the NEE segments
(any-hit).

``minipath-tpu-torch --scene atrium --layout q16 --integrator pt --nee
--nee-depth 1 --bounces 5`` builds the tree with the quantized layout, then
what ``pt_frame`` builds; requests, the window's sums and the compared
numbers are ``pt_frame``'s. Set-up fails at once where the program has no
layout choice, or where the tree's lean scene is no ``QPTScene``.

The check holds the program twice. Its words, copied to the host before the
program is freed, are decoded by the published rule and held to the mesh
(``reference/q16.py``: ``vertex_ulps``, ``box_ulps``, ``box_fit_ulps``).
The frames are held to ``reference/pathtrace.py``'s estimate over the mesh
itself, as ``pt_frame`` holds its frames: the decoded geometry lies within
half a 16-bit step of the mesh, far below the estimate's noise.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from benchmark.drivers import common, pt_frame, render_cli_q16
from benchmark.harness import scene
from benchmark.reference import pathtrace, q16

State = pt_frame.State
request = pt_frame.request


def setup(config: dict, params: dict, seed: int, device) -> State:
    phases = common.Phases()
    from minipath_tpu_torch.render.kernels_q import QPTScene
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import Environment, build_light_table, material_table
    from minipath_tpu_torch.scene.obj_loader import MeshData
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    layout = config["tree"]["layout"]
    if "layout" not in inspect.signature(TriangleBvh.build).parameters:
        raise RuntimeError(f"the program has no layout choice: TriangleBvh.build takes no layout= ({layout!r} asked)")
    phases("import")
    s = State()
    s.config, s.params, s.device, s.phases = config, params, device, phases
    s.mesh = scene.mesh(config)
    s.material_ids = scene.materials(config, s.mesh)
    s.phases("mesh")
    m = s.mesh
    data = MeshData(triangles=m.triangles, positions=m.positions, normals=m.normals, texcoords=m.texcoords)
    s.bvh = TriangleBvh.build(data, materials=s.material_ids, use_native=True, leaf_max=config["tree"]["leaf_max"],
                              layout=layout)
    s.phases("tree")
    s.table = material_table(pt_frame.port_materials(), device)
    s.pt_scene = s.bvh.pt_scene(device)
    if not isinstance(s.pt_scene, QPTScene):
        raise RuntimeError(f"layout {layout!r}: the tree's pt_scene is a {type(s.pt_scene).__name__}, no QPTScene")
    stack = s.bvh.recommended_stack_size
    s.tracer, _ = make_pt_tracer(s.pt_scene, stack_size=stack)
    s.lights = build_light_table(s.bvh.host_arrays.tri_packets, s.bvh.host_arrays.tri_material, s.table)
    s.shadow, _ = make_pt_shadow_tracer(s.pt_scene, stack_size=stack)
    s.size = (params["width"], params["height"])
    s.sampler = common.port_camera(config).build_sampler(s.size, device)
    s.env = Environment.sky(device)
    s.seeds = common.rng(seed, 0)
    s.pixels = pt_frame.check_blocks(seed, *s.size, params["check_blocks"], params["block"])
    s.phases("layouts")
    # Warm-up: one chunk of samples, which holds every shape a frame's
    # chunks use; it builds the kernels, and nothing compiles later.
    pt_frame._frame(s, int(common.rng(seed, 4).integers(0, 2**31)), min(8, params["spp"])).cpu()
    s.phases("warm-up")
    s.sums = torch.zeros((s.size[1], s.size[0], 3), dtype=torch.float64, device=device)
    s.squares = torch.zeros_like(s.sums)
    s.frames = 0
    return s


def check(s: State, records: list, seed: int) -> dict:
    """The words against the mesh, then the window's frames at the checked
    blocks against the reference's own estimate of the same pixels, as
    ``pt_frame.check`` compares them."""
    p = s.params
    frames = np.stack([r["sample"] for r in records]).astype(np.float64)  # (K, n, 3)
    config, mesh, ids, device, size = s.config, s.mesh, s.material_ids, s.device, s.size
    # The QPTScene's rows are its tree's QuantizedScene's, the tensors themselves.
    words, lane_vidx = render_cli_q16.program_words(s), np.array(s.bvh.host_arrays.tri_vidx, copy=True)
    common.free_program(s, "bvh", "table", "pt_scene", "tracer", "lights", "shadow", "sampler", "env",
                        "sums", "squares")
    lane_tri = q16.lane_triangles(lane_vidx, mesh.triangles)
    numbers = q16.check(q16.decode(words), lane_tri, mesh.positions, mesh.triangles)
    ref, vnorm = common.reference_scene(config, mesh, device)
    total, squares = pathtrace.estimate_pixels(
        ref, pathtrace.unit_shading_normals(vnorm), torch.from_numpy(ids).to(device).long(),
        pathtrace.material_table(device), common.lens(config), size, s.pixels, p["reference_paths"],
        p["bounces"], int(common.rng(seed, 3).integers(0, 2**62)))
    numbers.update({name: value for name, (value, _) in pt_frame.compare(
        frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"], p["block"] ** 2, p).items()})
    return {name: (numbers[name], limit) for name, limit in p["checks"].items()}
