"""``render_frame_pt`` as the CLI path traces the two-rooms scene.

``minipath-tpu-torch --scene tworooms --integrator pt --nee --bounces 7``
builds the lean scene, the material table, the light table and the
closest-hit and shadow tracers once, then renders one frame with
``samples_per_packet=min(8, spp)`` under no environment: the scene's only
light is its panel, which reaches the camera's room through a doorway. NEE
runs at every vertex (``nee_depth`` null); every knob the CLI leaves alone
stays at the function's default, so a change of a default is measured.
Requests, the window's sums and the compared numbers are ``pt_frame``'s;
the check's reference is ``reference/pathtrace_nee.py``, which samples the
panel itself, since a BSDF path from the dark room finds it too rarely.

The checked blocks are drawn from the seed, half of them from the middle
third of the frame's columns, which the doorway fills: the frame's light is
there. The dark room's pixels are lit by the glints of its metal spheres,
rare and bright, so that the mean of 16 blocks drawn from it alone moves by
some 18% from frame to frame; a seed that drew no block through the doorway
(one in some tens, drawing uniformly) would leave the compared totals to
that noise.

The mesh and the reference's tree are cached in ``benchmark/.cache/`` under
keys of their own (``harness/scene.py`` knows the atrium only).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.drivers import common, pt_frame
from benchmark.harness import scene
from benchmark.reference import atrium, bvh, pathtrace, pathtrace_nee, trace, tworooms

State = pt_frame.State
request = pt_frame.request


def _key(config: dict) -> str:
    sc = config["scene"]
    if sc["generator"] != "tworooms":
        raise ValueError(f"pt_frame_tworooms drives the tworooms generator, not {sc['generator']!r}")
    return f"tworooms_{sc['triangles']}_{sc['seed']}"


def mesh(config: dict) -> atrium.Mesh:
    sc = config["scene"]
    return atrium.Mesh(**scene._cached(_key(config), lambda: tworooms.make_tworooms(sc["triangles"],
                                                                                     sc["seed"])._asdict()))


def materials(config: dict, m: atrium.Mesh) -> np.ndarray:
    return tworooms.tworooms_materials(m, config["scene"]["materials"]["seed"])


def reference_tree(config: dict, m: atrium.Mesh) -> bvh.Tree:
    arrays = scene._cached(f"{_key(config)}_tree", lambda: scene._tree_arrays(m))
    return bvh.Tree(arrays["box_min"], arrays["box_max"], arrays["links"], arrays["packet_tri"], int(arrays["root"]))


def port_materials() -> list:
    """The scene's materials through the port's constructors."""
    from minipath_tpu_torch.scene.materials import emissive, lambertian, metal

    make = {"lambertian": lambda m: lambertian(m[1]), "metal": lambda m: metal(m[1], m[2]),
            "emissive": lambda m: emissive(m[1], m[4])}
    return [make[m[0]](m) for m in tworooms.MATERIALS]


def check_blocks(seed: int, width: int, height: int, count: int, side: int) -> np.ndarray:
    """``(count * side * side, 2)`` pixels of ``count`` distinct blocks of
    ``side`` x ``side`` drawn from the run's seed, block by block: half of
    them (as far as there are) among the blocks of the middle third of the
    columns, the rest among the others."""
    bw, bh = width // side, height // side
    ids = np.arange(bw * bh)
    middle = (ids % bw >= bw // 3) & (ids % bw < bw - bw // 3)
    rng = common.rng(seed, 1)
    inside = rng.choice(ids[middle], size=min(count // 2, int(middle.sum())), replace=False)
    outside = rng.choice(ids[~middle], size=min(count - len(inside), int((~middle).sum())), replace=False)
    yy, xx = np.mgrid[0:side, 0:side]
    return np.concatenate([np.stack([(b % bw) * side + xx.ravel(), (b // bw) * side + yy.ravel()], -1)
                           for b in np.concatenate([inside, outside])])


def setup(config: dict, params: dict, seed: int, device) -> State:
    phases = common.Phases()
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import Environment, build_light_table, material_table

    phases("import")
    s = State()
    s.config, s.params, s.device, s.phases = config, params, device, phases
    s.mesh = mesh(config)
    s.material_ids = materials(config, s.mesh)
    s.phases("mesh")
    s.bvh = scene.port_bvh(s.mesh, s.material_ids)
    s.phases("tree")
    s.table = material_table(port_materials(), device)
    s.pt_scene = s.bvh.pt_scene(device)
    stack = s.bvh.recommended_stack_size
    s.tracer, _ = make_pt_tracer(s.pt_scene, stack_size=stack)
    s.lights = build_light_table(s.bvh.host_arrays.tri_packets, s.bvh.host_arrays.tri_material, s.table)
    s.shadow, _ = make_pt_shadow_tracer(s.pt_scene, stack_size=stack)
    s.size = (params["width"], params["height"])
    s.sampler = common.port_camera(config).build_sampler(s.size, device)
    s.env = Environment.none(device)
    s.seeds = common.rng(seed, 0)
    s.pixels = check_blocks(seed, *s.size, params["check_blocks"], params["block"])
    s.phases("layouts")
    # Warm-up: one chunk of samples, which holds every shape a frame's
    # chunks use; it builds the kernels, and nothing compiles later.
    pt_frame._frame(s, int(common.rng(seed, 4).integers(0, 2**31)), min(8, params["spp"])).cpu()
    s.phases("warm-up")
    s.sums = torch.zeros((s.size[1], s.size[0], 3), dtype=torch.float64, device=device)
    s.squares = torch.zeros_like(s.sums)
    s.frames = 0
    return s


def reference(config: dict, m: atrium.Mesh, ids: np.ndarray, device, size, pixels, paths: int, bounces: int,
              seed: int, dtype=torch.float32):
    """The reference's ``(sum, sum of squares)`` at ``pixels`` over
    ``paths`` paths a pixel, computed in ``dtype``."""
    tree = reference_tree(config, m)
    ref = trace.prepare(tree, m.positions, m.triangles, device, dtype)
    vnorm = pathtrace.unit_shading_normals(trace.shading_normals(m.positions, m.normals, m.triangles, device, dtype))
    lights = pathtrace_nee.light_table(m.positions, m.triangles, ids, tworooms.MATERIALS, device, dtype)
    return pathtrace_nee.estimate_pixels(
        ref, vnorm, torch.from_numpy(ids).to(device).long(), pathtrace_nee.material_table(tworooms.MATERIALS, device,
                                                                                          dtype),
        lights, common.lens(config), size, pixels, paths, bounces, seed, block=1 << 20)


def check(s: State, records: list, seed: int) -> dict:
    """The window's frames at the checked blocks against the reference's
    own estimate of the same pixels, as ``pt_frame.check`` compares them."""
    p = s.params
    frames = np.stack([r["sample"] for r in records]).astype(np.float64)  # (K, n, 3)
    config, m, ids, device, size = s.config, s.mesh, s.material_ids, s.device, s.size
    common.free_program(s, "bvh", "table", "pt_scene", "tracer", "lights", "shadow", "sampler", "env",
                        "sums", "squares")
    total, squares = reference(config, m, ids, device, size, s.pixels, p["reference_paths"], p["bounces"],
                               int(common.rng(seed, 3).integers(0, 2**62)))
    return pt_frame.compare(frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"],
                            p["block"] ** 2, p)
