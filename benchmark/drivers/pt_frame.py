"""``render_frame_pt`` as the CLI's path tracer calls it.

``minipath-tpu-torch --scene atrium --integrator pt --nee --nee-depth 1
--bounces 5`` builds the lean scene, the material table, the light table and
the closest-hit and shadow tracers once, then renders one frame with
``samples_per_packet=min(8, spp)`` under the sky; every knob the CLI leaves
alone stays at the function's default, so a change of a default is
measured. One request is one frame: a fresh ``torch.Generator`` seeded from
the run's seed, ``render_frame_pt``, and the image on the host; the next
frame starts when that returns (a closed loop, one camera).

Beside each frame the harness keeps, on the card, the sums and sums of
squares of every pixel over the window's frames (for the estimator's
variance, ``pt_eff``), and on the host the checked pixels' values.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers import common
from benchmark.harness import scene
from benchmark.reference import atrium, pathtrace


class State:
    pass


def port_materials() -> list:
    """The benchmark's materials through the port's constructors."""
    from minipath_tpu_torch.scene.materials import dielectric, emissive, lambertian, metal

    make = {"lambertian": lambda m: lambertian(m[1]), "metal": lambda m: metal(m[1], m[2]),
            "dielectric": lambda m: dielectric(m[3]), "emissive": lambda m: emissive(m[1], m[4])}
    return [make[m[0]](m) for m in atrium.MATERIALS]


def setup(config: dict, params: dict, seed: int, device) -> State:
    phases = common.Phases()
    from minipath_tpu_torch.render.wavefront import make_pt_shadow_tracer, make_pt_tracer
    from minipath_tpu_torch.scene.materials import Environment, build_light_table, material_table

    phases("import")
    s = State()
    s.config, s.params, s.device, s.phases = config, params, device, phases
    s.mesh = scene.mesh(config)
    s.material_ids = scene.materials(config, s.mesh)
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
    s.env = Environment.sky(device)
    s.seeds = common.rng(seed, 0)
    s.pixels = check_blocks(seed, *s.size, params["check_blocks"], params["block"])
    s.phases("layouts")
    # Warm-up: one chunk of samples, which holds every shape a frame's
    # chunks use; it builds the kernels, and nothing compiles later.
    _frame(s, int(common.rng(seed, 4).integers(0, 2**31)), min(8, params["spp"])).cpu()
    s.phases("warm-up")
    s.sums = torch.zeros((s.size[1], s.size[0], 3), dtype=torch.float64, device=device)
    s.squares = torch.zeros_like(s.sums)
    s.frames = 0
    return s


def check_blocks(seed: int, width: int, height: int, count: int, side: int) -> np.ndarray:
    """``(count * side * side, 2)`` pixels of ``count`` distinct blocks of
    ``side`` x ``side`` drawn from the run's seed, block by block."""
    bw, bh = width // side, height // side
    pick = common.rng(seed, 1).choice(bw * bh, size=min(count, bw * bh), replace=False)
    yy, xx = np.mgrid[0:side, 0:side]
    return np.concatenate([np.stack([(b % bw) * side + xx.ravel(), (b // bw) * side + yy.ravel()], -1)
                           for b in pick])


def _frame(s: State, seed: int, spp: int):
    """One frame of ``spp`` samples, from a generator seeded with ``seed``."""
    from minipath_tpu_torch.render.wavefront import render_frame_pt

    p = s.params
    gen = torch.Generator(device=s.device)
    gen.manual_seed(seed)
    return render_frame_pt(
        s.tracer, s.pt_scene, s.table, s.sampler, gen, width=s.size[0], height=s.size[1], spp=spp,
        bounces=p["bounces"], env=s.env, samples_per_packet=min(8, p["spp"]), lights=s.lights,
        shadow_tracer=s.shadow, nee_max_depth=p["nee_depth"],
    )


def request(s: State) -> dict:
    p = s.params
    seed = int(s.seeds.integers(0, 2**31))
    start = time.perf_counter()
    img = _frame(s, seed, p["spp"])
    host = img.cpu().numpy()
    end = time.perf_counter()
    rgb = img[..., :3].double()
    s.sums += rgb
    s.squares += rgb * rgb
    s.frames += 1
    return {"start": start, "end": end, "seed": seed, "paths": s.size[0] * s.size[1] * p["spp"],
            "sample": host[s.pixels[:, 1], s.pixels[:, 0], :3].copy()}


def check(s: State, records: list, seed: int) -> dict:
    """The window's frames at the checked blocks against the reference's
    own estimate of the same pixels: the relative gap of the totals, and the
    mean over blocks of the squared gap in standard errors."""
    p = s.params
    frames = np.stack([r["sample"] for r in records]).astype(np.float64)  # (K, n, 3)
    config, mesh, ids, device, size = s.config, s.mesh, s.material_ids, s.device, s.size
    common.free_program(s, "bvh", "table", "pt_scene", "tracer", "lights", "shadow", "sampler", "env",
                        "sums", "squares")
    ref, vnorm = common.reference_scene(config, mesh, device)
    total, squares = pathtrace.estimate_pixels(
        ref, pathtrace.unit_shading_normals(vnorm), torch.from_numpy(ids).to(device).long(),
        pathtrace.material_table(device), common.lens(config), size, s.pixels, p["reference_paths"],
        p["bounces"], int(common.rng(seed, 3).integers(0, 2**62)))
    return compare(frames, total.cpu().numpy(), squares.cpu().numpy(), p["reference_paths"], p["block"] ** 2, p)


def compare(frames, ref_total, ref_squares, paths: int, per_block: int, params: dict) -> dict:
    """The compared numbers from the program's frames ``(K, n, 3)`` at the
    checked pixels and the reference's per-pixel sums over ``paths`` paths."""
    k = frames.shape[0]
    prog = frames.sum(axis=2).reshape(k, -1, per_block).mean(axis=2)  # (K, blocks): RGB sum, block mean
    p_mean = prog.mean(axis=0)
    p_se2 = prog.var(axis=0, ddof=1) / k if k > 1 else np.full_like(p_mean, np.inf)
    n = paths * per_block
    r_sum = ref_total.sum(axis=1).reshape(-1, per_block).sum(axis=1)
    r_sq = ref_squares.reshape(-1, per_block).sum(axis=1)
    r_mean = r_sum / n
    r_se2 = np.maximum(r_sq / n - r_mean ** 2, 0.0) / (n - 1)
    gap = abs(p_mean.sum() - r_mean.sum()) / r_mean.sum()
    z2 = float(np.mean((p_mean - r_mean) ** 2 / (p_se2 + r_se2)))
    c = params["checks"]
    return {"mean_gap": (float(gap), c["mean_gap"]), "block_z2": (z2, c["block_z2"])}
