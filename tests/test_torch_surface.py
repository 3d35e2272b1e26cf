"""The port's surface held to the JAX package's.

Every module of ``minipath_tpu/`` is parsed with ``ast`` (nothing of it is
imported here, so JAX is not loaded for this), and each of its public
module-level names must have one of three:

- a counterpart by the same name in the same module of ``minipath_tpu_torch/``;
- an entry in :data:`RENAMED`, whose target exists in the port;
- an entry in :data:`LEFT_OUT`, with its reason.

Every tool of the repository's root ``tools/`` (and the root's ``bench.py``
and ``__graft_entry__.py``) has a counterpart of the same name in
``minipath_tpu_torch/`` with a ``main``, or an entry in
:data:`TOOLS_LEFT_OUT`. ROADMAP.md's queue 1 is where a reader looks: its
tables name every rename and every item left out, and a test holds them to
the tables here. Last, the helpers ported for this surface, each against the
JAX function on the same inputs.
"""

import ast
import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
JAX_PACKAGE = REPO / "minipath_tpu"
PORT = REPO / "minipath_tpu_torch"

# (JAX module, name) -> (port module, name): the same function or type under
# the port's name. ``*_pallas`` became the kernel's name, ``*_xla`` the
# portable engine's.
RENAMED = {
    ("parallel/__init__.py", "render_frame_sum"): ("parallel/mesh.py", "render_frame_sum"),
    # A mesh is an argument of each renderer (``mesh=``), not a second factory.
    ("parallel/__init__.py", "render_frame_sum_sharded"): ("parallel/mesh.py", "render_frame_sum"),
    ("parallel/mesh.py", "render_frame_sum_sharded"): ("parallel/mesh.py", "render_frame_sum"),
    ("render/frame.py", "make_frame_renderer_sharded"): ("render/frame.py", "render_frame"),
    ("render/wavefront.py", "make_pt_renderer_sharded"): ("render/wavefront.py", "render_frame_pt"),
    # The port's one parity shader serves the tile integrators, the frames
    # and the portable engine.
    ("render/integrator.py", "shade_normal_dot"): ("render/frame.py", "shade_parity_sum"),
    ("utils/profiling.py", "annotate"): ("utils/profiling.py", "span"),
    ("parallel/mesh.py", "CAMERA_SALT"): ("render/frame.py", "CAMERA_SALT"),
    ("parallel/mesh.py", "gen_frame_rays9"): ("render/frame.py", "gen_frame_rays9"),
    ("parallel/mesh.py", "gen_rays9_blocks"): ("render/frame.py", "gen_rays9_blocks"),
    ("render/frame.py", "render_frame_pallas"): ("render/frame.py", "render_frame"),
    ("render/integrator.py", "render_tile_batch_bvh_pallas"): ("render/integrator.py", "render_tile_batch_bvh"),
    ("render/integrator.py", "render_tile_batch_bvh_xla"): ("render/integrator.py", "render_tile_batch_bvh_portable"),
    # The JAX package's one-tile bodies, which its batch renderers vmap; the
    # port's batch renderers take a batch of one tile as well as many.
    ("render/integrator.py", "render_tile_sum_bvh"): ("render/integrator.py", "render_tile_batch_bvh_portable"),
    ("render/integrator.py", "render_tile_sum_bvh_pallas"): ("render/integrator.py", "render_tile_batch_bvh"),
    ("render/integrator.py", "render_tile_sum_sphere"): ("render/integrator.py", "render_tile_batch_sphere"),
    ("render/wavefront.py", "make_pallas_tracer"): ("render/wavefront.py", "make_full_tracer"),
    ("render/wavefront.py", "make_xla_tracer"): ("render/wavefront.py", "make_portable_tracer"),
    ("render/wavefront.py", "make_xla_shadow_tracer"): ("render/wavefront.py", "make_portable_shadow_tracer"),
    ("render/pallas_kernels.py", "KernelHits"): ("render/kernels.py", "KernelHits"),
    ("render/pallas_kernels.py", "PTHits"): ("render/kernels.py", "PTHits"),
    ("render/pallas_kernels.py", "PTScene"): ("render/kernels.py", "PTScene"),
    ("render/pallas_kernels.py", "PallasScene"): ("render/kernels.py", "KernelScene"),
    ("render/pallas_kernels.py", "build_shade_flat"): ("render/kernels.py", "build_shade_flat"),
    ("render/pallas_kernels.py", "intersect_bvh_pallas"): ("render/kernels.py", "intersect_bvh"),
    ("render/pallas_kernels.py", "prepare_scene"): ("render/kernels.py", "prepare_scene"),
    ("render/pallas_kernels.py", "prepare_scene_pt"): ("render/kernels.py", "prepare_scene_pt"),
    ("render/pallas_kernels.py", "rays_to_rays9"): ("render/kernels.py", "rays_to_rays9"),
    ("render/pallas_kernels.py", "trace_packets_pallas"): ("render/kernels.py", "trace_packets"),
    ("render/pallas_kernels.py", "trace_packets_pallas_pt"): ("render/kernels.py", "trace_packets_pt"),
    ("render/pallas_kernels.py", "QPTScene"): ("render/kernels_q.py", "QPTScene"),
    ("render/pallas_kernels.py", "QuantizedPallasScene"): ("render/kernels_q.py", "QuantizedScene"),
    ("render/pallas_kernels.py", "prepare_scene_qpt"): ("render/kernels_q.py", "prepare_scene_qpt"),
    ("render/pallas_kernels.py", "prepare_scene_quantized"): ("render/kernels_q.py", "prepare_scene_quantized"),
    ("render/pallas_kernels.py", "trace_packets_pallas_q"): ("render/kernels_q.py", "trace_packets_q"),
    ("render/pallas_kernels.py", "trace_scene"): ("render/kernels_q.py", "trace_scene"),
}

# Names of the JAX package that the port does not carry, each with a reason
# that holds on the card. A whole module is keyed by its path alone.
_NO_VMEM = ("the card has no VMEM and no DMA in its loop: every layout lives in device memory, and the port's rule "
            "(scene/triangle_bvh.py's scene_budget_bytes, half the card's memory) picks f32 or quantized by bytes")
LEFT_OUT = {
    "utils/cache.py": "it only points JAX's compilation cache at a directory; utils/cuda_build.py caches the port's "
                      "builds",
    "render/pallas_kernels.py::VMEM_BUDGET": "the TPU's scoped VMEM budget that drives its f32 -> quantized -> HBM "
                                             "fallback chain; " + _NO_VMEM,
    "render/pallas_kernels.py::LEAF_DMA_ROWS": "the rows a TPU kernel copies from HBM into VMEM a leaf; " + _NO_VMEM,
    "render/pallas_kernels.py::QuantizedHbmScene": "the quantized layout with its triangles in HBM behind that DMA "
                                                   "(tri_in_hbm); " + _NO_VMEM,
    "cli.py::DEFAULT_OBJ": "the path of the reference crate's teapot.obj, outside the repository and absent (F2); "
                           "without --obj the port's CLI renders the procedural sphere, the branch the JAX CLI takes "
                           "where that file is missing",
}

_PACKET_UNION = ("2048-lane packets pay the union of their lanes' visits; the card traces one ray a thread with its "
                 "own stack and sorts children by insertion")
TOOLS_LEFT_OUT = {
    "__graft_entry__.py": "the TPU build's jit compile check and CPU-mesh dry run; on the card chip_smoke.py and "
                          "tests/test_torch_cuda_parallel.py do that work",
    "bench_teapot.py": "it needs teapot.obj, which is not in the repository (F2); it waits until that file is",
    "isolate_hbm.py": "it measures the TPU's leaf-row DMA from HBM into VMEM; the card has no VMEM and no DMA in its "
                      "loop",
    **{f"{name}.py": "packet size, packet key and child sort: " + _PACKET_UNION
       for name in ("sweep_pt", "sweep_pt2", "sweep_pt3", "sweep_pt4", "sweep_pt5", "sweep_pt6", "sweep_pt7",
                    "sweep_pt8", "sweep_pkt_bounce", "perf_sweep")},
    **{f"{name}.py": "leaf size under that packet union; perf_leaf asks the card the same question"
       for name in ("sweep_pt9", "sweep_pt12")},
    **{f"{name}.py": "XLA:TPU's lowering of the compaction's argsort and gathers; the card's sorts are torch's, inside "
                     "profile_pt_headline's compaction phase" for name in ("sweep_pt10", "sweep_pt16")},
    "sweep_pt11.py": "the two-level tracer, which is ported (render/twolevel.py) and measured on the card by "
                     "chip_smoke.py phase 19",
    **{f"{name}.py": "the TPU's shadow order and the any-hit kernel's knobs; chip_smoke.py phase 21 measures the four "
                     "shadow_sort modes on the card, whose any-hit loop was redesigned for it"
       for name in ("sweep_pt13", "sweep_shadow")},
    "sweep_pt14.py": "seeded traversal against the packet union bound; one ray a thread has no union",
    "sweep_pt15.py": "the TPU's NEE shadow pass by part; on the card the bounce loop's phases are annotated, and the "
                     "any-hit trace is 0.8% of the NEE-capped frame (chip_smoke.py phase 21)",
    "sweep_pt18.py": "how a packet's lanes tell the scalar core which children to push; the card has no scalar core "
                     "per packet",
    **{f"{name}.py": "covered by the bench (the quantized and f32 rungs), isolate_qpt and chip_smoke.py phase 4 "
                     "(native against Python trees)" for name in ("perf_quantized", "perf_frame", "perf_builders")},
    "sweep_rr.py": "superseded by sweep_rr2.py, on the same knob and workload",
    **{f"{name}.py": "showcases that the CLI covers" for name in ("render_pt", "render_atrium")},
    "profile_pt.py": "profile_pt_headline's phase split covers it",
}


def public_names(path: Path) -> set:
    """The public module-level names of a source file: those in ``__all__``
    and those its top level defines (functions, classes, assignments), not
    what it imports."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                names.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names.update(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


def _port_module(rel: str):
    """The port's module at ``rel`` (a path in the package), or None."""
    parts = Path(rel).with_suffix("").parts
    name = ".".join(("minipath_tpu_torch",) + (parts[:-1] if parts[-1] == "__init__" else parts))
    if not (PORT / rel).exists():
        return None
    return importlib.import_module(name)


JAX_MODULES = sorted(str(p.relative_to(JAX_PACKAGE)) for p in JAX_PACKAGE.rglob("*.py"))
ROOT_TOOLS = sorted(p.name for p in (REPO / "tools").glob("*.py")) + ["bench.py", "__graft_entry__.py"]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_each_public_name_has_a_counterpart(module):
    names = public_names(JAX_PACKAGE / module)
    if module in LEFT_OUT:
        assert _port_module(module) is None, f"{module} is left out, yet the port has it"
        return
    port = _port_module(module)
    missing = []
    for name in sorted(names):
        if (module, name) in RENAMED:
            target_module, target = RENAMED[module, name]
            assert hasattr(_port_module(target_module), target), f"{module}::{name} -> {target_module}::{target}"
        elif f"{module}::{name}" not in LEFT_OUT and not (port is not None and hasattr(port, name)):
            missing.append(name)
    assert not missing, f"{module}: no counterpart, rename or reason for {missing} (ROADMAP.md, queue 1)"


@pytest.mark.parametrize("tool", ROOT_TOOLS)
def test_each_tool_has_a_counterpart(tool):
    counterpart = PORT / tool if tool == "bench.py" else PORT / "tools" / tool
    if tool in TOOLS_LEFT_OUT:
        assert not counterpart.exists(), f"{tool} is left out, yet the port has {counterpart}"
        return
    assert counterpart.exists(), f"{tool}: no counterpart and no reason (ROADMAP.md, queue 1)"
    assert "main" in public_names(counterpart), f"{counterpart} has no main"


def test_the_tables_name_only_what_exists():
    """No entry outlives its name: each renamed or left-out name is a public
    name of its JAX module, and none of them also exists in the port under
    the JAX name in the same module."""
    for module, name in RENAMED:
        assert name in public_names(JAX_PACKAGE / module), (module, name)
        port = _port_module(module)
        assert port is None or not hasattr(port, name), (module, name)
    for key in LEFT_OUT:
        module, _, name = key.partition("::")
        assert (JAX_PACKAGE / module).exists(), key
        if name:
            port = _port_module(module)
            assert name in public_names(JAX_PACKAGE / module) and (port is None or not hasattr(port, name)), key
    for tool in TOOLS_LEFT_OUT:
        assert tool in ROOT_TOOLS, tool


def _queue1() -> str:
    text = (REPO / "ROADMAP.md").read_text()
    return text[text.index("### Queue 1"):text.index("### Queue 2")]


def test_roadmap_queue1_names_every_rename_and_every_item_left_out():
    """ROADMAP.md's queue 1 says what these tables say: each rename with its
    target, each item left out, each in backticks."""
    queue1 = _queue1()
    quoted = set(re.findall(r"`([^`]+)`", queue1))
    for (module, name), (target_module, target) in RENAMED.items():
        assert f"{module}::{name}" in quoted and f"{target_module}::{target}" in quoted, (module, name)
    for key in LEFT_OUT:
        assert key in quoted, key
    for tool in TOOLS_LEFT_OUT:
        assert (tool if tool == "__graft_entry__.py" else f"tools/{tool}") in quoted, tool


# ---- the helpers ported for this surface, against the JAX functions ---------


def test_intersect_bvh_matches_the_jax_function(rng):
    """``render/kernels.py::intersect_bvh`` (K1's plain version on the CPU,
    then ``finalize_hits``) against ``intersect_bvh_pallas`` in interpret
    mode, on ``tests/test_pallas.py``'s sphere and rays: hits equal, ``t``
    within 1e-5 relative, normals, points and texture coordinates within
    1e-5, materials equal."""
    from minipath_tpu.geometry.ray import make_rays as jax_make_rays
    from minipath_tpu.render.pallas_kernels import intersect_bvh_pallas
    from minipath_tpu.render.pallas_kernels import prepare_scene as jax_prepare_scene
    from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
    from minipath_tpu.scene.procedural import make_uv_sphere
    from minipath_tpu_torch.geometry.ray import Rays
    from minipath_tpu_torch.render import kernels
    from minipath_tpu_torch.scene.bvh.build import from_numpy

    res = jax_build_bvh(make_uv_sphere(rings=12, segments=20))
    n = 128
    origin = np.tile(np.array([0, 0, -4], np.float32), (1, n, 1))
    direction = np.array([0, 0, 1], np.float32) + 0.2 * rng.normal(size=(1, n, 3)).astype(np.float32)
    jrays = jax_make_rays(origin, direction)
    want = intersect_bvh_pallas(res.as_device(), jax_prepare_scene(res.as_device()), jrays, stack_size=48,
                                interpret=True)
    arrays = from_numpy(res.arrays._asdict(), "cpu")
    rays = Rays(*(torch.from_numpy(np.array(f)) for f in jrays))
    got = kernels.intersect_bvh(arrays, kernels.prepare_scene(arrays), rays, stack_size=48)
    hit = np.asarray(want.hit)
    assert np.array_equal(got.hit.numpy(), hit) and 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=1e-5)
    assert np.all(np.isinf(got.t.numpy()[~hit]))
    for field in ("normal", "point", "texture_coords"):
        np.testing.assert_allclose(getattr(got, field).numpy()[hit], np.asarray(getattr(want, field))[hit],
                                   rtol=0, atol=1e-5, err_msg=field)
    assert np.array_equal(got.material.numpy(), np.asarray(want.material))


def test_rays9_to_rays_matches_the_jax_function(rng):
    """``render/frame.py::rays9_to_rays`` undoes ``rays_to_rays9`` as the JAX
    function does its own packing: the same fields, bit for bit, from each
    package's layout of the same rays."""
    from minipath_tpu.geometry.ray import make_rays as jax_make_rays
    from minipath_tpu.render.frame import rays9_to_rays as jax_rays9_to_rays
    from minipath_tpu.render.pallas_kernels import rays_to_rays9 as jax_rays_to_rays9
    from minipath_tpu_torch.geometry.ray import Rays
    from minipath_tpu_torch.render.frame import rays9_to_rays
    from minipath_tpu_torch.render.kernels import rays_to_rays9

    o = rng.uniform(-5, 5, (3, 256, 3)).astype(np.float32)
    d = rng.normal(size=(3, 256, 3)).astype(np.float32)
    jrays = jax_make_rays(o, d)
    want = jax_rays9_to_rays(jax_rays_to_rays9(jrays))
    rays9 = rays_to_rays9(Rays(*(torch.from_numpy(np.array(f)) for f in jrays)))
    assert np.array_equal(rays9.numpy().reshape(-1), np.asarray(jax_rays_to_rays9(jrays)).reshape(-1))
    got = rays9_to_rays(rays9)
    for field in Rays._fields:
        a, b = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert a.shape == b.shape == (3, 256, 3) and np.array_equal(a, b), field
        assert np.array_equal(a, np.asarray(getattr(jrays, field))), field


def test_object_protocol_holds_both_packages_objects():
    """``scene.Object``: the sphere and the triangle BVH of each package are
    objects of its protocol; a plain value is not."""
    from minipath_tpu.scene import Object as JaxObject
    from minipath_tpu.scene.primitives import Sphere as JaxSphere
    from minipath_tpu.scene.procedural import make_cube
    from minipath_tpu.scene.triangle_bvh import TriangleBvh as JaxTriangleBvh
    from minipath_tpu_torch.scene import Object, Scene
    from minipath_tpu_torch.scene.primitives import Sphere
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    mesh = make_cube()
    for obj in (Sphere(), TriangleBvh.build(mesh)):
        assert isinstance(obj, Object) and isinstance(Scene(obj).object, Object)
    for obj in (JaxSphere(), JaxTriangleBvh.build(mesh)):
        assert isinstance(obj, JaxObject)
    assert not isinstance(object(), Object) and not isinstance(object(), JaxObject)


def test_epsilon_is_the_jax_packages():
    from minipath_tpu import geometry as jax_geometry
    from minipath_tpu_torch import geometry

    assert geometry.EPSILON == jax_geometry.EPSILON and "EPSILON" in geometry.__all__
