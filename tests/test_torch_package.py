"""The PyTorch port's package: it imports no JAX, and its host-side copies
(BVH build, scene layout, tile ordering) equal the JAX package's bit for
bit."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX stays on the CPU)
import numpy as np
import pytest
import torch

from minipath_tpu.render.pallas_kernels import prepare_scene as jax_prepare_scene
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu.screen_block import ScreenBlock as JaxScreenBlock
from minipath_tpu_torch.render.kernels import prepare_scene
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh.build import build_bvh, from_numpy
from minipath_tpu_torch.screen_block import ScreenBlock

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "minipath_tpu_torch"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(PORT))
)
def test_port_source_imports_no_jax(path):
    """No module of the port names jax or the JAX package in an import."""
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "minipath_tpu"), (path, mod)


def test_port_import_leaves_jax_unloaded():
    """Importing every module of the port, in a clean interpreter whose path
    holds only the repo, does not load jax."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import minipath_tpu_torch\n"
        "for m in pkgutil.walk_packages(minipath_tpu_torch.__path__, 'minipath_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert {'minipath_tpu_torch.parallel.mesh', 'minipath_tpu_torch.render.adaptive'} <= set(sys.modules)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_MESHES = {
    "cube": lambda P: P.make_cube(2.0),
    "uv_sphere": lambda P: P.make_uv_sphere(1.0, center=(0.5, 0.0, -1.0), rings=10, segments=14),
    "random_300": lambda P: P.make_random_triangles(300, seed=5),
    "atrium_3000": lambda P: P.make_atrium(3000),
}


@pytest.fixture(scope="module", params=sorted(_MESHES))
def builds(request):
    make = _MESHES[request.param]
    mesh_j, mesh_t = make(jax_procedural), make(procedural)
    for f in ("triangles", "positions", "normals", "texcoords"):
        assert np.array_equal(getattr(mesh_j, f), getattr(mesh_t, f))
    return jax_build_bvh(mesh_j), build_bvh(mesh_t)


def test_bvh_build_copy_is_bit_exact(builds):
    ref, port = builds
    for name in ref.arrays._fields:
        a, b = np.asarray(getattr(ref.arrays, name)), np.asarray(getattr(port.arrays, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert ref.max_depth == port.max_depth
    assert ref.recommended_stack_size == port.recommended_stack_size
    assert str(ref.leaf_fill) == str(port.leaf_fill)


def test_from_numpy_carries_the_jax_arrays(builds):
    ref, port = builds
    carried = from_numpy(ref.arrays._asdict(), "cpu")
    own = port.as_device("cpu")
    for name in carried._fields:
        assert torch.equal(getattr(carried, name), getattr(own, name)), name


def test_prepare_scene_is_bit_exact(builds):
    ref, port = builds
    want = jax_prepare_scene(ref.as_device())
    got = prepare_scene(port.as_device("cpu"))
    for name in ("node_box", "node_links", "tri_data", "tri_shade"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    assert got.root == int(np.asarray(want.root)[0, 0])


@pytest.mark.parametrize("size,tile", [((64, 48), 16), ((1920, 1080), 64), ((100, 37), 7)])
def test_tile_ordering_is_identical(size, tile):
    want = JaxScreenBlock.with_size((0, 0), size).tile_ordering(tile, rng=np.random.default_rng(9))
    got = ScreenBlock.with_size((0, 0), size).tile_ordering(tile, rng=np.random.default_rng(9))
    assert [(t.min.tolist(), t.max.tolist()) for t in got] == [
        (t.min.tolist(), t.max.tolist()) for t in want
    ]
