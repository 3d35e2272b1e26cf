"""The port's materials, lights and environments against the JAX package's.

Tolerances: material tables, material rows, environment radiance, light
tables (numpy-built on both sides) and the atrium's material ids are equal
bit for bit; ``sample_lights`` and ``hit_light_pdf`` in Sobol strata mode
(no iid uniform on either side) agree within 1e-6 relative, the float32
rounding of a few products taken in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minipath_tpu.scene import materials as jm
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu.scene.bvh.build import build_bvh as jax_build_bvh
from minipath_tpu.scene.obj_loader import MeshData
from minipath_tpu_torch.scene import materials as tm
from minipath_tpu_torch.scene import procedural

RTOL = 1e-6


def _dicts(mod):
    return [
        mod.lambertian((0.6, 0.5, 0.4)),
        mod.metal((0.9, 0.8, 0.7), 0.2),
        mod.dielectric(1.45),
        mod.emissive((1.0, 0.9, 0.8), 3.0),
    ]


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(got, want):
    assert type(got)._fields == type(want)._fields
    for name in type(got)._fields:
        g, w = _np(getattr(got, name)), _np(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_material_table_and_rows_equal():
    got = tm.material_table(_dicts(tm), "cpu")
    want = jm.material_table(_dicts(jm))
    _assert_tables_equal(got, want)
    _assert_tables_equal(tm.material_table([], "cpu"), jm.material_table([]))
    ids = np.random.default_rng(3).integers(0, 4, (7, 5)).astype(np.int32)
    rows = tm.material_rows(got, torch.from_numpy(ids))
    want_rows = jm.material_rows(want, jnp.asarray(ids))
    for g, w in zip(rows, want_rows):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("kind", ["sky", "uniform", "none", "gradient"])
def test_environment_radiance_equal(kind):
    d = np.random.default_rng(5).normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if kind == "sky":
        got, want = tm.Environment.sky("cpu"), jm.Environment.sky()
    elif kind == "uniform":
        got, want = tm.Environment.uniform((0.3, 0.6, 0.9), "cpu"), jm.Environment.uniform((0.3, 0.6, 0.9))
    elif kind == "none":
        got, want = tm.Environment.none("cpu"), jm.Environment.none()
    else:
        got = tm.Environment.gradient((1.0, 0.0, 0.0), (0.0, 0.0, 1.0), "cpu")
        want = jm.Environment(horizon=jnp.asarray([1.0, 0.0, 0.0]), zenith=jnp.asarray([0.0, 0.0, 1.0]))
    np.testing.assert_array_equal(_np(got.radiance(torch.from_numpy(d))), _np(want.radiance(jnp.asarray(d))))


def test_atrium_materials_equal():
    mesh = procedural.make_atrium(0)
    ids, dicts = procedural.atrium_materials(mesh)
    want_ids, want_dicts = jax_procedural.atrium_materials(jax_procedural.make_atrium(0))
    np.testing.assert_array_equal(ids, want_ids)
    assert (ids == 4).sum() > 0 and len(set(ids.tolist())) == 5
    _assert_tables_equal(tm.material_table(dicts, "cpu"), jm.material_table(want_dicts))


def _floor(half=12.0, y=-1.0):
    pos = np.array([[-half, y, -half], [half, y, -half], [half, y, half], [-half, y, half]], np.float32)
    return MeshData(triangles=np.array([[0, 1, 2], [0, 2, 3]], np.int32), positions=pos,
                    normals=np.zeros((4, 3), np.float32))


@pytest.fixture(scope="module")
def lit_scenes():
    """An atrium (many emissive ceiling and column-top triangles) and a
    spatially split soup over an emissive floor, whose two floor triangles
    each fill several lanes of the packed array."""
    atrium = jax_procedural.make_atrium(0)
    ids, dicts = jax_procedural.atrium_materials(atrium)
    soup = jax_procedural.merge_meshes([jax_procedural.make_random_triangles(300, seed=5), _floor()])
    soup_ids = np.zeros(soup.triangle_count, np.int32)
    soup_ids[-2:] = 3
    return {
        "atrium": (jax_build_bvh(atrium, materials=ids, leaf_max=24).arrays, dicts),
        "split": (jax_build_bvh(soup, materials=soup_ids, leaf_max=8, spatial_splits=True).arrays, _dicts(jm)),
    }


@pytest.mark.parametrize("name", ["atrium", "split"])
def test_build_light_table_equal(lit_scenes, name):
    arrays, dicts = lit_scenes[name]
    want = jm.build_light_table(arrays.tri_packets, arrays.tri_material, jm.material_table(dicts))
    got = tm.build_light_table(arrays.tri_packets, arrays.tri_material, tm.material_table(dicts, "cpu"))
    _assert_tables_equal(got, want)
    tl = _np(got.tri_light)
    if name == "split":
        # Duplicate emitter lanes share one light.
        assert got.v0.shape[0] == 2 and (tl >= 0).sum() > 2
    # No emitter -> None on both sides.
    plain = [jm.lambertian((0.5, 0.5, 0.5))] * 5
    assert jm.build_light_table(arrays.tri_packets, arrays.tri_material, jm.material_table(plain)) is None
    assert tm.build_light_table(arrays.tri_packets, arrays.tri_material, tm.material_table(plain, "cpu")) is None


def test_light_table_converter_round_trips(lit_scenes):
    arrays, dicts = lit_scenes["atrium"]
    want = jm.build_light_table(arrays.tri_packets, arrays.tri_material, jm.material_table(dicts))
    got = tm.light_table_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    _assert_tables_equal(got, want)
    table = tm.table_from_numpy({k: np.asarray(v) for k, v in jm.material_table(dicts)._asdict().items()}, "cpu")
    _assert_tables_equal(table, jm.material_table(dicts))


@pytest.mark.parametrize("name", ["atrium", "split"])
def test_sample_lights_and_hit_pdf_sobol_match(lit_scenes, name):
    arrays, dicts = lit_scenes[name]
    jl = jm.build_light_table(arrays.tri_packets, arrays.tri_material, jm.material_table(dicts))
    tl = tm.build_light_table(arrays.tri_packets, arrays.tri_material, tm.material_table(dicts, "cpu"))
    rng = np.random.default_rng(11)
    n = 512
    x = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    s = rng.integers(0, 16, n).astype(np.int32)
    pid = rng.integers(0, 1 << 20, n).astype(np.int32)
    strat = (-16, 12)
    got = tm.sample_lights(tl, None, torch.from_numpy(x), strat=(torch.from_numpy(s), torch.from_numpy(pid), *strat))
    want = jm.sample_lights(jl, jax.random.key(0), jnp.asarray(x), strat=(jnp.asarray(s), jnp.asarray(pid), *strat))
    names = ("y", "wi", "pdf", "emission", "cos_y", "li")
    for nm, g, w in zip(names, got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape, nm
        if nm == "li":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7, err_msg=nm)
    # BSDF rays toward the sampled light points, as an emitter hit reports
    # them: the lane of the sampled light, the unit direction and distance.
    lanes = np.array([np.nonzero(_np(tl.tri_light) == li)[0][0] for li in _np(got[5])], np.int32)
    lanes[::7] = -1  # misses
    lanes[1::7] = np.nonzero(_np(tl.tri_light) < 0)[0][0]  # a non-emitter
    t = np.linalg.norm(_np(got[0]) - x, axis=-1).astype(np.float32)
    gp = tm.hit_light_pdf(tl, torch.from_numpy(lanes), got[1], torch.from_numpy(t))
    wp = jm.hit_light_pdf(jl, jnp.asarray(lanes), jnp.asarray(_np(got[1])), jnp.asarray(t))
    np.testing.assert_allclose(_np(gp), _np(wp), rtol=RTOL)
    assert np.all(_np(gp)[::7] == 0) and np.all(_np(gp)[2::7] > 0)


@pytest.mark.parametrize("target", [0, 3000])
def test_tworooms_mesh_and_materials_equal(target):
    """``make_tworooms`` and ``tworooms_materials`` are NumPy copies: the
    mesh, the material ids and the table equal the JAX package's bit for
    bit, at the bare shell with one prop and with the props of a 3,000
    triangle budget."""
    mesh, want_mesh = procedural.make_tworooms(target), jax_procedural.make_tworooms(target)
    for f in ("triangles", "positions", "normals", "texcoords"):
        a, b = getattr(mesh, f), getattr(want_mesh, f)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    ids, dicts = procedural.tworooms_materials(mesh)
    want_ids, want_dicts = jax_procedural.tworooms_materials(want_mesh)
    assert ids.dtype == want_ids.dtype
    np.testing.assert_array_equal(ids, want_ids)
    assert (ids == 3).sum() == 2 and set(ids.tolist()) == {0, 1, 2, 3}
    _assert_tables_equal(tm.material_table(dicts, "cpu"), jm.material_table(want_dicts))
    if target:
        assert mesh.triangle_count > procedural.make_tworooms(0).triangle_count


def test_tworooms_light_table_is_the_panel():
    """The scene's one emitter: ``build_light_table`` finds the panel's two
    triangles (2 x 1.5 m at y = 5.7, facing down or up as wound), equal to
    the JAX package's table."""
    mesh = procedural.make_tworooms(0)
    ids, dicts = procedural.tworooms_materials(mesh)
    arrays = jax_build_bvh(mesh, materials=ids, leaf_max=24).arrays
    got = tm.build_light_table(arrays.tri_packets, arrays.tri_material, tm.material_table(dicts, "cpu"))
    want = jm.build_light_table(arrays.tri_packets, arrays.tri_material, jm.material_table(dicts))
    _assert_tables_equal(got, want)
    assert got.v0.shape[0] == 2
    corners = torch.cat([got.v0, got.v0 + got.e1, got.v0 + got.e2]).numpy()
    np.testing.assert_allclose(corners[:, 1], 5.7, atol=1e-6)
    assert corners[:, 0].min() == 6.0 and corners[:, 0].max() == 8.0 and np.abs(corners[:, 2]).max() == 0.75
    np.testing.assert_allclose(float(got.area.sum()), 3.0, rtol=1e-6)
