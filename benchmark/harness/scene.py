"""The configuration's scene, made from the frozen generator, for both sides.

The mesh and the reference's tree depend only on the configuration, so they
are cached in ``benchmark/.cache/`` (a fixed directory inside the checkout;
the first run writes, every later run reads). The program's tree is built
from the mesh in every run, as the CLI builds it: that is set-up its users
pay.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from benchmark.reference import atrium, bvh

CACHE = Path(__file__).resolve().parent.parent / ".cache"


def _cached(name: str, make) -> dict:
    path = CACHE / f"{name}.npz"
    if path.exists():
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    arrays = make()
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return arrays


def mesh(config: dict) -> atrium.Mesh:
    """The configuration's mesh (``scene``: ``generator``, ``triangles``, ``seed``)."""
    sc = config["scene"]
    if sc["generator"] != "atrium":
        raise ValueError(f"unknown scene generator {sc['generator']!r}")
    key = f"atrium_{sc['triangles']}_{sc['seed']}"
    return atrium.Mesh(**_cached(key, lambda: atrium.make_atrium(sc["triangles"], sc["seed"])._asdict()))


def materials(config: dict, m: atrium.Mesh) -> np.ndarray | None:
    sc = config["scene"]
    if sc.get("materials") is None:
        return None
    return atrium.atrium_materials(m, sc["materials"]["seed"])


def reference_tree(config: dict, m: atrium.Mesh) -> bvh.Tree:
    sc = config["scene"]
    key = f"atrium_{sc['triangles']}_{sc['seed']}_tree"
    arrays = _cached(key, lambda: _tree_arrays(m))
    return bvh.Tree(arrays["box_min"], arrays["box_max"], arrays["links"], arrays["packet_tri"], int(arrays["root"]))


def _tree_arrays(m: atrium.Mesh) -> dict:
    t = bvh.build_tree(m.positions, m.triangles)
    return {**t._asdict(), "root": np.int64(t.root)}


def port_bvh(m: atrium.Mesh, material_ids=None):
    """The program's tree over the same arrays, built as ``cli.py::load_scene``
    builds the atrium: natively, at the default leaf size."""
    from minipath_tpu_torch.scene.obj_loader import MeshData
    from minipath_tpu_torch.scene.triangle_bvh import TriangleBvh

    data = MeshData(triangles=m.triangles, positions=m.positions, normals=m.normals, texcoords=m.texcoords)
    if material_ids is None:
        return TriangleBvh.build(data, use_native=True)
    return TriangleBvh.build(data, materials=material_ids, use_native=True)
