"""The port as it is installed, on the CPU: a wheel built offline from a copy
of the checkout carries the CUDA sources of K1-K5, the native builder's
source and the GUI scripts; installed with ``--target`` outside the
repository, with its package directory read-only, it builds the native
library into the user's cache (``$XDG_CACHE_HOME/minipath_tpu_torch``) and
the tree it builds equals the checkout's bit for bit. Installed read-only
or writable, it caches the scenes of the bench and the tools in the user's
cache (``$XDG_CACHE_HOME/minipath_tpu_torch/bench_cache``), never beside the
package. Then the rules of both directories themselves, and the package's
copy of the native source, byte for byte the repository's.

The wheel is built from a copy, so that nothing is written into the
checkout (setuptools leaves ``build/`` and an ``.egg-info`` beside the
sources it builds). No network is used: ``--no-index`` and no build
isolation, with the setuptools of the running Python.
"""

import os
import shutil
import stat
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import native
from minipath_tpu_torch.utils import cuda_build

REPO = Path(__file__).resolve().parent.parent
PACKAGE = REPO / "minipath_tpu_torch"
CSRC = ("traverse.cu", "traverse_q.cu", "chain.cu", "traverse_common.cuh", "minipath_native.cpp")
SCRIPTS = ("minipath-tpu-gui = minipath_tpu.gui:main", "minipath-tpu-torch-gui = minipath_tpu_torch.gui:main")

# Run in the install's subprocess: the native tree of make_atrium(0), saved
# beside the paths of the package and of the library it loaded.
NATIVE_BUILD = """
import sys
import numpy as np
import minipath_tpu_torch
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import native
res = native.build_bvh_native(procedural.make_atrium(0))
np.savez(sys.argv[1], **res.arrays._asdict())
print(minipath_tpu_torch.__file__)
print(native.library_path())
"""


# Run in the install's subprocess: one small scene cached through the tools'
# cache and one through the bench's, each read back; prints the directory.
CACHE_SCENES = """
from minipath_tpu_torch import bench
from minipath_tpu_torch.tools import common
from minipath_tpu_torch.utils import cuda_build
kw = dict(materials=False, leaf_max=24)
assert not common.cached_scene("atrium", 0, **kw).cached and common.cached_scene("atrium", 0, **kw).cached
assert bench.build_obj_scene(0).triangle_count == bench.build_obj_scene(0).triangle_count
print(cuda_build.bench_cache_dir())
"""


def _pip(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-m", "pip", *args, "-q", "--no-deps", "--no-index", "--no-cache-dir"],
                   check=True, env=env, timeout=120)


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    pytest.importorskip("setuptools")
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    shutil.copy(REPO / "pyproject.toml", src)
    for pkg in ("minipath_tpu", "minipath_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.pyc"))
    _pip("wheel", "--no-build-isolation", "-w", str(tmp / "dist"), str(src))
    (path,) = (tmp / "dist").glob("*.whl")
    return path


@pytest.fixture(scope="module")
def installed(wheel, tmp_path_factory):
    """The wheel installed with ``--target``, its package made read-only."""
    target = tmp_path_factory.mktemp("site")
    _pip("install", "--target", str(target), str(wheel))
    package = target / "minipath_tpu_torch"
    modes = {p: p.stat().st_mode for p in [package, *package.rglob("*")]}
    for p, mode in modes.items():
        p.chmod(mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH))
    yield package
    for p, mode in modes.items():
        p.chmod(mode)


@pytest.fixture(scope="module")
def writable(wheel, tmp_path_factory):
    """The wheel installed with ``--target``, left writable, as in a
    virtual environment."""
    target = tmp_path_factory.mktemp("venv_site")
    _pip("install", "--target", str(target), str(wheel))
    return target / "minipath_tpu_torch"


def _tree(path: Path) -> list:
    return sorted(str(p.relative_to(path)) for p in path.rglob("*"))


def test_wheel_holds_the_sources_and_both_gui_scripts(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        scripts = z.read(entry_points).decode()
    for name in CSRC:
        assert f"minipath_tpu_torch/csrc/{name}" in names, name
    assert {n for n in names if n.startswith("minipath_tpu_torch/csrc/")} == {
        f"minipath_tpu_torch/csrc/{p.name}" for p in (PACKAGE / "csrc").iterdir()
    }
    assert not [n for n in names if "/_build/" in n or n.endswith(".so")]
    for line in SCRIPTS:
        assert line in scripts.splitlines(), line


def test_a_read_only_install_builds_the_native_tree_into_the_user_cache(installed, tmp_path):
    cache, home, cwd = tmp_path / "cache", tmp_path / "home", tmp_path / "cwd"
    for d in (home, cwd):
        d.mkdir()
    before = sorted(p.relative_to(installed) for p in installed.rglob("*"))
    env = {**os.environ, "HOME": str(home), "XDG_CACHE_HOME": str(cache), "PYTHONPATH": str(installed.parent),
           "PYTHONDONTWRITEBYTECODE": "1"}
    out = tmp_path / "tree.npz"
    proc = subprocess.run([sys.executable, "-c", NATIVE_BUILD, str(out)], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    package_file, library = (Path(line) for line in proc.stdout.splitlines())
    assert package_file == installed / "__init__.py"
    assert library.parent == cache / "minipath_tpu_torch" and library.exists()
    assert sorted(p.relative_to(installed) for p in installed.rglob("*")) == before  # nothing written there
    assert not list(home.iterdir()) and not list(cwd.iterdir())
    want = native.build_bvh_native(procedural.make_atrium(0)).arrays
    with np.load(out) as got:
        assert set(got.files) == set(want._fields)
        for name in want._fields:
            a, b = got[name], np.asarray(getattr(want, name))
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), name


@pytest.mark.parametrize("case", ["read-only", "writable"])
def test_an_install_caches_its_scenes_in_the_user_cache(installed, writable, tmp_path, case):
    """The tools' and the bench's scene caches of an installation, read-only
    or writable, go to ``$XDG_CACHE_HOME/minipath_tpu_torch/bench_cache``:
    nothing new lands beside the package, nor in it but the writable
    package's own ``_build/``, nor in ``HOME`` or the working directory."""
    package = installed if case == "read-only" else writable
    cache, home, cwd = tmp_path / "cache", tmp_path / "home", tmp_path / "cwd"
    for d in (home, cwd):
        d.mkdir()
    site_before, package_before = _tree(package.parent), _tree(package)
    env = {**os.environ, "HOME": str(home), "XDG_CACHE_HOME": str(cache), "PYTHONPATH": str(package.parent),
           "PYTHONDONTWRITEBYTECODE": "1"}
    proc = subprocess.run([sys.executable, "-c", CACHE_SCENES], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stderr
    bench_cache = cache / "minipath_tpu_torch" / "bench_cache"
    assert Path(proc.stdout.strip()) == bench_cache
    assert sorted(p.name for p in bench_cache.iterdir()) == [
        "atrium_0.obj", "atrium_0_plain_leaf24.npz", "atrium_obj_0.npz"]
    new_in_package = sorted(set(_tree(package)) - set(package_before))
    assert new_in_package == ([] if case == "read-only" else [n for n in new_in_package if n.startswith("_build")])
    assert sorted(set(_tree(package.parent)) - set(site_before)) == [f"minipath_tpu_torch/{n}" for n in new_in_package]
    assert not list(home.iterdir()) and not list(cwd.iterdir())


@pytest.mark.parametrize("case", ["checkout", "installation", "read-only installation", "no XDG_CACHE_HOME"])
def test_bench_cache_dir_is_the_checkouts_or_the_users(monkeypatch, tmp_path, case):
    """A checkout, told by its ``pyproject.toml`` beside the package, caches
    scenes under its ``.bench_cache/torch/``; an installation, writable or
    not, under ``$XDG_CACHE_HOME`` or ``~/.cache``. The real checkout is the
    first case."""
    root, home = tmp_path / "site", tmp_path / "home"
    (root / "minipath_tpu_torch").mkdir(parents=True)
    monkeypatch.setattr(cuda_build, "ROOT", root)
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    want = tmp_path / "xdg" / "minipath_tpu_torch" / "bench_cache"
    if case == "checkout":
        monkeypatch.setattr(cuda_build, "ROOT", REPO)
        want = REPO / ".bench_cache" / "torch"
    elif case == "read-only installation":
        root.chmod(0o555)
    elif case == "no XDG_CACHE_HOME":
        monkeypatch.delenv("XDG_CACHE_HOME")
        want = home / ".cache" / "minipath_tpu_torch" / "bench_cache"
    try:
        assert cuda_build.bench_cache_dir() == want and want.is_dir()
    finally:
        root.chmod(0o755)
    assert _tree(root) == ["minipath_tpu_torch"]


@pytest.mark.parametrize("case", ["writable package", "read-only package", "read-only _build", "no XDG_CACHE_HOME"])
def test_build_dir_falls_back_to_the_user_cache(monkeypatch, tmp_path, case):
    """The package's ``_build/`` where it (or the package, before the first
    build) can be written; else the user's cache, under ``$XDG_CACHE_HOME``
    or ``~/.cache``. A directory is read-only where its mode grants no write,
    also to root."""
    package, home = tmp_path / "pkg", tmp_path / "home"
    package.mkdir()
    monkeypatch.setattr(cuda_build, "BUILD_DIR", package / "_build")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    want = tmp_path / "xdg" / "minipath_tpu_torch"
    if case == "writable package":
        want = package / "_build"
    elif case == "read-only package":
        package.chmod(0o555)
    elif case == "read-only _build":
        (package / "_build").mkdir(mode=0o555)
    else:
        package.chmod(0o555)
        monkeypatch.delenv("XDG_CACHE_HOME")
        want = home / ".cache" / "minipath_tpu_torch"
    try:
        assert cuda_build.build_dir() == want and want.is_dir()
    finally:
        package.chmod(0o755)
        if (package / "_build").exists():
            (package / "_build").chmod(0o755)


def test_native_source_is_the_repositorys_byte_for_byte():
    """The package carries its own copy of ``native/minipath_native.cpp``, so
    that an installed port can build its native builder; where the
    repository's source is present, the two are the same bytes."""
    copy = PACKAGE / "csrc" / "minipath_native.cpp"
    assert native._SOURCE == copy
    original = REPO / "native" / "minipath_native.cpp"
    if original.exists():
        assert copy.read_bytes() == original.read_bytes()
