"""The port's command line on the CPU: the atrium's tree, ``--denoise`` and
``--aov``.

The CLI builds the atrium with the native C++ code, as the JAX
package's CLI does (``minipath_tpu/cli.py``: ``use_native=True``), so its
arrays equal ``native.build_bvh_native``'s on the same mesh, and the JAX
CLI's, array for array: no tolerance. The path-traced runs hold the files
the flags write: their sizes, their alpha and the branch of the filter the
messages name.
"""

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from minipath_tpu import cli as jax_cli
from minipath_tpu.scene import procedural as jax_procedural
from minipath_tpu_torch import cli
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import native
from minipath_tpu_torch.scene.bvh.build import build_bvh

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def small_atrium(monkeypatch):
    """``make_atrium`` cut to 3,000 triangles in both packages."""
    if shutil.which("g++") is None:
        pytest.skip("native toolchain unavailable (no g++)")
    make, jax_make = procedural.make_atrium, jax_procedural.make_atrium
    monkeypatch.setattr(procedural, "make_atrium", lambda: make(3000))
    monkeypatch.setattr(jax_procedural, "make_atrium", lambda: jax_make(3000))
    return make(3000)


@pytest.mark.parametrize("integrator", ["normal", "pt"])
def test_cli_atrium_is_the_native_build(small_atrium, integrator):
    args = argparse.Namespace(scene="atrium", obj=None, integrator=integrator, layout="auto")
    bvh, dicts = cli.load_scene(args)
    ids = procedural.atrium_materials(small_atrium)[0] if integrator == "pt" else None
    assert (dicts is None) == (integrator == "normal")
    want = native.build_bvh_native(small_atrium, materials=ids)
    jax_bvh, _ = jax_cli.load_scene(args)
    for f in want.arrays._fields:
        got = np.asarray(getattr(bvh.host_arrays, f))
        assert np.array_equal(got, np.asarray(getattr(want.arrays, f))), f
        assert np.array_equal(got, np.asarray(getattr(jax_bvh.host_arrays, f))), f
    assert bvh.recommended_stack_size == want.recommended_stack_size
    # ... and that is another tree than the Python build's.
    python = build_bvh(small_atrium, materials=ids)
    assert python.arrays.node_child_links.shape != want.arrays.node_child_links.shape or not np.array_equal(
        python.arrays.node_child_links, want.arrays.node_child_links)


def _run(tmp_path, *flags):
    out = tmp_path / "frame.png"
    proc = subprocess.run(
        [sys.executable, "-m", "minipath_tpu_torch.cli", "--scene", "sphere-mesh", "--integrator", "pt",
         "--width", "64", "--height", "48", "--bounces", "3", "--device", "cpu", "--no-stats", "-o", str(out),
         *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        # Two threads: the plain traversal gains nothing from more, and the
        # suite's other processes share the cores.
        env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr
    return out, proc.stderr


def _png(path):
    return np.asarray(Image.open(path))


def test_cli_denoise_and_aov_write_three_pngs(tmp_path):
    prefix = tmp_path / "aov"
    out, said = _run(tmp_path, "--spp", "4", "--denoise", "--aov", str(prefix))
    assert "denoised (variance-guided a-trous)" in said
    assert f"saved {prefix}_normal.png, {prefix}_depth.png" in said
    img, normal, depth = _png(out), _png(f"{prefix}_normal.png"), _png(f"{prefix}_depth.png")
    assert img.shape == normal.shape == depth.shape == (48, 64, 4)
    assert (img[..., 3] == 255).all() and img[..., :3].std() > 0
    hit = normal[..., 3] == 255
    assert 0.05 < hit.mean() < 0.6 and not normal[~hit].any()  # the sphere, the sky around it
    # The unit normal n*0.5+0.5: its length from the mid-grey is 0.5.
    n = normal[hit][:, :3].astype(np.float64) / 255 - 0.5
    np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 0.5, atol=0.02)
    # Near bright, far dark: the sphere's centre is nearer than its rim.
    assert (depth[..., 3] == 255).all() and not depth[~hit][:, :3].any()
    ys, xs = np.nonzero(hit)
    centre = depth[int(ys.mean()), int(xs.mean()), 0]
    assert centre == depth[..., 0].max() > depth[hit][:, 0].min()


def test_cli_denoise_at_one_spp_takes_the_fixed_sigma_branch(tmp_path):
    out, said = _run(tmp_path, "--spp", "1", "--denoise")
    assert "denoised (edge-avoiding a-trous)" in said and "variance-guided" not in said
    img = _png(out)
    assert img.shape == (48, 64, 4) and img[..., :3].std() > 0
    assert not list(tmp_path.glob("*_normal.png"))


def test_cli_denoise_filters_the_saved_image(tmp_path):
    """The same seed with and without ``--denoise``: the filter changes the
    frame, keeps its mean within 5%, and lowers its pixel-to-pixel
    roughness."""
    raw, _ = _run(tmp_path, "--spp", "2")
    raw = _png(raw).astype(np.float64)
    den, _ = _run(tmp_path, "--spp", "2", "--denoise")
    den = _png(den).astype(np.float64)
    assert not np.array_equal(raw, den)
    np.testing.assert_allclose(den[..., :3].mean(), raw[..., :3].mean(), rtol=0.05)

    def roughness(a):
        return np.abs(np.diff(a[..., :3], axis=1)).mean()

    assert roughness(den) < roughness(raw)


def test_help_names_no_unported_flag():
    text = cli.build_parser().format_help()
    for flag in ("--denoise", "--aov", "--devices", "--adaptive"):
        assert flag in text and flag in cli.__doc__, flag
    assert "not ported" not in text.lower() and "not ported" not in cli.__doc__.lower()


@pytest.mark.parametrize("integrator", ["normal", "pt"])
def test_cli_devices_on_the_cpu_writes_png(tmp_path, integrator):
    """``--devices 2 --device cpu``: a mesh of the one CPU device, twice."""
    out, said = _run(tmp_path, "--integrator", integrator, "--spp", "2", "--devices", "2", "-q")
    assert " on 2 x cpu in " in said
    img = _png(out)
    assert img.shape == (48, 64, 4) and (img[..., 3] > 0).any() and img[..., :3].std() > 0


def test_cli_devices_keeps_clamp_and_the_variance_buffer(tmp_path, capsys):
    """Under ``--devices`` the path tracer takes ``--clamp`` (the clamped
    frame is another image than the same run's without it) and ``--denoise``
    gets the variance buffer, as on one device."""
    base = ["--scene", "sphere-mesh", "--integrator", "pt", "--width", "32", "--height", "24", "--spp", "2",
            "--bounces", "3", "--devices", "2", "--device", "cpu", "--no-stats", "-q"]
    images = []
    for name, flags in (("plain", []), ("clamped", ["--clamp", "0.05"])):
        assert cli.main([*base, "-o", str(tmp_path / f"{name}.png"), *flags]) == 0
        images.append(_png(tmp_path / f"{name}.png"))
    assert images[0].shape == images[1].shape == (24, 32, 4)
    assert not np.array_equal(images[0], images[1])
    capsys.readouterr()
    assert cli.main([*base, "-o", str(tmp_path / "denoised.png"), "--denoise"]) == 0
    said = capsys.readouterr().err
    assert "denoised (variance-guided a-trous)" in said and "no variance buffer" not in said


def test_cli_devices_beyond_the_cards_exits_2(monkeypatch, capsys):
    """More devices than there are: exit 2 with a message, never fewer
    devices. Without a card the device check exits first; with one card
    (faked), the mesh's."""
    import torch

    assert cli.main(["--devices", "3", "--device", "cuda", "--no-stats"]) == 2
    assert "no CUDA device is available" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["--devices", "3", "--device", "cuda", "--no-stats"]) == 2
    assert "--devices 3: 3 CUDA devices asked for, 1 available" in capsys.readouterr().err


@pytest.mark.parametrize("flags,warnings", [
    (("--sobol", "--denoise"), ("--sobol with --adaptive is not supported; rendering with jittered strata",
                                "--denoise with --adaptive uses the fixed-sigma filter (no variance buffer)")),
    (("--devices", "2"), ("--adaptive is single-device only; rendering uniform spp across the mesh",)),
], ids=["sobol_denoise", "mesh"])
def test_cli_adaptive_writes_png_with_its_warnings(tmp_path, flags, warnings):
    out, said = _run(tmp_path, "--adaptive", "--spp", "10", *flags)
    for text in warnings:
        assert text in said, text
    img = _png(out)
    assert img.shape == (48, 64, 4) and (img[..., 3] == 255).all() and img[..., :3].std() > 0


def test_cli_adaptive_budget_too_small_exits_2(capsys):
    assert cli.main(["--integrator", "pt", "--adaptive", "--spp", "8", "--device", "cpu", "--no-stats"]) == 2
    assert "--adaptive needs --spp >= 10" in capsys.readouterr().err
