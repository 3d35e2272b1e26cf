"""What K3's 8-byte stack entries rest on, and the kernels' push order, on
the CPU.

A stack entry of K3 carries no box: an inner node's own decompressed box is
its ``node_frame`` row, and a leaf's rides as float bits in words 58..63 of
its packets' rows in the device copy of ``tri_q``
(``render/kernels_q.py::quantized_scene_from_numpy``). Both must equal, bit
for bit, the box that the level-by-level decompression of the plain version
(``decompressed_kernel_scene``) gives the node as a child of its parent,
which is what the stack used to carry. The quantizer's own words stay as
they are (``tests/test_torch_quantize.py`` holds them to the JAX package's).

``push_ranks`` states the order in which the kernels push an inner node's
hit children (``csrc/traverse_common.cuh``); it is held to the stable
descending sort of the plain traversal.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from minipath_tpu_torch import TriangleBvh
from minipath_tpu_torch.render import kernels, kernels_q
from minipath_tpu_torch.scene import procedural
from minipath_tpu_torch.scene.bvh import links as L
from minipath_tpu_torch.scene.bvh.quantize import build_quantized_scene
from minipath_tpu_torch.scene.obj_loader import MeshData
from minipath_tpu_torch.utils import cuda_build

SCENES = {
    "atrium": lambda: TriangleBvh.build(procedural.make_atrium(0, seed=3), leaf_max=24),
    "random triangles": lambda: TriangleBvh.build(procedural.make_random_triangles(900, seed=5)),
    "sphere": lambda: TriangleBvh.build(procedural.make_uv_sphere(2.0, (1.0, -2.0, 0.5), rings=12, segments=20), leaf_max=8),
    "one leaf": lambda: TriangleBvh.build(procedural.make_quad(3.0)),
    "empty": lambda: TriangleBvh.build(MeshData()),
}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    bvh = SCENES[request.param]()
    return bvh, bvh.quantized_scene("cpu")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_frames_equal_the_boxes_the_plain_version_derives(scene):
    """Every reachable node's frame is its box in its parent's decompressed
    row; every packet of a reachable leaf carries the leaf's."""
    bvh, q = scene
    rows = kernels_q.decompressed_kernel_scene(q)
    child_box = rows.node_box.view(-1, 8, 6)
    links = rows.node_links
    frames = q.node_frame
    assert frames.shape == (q.node_q.shape[0], 8) and frames.dtype == torch.float32
    assert torch.all(frames[:, 6:] == 0)
    leaf_frames = q.tri_q[:, kernels_q.LEAF_FRAME_WORDS]
    seen_nodes, seen_packets = 0, 0
    root_is_inner = q.root != L.NULL_LINK and not q.root & L.COUNT_MASK
    stack = [q.root >> L.COUNT_BITS] if root_is_inner else []
    while stack:
        n = stack.pop()
        for c in range(8):
            link = int(links[n, c])
            if link == L.NULL_LINK:
                continue
            want = _bits(child_box[n, c])
            count, idx = link & L.COUNT_MASK, link >> L.COUNT_BITS
            if count == 0:
                assert torch.equal(_bits(frames[idx, :6]), want), (n, c)
                stack.append(idx)
                seen_nodes += 1
            else:
                for j in range(count):
                    assert torch.equal(leaf_frames[idx + j], want), (n, c, j)
                seen_packets += count
    if root_is_inner:
        assert seen_nodes == q.node_q.shape[0] - 1  # every node but the root is some node's child
        assert seen_packets == q.tri_q.shape[0]


def test_the_roots_frame_is_the_stored_box(scene):
    _, q = scene
    if q.root == L.NULL_LINK:
        assert q.node_frame.shape[0] == 0 or torch.all(q.node_frame == 0)
    elif q.root & L.COUNT_MASK:
        first = q.root >> L.COUNT_BITS
        for j in range(q.root & L.COUNT_MASK):
            assert torch.equal(q.tri_q[first + j, kernels_q.LEAF_FRAME_WORDS], _bits(q.root_box))
    else:
        assert torch.equal(_bits(q.node_frame[q.root >> L.COUNT_BITS, :6]), _bits(q.root_box))


def test_the_quantizers_words_are_untouched(scene):
    bvh, q = scene
    host = build_quantized_scene(bvh.host_arrays)
    node_q = np.asarray(host.node_q, np.int32).reshape(-1, 32)
    tri_q = np.asarray(host.tri_q, np.int32).reshape(-1, 64)
    np.testing.assert_array_equal(q.node_q.numpy(), node_q)
    np.testing.assert_array_equal(q.tri_q[:, :58].numpy(), tri_q[:, :58])
    assert not tri_q[:, 58:].any()  # the words the frames ride in are the quantizer's unused ones
    assert q.root == int(np.asarray(host.root).reshape(()))
    np.testing.assert_array_equal(q.root_box.numpy(), np.asarray(host.root_box, np.float32).reshape(6))


def test_byte_counts_include_the_frames(scene):
    bvh, q = scene
    tensors = (q.node_q, q.tri_q, q.node_frame)
    assert bvh.quantized_scene_bytes() == sum(t.numel() * t.element_size() for t in tensors)
    N, M = q.node_q.shape[0], q.tri_q.shape[0]
    assert bvh.quantized_scene_bytes() == N * 160 + M * 256
    qpt = bvh.quantized_pt_scene("cpu")
    assert qpt.node_frame is q.node_frame and qpt.tri_q is q.tri_q
    assert bvh.quantized_scene_bytes(pt=True) == bvh.quantized_scene_bytes() + qpt.shade_flat.numel() * 2
    assert bvh.quantized_scene_bytes() < bvh.f32_scene_bytes() or N == 0


def test_the_kernel_wrapper_needs_the_frames():
    """A scene assembled without ``node_frame`` serves the plain version
    only: the checks the launch makes raise on it."""
    bvh = SCENES["sphere"]()
    q = bvh.quantized_pt_scene("cpu")
    bare = kernels_q.QPTScene(*q[:4], shade_flat=q.shade_flat)
    r9 = torch.zeros((1, 9, 4))
    r9[:, 5] = 1.0
    r9[:, 6:] = 1.0
    got = kernels_q.trace_packets_q(bare, r9, stack_size=8, lean=True)
    want = kernels_q.trace_packets_q(q, r9, stack_size=8, lean=True)
    assert torch.equal(got.tri, want.tri)
    with pytest.raises(ValueError, match="node_frame is missing"):
        kernels._check(bare, r9, 8, kernels_q._FRAME_ROWS)
    kernels._check(q, r9, 8, kernels_q._FRAME_ROWS)


def _sorted_places(t1: torch.Tensor, hit: torch.Tensor) -> torch.Tensor:
    """Each hit child's place in the plain traversal's push order: a stable
    descending sort of the entry distances, misses keyed +inf (they sort
    first and take no place)."""
    key = torch.where(hit, t1, torch.full_like(t1, float("inf")))
    _, order = torch.sort(key, dim=1, descending=True, stable=True)
    hit_sorted = torch.gather(hit, 1, order)
    place_sorted = torch.cumsum(hit_sorted, dim=1) - hit_sorted.long()
    place = torch.empty_like(place_sorted).scatter_(1, order, place_sorted)
    return torch.where(hit, place, torch.full_like(place, -1))


@pytest.mark.parametrize("n_hit", range(9))
def test_push_ranks_equal_the_stable_sort(n_hit):
    """Random entry distances from a small set of values, so that ties are
    the rule, with exactly ``n_hit`` of the eight children hit."""
    rng = np.random.default_rng(n_hit)
    k = 4000
    t1 = torch.from_numpy(rng.choice(np.array([0.0, 0.5, 1.0, 1.5, 7.25], np.float32), size=(k, 8)))
    hit = torch.zeros((k, 8), dtype=torch.bool)
    for row in range(k):
        hit[row, rng.choice(8, size=n_hit, replace=False)] = True
    ranks = kernels.push_ranks(t1, hit)
    assert torch.equal(ranks, _sorted_places(t1, hit))
    if n_hit:
        hit_ranks = torch.sort(ranks.masked_fill(~hit, 99), dim=1).values[:, :n_hit]
        assert torch.equal(hit_ranks, torch.arange(n_hit).expand(k, n_hit))  # a permutation of 0..n_hit-1
        nearest = torch.where(hit, t1, torch.full_like(t1, float("inf"))).min(dim=1).values
        last = (ranks == n_hit - 1) & hit
        assert torch.equal(t1[last], nearest)  # the entry kept in registers is a nearest child


@settings(max_examples=200, deadline=None, database=None)
@given(
    st.lists(st.tuples(st.sampled_from([0.0, 1e-30, 0.25, 0.25, 3.0, 1e30]), st.booleans()), min_size=8, max_size=8)
)
def test_push_ranks_on_any_node(children):
    t1 = torch.tensor([[t for t, _ in children]], dtype=torch.float32)
    hit = torch.tensor([[h for _, h in children]])
    assert torch.equal(kernels.push_ranks(t1, hit), _sorted_places(t1, hit))


def test_a_headers_edit_changes_the_build_key(tmp_path):
    """A build is keyed on the source and the headers it includes by a quoted
    name, so that an edited header cannot run an old library."""
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <cuda_runtime.h>\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n  # include "c.cuh"\nint b;\n')
    (tmp_path / "c.cuh").write_text('#pragma once\n#include "b.cuh"\nint c;\n')  # a cycle ends
    first = cuda_build.source_bytes(tmp_path / "a.cu")
    assert b"int a;" in first and b"int b;" in first and first.count(b"int c;") == 1
    (tmp_path / "c.cuh").write_text("#pragma once\nint c = 1;\n")
    assert cuda_build.source_bytes(tmp_path / "a.cu") != first
    csrc = cuda_build.BUILD_DIR.parent / "csrc"
    common = (csrc / "traverse_common.cuh").read_bytes()
    for name in ("traverse.cu", "traverse_q.cu"):
        assert common in cuda_build.source_bytes(csrc / name), name
    assert cuda_build.source_bytes(csrc / "chain.cu") == (csrc / "chain.cu").read_bytes()
