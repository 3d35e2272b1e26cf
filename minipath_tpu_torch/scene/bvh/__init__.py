"""8-ary bounding volume hierarchy: flat SoA layout, host-side build.

Layout counterpart of ``minipath/src/scene/triangle_bvh/mod.rs``: nodes hold
8 child boxes + 8 compressed child links, leaves are 8-triangle packets
(1..7 packets per leaf, i.e. at most 56 triangles). The build is NumPy;
``BuildResult.as_device`` moves its arrays to a torch device.
"""

from minipath_tpu_torch.scene.bvh.links import (
    LEAF_NODE_MAX_TRIANGLES,
    LEAF_NODE_PACKET_SIZE,
    INNER_NODE_CHILDREN,
    MAX_INDEX,
    MAX_COUNT,
    NULL_LINK,
    decode_count,
    decode_index,
    is_inner,
    is_leaf,
    is_null,
    new_inner,
    new_leaf,
)
from minipath_tpu_torch.scene.bvh.build import (
    BvhArrays,
    BuildResult,
    build_bvh,
    from_numpy,
)

__all__ = [
    "BvhArrays",
    "BuildResult",
    "INNER_NODE_CHILDREN",
    "LEAF_NODE_MAX_TRIANGLES",
    "LEAF_NODE_PACKET_SIZE",
    "MAX_COUNT",
    "MAX_INDEX",
    "NULL_LINK",
    "build_bvh",
    "decode_count",
    "decode_index",
    "from_numpy",
    "is_inner",
    "is_leaf",
    "is_null",
    "new_inner",
    "new_leaf",
]
