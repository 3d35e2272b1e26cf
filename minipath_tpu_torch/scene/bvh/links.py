"""Compressed node links.

Same bit layout as the reference ``CompressedNodeLink``
(``minipath/src/scene/triangle_bvh/mod.rs:55-114``): an int32 whose 3
low bits are the leaf packet count (0 means inner node) and whose high bits
are the node/packet index; the all-ones-high pattern is NULL. As an int32,
NULL is the value -8, which lets host NumPy, torch tensors and the CUDA
kernel test ``link == NULL_LINK`` without unsigned types.

These helpers work symmetrically on Python ints, NumPy arrays and torch
tensors.
"""

from __future__ import annotations

INNER_NODE_CHILDREN = 8
LEAF_NODE_PACKET_SIZE = 8
COUNT_BITS = 3
COUNT_MASK = (1 << COUNT_BITS) - 1  # 7
MAX_COUNT = COUNT_MASK  # 7 packets per leaf
LEAF_NODE_MAX_TRIANGLES = LEAF_NODE_PACKET_SIZE * MAX_COUNT  # 56

# Keep indices in 28 bits so (index << 3) stays a positive int32; the
# reference uses 29 bits with u32 (mod.rs:71) — 268M nodes/packets is ample.
MAX_INDEX = (1 << 28) - 2

# Bit pattern 0xFFFF_FFF8 interpreted as int32.
NULL_LINK = -8


def new_leaf(index, count):
    """Leaf link: ``index`` of first packet, ``count`` packets in 1..=7."""
    assert 1 <= count <= MAX_COUNT, count
    assert 0 <= index <= MAX_INDEX, index
    return (index << COUNT_BITS) | count


def new_inner(index):
    assert 0 <= index <= MAX_INDEX, index
    return index << COUNT_BITS


def is_null(link):
    return link == NULL_LINK


def is_leaf(link):
    """True for non-null links with a nonzero packet count.

    Note NULL has ``link & 7 == 0`` (two's complement -8), so NULL is never
    classified as a leaf; callers must still mask NULL before treating a
    link as an inner node.
    """
    return (link & COUNT_MASK) != 0


def is_inner(link):
    return ((link & COUNT_MASK) == 0) & (link != NULL_LINK)


def decode_index(link):
    """Index bits. Valid links are non-negative, so an arithmetic shift is
    exact; NULL decodes to -1 and must be masked by the caller."""
    return link >> COUNT_BITS


def decode_count(link):
    return link & COUNT_MASK
