// What the per-ray traversal loops of csrc/traverse.cu (K1, K2) and
// csrc/traverse_q.cu (K3) share: the stack (its entry, the ordered push of an
// inner node's hit children, the pop) and the triangle test.
//
// An entry is {link (as float bits), t_entry}: 8 bytes, one local-memory
// access. The stack array is the only thing a traversal thread keeps in local
// memory (ptxas reports a frame of MP_STACK_CAPACITY * 8 bytes and no spill).
//
// Order. The hit children of a node go onto the stack farthest first, stable
// in child order for equal entry distances, so that the nearest pops first:
// child c's place among them is the number of hit children that are farther,
// or equally far with a smaller child index (render/kernels.py::push_ranks
// states the rule; the plain version takes a stable descending sort).
//
// How the order is made. The children are taken one at a time, in child
// order, as their slab tests finish. The nearest so far stays in registers;
// the others form a sorted run that grows in place on the stack, at
// stack[sp .. sp + n). A new child that is not farther than the nearest
// becomes the nearest, and the old nearest is appended to the run without a
// comparison (it is nearer than every entry there); only a child farther than
// the nearest is inserted, behind the entries at least as far. So a node with
// one hit child touches no memory, one with two makes one 8-byte store, and
// the sort needs no array of its own. Counting every child's rank in
// registers instead (28 comparisons, unrolled) was measured and is slower: a
// node has two or three hit children as a rule, and the counting pays for all
// eight, with registers that cost a block of occupancy.
//
// The nearest child makes no round trip through the stack: where its place
// sp + n_hit - 1 lies inside the stack, the caller goes on with it directly.
// It needs no prune test: it passed t1 <= t2 <= best_t a moment ago and
// best_t has not changed since.
//
// Overflow. A place at or past stack_size drops the entry and counts it, so
// the nearest entries are the first to go: a run that is full loses its last
// entry to a farther newcomer, and the nearest child is dropped where the run
// fills the stack.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MP_STACK_CAPACITY 128
#define MP_NULL_LINK (-8)
#define MP_COUNT_BITS 3
#define MP_COUNT_MASK 7
#define MP_BLOCK 128
// Blocks of MP_BLOCK threads that the register allocation must let one SM
// hold: 7 caps a thread at 72 registers, which every instance of the loops
// meets without a spill (8 would cap it at 64, and spills).
#define MP_MIN_BLOCKS 7

namespace {

// Pops entries until one survives the occlusion prune (its subtree does not
// start beyond the ray's best hit); false when the stack is empty.
__device__ __forceinline__ bool mp_pop(const float2* stack, int& sp, float best_t, int& cur) {
  while (sp > 0) {
    const float2 e = stack[--sp];
    if (!(e.y > best_t)) {
      cur = __float_as_int(e.x);
      return true;
    }
  }
  return false;
}

// The hit children of the node being visited: the nearest so far in
// registers, the others as a sorted run on the stack, stack[sp .. sp + n).
struct MpChildren {
  int n;          // entries of the run
  int room;       // stack_size - sp: the most the run may hold
  float near_t;   // the nearest hit child so far; -1 while there is none (an
                  // entry distance is never negative)
  int near_link;
};

__device__ __forceinline__ MpChildren mp_children(int sp, int stack_size) {
  return MpChildren{0, stack_size - sp, -1.f, 0};
}

// Takes hit child (link, t1) of the node whose run starts at `run`. A child
// that is not farther than the nearest so far comes after it in push order (a
// later child goes after an equal earlier one), so it becomes the nearest and
// the old one goes to the end of the run; a farther child is inserted into the
// run behind every entry that is at least as far. A run that is full loses its
// last entry, the nearest of them, and counts it.
__device__ __forceinline__ void mp_hit_child(float2* run, MpChildren& ch, float t1, int link, int& ovf) {
  if (ch.near_t < 0.f) {
    ch.near_t = t1;
    ch.near_link = link;
    return;
  }
  float t = t1;
  int l = link;
  int j;
  if (t1 <= ch.near_t) {
    t = ch.near_t;
    l = ch.near_link;
    ch.near_t = t1;
    ch.near_link = link;
    if (ch.n == ch.room) {
      ++ovf;
      return;
    }
    j = ch.n++;
  } else {
    if (ch.n == ch.room) {
      ++ovf;
      if (ch.room == 0 || !(run[ch.n - 1].y < t)) return;
      j = ch.n - 1;
    } else {
      j = ch.n++;
    }
    while (j > 0 && run[j - 1].y < t) {
      run[j] = run[j - 1];
      --j;
    }
  }
  run[j] = make_float2(__int_as_float(l), t);
}

// After the node's last child: the run stays on the stack, and the nearest
// child is the next entry to visit where its place lies inside the stack;
// else it is dropped and counted, and the next surviving pop is. False when
// the traversal has no entry left.
__device__ __forceinline__ bool mp_children_done(const float2* stack, int& sp, const MpChildren& ch, float best_t,
                                                 int& cur, int& ovf) {
  sp += ch.n;
  if (ch.near_t >= 0.f) {
    if (ch.n < ch.room) {
      cur = ch.near_link;
      return true;
    }
    ++ovf;
  }
  return mp_pop(stack, sp, best_t, cur);
}

// A ray's best hit so far: t starts at t_max, tri at -1.
struct MpBest {
  float t, u, v;
  int tri;
};

// Two-sided Moller-Trumbore of the ray (o, d) against the triangle (v0, e1 =
// v1 - v0, e2 = v2 - v0), which is number `tri`; a hit with 0 <= t < best.t
// (strict, so that the first of equal hits stays) becomes the best. Every step
// is written in the plain version's order.
__device__ __forceinline__ void mp_test_triangle(float ox, float oy, float oz, float dx, float dy, float dz,
                                                 float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
                                                 float e2x, float e2y, float e2z, int tri, MpBest& best) {
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / det;
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = inv_det * (sx * px + sy * py + sz * pz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = inv_det * (dx * qx + dy * qy + dz * qz);
  const float t = inv_det * (e2x * qx + e2y * qy + e2z * qz);
  if (u >= 0.f && v >= 0.f && u + v <= 1.f && t >= 0.f && t < best.t) {
    best.t = t;
    best.tri = tri;
    best.u = u;
    best.v = v;
  }
}

}  // namespace
