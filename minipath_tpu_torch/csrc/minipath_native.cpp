// minipath_tpu native host-side runtime: OBJ loading + 8-ary SAH BVH build.
//
// Role counterpart of the reference's Rust scene-building layer
// (/root/reference/src/scene/triangle_bvh/building.rs): parse Wavefront OBJ
// with (pos,tex,normal)-tuple vertex dedup, then build the 8-ary BVH with
// <=56-triangle leaves packed as 8-wide packets. The build algorithm is the
// same collapsed-binary binned-SAH scheme as the Python builder
// (minipath_tpu/scene/bvh/build.py) so both emit interchangeable flat
// arrays; this one exists for speed on large scenes (C++ instead of the
// reference's Rust — no translation, shared spec with the Python builder).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kChildren = 8;
constexpr int kPacket = 8;
constexpr int kLeafMaxLimit = 56;  // 7 packets * 8 (format limit)
constexpr int32_t kNull = -8;
constexpr int kBins = 16;

struct V3 {
  float x = 0, y = 0, z = 0;
};
static inline V3 vmin(const V3& a, const V3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3& a, const V3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline float surface_area(const V3& lo, const V3& hi) {
  float sx = std::max(hi.x - lo.x, 0.f);
  float sy = std::max(hi.y - lo.y, 0.f);
  float sz = std::max(hi.z - lo.z, 0.f);
  return 2.f * (sx * (sy + sz) + sy * sz);
}

struct Builder {
  // Inputs.
  const float* positions;   // V*3
  const float* normals;     // V*3 (may be null)
  const int32_t* tris;      // T*3
  const int32_t* materials; // T (may be null)
  int64_t n_tris = 0;
  int leaf_max = kLeafMaxLimit;

  std::vector<V3> tmin, tmax, cent;

  // Outputs.
  std::vector<int32_t> node_links;   // N*8
  std::vector<float> node_box_min;   // N*8*3
  std::vector<float> node_box_max;   // N*8*3
  std::vector<float> tri_packets;    // M*8*9
  std::vector<int32_t> tri_vidx;     // M*8*3
  std::vector<uint8_t> tri_flat;     // M*8
  std::vector<int32_t> tri_material; // M*8
  int32_t max_depth = 0;

  void prepare() {
    tmin.resize(n_tris);
    tmax.resize(n_tris);
    cent.resize(n_tris);
    for (int64_t t = 0; t < n_tris; ++t) {
      V3 lo{INFINITY, INFINITY, INFINITY}, hi{-INFINITY, -INFINITY, -INFINITY};
      for (int k = 0; k < 3; ++k) {
        const float* p = positions + 3 * (int64_t)tris[3 * t + k];
        V3 v{p[0], p[1], p[2]};
        lo = vmin(lo, v);
        hi = vmax(hi, v);
      }
      tmin[t] = lo;
      tmax[t] = hi;
      // Vertex-mean centroid (NOT box center) — matches the Python builder
      // and the reference's Triangle::centroid; box-center binning produced
      // measurably worse partitions for coherent camera packets.
      V3 csum{0, 0, 0};
      for (int k = 0; k < 3; ++k) {
        const float* p = positions + 3 * (int64_t)tris[3 * t + k];
        csum.x += p[0]; csum.y += p[1]; csum.z += p[2];
      }
      cent[t] = {csum.x / 3.f, csum.y / 3.f, csum.z / 3.f};
    }
  }

  void group_bounds(const int32_t* idx, int64_t n, V3* lo, V3* hi) const {
    V3 a{INFINITY, INFINITY, INFINITY}, b{-INFINITY, -INFINITY, -INFINITY};
    for (int64_t i = 0; i < n; ++i) {
      a = vmin(a, tmin[idx[i]]);
      b = vmax(b, tmax[idx[i]]);
    }
    *lo = a;
    *hi = b;
  }

  // Binned-SAH binary split of idx[0..n) in place.
  // Returns split point (elements [0, s) left), or 0 if unsplittable.
  int64_t binary_split(int32_t* idx, int64_t n) {
    V3 clo{INFINITY, INFINITY, INFINITY}, chi{-INFINITY, -INFINITY, -INFINITY};
    for (int64_t i = 0; i < n; ++i) {
      clo = vmin(clo, cent[idx[i]]);
      chi = vmax(chi, cent[idx[i]]);
    }
    float ext[3] = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
    float clo_a[3] = {clo.x, clo.y, clo.z};

    float best_cost = INFINITY;
    int best_axis = -1, best_bin = -1;
    for (int axis = 0; axis < 3; ++axis) {
      if (!(ext[axis] > 0)) continue;
      float scale = kBins / ext[axis];
      int64_t counts[kBins] = {0};
      V3 blo[kBins], bhi[kBins];
      for (int b = 0; b < kBins; ++b) {
        blo[b] = {INFINITY, INFINITY, INFINITY};
        bhi[b] = {-INFINITY, -INFINITY, -INFINITY};
      }
      for (int64_t i = 0; i < n; ++i) {
        const float c = axis == 0 ? cent[idx[i]].x : axis == 1 ? cent[idx[i]].y : cent[idx[i]].z;
        int b = std::min((int)((c - clo_a[axis]) * scale), kBins - 1);
        counts[b]++;
        blo[b] = vmin(blo[b], tmin[idx[i]]);
        bhi[b] = vmax(bhi[b], tmax[idx[i]]);
      }
      // prefix/suffix sweeps
      V3 plo[kBins], phi[kBins], slo[kBins], shi[kBins];
      int64_t pcnt[kBins], scnt[kBins];
      V3 a{INFINITY, INFINITY, INFINITY}, b2{-INFINITY, -INFINITY, -INFINITY};
      int64_t acc = 0;
      for (int b = 0; b < kBins; ++b) {
        a = vmin(a, blo[b]);
        b2 = vmax(b2, bhi[b]);
        acc += counts[b];
        plo[b] = a;
        phi[b] = b2;
        pcnt[b] = acc;
      }
      a = {INFINITY, INFINITY, INFINITY};
      b2 = {-INFINITY, -INFINITY, -INFINITY};
      acc = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        a = vmin(a, blo[b]);
        b2 = vmax(b2, bhi[b]);
        acc += counts[b];
        slo[b] = a;
        shi[b] = b2;
        scnt[b] = acc;
      }
      for (int b = 0; b < kBins - 1; ++b) {
        if (pcnt[b] == 0 || scnt[b + 1] == 0) continue;
        float cost = surface_area(plo[b], phi[b]) * pcnt[b] +
                     surface_area(slo[b + 1], shi[b + 1]) * scnt[b + 1];
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }
    if (best_axis < 0) return 0;

    float scale = kBins / ext[best_axis];
    float lo_a = clo_a[best_axis];
    auto bin_of = [&](int32_t t) {
      const float c = best_axis == 0 ? cent[t].x : best_axis == 1 ? cent[t].y : cent[t].z;
      return std::min((int)((c - lo_a) * scale), kBins - 1);
    };
    // stable: keeps spatially-sorted triangle order inside groups, which
    // sets which triangles share an 8-wide leaf packet downstream.
    int32_t* mid = std::stable_partition(idx, idx + n, [&](int32_t t) { return bin_of(t) <= best_bin; });
    return mid - idx;
  }

  // Partition idx[0..n) into up to 8 child groups; writes sizes.
  int split8(int32_t* idx, int64_t n, int64_t sizes[kChildren]) {
    struct Group {
      int64_t off, len;
      bool splittable = true;
    };
    std::vector<Group> groups{{0, n, true}};
    while ((int)groups.size() < kChildren) {
      // Pick the costliest splittable group with > kPacket tris (mandatory
      // if > kLeafMax).
      int cand = -1;
      float cand_pri = -INFINITY;
      for (int g = 0; g < (int)groups.size(); ++g) {
        if (!groups[g].splittable || groups[g].len <= kPacket) continue;
        V3 lo, hi;
        group_bounds(idx + groups[g].off, groups[g].len, &lo, &hi);
        float pri = surface_area(lo, hi) * (float)groups[g].len;
        if (groups[g].len > leaf_max) pri = INFINITY;
        if (pri > cand_pri) {
          cand_pri = pri;
          cand = g;
        }
      }
      if (cand < 0) break;
      int64_t s = binary_split(idx + groups[cand].off, groups[cand].len);
      if (s == 0 || s == groups[cand].len) {
        groups[cand].splittable = false;
        continue;
      }
      Group right{groups[cand].off + s, groups[cand].len - s, true};
      groups[cand].len = s;
      groups.push_back(right);
    }
    if ((int)groups.size() == 1) {
      // Identical centroids beyond the leaf limit: round-robin split.
      std::vector<int32_t> tmp(idx, idx + n);
      int ng = (int)std::min<int64_t>(kChildren, n);
      int64_t off = 0;
      for (int g = 0; g < ng; ++g) {
        int64_t cnt = 0;
        for (int64_t i = g; i < n; i += ng) idx[off + cnt++] = tmp[i];
        sizes[g] = cnt;
        off += cnt;
      }
      for (int g = ng; g < kChildren; ++g) sizes[g] = 0;
      return ng;
    }
    // Materialize group order (already contiguous by construction? groups
    // were appended out of order; rebuild contiguous layout).
    std::vector<int32_t> tmp(idx, idx + n);
    int64_t off = 0;
    for (int g = 0; g < (int)groups.size(); ++g) {
      std::memcpy(idx + off, tmp.data() + groups[g].off, groups[g].len * sizeof(int32_t));
      sizes[g] = groups[g].len;
      off += groups[g].len;
    }
    for (int g = (int)groups.size(); g < kChildren; ++g) sizes[g] = 0;
    return (int)groups.size();
  }

  int32_t build_leaf(const int32_t* idx, int64_t n, int depth) {
    max_depth = std::max(max_depth, depth);
    int64_t packets = (n + kPacket - 1) / kPacket;
    int64_t first = (int64_t)tri_packets.size() / (kPacket * 9);
    int64_t base_tri = first * kPacket;
    tri_packets.resize((first + packets) * kPacket * 9, 0.f);
    tri_vidx.resize((first + packets) * kPacket * 3, 0);
    tri_flat.resize((first + packets) * kPacket, 0);
    tri_material.resize((first + packets) * kPacket, 0);
    for (int64_t i = 0; i < n; ++i) {
      int32_t t = idx[i];
      float* dst = tri_packets.data() + (base_tri + i) * 9;
      bool flat = normals == nullptr;
      for (int k = 0; k < 3; ++k) {
        int32_t v = tris[3 * t + k];
        const float* p = positions + 3 * (int64_t)v;
        dst[3 * k + 0] = p[0];
        dst[3 * k + 1] = p[1];
        dst[3 * k + 2] = p[2];
        tri_vidx[(base_tri + i) * 3 + k] = v;
        if (normals) {
          const float* nn = normals + 3 * (int64_t)v;
          if (nn[0] * nn[0] + nn[1] * nn[1] + nn[2] * nn[2] == 0.f) flat = true;
        }
      }
      tri_flat[base_tri + i] = flat ? 1 : 0;
      tri_material[base_tri + i] = materials ? materials[t] : 0;
    }
    return (int32_t)((first << 3) | packets);
  }

  int32_t build_recursive(int32_t* idx, int64_t n, int depth) {
    if (n <= leaf_max) return build_leaf(idx, n, depth);
    int64_t sizes[kChildren];
    int ng = split8(idx, n, sizes);
    int64_t node_id = (int64_t)node_links.size() / kChildren;
    node_links.resize((node_id + 1) * kChildren, kNull);
    node_box_min.resize((node_id + 1) * kChildren * 3, 0.f);
    node_box_max.resize((node_id + 1) * kChildren * 3, 0.f);
    int64_t off = 0;
    for (int g = 0; g < ng; ++g) {
      if (sizes[g] == 0) continue;
      V3 lo, hi;
      group_bounds(idx + off, sizes[g], &lo, &hi);
      float* bl = node_box_min.data() + (node_id * kChildren + g) * 3;
      float* bh = node_box_max.data() + (node_id * kChildren + g) * 3;
      bl[0] = lo.x; bl[1] = lo.y; bl[2] = lo.z;
      bh[0] = hi.x; bh[1] = hi.y; bh[2] = hi.z;
      int32_t link = build_recursive(idx + off, sizes[g], depth + 1);
      node_links[node_id * kChildren + g] = link;
      off += sizes[g];
    }
    return (int32_t)(node_id << 3);
  }
};

}  // namespace

extern "C" {

struct MpBvh {
  int32_t* node_links;
  float* node_box_min;
  float* node_box_max;
  float* tri_packets;
  int32_t* tri_vidx;
  uint8_t* tri_flat;
  int32_t* tri_material;
  int64_t n_nodes;
  int64_t n_packets;
  int32_t root;
  int32_t max_depth;
  float bbox_min[3];
  float bbox_max[3];
};

static float* copy_f(const std::vector<float>& v) {
  float* p = (float*)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(float));
  std::memcpy(p, v.data(), v.size() * sizeof(float));
  return p;
}
static int32_t* copy_i(const std::vector<int32_t>& v) {
  int32_t* p = (int32_t*)std::malloc(std::max<size_t>(v.size(), 1) * sizeof(int32_t));
  std::memcpy(p, v.data(), v.size() * sizeof(int32_t));
  return p;
}

int mp_build_bvh(const float* positions, const float* normals, int64_t n_verts,
                 const int32_t* tris, const int32_t* materials, int64_t n_tris,
                 int32_t leaf_max, MpBvh* out) {
  (void)n_verts;
  std::memset(out, 0, sizeof(MpBvh));
  Builder b;
  b.positions = positions;
  b.normals = normals;
  b.tris = tris;
  b.materials = materials;
  b.n_tris = n_tris;
  if (leaf_max >= 1 && leaf_max <= kLeafMaxLimit) b.leaf_max = leaf_max;

  if (n_tris == 0) {
    out->root = kNull;
    out->n_nodes = 0;
    out->n_packets = 0;
    return 0;
  }
  b.prepare();

  V3 lo{INFINITY, INFINITY, INFINITY}, hi{-INFINITY, -INFINITY, -INFINITY};
  for (int64_t t = 0; t < n_tris; ++t) {
    lo = vmin(lo, b.tmin[t]);
    hi = vmax(hi, b.tmax[t]);
  }
  std::vector<int32_t> idx(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) idx[i] = (int32_t)i;
  out->root = b.build_recursive(idx.data(), n_tris, 0);

  out->n_nodes = (int64_t)b.node_links.size() / kChildren;
  out->n_packets = (int64_t)b.tri_packets.size() / (kPacket * 9);
  out->node_links = copy_i(b.node_links);
  out->node_box_min = copy_f(b.node_box_min);
  out->node_box_max = copy_f(b.node_box_max);
  out->tri_packets = copy_f(b.tri_packets);
  out->tri_vidx = copy_i(b.tri_vidx);
  out->tri_material = copy_i(b.tri_material);
  out->tri_flat = (uint8_t*)std::malloc(std::max<size_t>(b.tri_flat.size(), 1));
  std::memcpy(out->tri_flat, b.tri_flat.data(), b.tri_flat.size());
  out->max_depth = b.max_depth;
  out->bbox_min[0] = lo.x; out->bbox_min[1] = lo.y; out->bbox_min[2] = lo.z;
  out->bbox_max[0] = hi.x; out->bbox_max[1] = hi.y; out->bbox_max[2] = hi.z;
  return 0;
}

void mp_free_bvh(MpBvh* b) {
  std::free(b->node_links);
  std::free(b->node_box_min);
  std::free(b->node_box_max);
  std::free(b->tri_packets);
  std::free(b->tri_vidx);
  std::free(b->tri_flat);
  std::free(b->tri_material);
  std::memset(b, 0, sizeof(MpBvh));
}

// ---------------- OBJ loading ------------------------------------------------

struct MpMesh {
  float* positions;  // V*3
  float* normals;    // V*3
  float* texcoords;  // V*3
  int32_t* tris;     // T*3
  int64_t n_verts;
  int64_t n_tris;
};

namespace {
struct TupleKey {
  int32_t p, t, n;
  bool operator==(const TupleKey& o) const { return p == o.p && t == o.t && n == o.n; }
};
struct TupleHash {
  size_t operator()(const TupleKey& k) const {
    size_t h = (size_t)(uint32_t)k.p;
    h = h * 1000003u ^ (size_t)(uint32_t)k.t;
    h = h * 1000003u ^ (size_t)(uint32_t)k.n;
    return h;
  }
};
}  // namespace

int mp_load_obj(const char* path, MpMesh* out) {
  std::memset(out, 0, sizeof(MpMesh));
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<float> pos, tex, nrm;           // raw file-order data
  std::vector<float> opos, otex, onrm;        // unified output
  std::vector<int32_t> otris;
  std::unordered_map<TupleKey, int32_t, TupleHash> dedup;

  auto resolve = [](long v, size_t count) -> int32_t {
    if (v > 0) return (int32_t)(v - 1);
    if (v < 0) return (int32_t)((long)count + v);
    return -1;
  };

  char line[4096];
  std::vector<int32_t> face;
  while (std::fgets(line, sizeof(line), f)) {
    char* s = line;
    while (*s == ' ' || *s == '\t') ++s;
    if (s[0] == 'v' && s[1] == ' ') {
      float x, y, z;
      if (std::sscanf(s + 2, "%f %f %f", &x, &y, &z) == 3) {
        pos.push_back(x); pos.push_back(y); pos.push_back(z);
      }
    } else if (s[0] == 'v' && s[1] == 't') {
      float u = 0, v = 0;
      std::sscanf(s + 2, "%f %f", &u, &v);
      tex.push_back(u); tex.push_back(v); tex.push_back(0.f);
    } else if (s[0] == 'v' && s[1] == 'n') {
      float x, y, z;
      if (std::sscanf(s + 2, "%f %f %f", &x, &y, &z) == 3) {
        float len = std::sqrt(x * x + y * y + z * z);
        if (len > 0) { x /= len; y /= len; z /= len; }
        nrm.push_back(x); nrm.push_back(y); nrm.push_back(z);
      }
    } else if (s[0] == 'f' && (s[1] == ' ' || s[1] == '\t')) {
      face.clear();
      char* q = s + 1;
      while (*q) {
        while (*q == ' ' || *q == '\t') ++q;
        if (*q == '\0' || *q == '\n' || *q == '\r') break;
        long vi = std::strtol(q, &q, 10);
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (*q == '/') {
          ++q;
          if (*q != '/') { ti = std::strtol(q, &q, 10); has_t = true; }
          if (*q == '/') { ++q; ni = std::strtol(q, &q, 10); has_n = true; }
        }
        TupleKey key{resolve(vi, pos.size() / 3),
                     has_t ? resolve(ti, tex.size() / 3) : -1,
                     has_n ? resolve(ni, nrm.size() / 3) : -1};
        if (key.p < 0 || key.p >= (int32_t)(pos.size() / 3)) { std::fclose(f); return 2; }
        auto it = dedup.find(key);
        int32_t id;
        if (it != dedup.end()) {
          id = it->second;
        } else {
          id = (int32_t)(opos.size() / 3);
          dedup.emplace(key, id);
          opos.push_back(pos[3 * key.p]);
          opos.push_back(pos[3 * key.p + 1]);
          opos.push_back(pos[3 * key.p + 2]);
          if (key.t >= 0 && key.t < (int32_t)(tex.size() / 3)) {
            otex.push_back(tex[3 * key.t]);
            otex.push_back(tex[3 * key.t + 1]);
            otex.push_back(tex[3 * key.t + 2]);
          } else {
            otex.push_back(0); otex.push_back(0); otex.push_back(0);
          }
          if (key.n >= 0 && key.n < (int32_t)(nrm.size() / 3)) {
            onrm.push_back(nrm[3 * key.n]);
            onrm.push_back(nrm[3 * key.n + 1]);
            onrm.push_back(nrm[3 * key.n + 2]);
          } else {
            onrm.push_back(0); onrm.push_back(0); onrm.push_back(0);
          }
        }
        face.push_back(id);
      }
      // Fan triangulation (reference skips non-triangles; building.rs:43-46).
      for (size_t k = 1; k + 1 < face.size(); ++k) {
        otris.push_back(face[0]);
        otris.push_back(face[k]);
        otris.push_back(face[k + 1]);
      }
    }
  }
  std::fclose(f);

  out->n_verts = (int64_t)opos.size() / 3;
  out->n_tris = (int64_t)otris.size() / 3;
  out->positions = copy_f(opos);
  out->normals = copy_f(onrm);
  out->texcoords = copy_f(otex);
  out->tris = copy_i(otris);
  return 0;
}

void mp_free_mesh(MpMesh* m) {
  std::free(m->positions);
  std::free(m->normals);
  std::free(m->texcoords);
  std::free(m->tris);
  std::memset(m, 0, sizeof(MpMesh));
}

}  // extern "C"
