// Native host-side runtime of gpis_tpu_torch (a copy of the JAX package's
// gpis_tpu/native/src/gomcpp.cpp, so the port imports nothing of that
// package): voxel-grid downsampling, isosurface extraction (marching
// tetrahedra) and binary PLY parsing, the branchy, data-dependent host
// stages beside the CUDA kernels, exposed through a minimal C ABI consumed
// via ctypes (gpis_tpu_torch/native/bindings.py).  No Python.h dependency.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- memory

void gom_free(void* p) { std::free(p); }

// ------------------------------------------------- voxel-grid downsample
// PCL VoxelGrid semantics: centroid of the points in each occupied voxel.
// Returns the number of output points; out must hold n*3 doubles (the
// output count never exceeds the input count).

int64_t gom_voxel_downsample(const double* pts, int64_t n, double leaf,
                             double* out) {
  if (leaf <= 0.0 || n == 0) {
    std::memcpy(out, pts, sizeof(double) * 3 * n);
    return n;
  }
  struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const {
      return x == o.x && y == o.y && z == o.z;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      // 3D -> 1D mix (large primes; same idea as PCL's hash).
      return static_cast<size_t>(k.x * 73856093LL ^ k.y * 19349669LL ^
                                 k.z * 83492791LL);
    }
  };
  struct Acc {
    double sx = 0, sy = 0, sz = 0;
    int64_t cnt = 0;
    int64_t order = 0;  // first-seen order for deterministic output
  };
  std::unordered_map<Key, Acc, KeyHash> cells;
  cells.reserve(static_cast<size_t>(n));
  int64_t next_order = 0;
  for (int64_t i = 0; i < n; ++i) {
    const double* p = pts + 3 * i;
    Key k{static_cast<int64_t>(std::floor(p[0] / leaf)),
          static_cast<int64_t>(std::floor(p[1] / leaf)),
          static_cast<int64_t>(std::floor(p[2] / leaf))};
    Acc& a = cells[k];
    if (a.cnt == 0) a.order = next_order++;
    a.sx += p[0];
    a.sy += p[1];
    a.sz += p[2];
    a.cnt += 1;
  }
  // Deterministic order: first occurrence of each voxel.
  std::vector<const Acc*> ordered(cells.size());
  for (const auto& kv : cells) ordered[kv.second.order] = &kv.second;
  int64_t m = 0;
  for (const Acc* a : ordered) {
    out[3 * m + 0] = a->sx / a->cnt;
    out[3 * m + 1] = a->sy / a->cnt;
    out[3 * m + 2] = a->sz / a->cnt;
    ++m;
  }
  return m;
}

// ---------------------------------------------------- marching tetrahedra
// Same algorithm/decomposition as gpis_tpu/surface/marching.py (6 tets
// sharing the 0-6 cube diagonal; 16-case sign table built at startup), so
// the two implementations are cross-checked vertex-for-vertex in tests.

namespace {

const int kCorners[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                            {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
const int kTets[6][4] = {{0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
                         {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6}};

struct Case {
  int ntri;          // 0, 1 or 2
  int edges[2][3][2];  // per triangle, 3 edges, each (i, j) tet-vertex pair
};

Case BuildCase(int mask) {
  Case c{};
  int inside[4], outside[4], ni = 0, no = 0;
  for (int v = 0; v < 4; ++v) {
    if (mask >> v & 1)
      inside[ni++] = v;
    else
      outside[no++] = v;
  }
  if (ni == 1) {
    c.ntri = 1;
    for (int e = 0; e < 3; ++e) {
      c.edges[0][e][0] = inside[0];
      c.edges[0][e][1] = outside[e];
    }
  } else if (ni == 3) {
    c.ntri = 1;
    for (int e = 0; e < 3; ++e) {
      c.edges[0][e][0] = outside[0];
      c.edges[0][e][1] = inside[e];
    }
  } else if (ni == 2) {
    int a = inside[0], b = inside[1], cc = outside[0], d = outside[1];
    c.ntri = 2;
    int quad[4][2] = {{a, cc}, {a, d}, {b, d}, {b, cc}};
    int t0[3] = {0, 1, 2}, t1[3] = {0, 2, 3};
    for (int e = 0; e < 3; ++e) {
      c.edges[0][e][0] = quad[t0[e]][0];
      c.edges[0][e][1] = quad[t0[e]][1];
      c.edges[1][e][0] = quad[t1[e]][0];
      c.edges[1][e][1] = quad[t1[e]][1];
    }
  }
  return c;
}

struct CaseTable {
  Case cases[16];
  CaseTable() {
    for (int m = 0; m < 16; ++m) cases[m] = BuildCase(m);
  }
};
const CaseTable g_cases;

}  // namespace

// field: rx*ry*rz doubles (C order), axes ax/ay/az. Returns number of
// triangles; *out_verts is malloc'd (ntri*9 doubles: 3 vertices x xyz),
// caller frees with gom_free.
int64_t gom_marching_tets(const double* field, int64_t rx, int64_t ry,
                          int64_t rz, const double* ax, const double* ay,
                          const double* az, double iso, double** out_verts) {
  std::vector<double> tris;
  tris.reserve(1 << 16);
  double vals[8];
  double pos[8][3];
  const int64_t syz = ry * rz, sz = rz;
  for (int64_t cx = 0; cx + 1 < rx; ++cx) {
    for (int64_t cy = 0; cy + 1 < ry; ++cy) {
      for (int64_t cz = 0; cz + 1 < rz; ++cz) {
        int any_neg = 0, any_pos = 0;
        for (int c = 0; c < 8; ++c) {
          const int64_t ix = cx + kCorners[c][0], iy = cy + kCorners[c][1],
                        iz = cz + kCorners[c][2];
          const double v = field[ix * syz + iy * sz + iz] - iso;
          vals[c] = v;
          pos[c][0] = ax[ix];
          pos[c][1] = ay[iy];
          pos[c][2] = az[iz];
          if (v < 0)
            any_neg = 1;
          else
            any_pos = 1;
        }
        if (!any_neg || !any_pos) continue;
        for (int t = 0; t < 6; ++t) {
          int mask = 0;
          for (int v = 0; v < 4; ++v)
            if (vals[kTets[t][v]] < 0.0) mask |= 1 << v;
          const Case& cs = g_cases.cases[mask];
          for (int tri = 0; tri < cs.ntri; ++tri) {
            for (int e = 0; e < 3; ++e) {
              const int i = kTets[t][cs.edges[tri][e][0]];
              const int j = kTets[t][cs.edges[tri][e][1]];
              const double fi = vals[i], fj = vals[j];
              const double s = fi / (fi - fj);
              for (int d = 0; d < 3; ++d)
                tris.push_back(pos[i][d] + s * (pos[j][d] - pos[i][d]));
            }
          }
        }
      }
    }
  }
  const int64_t ntri = static_cast<int64_t>(tris.size() / 9);
  *out_verts = static_cast<double*>(std::malloc(tris.size() * sizeof(double)));
  std::memcpy(*out_verts, tris.data(), tris.size() * sizeof(double));
  return ntri;
}

// ------------------------------------------------------- binary PLY parse
// Fast path for binary_little_endian vertex data: given the raw vertex
// buffer, per-property byte sizes, and the x/y/z (and optional nx/ny/nz)
// property indices, extract positions (+normals) as doubles.

int64_t gom_ply_extract(const uint8_t* buf, int64_t n_vertex,
                        const int32_t* prop_sizes, const int32_t* prop_kinds,
                        int32_t n_props, int32_t ix, int32_t iy, int32_t iz,
                        int32_t inx, int32_t iny, int32_t inz, double* out_pts,
                        double* out_normals) {
  // prop_kinds: 0=float32, 1=float64, 2=(u)int8, 3=(u)int16, 4=(u)int32
  std::vector<int32_t> offs(n_props + 1, 0);
  for (int32_t p = 0; p < n_props; ++p) offs[p + 1] = offs[p] + prop_sizes[p];
  const int32_t stride = offs[n_props];
  auto read_val = [&](const uint8_t* rec, int32_t p) -> double {
    const uint8_t* q = rec + offs[p];
    switch (prop_kinds[p]) {
      case 0: {
        float f;
        std::memcpy(&f, q, 4);
        return f;
      }
      case 1: {
        double d;
        std::memcpy(&d, q, 8);
        return d;
      }
      case 2:
        return *q;
      case 3: {
        int16_t v;
        std::memcpy(&v, q, 2);
        return v;
      }
      default: {
        int32_t v;
        std::memcpy(&v, q, 4);
        return v;
      }
    }
  };
  for (int64_t i = 0; i < n_vertex; ++i) {
    const uint8_t* rec = buf + i * stride;
    out_pts[3 * i + 0] = read_val(rec, ix);
    out_pts[3 * i + 1] = read_val(rec, iy);
    out_pts[3 * i + 2] = read_val(rec, iz);
    if (out_normals && inx >= 0) {
      out_normals[3 * i + 0] = read_val(rec, inx);
      out_normals[3 * i + 1] = read_val(rec, iny);
      out_normals[3 * i + 2] = read_val(rec, inz);
    }
  }
  return n_vertex;
}

}  // extern "C"
