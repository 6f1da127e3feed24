// Native isosurface mesh extraction via marching tetrahedra.
//
// Role parity with the reference's IsosurfaceCpp submodule (Marching
// Cubes / SnapMC used by src/Renderers/IsoSurfaceRasterizer.cpp:163-173):
// extract a triangle mesh of the iso-level set of a (Z, Y, X) scalar
// grid for rasterization/export. Marching tetrahedra splits each cell
// into 6 tets; every tet case is enumerable without the 256-entry MC
// tables and the result is watertight.
//
// A copy of correrender_tpu/native/isosurface.cpp, built by
// correrender_tpu_torch/native.py (g++ -O3 -march=native -std=c++17).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// 6-tetrahedra decomposition of a cube (corner indices 0..7 with
// bit 0 = +x, bit 1 = +y, bit 2 = +z): the fan {0, c_i, c_{i+1}, 7}
// around the BODY diagonal 0-7, with c walking the edge cycle
// 1,3,2,6,4,5 (consecutive corners cube-edge-adjacent). Every tet has
// volume 1/6 and the union tiles the cube exactly — an earlier table
// fanned around the FACE diagonal 0-6, leaving ~25% of each cell
// uncovered and ~25% double-covered (holes + z-fighting duplicate
// sheets, found by Monte-Carlo coverage).
const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

const int kCornerOffset[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

// SnapMC-style vertex snapping (reference IsoSurfaces.hpp:32-34):
// intersections within gamma of a grid vertex snap onto it, removing
// the sliver triangles plain marching produces near corners. gamma=0
// recovers exact interpolation.
inline V3 lerpVertex(const V3& p0, const V3& p1, float v0, float v1,
                     float iso, float gamma) {
    float denom = v1 - v0;
    float t = std::abs(denom) < 1e-30f ? 0.5f : (iso - v0) / denom;
    if (t < 0.0f) t = 0.0f;
    if (t > 1.0f) t = 1.0f;
    if (t < gamma) t = 0.0f;
    else if (t > 1.0f - gamma) t = 1.0f;
    return V3{p0.x + t * (p1.x - p0.x), p0.y + t * (p1.y - p0.y),
              p0.z + t * (p1.z - p0.z)};
}

struct MeshBuffers {
    std::vector<float> vertices;  // xyz triplets, 3 per triangle corner
};

// Emit triangles for one tetrahedron. Winding is normalized against
// the tet's constant field gradient: face normals point toward the
// val < iso side (down-gradient), giving a globally consistent
// orientation regardless of case.
void marchTet(const V3 pos[4], const float val[4], float iso,
              float gamma, MeshBuffers* out) {
    int code = 0;
    for (int i = 0; i < 4; ++i) {
        if (val[i] >= iso) code |= 1 << i;
    }
    if (code == 0 || code == 15) return;

    // Constant gradient of the linear interpolant over the tet:
    // solve [p1-p0; p2-p0; p3-p0] g = [v1-v0, v2-v0, v3-v0].
    float m[3][3] = {
        {pos[1].x - pos[0].x, pos[1].y - pos[0].y, pos[1].z - pos[0].z},
        {pos[2].x - pos[0].x, pos[2].y - pos[0].y, pos[2].z - pos[0].z},
        {pos[3].x - pos[0].x, pos[3].y - pos[0].y, pos[3].z - pos[0].z},
    };
    float dv[3] = {val[1] - val[0], val[2] - val[0], val[3] - val[0]};
    float det =
        m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
        m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
        m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
    V3 g{0.f, 0.f, 1.f};
    if (std::abs(det) > 1e-20f) {
        float inv = 1.0f / det;
        // g = M^{-1} dv (rows of inverse via cofactors).
        g.x = inv * (dv[0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
                     dv[1] * (m[0][1] * m[2][2] - m[0][2] * m[2][1]) +
                     dv[2] * (m[0][1] * m[1][2] - m[0][2] * m[1][1]));
        g.y = inv * (-dv[0] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
                     dv[1] * (m[0][0] * m[2][2] - m[0][2] * m[2][0]) -
                     dv[2] * (m[0][0] * m[1][2] - m[0][2] * m[1][0]));
        g.z = inv * (dv[0] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]) -
                     dv[1] * (m[0][0] * m[2][1] - m[0][1] * m[2][0]) +
                     dv[2] * (m[0][0] * m[1][1] - m[0][1] * m[1][0]));
    }

    auto edge = [&](int a, int b) {
        return lerpVertex(pos[a], pos[b], val[a], val[b], iso, gamma);
    };
    auto emit = [&](V3 a, V3 b, V3 c) {
        // Snapped vertices can coincide: drop degenerate triangles.
        V3 e1{b.x - a.x, b.y - a.y, b.z - a.z};
        V3 e2{c.x - a.x, c.y - a.y, c.z - a.z};
        V3 fn{e1.y * e2.z - e1.z * e2.y, e1.z * e2.x - e1.x * e2.z,
              e1.x * e2.y - e1.y * e2.x};
        float area2 = fn.x * fn.x + fn.y * fn.y + fn.z * fn.z;
        if (area2 < 1e-14f) return;
        if (fn.x * g.x + fn.y * g.y + fn.z * g.z > 0.0f) {
            V3 tmp = b; b = c; c = tmp;
        }
        const V3 tri[3] = {a, b, c};
        for (const V3& v : tri) {
            out->vertices.push_back(v.x);
            out->vertices.push_back(v.y);
            out->vertices.push_back(v.z);
        }
    };

    switch (code) {
        case 1: case 14:
            emit(edge(0,1), edge(0,2), edge(0,3)); break;
        case 2: case 13:
            emit(edge(1,0), edge(1,3), edge(1,2)); break;
        case 4: case 11:
            emit(edge(2,0), edge(2,1), edge(2,3)); break;
        case 8: case 7:
            emit(edge(3,0), edge(3,2), edge(3,1)); break;
        case 3: case 12: {  // {0,1} vs {2,3}
            V3 a = edge(0,2), b = edge(0,3), c = edge(1,3), d = edge(1,2);
            emit(a, b, c); emit(a, c, d); break;
        }
        case 5: case 10: {  // {0,2} vs {1,3}
            V3 a = edge(0,1), b = edge(0,3), c = edge(2,3), d = edge(2,1);
            emit(a, b, c); emit(a, c, d); break;
        }
        case 6: case 9: {  // {1,2} vs {0,3}
            V3 a = edge(1,0), b = edge(1,3), c = edge(2,3), d = edge(2,0);
            emit(a, b, c); emit(a, c, d); break;
        }
    }
}

}  // namespace

extern "C" {

// Extracts the isosurface; returns the number of float3 vertices
// (3 per triangle). The returned buffer is malloc'd; free with
// isosurface_free. Vertex coordinates are in voxel space (x, y, z).
int64_t isosurface_extract(
        const float* grid, int64_t zs, int64_t ys, int64_t xs,
        float iso, float gamma, float** out_vertices) {
    MeshBuffers mesh;
    mesh.vertices.reserve(1 << 16);

    auto at = [&](int64_t z, int64_t y, int64_t x) {
        return grid[(z * ys + y) * xs + x];
    };

    for (int64_t z = 0; z + 1 < zs; ++z) {
        for (int64_t y = 0; y + 1 < ys; ++y) {
            for (int64_t x = 0; x + 1 < xs; ++x) {
                float cval[8];
                V3 cpos[8];
                bool anyNan = false;
                for (int c = 0; c < 8; ++c) {
                    int64_t cx = x + kCornerOffset[c][0];
                    int64_t cy = y + kCornerOffset[c][1];
                    int64_t cz = z + kCornerOffset[c][2];
                    cval[c] = at(cz, cy, cx);
                    if (std::isnan(cval[c])) anyNan = true;
                    cpos[c] = V3{float(cx), float(cy), float(cz)};
                }
                if (anyNan) continue;
                for (const auto& tet : kTets) {
                    V3 tpos[4];
                    float tval[4];
                    for (int i = 0; i < 4; ++i) {
                        tpos[i] = cpos[tet[i]];
                        tval[i] = cval[tet[i]];
                    }
                    marchTet(tpos, tval, iso, gamma, &mesh);
                }
            }
        }
    }

    int64_t numVerts = int64_t(mesh.vertices.size() / 3);
    *out_vertices = static_cast<float*>(
        std::malloc(mesh.vertices.size() * sizeof(float)));
    std::memcpy(*out_vertices, mesh.vertices.data(),
                mesh.vertices.size() * sizeof(float));
    return numVerts;
}

void isosurface_free(float* ptr) { std::free(ptr); }

}  // extern "C"
