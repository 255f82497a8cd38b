// The C++ OBJ reader of liverrenderer_tpu_torch/scene/meshio.py (the
// port's copy of the JAX package's native/mesh_load.cpp, with the same
// parse): fan-triangulated polygons, vertices split by unique (v, vt, vn)
// corner, uv.y = 1 - t as Mitsuba's obj.cpp.  meshio.py keeps its plain
// Python version, `_load_obj`, and the tests hold the two equal bit for
// bit.  Compiled with the host C++ compiler at first use (host_build.py)
// and called through ctypes in two calls:
//   1) lrt_obj_load(path, &handle, &n_verts, &n_tris, &has_uv, &has_n)
//   2) lrt_obj_fetch(handle, verts, faces, normals, uvs)  -- frees handle
// Each returns 0 on success.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <tuple>
#include <unordered_map>
#include <vector>

namespace {

struct TupleHash {
    size_t operator()(const std::tuple<int, int, int>& k) const {
        size_t h = std::get<0>(k) * 73856093u;
        h ^= std::get<1>(k) * 19349663u;
        h ^= std::get<2>(k) * 83492791u;
        return h;
    }
};

struct ObjData {
    std::vector<float> verts;    // (V,3)
    std::vector<int32_t> faces;  // (T,3)
    std::vector<float> normals;  // (V,3) or empty
    std::vector<float> uvs;      // (V,2) or empty
    bool has_uv = false, has_n = false;
};

std::unordered_map<int64_t, ObjData*> g_handles;
int64_t g_next_handle = 1;

inline const char* skip_ws(const char* p, const char* end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    return p;
}

inline int fix_index(int i, int n) { return i > 0 ? i - 1 : n + i; }

}  // namespace

extern "C" {

int lrt_obj_load(const char* path, int64_t* handle, int64_t* n_verts,
                 int64_t* n_tris, int32_t* has_uv, int32_t* has_n) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(size, '\0');
    if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        std::fclose(f);
        return -1;
    }
    std::fclose(f);

    std::vector<float> v, vt, vn;
    struct Corner {
        int vi, ti, ni;
    };
    std::vector<Corner> tris;  // 3 per triangle

    const char* p = buf.data();
    const char* end = p + buf.size();
    std::vector<Corner> poly;
    while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', end - p));
        const char* le = nl ? nl : end;
        p = skip_ws(p, le);
        if (le - p >= 2 && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == 't' || p[1] == 'n')) {
            char kind = p[1];
            const char* q = p + (kind == ' ' ? 1 : 2);
            int want = (kind == 't') ? 2 : 3;
            std::vector<float>& dst =
                (kind == ' ') ? v : (kind == 't' ? vt : vn);
            for (int k = 0; k < want; ++k) {
                char* qe;
                dst.push_back(std::strtof(q, &qe));
                q = qe;
            }
        } else if (le - p >= 2 && p[0] == 'f' && p[1] == ' ') {
            const char* q = p + 1;
            poly.clear();
            while (true) {
                q = skip_ws(q, le);
                if (q >= le || *q == '\n' || *q == '#') break;
                char* qe;
                long vi = std::strtol(q, &qe, 10);
                if (qe == q) break;
                q = qe;
                long ti = 0, ni = 0;
                if (q < le && *q == '/') {
                    ++q;
                    if (q < le && *q != '/') {
                        ti = std::strtol(q, &qe, 10);
                        q = qe;
                    }
                    if (q < le && *q == '/') {
                        ++q;
                        ni = std::strtol(q, &qe, 10);
                        q = qe;
                    }
                }
                poly.push_back({static_cast<int>(vi), static_cast<int>(ti),
                                static_cast<int>(ni)});
            }
            for (size_t k = 1; k + 1 < poly.size(); ++k) {
                tris.push_back(poly[0]);
                tris.push_back(poly[k]);
                tris.push_back(poly[k + 1]);
            }
        }
        p = nl ? nl + 1 : end;
    }

    ObjData* od = new ObjData;
    int nv = static_cast<int>(v.size() / 3);
    int nt = static_cast<int>(vt.size() / 2);
    int nn = static_cast<int>(vn.size() / 3);
    bool any_t = false, any_n = false;
    for (const Corner& c : tris) {
        if (c.ti != 0) any_t = true;
        if (c.ni != 0) any_n = true;
    }
    od->has_uv = any_t && nt > 0;
    od->has_n = any_n && nn > 0;

    if (!od->has_uv && !od->has_n) {
        od->verts = std::move(v);
        od->faces.reserve(tris.size());
        for (const Corner& c : tris)
            od->faces.push_back(fix_index(c.vi, nv));
    } else {
        std::unordered_map<std::tuple<int, int, int>, int32_t, TupleHash>
            corner_map;
        corner_map.reserve(tris.size());
        od->faces.reserve(tris.size());
        for (const Corner& c : tris) {
            auto key = std::make_tuple(c.vi, c.ti, c.ni);
            auto it = corner_map.find(key);
            int32_t idx;
            if (it == corner_map.end()) {
                idx = static_cast<int32_t>(od->verts.size() / 3);
                corner_map.emplace(key, idx);
                int visrc = fix_index(c.vi, nv);
                od->verts.push_back(v[visrc * 3]);
                od->verts.push_back(v[visrc * 3 + 1]);
                od->verts.push_back(v[visrc * 3 + 2]);
                if (od->has_uv) {
                    if (c.ti != 0) {
                        int t = fix_index(c.ti, nt);
                        od->uvs.push_back(vt[t * 2]);
                        od->uvs.push_back(1.0f - vt[t * 2 + 1]);
                    } else {
                        od->uvs.push_back(0.0f);
                        od->uvs.push_back(0.0f);
                    }
                }
                if (od->has_n) {
                    if (c.ni != 0) {
                        int nsrc = fix_index(c.ni, nn);
                        od->normals.push_back(vn[nsrc * 3]);
                        od->normals.push_back(vn[nsrc * 3 + 1]);
                        od->normals.push_back(vn[nsrc * 3 + 2]);
                    } else {
                        od->normals.push_back(0.0f);
                        od->normals.push_back(0.0f);
                        od->normals.push_back(0.0f);
                    }
                }
            } else {
                idx = it->second;
            }
            od->faces.push_back(idx);
        }
    }

    *handle = g_next_handle++;
    g_handles[*handle] = od;
    *n_verts = static_cast<int64_t>(od->verts.size() / 3);
    *n_tris = static_cast<int64_t>(od->faces.size() / 3);
    *has_uv = od->has_uv ? 1 : 0;
    *has_n = od->has_n ? 1 : 0;
    return 0;
}

int lrt_obj_fetch(int64_t handle, float* verts, int32_t* faces,
                  float* normals, float* uvs) {
    auto it = g_handles.find(handle);
    if (it == g_handles.end()) return -1;
    ObjData* od = it->second;
    std::memcpy(verts, od->verts.data(), od->verts.size() * sizeof(float));
    std::memcpy(faces, od->faces.data(), od->faces.size() * sizeof(int32_t));
    if (od->has_n && normals)
        std::memcpy(normals, od->normals.data(),
                    od->normals.size() * sizeof(float));
    if (od->has_uv && uvs)
        std::memcpy(uvs, od->uvs.data(), od->uvs.size() * sizeof(float));
    delete od;
    g_handles.erase(it);
    return 0;
}

}  // extern "C"
