// Native OBJ parsing for the host side of pytorch3d_tpu_torch's IO.
//
// A zero-dependency single-pass OBJ vertex/face parser exposed through a C
// interface (ctypes).  io/obj_io.py takes it for files without materials;
// the pure-Python scanner there stays the fallback and the test oracle.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 fast_io.cpp -o libfast_io.so
// (done lazily by pytorch3d_tpu_torch/io/fast_io.py into build/host/ at the
// root of the checkout, named by a hash of this source).

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Malformed-input codes (mirrors the reference loader's error cases,
// reference io/obj_io.py:479-486 and :393/:409 — behavior parity only).
enum ObjError : int {
  OBJ_OK = 0,
  OBJ_ERR_VERTEX = 1,        // "v" line without 3 numeric values
  OBJ_ERR_TEXTURE = 2,       // "vt" line without 2 numeric values
  OBJ_ERR_NORMAL = 3,        // "vn" line without 3 numeric values
  OBJ_ERR_FACE_PROPS = 4,    // face vertex with >3 '/'-properties
  OBJ_ERR_INCONSISTENT = 5,  // mixed with/without uv or normal indices
};

struct ObjData {
  std::vector<float> verts;      // V * 3
  std::vector<int32_t> faces;    // F * 3 (fan-triangulated)
  std::vector<float> normals;    // VN * 3
  std::vector<float> uvs;        // VT * 2
  std::vector<int32_t> faces_uv; // F * 3, -1 padded (reference obj_io
                                 // pads missing per-face uv/normal
                                 // indices with -1 so all index tensors
                                 // stay F-aligned)
  std::vector<int32_t> faces_n;  // F * 3, -1 padded
  bool any_face_uv = false;
  bool any_face_n = false;
  int error = OBJ_OK;
  long error_line = 0;           // 1-based line of the malformed construct
};

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

// strtof-like without locale overhead for the common case.  Positioned at
// a non-space char by the caller; fails (returns p, *ok=false) when no
// number starts here or the line ended — strtof alone would silently walk
// across the '\n' and swallow the NEXT line's numbers on malformed input.
inline const char* parse_float(const char* p, const char* end, float* out,
                               bool* ok) {
  p = skip_ws(p, end);
  if (p >= end || *p == '\n') {
    *ok = false;
    return p;
  }
  char* q;
  *out = strtof(p, &q);
  *ok = (q != p);
  return q;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
  char* q;
  *out = strtol(p, &q, 10);
  return q;
}

ObjData* parse_obj_impl(const char* text, size_t len) {
  auto* data = new ObjData();
  const char* p = text;
  const char* end = text + len;
  std::vector<long> vi, ti, ni;  // per-face scratch
  long line = 0;
  while (p < end) {
    ++line;
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' &&
        (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      for (int k = 0; k < 3; ++k) {
        float f;
        bool ok;
        p = parse_float(p, end, &f, &ok);
        if (!ok) {
          data->error = OBJ_ERR_VERTEX;
          data->error_line = line;
          return data;
        }
        data->verts.push_back(f);
      }
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      p += 3;
      for (int k = 0; k < 2; ++k) {
        float f;
        bool ok;
        p = parse_float(p, end, &f, &ok);
        if (!ok) {
          data->error = OBJ_ERR_TEXTURE;
          data->error_line = line;
          return data;
        }
        data->uvs.push_back(f);
      }
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      p += 3;
      for (int k = 0; k < 3; ++k) {
        float f;
        bool ok;
        p = parse_float(p, end, &f, &ok);
        if (!ok) {
          data->error = OBJ_ERR_NORMAL;
          data->error_line = line;
          return data;
        }
        data->normals.push_back(f);
      }
    } else if (p + 1 < end && p[0] == 'f' &&
               (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      vi.clear();
      ti.clear();
      ni.clear();
      while (p < end && *p != '\n') {
        p = skip_ws(p, end);
        if (p >= end || *p == '\n' || *p == '#') break;
        long v = 0, t = 0, n = 0;
        bool has_t = false, has_n = false;
        p = parse_int(p, end, &v);
        if (p < end && *p == '/') {
          ++p;
          if (p < end && *p != '/') {
            p = parse_int(p, end, &t);
            has_t = true;
          }
          if (p < end && *p == '/') {
            ++p;
            p = parse_int(p, end, &n);
            has_n = true;
          }
          if (p < end && *p == '/') {
            // e.g. "f 2/1/1/3" — more than vert/uv/normal
            data->error = OBJ_ERR_FACE_PROPS;
            data->error_line = line;
            return data;
          }
        }
        long V = (long)(data->verts.size() / 3);
        vi.push_back(v > 0 ? v - 1 : v + V);
        if (has_t) {
          long T = (long)(data->uvs.size() / 2);
          ti.push_back(t > 0 ? t - 1 : t + T);
        }
        if (has_n) {
          long N = (long)(data->normals.size() / 3);
          ni.push_back(n > 0 ? n - 1 : n + N);
        }
      }
      // triplets must be all-or-none per face (reference obj_io.py:409)
      if ((!ti.empty() && ti.size() != vi.size()) ||
          (!ni.empty() && ni.size() != vi.size())) {
        data->error = OBJ_ERR_INCONSISTENT;
        data->error_line = line;
        return data;
      }
      // fan triangulation; uv/normal streams stay F-aligned (-1 pad)
      bool face_has_uv = ti.size() == vi.size() && !ti.empty();
      bool face_has_n = ni.size() == vi.size() && !ni.empty();
      data->any_face_uv |= face_has_uv;
      data->any_face_n |= face_has_n;
      for (size_t k = 2; k < vi.size(); ++k) {
        data->faces.push_back((int32_t)vi[0]);
        data->faces.push_back((int32_t)vi[k - 1]);
        data->faces.push_back((int32_t)vi[k]);
        data->faces_uv.push_back(face_has_uv ? (int32_t)ti[0] : -1);
        data->faces_uv.push_back(face_has_uv ? (int32_t)ti[k - 1] : -1);
        data->faces_uv.push_back(face_has_uv ? (int32_t)ti[k] : -1);
        data->faces_n.push_back(face_has_n ? (int32_t)ni[0] : -1);
        data->faces_n.push_back(face_has_n ? (int32_t)ni[k - 1] : -1);
        data->faces_n.push_back(face_has_n ? (int32_t)ni[k] : -1);
      }
    }
    p = next_line(p, end);
  }
  return data;
}

}  // namespace

extern "C" {

// Parse; returns an opaque handle. Query sizes, copy out, then free.
void* obj_parse(const char* text, size_t len) {
  return parse_obj_impl(text, len);
}

size_t obj_num_verts(void* h) { return ((ObjData*)h)->verts.size() / 3; }
size_t obj_num_faces(void* h) { return ((ObjData*)h)->faces.size() / 3; }
size_t obj_num_uvs(void* h) { return ((ObjData*)h)->uvs.size() / 2; }
size_t obj_num_normals(void* h) { return ((ObjData*)h)->normals.size() / 3; }
int obj_has_face_uvs(void* h) { return ((ObjData*)h)->any_face_uv; }
int obj_has_face_normals(void* h) { return ((ObjData*)h)->any_face_n; }
int obj_error(void* h) { return ((ObjData*)h)->error; }
long obj_error_line(void* h) { return ((ObjData*)h)->error_line; }

void obj_copy_verts(void* h, float* out) {
  auto& v = ((ObjData*)h)->verts;
  memcpy(out, v.data(), v.size() * sizeof(float));
}
void obj_copy_faces(void* h, int32_t* out) {
  auto& f = ((ObjData*)h)->faces;
  memcpy(out, f.data(), f.size() * sizeof(int32_t));
}
void obj_copy_uvs(void* h, float* out) {
  auto& v = ((ObjData*)h)->uvs;
  memcpy(out, v.data(), v.size() * sizeof(float));
}
void obj_copy_normals(void* h, float* out) {
  auto& v = ((ObjData*)h)->normals;
  memcpy(out, v.data(), v.size() * sizeof(float));
}
void obj_copy_face_uvs(void* h, int32_t* out) {
  auto& f = ((ObjData*)h)->faces_uv;
  memcpy(out, f.data(), f.size() * sizeof(int32_t));
}
void obj_copy_face_normals(void* h, int32_t* out) {
  auto& f = ((ObjData*)h)->faces_n;
  memcpy(out, f.data(), f.size() * sizeof(int32_t));
}
void obj_free(void* h) { delete (ObjData*)h; }
}
