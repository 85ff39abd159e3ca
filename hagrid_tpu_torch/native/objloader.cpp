// Fast Wavefront OBJ parser (native runtime component of hagrid_tpu_torch).
//
// Scene IO stays native C++ because San-Miguel-scale OBJs (hundreds of MB)
// parse ~50x slower in Python. Exposed to Python through a plain C ABI and
// ctypes (native/objloader_native.py builds it with g++ at first use).
//
// Semantics (matching the Python parser of hagrid_tpu_torch/io/obj.py):
// v/f records, fan triangulation of polygons, negative (relative)
// indices; vt/vn/materials ignored.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> verts;   // 3 per vertex
  std::vector<int> faces;     // 3 per triangle
};

// Parse a float fast; advances *p past the number.
inline float parse_float(const char** p) {
  char* end;
  float v = strtof(*p, &end);
  *p = end;
  return v;
}

inline long parse_int(const char** p) {
  char* end;
  long v = strtol(*p, &end, 10);
  *p = end;
  return v;
}

inline void skip_ws(const char** p) {
  while (**p == ' ' || **p == '\t') ++(*p);
}

}  // namespace

extern "C" {

// Parses `path`. On success returns an opaque handle and writes counts;
// on failure returns nullptr.
void* obj_load(const char* path, long* n_verts, long* n_faces) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\0';

  ObjData* data = new ObjData();
  data->verts.reserve(1 << 16);
  data->faces.reserve(1 << 16);
  std::vector<long> poly;
  poly.reserve(16);

  const char* p = buf.data();
  const char* end = buf.data() + size;
  while (p < end) {
    skip_ws(&p);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      float x = parse_float(&p);
      float y = parse_float(&p);
      float z = parse_float(&p);
      data->verts.push_back(x);
      data->verts.push_back(y);
      data->verts.push_back(z);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      poly.clear();
      while (true) {
        skip_ws(&p);
        if (*p == '\n' || *p == '\r' || *p == '\0' || *p == '#') break;
        long idx = parse_int(&p);
        // Skip /vt/vn suffixes.
        while (*p != ' ' && *p != '\t' && *p != '\n' && *p != '\r' &&
               *p != '\0')
          ++p;
        long nv = (long)(data->verts.size() / 3);
        poly.push_back(idx > 0 ? idx - 1 : nv + idx);
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        data->faces.push_back((int)poly[0]);
        data->faces.push_back((int)poly[k]);
        data->faces.push_back((int)poly[k + 1]);
      }
    }
    // Advance to next line.
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  *n_verts = (long)(data->verts.size() / 3);
  *n_faces = (long)(data->faces.size() / 3);
  return data;
}

void obj_copy(void* handle, float* verts, int* faces) {
  ObjData* data = (ObjData*)handle;
  memcpy(verts, data->verts.data(), data->verts.size() * sizeof(float));
  memcpy(faces, data->faces.data(), data->faces.size() * sizeof(int));
}

void obj_free(void* handle) { delete (ObjData*)handle; }

}  // extern "C"
