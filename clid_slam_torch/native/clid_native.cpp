// clid_slam_torch native host runtime (the port's own copy of the JAX
// package's clid_native.cpp).
//
// The card owns all map/tracking compute; the host's job is to keep it
// fed. The reference leans on Open3D's C++ core for point-cloud parsing
// and containers (utils/slam_dataset.py:187-193, 993-1062) and reads every
// frame synchronously inside the SLAM loop (utils/slam_dataset.py:250-295).
// This library provides the equivalents, off the critical path:
//
//   * zero-copy-ish parsers for KITTI .bin, PLY (ascii + binary LE) and
//     PCD (ascii + binary) frames with non-finite filtering,
//   * a voxel-grid downsample identical in semantics to
//     ops/voxel.voxel_down_sample_mask (keep the point closest to its
//     voxel center; same hash, same packed-key tie-breaking) so frames
//     can be thinned in loader threads before they reach the card,
//   * a multi-threaded prefetching frame loader (read + parse + optional
//     downsample of frame i+1..i+W while the card works on frame i).
//
// Exposed as a plain C ABI consumed via ctypes. Built on demand by
// clid_slam_torch/native/__init__.py.

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct CloudData {
  std::vector<float> xyz;        // n*3
  std::vector<float> intensity;  // n or empty
  std::vector<double> ts;        // n or empty
  std::vector<float> rgb;        // n*3 or empty
  int64_t n = 0;
};

// ------------------------------------------------------------------ utils

bool read_file(const std::string& path, std::vector<char>& buf,
               std::string& err) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) {
    err = "cannot open " + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(size);
  size_t got = size ? std::fread(buf.data(), 1, size, f) : 0;
  std::fclose(f);
  if ((long)got != size) {
    err = "short read on " + path;
    return false;
  }
  return true;
}

// Drop rows whose xyz is not finite (mirrors utils/io.py read_point_cloud).
void filter_nonfinite(CloudData& c) {
  int64_t w = 0;
  for (int64_t i = 0; i < c.n; ++i) {
    const float* p = &c.xyz[i * 3];
    if (!(std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2])))
      continue;
    if (w != i) {
      std::memcpy(&c.xyz[w * 3], p, 3 * sizeof(float));
      if (!c.intensity.empty()) c.intensity[w] = c.intensity[i];
      if (!c.ts.empty()) c.ts[w] = c.ts[i];
      if (!c.rgb.empty())
        std::memcpy(&c.rgb[w * 3], &c.rgb[i * 3], 3 * sizeof(float));
    }
    ++w;
  }
  c.n = w;
  c.xyz.resize(w * 3);
  if (!c.intensity.empty()) c.intensity.resize(w);
  if (!c.ts.empty()) c.ts.resize(w);
  if (!c.rgb.empty()) c.rgb.resize(w * 3);
}

// ------------------------------------------------------------- KITTI .bin

bool parse_bin(const std::string& path, CloudData& out, std::string& err) {
  std::vector<char> buf;
  if (!read_file(path, buf, err)) return false;
  int64_t n = (int64_t)(buf.size() / (4 * sizeof(float)));
  const float* d = reinterpret_cast<const float*>(buf.data());
  out.n = n;
  out.xyz.resize(n * 3);
  out.intensity.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    out.xyz[i * 3 + 0] = d[i * 4 + 0];
    out.xyz[i * 3 + 1] = d[i * 4 + 1];
    out.xyz[i * 3 + 2] = d[i * 4 + 2];
    out.intensity[i] = d[i * 4 + 3];
  }
  return true;
}

// ------------------------------------------------------------------- PLY

enum FieldType { FT_NONE = 0, FT_F32, FT_F64, FT_I8, FT_U8, FT_I16, FT_U16,
                 FT_I32, FT_U32 };

int field_size(FieldType t) {
  switch (t) {
    case FT_F64: return 8;
    case FT_F32: case FT_I32: case FT_U32: return 4;
    case FT_I16: case FT_U16: return 2;
    case FT_I8: case FT_U8: return 1;
    default: return 0;
  }
}

FieldType ply_type(const std::string& s) {
  if (s == "float" || s == "float32") return FT_F32;
  if (s == "double" || s == "float64") return FT_F64;
  if (s == "char" || s == "int8") return FT_I8;
  if (s == "uchar" || s == "uint8") return FT_U8;
  if (s == "short" || s == "int16") return FT_I16;
  if (s == "ushort" || s == "uint16") return FT_U16;
  if (s == "int" || s == "int32") return FT_I32;
  if (s == "uint" || s == "uint32") return FT_U32;
  return FT_NONE;
}

double read_field(const char* p, FieldType t) {
  switch (t) {
    case FT_F32: { float v; std::memcpy(&v, p, 4); return v; }
    case FT_F64: { double v; std::memcpy(&v, p, 8); return v; }
    case FT_I8: { int8_t v; std::memcpy(&v, p, 1); return v; }
    case FT_U8: { uint8_t v; std::memcpy(&v, p, 1); return v; }
    case FT_I16: { int16_t v; std::memcpy(&v, p, 2); return v; }
    case FT_U16: { uint16_t v; std::memcpy(&v, p, 2); return v; }
    case FT_I32: { int32_t v; std::memcpy(&v, p, 4); return v; }
    case FT_U32: { uint32_t v; std::memcpy(&v, p, 4); return v; }
    default: return 0.0;
  }
}

struct PropLayout {
  // byte offset (binary) or column index (ascii) + type per channel; -1 absent
  int x = -1, y = -1, z = -1, inten = -1, ts = -1, r = -1, g = -1, b = -1;
  FieldType tx{}, ty{}, tz{}, ti{}, tt{}, tr{}, tg{}, tb{};
  int stride = 0;      // binary row bytes
  int n_cols = 0;      // ascii columns
};

void assign_prop(PropLayout& L, const std::string& name, int pos,
                 FieldType t) {
  if (name == "x") { L.x = pos; L.tx = t; }
  else if (name == "y") { L.y = pos; L.ty = t; }
  else if (name == "z") { L.z = pos; L.tz = t; }
  else if (name == "intensity") { L.inten = pos; L.ti = t; }
  else if (name == "timestamp" || name == "time" || name == "t") {
    if (L.ts < 0) { L.ts = pos; L.tt = t; }
  } else if (name == "red") { L.r = pos; L.tr = t; }
  else if (name == "green") { L.g = pos; L.tg = t; }
  else if (name == "blue") { L.b = pos; L.tb = t; }
}

bool parse_ply(const std::string& path, CloudData& out, std::string& err) {
  std::vector<char> buf;
  if (!read_file(path, buf, err)) return false;
  size_t pos = 0, size = buf.size();
  auto next_line = [&](std::string& line) -> bool {
    if (pos >= size) return false;
    size_t e = pos;
    while (e < size && buf[e] != '\n') ++e;
    line.assign(&buf[pos], e - pos);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos = e + 1;
    return true;
  };
  std::string line;
  if (!next_line(line) || line != "ply") {
    err = path + ": not a PLY file";
    return false;
  }
  bool ascii = false, big_endian = false, in_vertex = false;
  int64_t n_vertex = 0;
  PropLayout L;
  while (next_line(line)) {
    char w0[64] = {0}, w1[64] = {0}, w2[64] = {0};
    if (std::sscanf(line.c_str(), "%63s %63s %63s", w0, w1, w2) < 1) continue;
    std::string t0 = w0, t1 = w1, t2 = w2;
    if (t0 == "format") {
      ascii = t1 == "ascii";
      big_endian = t1.find("big") != std::string::npos;
    } else if (t0 == "element") {
      in_vertex = t1 == "vertex";
      if (in_vertex) n_vertex = std::atoll(w2);
    } else if (t0 == "property" && in_vertex) {
      if (t1 == "list") {
        err = path + ": list property on vertex not supported";
        return false;
      }
      FieldType ft = ply_type(t1);
      if (ft == FT_NONE) {
        err = path + ": unknown PLY type " + t1;
        return false;
      }
      assign_prop(L, t2, ascii ? L.n_cols : L.stride, ft);
      L.stride += field_size(ft);
      L.n_cols += 1;
    } else if (t0 == "end_header") {
      break;
    }
  }
  if (big_endian) {
    err = path + ": big-endian PLY not supported";
    return false;
  }
  if (L.x < 0 || L.y < 0 || L.z < 0) {
    err = path + ": PLY has no x/y/z vertex properties";
    return false;
  }
  out.n = n_vertex;
  out.xyz.resize(n_vertex * 3);
  bool has_i = L.inten >= 0, has_ts = L.ts >= 0,
       has_rgb = L.r >= 0 && L.g >= 0 && L.b >= 0;
  if (has_i) out.intensity.resize(n_vertex);
  if (has_ts) out.ts.resize(n_vertex);
  if (has_rgb) out.rgb.resize(n_vertex * 3);

  if (!ascii) {
    if (pos + (size_t)n_vertex * L.stride > size) {
      err = path + ": truncated PLY payload";
      return false;
    }
    const char* row = &buf[pos];
    for (int64_t i = 0; i < n_vertex; ++i, row += L.stride) {
      out.xyz[i * 3 + 0] = (float)read_field(row + L.x, L.tx);
      out.xyz[i * 3 + 1] = (float)read_field(row + L.y, L.ty);
      out.xyz[i * 3 + 2] = (float)read_field(row + L.z, L.tz);
      if (has_i) out.intensity[i] = (float)read_field(row + L.inten, L.ti);
      if (has_ts) out.ts[i] = read_field(row + L.ts, L.tt);
      if (has_rgb) {
        out.rgb[i * 3 + 0] = (float)read_field(row + L.r, L.tr);
        out.rgb[i * 3 + 1] = (float)read_field(row + L.g, L.tg);
        out.rgb[i * 3 + 2] = (float)read_field(row + L.b, L.tb);
      }
    }
  } else {
    const char* p = &buf[pos];
    const char* end = buf.data() + size;
    std::vector<double> cols(L.n_cols);
    for (int64_t i = 0; i < n_vertex; ++i) {
      for (int c = 0; c < L.n_cols; ++c) {
        char* q = nullptr;
        cols[c] = std::strtod(p, &q);
        if (q == p) {
          err = path + ": ascii parse error";
          return false;
        }
        p = q;
        if (p > end) { err = path + ": truncated ascii PLY"; return false; }
      }
      out.xyz[i * 3 + 0] = (float)cols[L.x];
      out.xyz[i * 3 + 1] = (float)cols[L.y];
      out.xyz[i * 3 + 2] = (float)cols[L.z];
      if (has_i) out.intensity[i] = (float)cols[L.inten];
      if (has_ts) out.ts[i] = cols[L.ts];
      if (has_rgb) {
        out.rgb[i * 3 + 0] = (float)cols[L.r];
        out.rgb[i * 3 + 1] = (float)cols[L.g];
        out.rgb[i * 3 + 2] = (float)cols[L.b];
      }
    }
  }
  return true;
}

// ------------------------------------------------------------------- PCD

bool parse_pcd(const std::string& path, CloudData& out, std::string& err) {
  std::vector<char> buf;
  if (!read_file(path, buf, err)) return false;
  size_t pos = 0, size = buf.size();
  auto next_line = [&](std::string& line) -> bool {
    if (pos >= size) return false;
    size_t e = pos;
    while (e < size && buf[e] != '\n') ++e;
    line.assign(&buf[pos], e - pos);
    if (!line.empty() && line.back() == '\r') line.pop_back();
    pos = e + 1;
    return true;
  };
  std::vector<std::string> fields, types;
  std::vector<int> sizes, counts;
  int64_t n = 0;
  bool ascii = true;
  std::string line;
  while (next_line(line)) {
    if (line.empty() || line[0] == '#') continue;
    size_t sp = line.find(' ');
    std::string key = line.substr(0, sp);
    std::string val = sp == std::string::npos ? "" : line.substr(sp + 1);
    auto split = [](const std::string& s) {
      std::vector<std::string> v;
      size_t i = 0;
      while (i < s.size()) {
        while (i < s.size() && std::isspace((unsigned char)s[i])) ++i;
        size_t j = i;
        while (j < s.size() && !std::isspace((unsigned char)s[j])) ++j;
        if (j > i) v.push_back(s.substr(i, j - i));
        i = j;
      }
      return v;
    };
    if (key == "FIELDS") fields = split(val);
    else if (key == "TYPE") types = split(val);
    else if (key == "SIZE") {
      for (auto& s : split(val)) sizes.push_back(std::atoi(s.c_str()));
    } else if (key == "COUNT") {
      for (auto& s : split(val)) counts.push_back(std::atoi(s.c_str()));
    } else if (key == "POINTS") n = std::atoll(val.c_str());
    else if (key == "DATA") {
      ascii = val == "ascii";
      if (!ascii && val != "binary") {
        err = path + ": unsupported PCD DATA " + val;
        return false;
      }
      break;
    }
  }
  if (counts.empty()) counts.assign(fields.size(), 1);
  if (fields.size() != types.size() || fields.size() != sizes.size() ||
      fields.size() != counts.size()) {
    err = path + ": inconsistent PCD header";
    return false;
  }
  PropLayout L;
  int stride = 0, col = 0;
  for (size_t f = 0; f < fields.size(); ++f) {
    FieldType ft = FT_NONE;
    char t = types[f].empty() ? 'F' : types[f][0];
    int s = sizes[f];
    if (t == 'F') ft = s == 8 ? FT_F64 : FT_F32;
    else if (t == 'I') ft = s == 1 ? FT_I8 : (s == 2 ? FT_I16 : FT_I32);
    else if (t == 'U') ft = s == 1 ? FT_U8 : (s == 2 ? FT_U16 : FT_U32);
    if (ft == FT_NONE) { err = path + ": bad PCD type"; return false; }
    if (counts[f] == 1)
      assign_prop(L, fields[f], ascii ? col : stride, ft);
    stride += field_size(ft) * counts[f];
    col += counts[f];
  }
  L.stride = stride;
  L.n_cols = col;
  if (L.x < 0 || L.y < 0 || L.z < 0) {
    err = path + ": PCD has no x/y/z fields";
    return false;
  }
  out.n = n;
  out.xyz.resize(n * 3);
  bool has_i = L.inten >= 0, has_ts = L.ts >= 0;
  if (has_i) out.intensity.resize(n);
  if (has_ts) out.ts.resize(n);
  if (!ascii) {
    if (pos + (size_t)n * stride > size) {
      err = path + ": truncated PCD payload";
      return false;
    }
    const char* row = &buf[pos];
    for (int64_t i = 0; i < n; ++i, row += stride) {
      out.xyz[i * 3 + 0] = (float)read_field(row + L.x, L.tx);
      out.xyz[i * 3 + 1] = (float)read_field(row + L.y, L.ty);
      out.xyz[i * 3 + 2] = (float)read_field(row + L.z, L.tz);
      if (has_i) out.intensity[i] = (float)read_field(row + L.inten, L.ti);
      if (has_ts) out.ts[i] = read_field(row + L.ts, L.tt);
    }
  } else {
    const char* p = &buf[pos];
    const char* end = buf.data() + size;
    std::vector<double> cols(L.n_cols);
    for (int64_t i = 0; i < n; ++i) {
      for (int c = 0; c < L.n_cols; ++c) {
        char* q = nullptr;
        cols[c] = std::strtod(p, &q);
        if (q == p) { err = path + ": ascii parse error"; return false; }
        p = q;
        if (p > end) { err = path + ": truncated ascii PCD"; return false; }
      }
      out.xyz[i * 3 + 0] = (float)cols[L.x];
      out.xyz[i * 3 + 1] = (float)cols[L.y];
      out.xyz[i * 3 + 2] = (float)cols[L.z];
      if (has_i) out.intensity[i] = (float)cols[L.inten];
      if (has_ts) out.ts[i] = cols[L.ts];
    }
  }
  return true;
}

bool parse_any(const std::string& path, CloudData& out, std::string& err) {
  size_t dot = path.rfind('.');
  std::string ext = dot == std::string::npos ? "" : path.substr(dot);
  for (auto& ch : ext) ch = (char)std::tolower((unsigned char)ch);
  bool ok;
  if (ext == ".bin") ok = parse_bin(path, out, err);
  else if (ext == ".ply") ok = parse_ply(path, out, err);
  else if (ext == ".pcd") ok = parse_pcd(path, out, err);
  else { err = "unsupported point cloud format: " + ext; return false; }
  if (ok) filter_nonfinite(out);
  return ok;
}

}  // namespace

// ==================================================================== C ABI

extern "C" {

// Mirrors the Python-side struct in native/__init__.py. All pointers are
// owned by the handle and freed by clid_cloud_free.
struct ClidCloud {
  float* xyz;        // [n*3]
  float* intensity;  // [n] or null
  double* ts;        // [n] or null
  float* rgb;        // [n*3] or null
  int64_t n;
  void* handle;      // opaque CloudData*
  char err[256];
};

static void fill_cloud(ClidCloud* c, CloudData* d) {
  c->handle = d;
  c->n = d->n;
  c->xyz = d->xyz.data();
  c->intensity = d->intensity.empty() ? nullptr : d->intensity.data();
  c->ts = d->ts.empty() ? nullptr : d->ts.data();
  c->rgb = d->rgb.empty() ? nullptr : d->rgb.data();
  c->err[0] = 0;
}

int clid_read_cloud(const char* path, ClidCloud* out) {
  std::memset(out, 0, sizeof(*out));
  auto* d = new CloudData();
  std::string err;
  if (!parse_any(path, *d, err)) {
    std::snprintf(out->err, sizeof(out->err), "%s", err.c_str());
    delete d;
    return -1;
  }
  fill_cloud(out, d);
  return 0;
}

void clid_cloud_free(ClidCloud* c) {
  delete static_cast<CloudData*>(c->handle);
  std::memset(c, 0, sizeof(*c));
}

// Voxel downsample: keep, per voxel, the point closest to the voxel center.
// Bit-for-bit the same selection as ops/voxel.voxel_down_sample_mask
// (same sum-of-primes + murmur3-finalizer hash, same quantized packed key
// with smaller-index tie-breaking), so host-thinned clouds match what the
// device path would have kept. table_size must be a power of two.
int64_t clid_voxel_downsample(const float* pts, int64_t n, float res,
                              int64_t table_size, const uint8_t* in_mask,
                              uint8_t* keep) {
  const uint32_t P1 = 73856093u, P2 = 19349669u, P3 = 83492791u;
  const int32_t INT32_MAX_ = 2147483647;
  int64_t levels64 = (INT32_MAX_ - 1) / (n > 0 ? n : 1) - 1;
  if (levels64 < 2) levels64 = 2;
  if (levels64 > 32766) levels64 = 32766;
  float levels = (float)levels64;
  float max_d2 = 0.75f * res * res + 1e-12f;

  std::vector<int32_t> table(table_size, INT32_MAX_);
  std::vector<int32_t> keys(n);
  std::vector<uint32_t> hs(n);
  for (int64_t i = 0; i < n; ++i) {
    keep[i] = 0;
    if (in_mask && !in_mask[i]) { keys[i] = INT32_MAX_; hs[i] = 0; continue; }
    float gx = std::floor(pts[i * 3 + 0] / res);
    float gy = std::floor(pts[i * 3 + 1] / res);
    float gz = std::floor(pts[i * 3 + 2] / res);
    float dx = pts[i * 3 + 0] - (gx + 0.5f) * res;
    float dy = pts[i * 3 + 1] - (gy + 0.5f) * res;
    float dz = pts[i * 3 + 2] - (gz + 0.5f) * res;
    float d2 = dx * dx + dy * dy + dz * dz;
    float sqf = d2 / max_d2 * levels;
    if (sqf < 0.f) sqf = 0.f;
    if (sqf > levels) sqf = levels;
    int32_t key = (int32_t)sqf * (int32_t)n + (int32_t)i;
    uint32_t h = (uint32_t)(int32_t)gx * P1 + (uint32_t)(int32_t)gy * P2 +
                 (uint32_t)(int32_t)gz * P3;
    h ^= h >> 16; h *= 0x85EBCA6Bu; h ^= h >> 13; h *= 0xC2B2AE35u;
    h ^= h >> 16;
    h &= (uint32_t)(table_size - 1);
    keys[i] = key;
    hs[i] = h;
    if (key < table[h]) table[h] = key;
  }
  int64_t kept = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (keys[i] != INT32_MAX_ && table[hs[i]] == keys[i]) {
      keep[i] = 1;
      ++kept;
    }
  }
  return kept;
}

// ------------------------------------------------- prefetching frame loader

struct Loader {
  std::vector<std::string> paths;
  std::vector<CloudData*> done;   // parsed results, nulled once consumed
  std::vector<std::string> errs;
  std::vector<uint8_t> state;     // 0 idle, 1 inflight, 2 done
  std::mutex m;
  std::condition_variable cv_work, cv_done;
  int64_t horizon = 0;  // schedule frames < horizon
  bool stop = false;
  std::vector<std::thread> workers;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(m);
      stop = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    for (auto* d : done) delete d;
  }

  void work() {
    for (;;) {
      int64_t job = -1;
      {
        std::unique_lock<std::mutex> lk(m);
        cv_work.wait(lk, [&] {
          if (stop) return true;
          for (int64_t i = 0; i < horizon && i < (int64_t)paths.size(); ++i)
            if (state[i] == 0) { job = i; return true; }
          return false;
        });
        if (stop) return;
        state[job] = 1;
      }
      auto* d = new CloudData();
      std::string err;
      bool ok = parse_any(paths[job], *d, err);
      {
        std::lock_guard<std::mutex> lk(m);
        if (!ok) { delete d; d = nullptr; errs[job] = err; }
        done[job] = d;
        state[job] = 2;
      }
      cv_done.notify_all();
    }
  }
};

void* clid_loader_create(const char** paths, int64_t n_paths, int lookahead,
                         int n_threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->done.assign(n_paths, nullptr);
  L->errs.resize(n_paths);
  L->state.assign(n_paths, 0);
  L->horizon = lookahead;
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back(&Loader::work, L);
  return L;
}

// Blocking fetch of frame idx; extends the prefetch horizon past it.
int clid_loader_get(void* loader, int64_t idx, int64_t lookahead,
                    ClidCloud* out) {
  auto* L = static_cast<Loader*>(loader);
  std::memset(out, 0, sizeof(*out));
  if (idx < 0 || idx >= (int64_t)L->paths.size()) {
    std::snprintf(out->err, sizeof(out->err), "frame index out of range");
    return -1;
  }
  CloudData* d = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->m);
    int64_t h = idx + 1 + lookahead;
    if (h > L->horizon) L->horizon = h;
    lk.unlock();
    L->cv_work.notify_all();
    lk.lock();
    L->cv_done.wait(lk, [&] { return L->state[idx] == 2; });
    d = L->done[idx];
    L->done[idx] = nullptr;  // hand ownership to caller
    if (!d) {
      std::snprintf(out->err, sizeof(out->err), "%s", L->errs[idx].c_str());
      return -1;
    }
  }
  fill_cloud(out, d);
  return 0;
}

void clid_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
