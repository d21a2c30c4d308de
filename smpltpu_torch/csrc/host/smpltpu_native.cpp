// smpltpu_torch host runtime: fast MediaPipe-JSON keypoint parsing and
// triangle fill, the host-side hot paths of the pipeline (a copy of the
// JAX package's native/smpltpu_native.cpp, kept in the port so that the
// port loads nothing of that package):
//   * keypoint JSON loading  (reference include/Utils.h:61-99 via
//     nlohmann/json; here a purpose-built zero-dependency parser that
//     reproduces smpltpu_torch.io.keypoints.load_mp_json exactly, held
//     bit for bit by tests/test_torch_native.py)
//   * triangle fill          (reference include/RenderSMPLMesh.h:94-109
//     via cv::fillConvexPoly; here a scanline half-plane fill matching
//     smpltpu_torch.render.raster._fill_triangles_numpy). Unlike the
//     copy's original, the triangles come in as doubles: the numpy fill
//     tests the float64 drawlist, and a float32 rounding of the corners
//     moves pixels on the edges of a real mesh.
//
// Exposed as a C ABI consumed with ctypes (smpltpu_torch/native). Built at
// first use with g++ -O3 -std=c++17 -fPIC -shared -ffp-contract=off (no
// fused multiply-add: the edge functions must round as numpy's do).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ----------------------------------------------------------------------
// Minimal JSON reader (only what MediaPipe landmark files need: an array
// of objects with numeric fields; tolerates arbitrary nested values).
// ----------------------------------------------------------------------
struct Landmark {
  double x = 0.0, y = 0.0, vis = 0.0;
  bool has_x = false, has_y = false, has_vis = false;
};

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) { ++p; return true; }
    return false;
  }
  // skip any JSON value (for fields we do not care about)
  void skip_value();
  bool parse_string(std::string* out);
  bool parse_number(double* out);
  bool parse_landmark(Landmark* lm);
};

bool Parser::parse_string(std::string* out) {
  skip_ws();
  if (p >= end || *p != '"') return false;
  ++p;
  out->clear();
  while (p < end && *p != '"') {
    if (*p == '\\' && p + 1 < end) ++p;  // keep escaped char verbatim
    out->push_back(*p++);
  }
  if (p >= end) return false;
  ++p;  // closing quote
  return true;
}

bool Parser::parse_number(double* out) {
  skip_ws();
  char* num_end = nullptr;
  double v = std::strtod(p, &num_end);
  if (num_end == p) return false;
  p = num_end;
  *out = v;
  return true;
}

void Parser::skip_value() {
  skip_ws();
  if (p >= end) { ok = false; return; }
  char c = *p;
  if (c == '"') {
    std::string s;
    if (!parse_string(&s)) ok = false;
  } else if (c == '{') {
    ++p;
    skip_ws();
    if (consume('}')) return;
    while (p < end) {
      std::string key;
      if (!parse_string(&key) || !consume(':')) { ok = false; return; }
      skip_value();
      if (consume('}')) return;
      if (!consume(',')) { ok = false; return; }
    }
    ok = false;
  } else if (c == '[') {
    ++p;
    skip_ws();
    if (consume(']')) return;
    while (p < end) {
      skip_value();
      if (consume(']')) return;
      if (!consume(',')) { ok = false; return; }
    }
    ok = false;
  } else if (std::strncmp(p, "true", 4) == 0 && p + 4 <= end) {
    p += 4;
  } else if (std::strncmp(p, "false", 5) == 0 && p + 5 <= end) {
    p += 5;
  } else if (std::strncmp(p, "null", 4) == 0 && p + 4 <= end) {
    p += 4;
  } else {
    double d;
    if (!parse_number(&d)) ok = false;
  }
}

bool Parser::parse_landmark(Landmark* lm) {
  skip_ws();
  if (!consume('{')) return false;
  if (consume('}')) return true;
  while (p < end) {
    std::string key;
    if (!parse_string(&key) || !consume(':')) return false;
    skip_ws();
    // booleans must NOT count as numbers (python-side isinstance(bool)
    // exclusion, smpltpu/io/keypoints.py _coord)
    bool is_bool = (std::strncmp(p, "true", 4) == 0 ||
                    std::strncmp(p, "false", 5) == 0);
    bool is_number = !is_bool &&
        (*p == '-' || *p == '+' || std::isdigit(static_cast<unsigned char>(*p)));
    if (is_number) {
      double v;
      if (!parse_number(&v)) return false;
      if (key == "x") { lm->x = v; lm->has_x = true; }
      else if (key == "y") { lm->y = v; lm->has_y = true; }
      else if (key == "visibility") { lm->vis = v; lm->has_vis = true; }
    } else {
      skip_value();
      if (!ok) return false;
    }
    if (consume('}')) return true;
    if (!consume(',')) return false;
  }
  return false;
}

// MP->SMPL constants (smpltpu/constants.py, reference include/Utils.h:18-23)
const int kMpMap[24] = {-1, 23, 24, -1, 25, 26, -1, 27, 28, -1,
                        31, 32, -1, -1, -1, 0,  11, 12, 13, 14,
                        15, 16, -1, -1};
const int kUseSmpl[17] = {1, 2, 4, 5, 7, 8, 10, 11, 15, 16, 17, 18, 19,
                          20, 21, 0, 0};
const double kVisThresh = 0.5;

struct Mid {
  bool ok = false;
  double x = 0.0, y = 0.0, vis = 0.0;
};

Mid midpoint(const std::vector<Landmark>& lms, size_t a, size_t b,
             double default_vis) {
  Mid m;
  if (a >= lms.size() || b >= lms.size()) return m;
  const Landmark& la = lms[a];
  const Landmark& lb = lms[b];
  if (!(la.has_x && la.has_y && lb.has_x && lb.has_y)) return m;
  m.ok = true;
  m.x = 0.5 * (la.x + lb.x);
  m.y = 0.5 * (la.y + lb.y);
  double va = la.has_vis ? la.vis : default_vis;
  double vb = lb.has_vis ? lb.vis : default_vis;
  m.vis = va < vb ? va : vb;
  return m;
}

int parse_buffer(const char* data, long len, int width, int height,
                 double midpoint_default_vis, double* out /* 17*4 */) {
  // initialize all slots invalid with their jids
  for (int s = 0; s < 17; ++s) {
    out[4 * s + 0] = kUseSmpl[s];
    out[4 * s + 1] = 0.0;
    out[4 * s + 2] = 0.0;
    out[4 * s + 3] = 0.0;
  }
  Parser ps{data, data + len};
  if (!ps.consume('[')) return 0;  // not a list -> no detection
  std::vector<Landmark> lms;
  ps.skip_ws();
  if (!ps.consume(']')) {
    while (ps.p < ps.end) {
      Landmark lm;
      if (!ps.parse_landmark(&lm)) return 0;  // corrupt -> no detection
      lms.push_back(lm);
      if (ps.consume(']')) break;
      if (!ps.consume(',')) return 0;
    }
  }

  Mid pelvis = midpoint(lms, 23, 24, midpoint_default_vis);
  Mid chest = midpoint(lms, 11, 12, midpoint_default_vis);
  (void)chest;  // computed for parity; jid 6 never emitted (Utils.h quirk)

  int n_valid = 0;
  for (int s = 0; s < 17; ++s) {
    int sid = kUseSmpl[s];
    bool ok = false;
    double x = 0.0, y = 0.0, vis = 0.0;
    if (sid == 0) {
      ok = pelvis.ok; x = pelvis.x; y = pelvis.y; vis = pelvis.vis;
    } else if (sid == 6) {
      ok = chest.ok; x = chest.x; y = chest.y; vis = chest.vis;
    } else {
      int mp = kMpMap[sid];
      if (mp >= 0 && static_cast<size_t>(mp) < lms.size()) {
        const Landmark& lm = lms[mp];
        ok = lm.has_x && lm.has_y;
        x = lm.x; y = lm.y;
        vis = lm.has_vis ? lm.vis : 1.0;
      }
    }
    if (!ok || vis < kVisThresh) continue;
    out[4 * s + 1] = x * width;
    out[4 * s + 2] = y * height;
    out[4 * s + 3] = 1.0;
    ++n_valid;
  }
  return n_valid;
}

bool read_file(const char* path, std::vector<char>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(static_cast<size_t>(n > 0 ? n : 0));
  size_t got = n > 0 ? std::fread(buf->data(), 1, buf->size(), f) : 0;
  std::fclose(f);
  buf->resize(got);
  return true;
}

}  // namespace

extern "C" {

// Parse one JSON buffer. Returns the number of valid slots (0..17).
int smpltpu_parse_mp_json(const char* data, long len, int width, int height,
                          double midpoint_default_vis, double* out) {
  return parse_buffer(data, len, width, height, midpoint_default_vis, out);
}

// Parse many files in parallel into (n_files, 17, 4). paths are
// '\n'-joined. Returns the number of files processed.
int smpltpu_parse_mp_json_files(const char* paths_joined, int n_files,
                                int width, int height,
                                double midpoint_default_vis, double* out) {
  std::vector<const char*> starts;
  std::vector<long> lens;
  const char* p = paths_joined;
  for (int i = 0; i < n_files; ++i) {
    const char* nl = std::strchr(p, '\n');
    long n = nl ? (nl - p) : static_cast<long>(std::strlen(p));
    starts.push_back(p);
    lens.push_back(n);
    if (!nl) { n_files = i + 1; break; }
    p = nl + 1;
  }
  std::atomic<int> next{0};
  int n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;
  auto worker = [&]() {
    std::vector<char> buf;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files) break;
      std::string path(starts[i], static_cast<size_t>(lens[i]));
      if (read_file(path.c_str(), &buf)) {
        parse_buffer(buf.data(), static_cast<long>(buf.size()), width,
                     height, midpoint_default_vis, out + 17 * 4 * i);
      } else {
        parse_buffer("", 0, width, height, midpoint_default_vis,
                     out + 17 * 4 * i);
      }
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return n_files;
}

// Fill painter-sorted triangles into a BGR uint8 image.
// tris: (m, 3, 2) double pixel coords; gray: (m,) int32 fill values.
void smpltpu_fill_triangles(unsigned char* img, int height, int width,
                            const double* tris, const int* gray, long m) {
  for (long t = 0; t < m; ++t) {
    const double* tri = tris + 6 * t;
    double min_x = tri[0], max_x = tri[0], min_y = tri[1], max_y = tri[1];
    for (int v = 1; v < 3; ++v) {
      min_x = std::fmin(min_x, tri[2 * v]);
      max_x = std::fmax(max_x, tri[2 * v]);
      min_y = std::fmin(min_y, tri[2 * v + 1]);
      max_y = std::fmax(max_y, tri[2 * v + 1]);
    }
    int x0 = std::max(static_cast<int>(std::floor(min_x)), 0);
    int x1 = std::min(static_cast<int>(std::ceil(max_x)) + 1, width);
    int y0 = std::max(static_cast<int>(std::floor(min_y)), 0);
    int y1 = std::min(static_cast<int>(std::ceil(max_y)) + 1, height);
    if (x0 >= x1 || y0 >= y1) continue;
    unsigned char c = static_cast<unsigned char>(
        gray[t] < 0 ? 0 : (gray[t] > 255 ? 255 : gray[t]));
    // edge functions; inside = consistent sign (matches the numpy fallback)
    double ax[3], ay[3], ex[3], ey[3];
    for (int v = 0; v < 3; ++v) {
      ax[v] = tri[2 * v];
      ay[v] = tri[2 * v + 1];
      ex[v] = tri[2 * ((v + 1) % 3)] - ax[v];
      ey[v] = tri[2 * ((v + 1) % 3) + 1] - ay[v];
    }
    for (int y = y0; y < y1; ++y) {
      double py = y + 0.5;
      unsigned char* row = img + (static_cast<long>(y) * width) * 3;
      for (int x = x0; x < x1; ++x) {
        double px = x + 0.5;
        bool sign = false, first = true, inside = true;
        for (int v = 0; v < 3; ++v) {
          double e = ex[v] * (py - ay[v]) - ey[v] * (px - ax[v]);
          bool s = e >= 0.0;
          if (first) { sign = s; first = false; }
          else if (s != sign && std::fabs(e) >= 1e-12) { inside = false; break; }
        }
        if (inside) {
          unsigned char* px8 = row + 3 * x;
          px8[0] = c; px8[1] = c; px8[2] = c;
        }
      }
    }
  }
}

}  // extern "C"
