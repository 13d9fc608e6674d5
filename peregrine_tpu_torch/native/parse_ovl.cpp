// preads.ovl text parser (13 columns, src/shmr_dedup.c:93-99).
//
// The Python per-line split/convert loop dominated the layout stage wall
// at scale (parsing, not graph algorithms — the reference acknowledges
// the same by running its layout under pypy).  Phase semantics mirror
// graph/string_graph.generate_string_graph's first loop exactly:
// self-pairs skipped; contains/contained rows update the contained set
// regardless of identity/length filters; 'none' rows skipped; overlap
// rows kept iff identity >= min_idt and both lengths >= min_len; a line
// starting with '-' terminates input.  Equality with the Python loop is
// asserted in tests/test_graph.py.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Cursor {
  const char *p, *end;
  bool eof() const { return p >= end; }
};

inline void skip_ws(Cursor &c) {
  while (!c.eof() && (*c.p == ' ' || *c.p == '\t')) c.p++;
}

inline int64_t read_int(Cursor &c) {
  skip_ws(c);
  bool neg = false;
  if (!c.eof() && *c.p == '-') { neg = true; c.p++; }
  int64_t v = 0;
  while (!c.eof() && *c.p >= '0' && *c.p <= '9') v = v * 10 + (*c.p++ - '0');
  return neg ? -v : v;
}

inline double read_float(Cursor &c) {
  skip_ws(c);
  bool neg = false;
  if (!c.eof() && *c.p == '-') { neg = true; c.p++; }
  double v = 0;
  while (!c.eof() && *c.p >= '0' && *c.p <= '9') v = v * 10 + (*c.p++ - '0');
  if (!c.eof() && *c.p == '.') {
    c.p++;
    double f = 0.1;
    while (!c.eof() && *c.p >= '0' && *c.p <= '9') {
      v += (*c.p++ - '0') * f;
      f *= 0.1;
    }
  }
  return neg ? -v : v;
}

}  // namespace

extern "C" {

#pragma pack(push, 1)
// parsed with graph/string_graph.OVL_ROW_DTYPE (44 bytes)
struct OvlRow {
  int32_t f_id, g_id, score;
  float idt;
  int32_t f_b, f_e, f_l;
  int32_t g_s, g_b, g_e, g_l;
};
#pragma pack(pop)

void parse_ovl_c(const char *buf, int64_t len, int32_t min_len,
                 double min_idt, OvlRow **rows, int64_t *n_rows,
                 int32_t **contained, int64_t *n_contained) {
  std::vector<OvlRow> out;
  std::vector<int32_t> cont;
  Cursor c{buf, buf + len};
  while (!c.eof()) {
    skip_ws(c);
    if (c.eof()) break;
    if (*c.p == '-') break;  // terminator line
    if (*c.p == '\n') { c.p++; continue; }
    OvlRow r;
    r.f_id = (int32_t)read_int(c);
    r.g_id = (int32_t)read_int(c);
    r.score = (int32_t)read_int(c);
    // compare identity in double BEFORE narrowing to f32: the Python
    // reference compares float64, and e.g. f32(96.1) < 96.1
    const double idt = read_float(c);
    r.idt = (float)idt;
    read_int(c);  // f_strand: always 0 in this format
    r.f_b = (int32_t)read_int(c);
    r.f_e = (int32_t)read_int(c);
    r.f_l = (int32_t)read_int(c);
    r.g_s = (int32_t)read_int(c);
    r.g_b = (int32_t)read_int(c);
    r.g_e = (int32_t)read_int(c);
    r.g_l = (int32_t)read_int(c);
    skip_ws(c);
    const char *t = c.p;
    while (!c.eof() && *c.p != '\n' && *c.p != ' ' && *c.p != '\t') c.p++;
    const int64_t tlen = c.p - t;
    while (!c.eof() && *c.p != '\n') c.p++;
    if (!c.eof()) c.p++;  // consume newline

    if (r.f_id == r.g_id) continue;
    if (tlen == 9 && !std::memcmp(t, "contained", 9)) {
      cont.push_back(r.f_id);
      continue;
    }
    if (tlen == 8 && !std::memcmp(t, "contains", 8)) {
      cont.push_back(r.g_id);
      continue;
    }
    if (tlen == 4 && !std::memcmp(t, "none", 4)) continue;
    if (idt < min_idt) continue;
    if (r.f_l < min_len || r.g_l < min_len) continue;
    out.push_back(r);
  }
  *n_rows = (int64_t)out.size();
  *rows = (OvlRow *)std::malloc(out.size() * sizeof(OvlRow));
  std::memcpy(*rows, out.data(), out.size() * sizeof(OvlRow));
  *n_contained = (int64_t)cont.size();
  *contained = (int32_t *)std::malloc(cont.size() * sizeof(int32_t));
  std::memcpy(*contained, cont.data(), cont.size() * sizeof(int32_t));
}

void free_ovl_rows_c(OvlRow **r, int32_t **c) {
  std::free(*r);
  std::free(*c);
  *r = nullptr;
  *c = nullptr;
}

}  // extern "C"
