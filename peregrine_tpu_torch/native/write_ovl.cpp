// Direct preads.ovl emission (shmr_dedup text schema,
// src/shmr_dedup.c:93-99).  ovlps_to_text's final formatting loop
// materialized 7.7M Python f-strings and _write_lines wrote them one at
// a time (~30-44 s at 250 Mb scale); this streams the rows straight to
// the file from the already-vectorized column arrays.  Byte-identical
// to the Python formatting (asserted in tests/test_overlap.py): glibc
// printf and CPython both emit the correctly-rounded decimal of the
// same double for %0.1f.

#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// columns in ovlps_to_text order; returns rows written or -1 on error.
// Writes the trailing "-\n" terminator row when write_term != 0.
int64_t write_ovl_c(const int64_t *rid0, const int64_t *rid1,
                    const int64_t *neg_m, const double *err,
                    const int64_t *a_bgn, const int64_t *a_end,
                    const int64_t *rlen0, const int64_t *strand,
                    const int64_t *b_bgn, const int64_t *b_end,
                    const int64_t *rlen1, const uint8_t *type,
                    int64_t n, int32_t write_term, const char *path) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  static const char *kNames[3] = {"overlap", "contains", "contained"};
  char *buf = new char[1 << 22];
  setvbuf(f, buf, _IOFBF, 1 << 22);
  int64_t i = 0;
  for (; i < n; i++) {
    if (fprintf(f, "%09lld %09lld %lld %0.1f 0 %lld %lld %lld %lld %lld "
                   "%lld %lld %s\n",
                (long long)rid0[i], (long long)rid1[i], (long long)neg_m[i],
                err[i], (long long)a_bgn[i], (long long)a_end[i],
                (long long)rlen0[i], (long long)strand[i],
                (long long)b_bgn[i], (long long)b_end[i],
                (long long)rlen1[i], kNames[type[i] > 2 ? 0 : type[i]]) < 0) {
      i = -1;
      break;
    }
  }
  if (i >= 0 && write_term && fputs("-\n", f) == EOF) i = -1;
  if (fclose(f) != 0) i = -1;
  delete[] buf;
  return i;
}

}  // extern "C"
