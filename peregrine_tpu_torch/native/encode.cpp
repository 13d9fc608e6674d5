// 4-bit dual-strand sequence encoding (the reference's encode_biseq,
// src/shmr_utils.c:44-51): low nibble = one-hot forward base at p, high
// nibble = complement one-hot of the base at the mirrored position
// len-1-p.  One pass; the numpy path (io/seqdb.encode_biseq) does two
// 256-entry gathers plus a reversed copy plus a per-read temporary, and
// SeqDB.from_reads then concatenates all temporaries — at 4.2 GB of
// reads that is several extra full-size copies on an erratic-memory
// host.  Semantics equality is tested in tests/test_seqdb.py.

#include <cstdint>
#include <cstdio>

extern "C" {

// out must hold n bytes; encodes one read.
void encode_biseq_c(const uint8_t *seq, int64_t n, uint8_t *out) {
  static uint8_t f4[256], r4[256];
  static bool init = false;
  if (!init) {
    for (int i = 0; i < 256; i++) f4[i] = r4[i] = 0;
    const char bases[4] = {'A', 'C', 'G', 'T'};
    const uint8_t fw[4] = {1, 2, 4, 8};
    const uint8_t rv[4] = {8, 4, 2, 1};
    for (int i = 0; i < 4; i++) {
      f4[(uint8_t)bases[i]] = f4[(uint8_t)(bases[i] + 32)] = fw[i];
      r4[(uint8_t)bases[i]] = r4[(uint8_t)(bases[i] + 32)] = rv[i];
    }
    init = true;
  }
  for (int64_t i = 0; i < n; i++)
    out[i] = (uint8_t)((r4[seq[n - 1 - i]] << 4) | f4[seq[i]]);
}

// Space-separated integer rows -> file (the mapping stage's
// reads2ref-format checkpoint, reference src/shmr_map.c:153 printf).
// np.savetxt formats each cell through Python (~8 s for the 3M-row
// Drosophila mapping table); this is one buffered pass.
int64_t write_rows_c(const int64_t *rows, int64_t n, int64_t m,
                     const char *path) {
  FILE *f = fopen(path, "wb");
  if (!f) return -1;
  char buf[32 * 16];
  for (int64_t i = 0; i < n; i++) {
    char *p = buf;
    for (int64_t j = 0; j < m; j++) {
      if (j) *p++ = ' ';
      p += snprintf(p, 24, "%lld", (long long)rows[i * m + j]);
    }
    *p++ = '\n';
    fwrite(buf, 1, (size_t)(p - buf), f);
  }
  fclose(f);
  return n;
}

}  // extern "C"
