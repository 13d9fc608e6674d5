// Host packing of the 4-bit dual-strand seqdb into the device planes
// (2-bit forward codes, 4 bases/byte + 1-bit ambiguity flags, 8/byte) —
// one pass over the byte array.  The numpy version (ops/dbgather.pack_db_np)
// allocated several full-size temporaries per step, costing ~7 s for a
// 140 MB db on this host; this loop is memory-bound (~0.2 s).  Semantics
// equality is tested in tests/test_dbgather.py.

#include <cstdint>
#include <cstring>

extern "C" {

// fw must hold (guard + n + 3) / 4 bytes, amb (guard + n + 7) / 8 bytes,
// both zero-initialized by the caller; guard_bases % 8 == 0.
void pack_db_c(const uint8_t *data, int64_t n, int64_t guard_bases,
               uint8_t *fw, uint8_t *amb) {
  static const uint8_t code_tbl[16] = {0, 0, 1, 0, 2, 0, 0, 0,
                                       3, 0, 0, 0, 0, 0, 0, 0};
  static const uint8_t amb_tbl[16] = {1, 0, 0, 1, 0, 1, 1, 1,
                                      0, 1, 1, 1, 1, 1, 1, 1};
  for (int64_t i = 0; i < n; i++) {
    const uint8_t nib = data[i] & 0x0F;
    const int64_t p = guard_bases + i;
    fw[p >> 2] |= (uint8_t)(code_tbl[nib] << ((p & 3) << 1));
    amb[p >> 3] |= (uint8_t)(amb_tbl[nib] << (p & 7));
  }
}

}  // extern "C"
