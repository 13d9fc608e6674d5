// Banded greedy O(ND) difference alignment (Myers 1986), two variants:
//
//  * ovlp_match_c  — overlap confirmation on 4-bit dual-strand packed
//    sequences, no traceback.  Observable behavior mirrors the reference
//    aligner (reference: src/DWmatch.c:66-204): per-d furthest-reaching
//    diagonals V[k], band pruning by U[k] = x+y against best_m - tolerance,
//    alignment start = first exact run > 16 bases, longest-run endpoint
//    tracking, m_size = (qspan + tspan + 2d)/2.
//
//  * dw_align_c    — ASCII variant recording the full diagonal trace for
//    backtracking into explicit gapped alignment strings (semantics:
//    reference falcon/DW_banded.c:104-315).  Unlike the reference's
//    flat-array + qsort + bsearch scheme, the trace is stored as per-d
//    rows indexed by (k - row_min_k)/2, making backtrack O(d).
//
// Built as a plain-C-ABI shared object consumed through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

typedef int32_t coor;

struct OvlpMatch {
  coor m_size, dist;
  coor q_bgn, q_end;
  coor t_bgn, t_end;
  coor t_m_end, q_m_end;
};

void ovlp_match_c(const uint8_t *q, coor q_len, uint8_t q_strand,
                  const uint8_t *t, coor t_len, uint8_t t_strand,
                  coor band_tolerance, OvlpMatch *out) {
  const int q_shift = q_strand ? 4 : 0;
  const int t_shift = t_strand ? 4 : 0;
  const coor max_d = (coor)(0.3 * (q_len + t_len));
  const coor band_size = band_tolerance * 2;

  std::vector<coor> V((size_t)max_d * 2 + 1, 0);
  std::vector<coor> U((size_t)max_d * 2 + 1, 0);
  const coor k_off = max_d;

  std::memset(out, 0, sizeof(*out));
  bool start = false, matched = false;
  coor longest = 0, best_m = -1, min_k = 0, max_k = 0;
  coor x = 0, y = 0;

  for (coor d = 0; d < max_d; d++) {
    if (max_k - min_k > band_size) break;

    for (coor k = min_k; k <= max_k; k += 2) {
      if (k == min_k || (k != max_k && V[k - 1 + k_off] < V[k + 1 + k_off])) {
        x = V[k + 1 + k_off];
      } else {
        x = V[k - 1 + k_off] + 1;
      }
      y = x - k;
      const coor x1 = x, y1 = y;

      // Snake extension, 8 bases per step: shifting the whole u64 right by
      // the strand nibble-shift keeps each byte's selected nibble in place
      // under the 0x0F mask (bit 8i+4..8i+7 -> 8i..8i+3, no cross-byte
      // contamination).  On a mismatch, advance to the first differing
      // byte and fall through — the scalar loop re-tests it and exits.
      // Bounds: both loads stay fully inside the sequences (x+8<=q_len),
      // so no read ever crosses the end of the caller's buffer (db_data
      // is a file-backed mmap; an overrun would fault).
      while (x + 8 <= q_len && y + 8 <= t_len) {
        uint64_t qw, tw;
        std::memcpy(&qw, q + x, 8);
        std::memcpy(&tw, t + y, 8);
        const uint64_t diff =
            ((qw >> q_shift) ^ (tw >> t_shift)) & 0x0F0F0F0F0F0F0F0FULL;
        if (diff) {
          const coor adv = (coor)(__builtin_ctzll(diff) >> 3);
          x += adv;
          y += adv;
          break;
        }
        x += 8;
        y += 8;
      }
      while (x < q_len && y < t_len &&
             ((q[x] >> q_shift) & 0x0F) == ((t[y] >> t_shift) & 0x0F)) {
        x++;
        y++;
      }
      if (x - x1 > 16 && !start) {
        out->q_bgn = x1;
        out->t_bgn = y1;
        start = true;
      }
      if (x - x1 > longest) {
        longest = x - x1;
        out->q_m_end = x;
        out->t_m_end = y;
      }
      V[k + k_off] = x;
      U[k + k_off] = x + y;
      if (x + y > best_m) best_m = x + y;
      if (x >= q_len || y >= t_len) {
        matched = true;
        break;
      }
    }

    coor new_min_k = max_k, new_max_k = min_k;
    for (coor k2 = min_k; k2 <= max_k; k2 += 2) {
      if (U[k2 + k_off] >= best_m - band_tolerance) {
        if (k2 < new_min_k) new_min_k = k2;
        if (k2 > new_max_k) new_max_k = k2;
      }
    }
    max_k = new_max_k + 1;
    min_k = new_min_k - 1;

    if (matched) {
      out->q_end = x;
      out->t_end = y;
      out->dist = d;
      out->m_size = (out->q_end - out->q_bgn + out->t_end - out->t_bgn + 2 * d) / 2;
      break;
    }
  }
  if (!matched) {
    out->q_bgn = 0;
    out->t_bgn = 0;
  }
}

// ---------------------------------------------------------------------------

struct Alignment {
  coor aln_str_size, dist;
  coor aln_q_s, aln_q_e;
  coor aln_t_s, aln_t_e;
  char *q_aln_str;  // malloc'd, caller frees via free_alignment_c
  char *t_aln_str;
};

struct TraceCell {
  coor x2, y2;   // snake end
  coor pre_k;
};

void dw_align_c(const char *q, coor q_len, const char *t, coor t_len,
                coor band_tolerance, int get_aln_str, Alignment *out) {
  const coor max_d = (coor)(0.3 * (q_len + t_len));
  const coor band_size = band_tolerance * 2;

  std::vector<coor> V((size_t)max_d * 2 + 1, 0);
  std::vector<coor> U((size_t)max_d * 2 + 1, 0);
  const coor k_off = max_d;

  std::vector<std::vector<TraceCell>> rows;
  std::vector<coor> row_min_k;

  std::memset(out, 0, sizeof(*out));
  out->q_aln_str = (char *)std::calloc((size_t)q_len + t_len + 1, 1);
  out->t_aln_str = (char *)std::calloc((size_t)q_len + t_len + 1, 1);

  bool aligned = false;
  coor best_m = -1, min_k = 0, max_k = 0;
  coor x = 0, y = 0, final_k = 0, final_d = 0;

  for (coor d = 0; d < max_d; d++) {
    if (max_k - min_k > band_size) break;

    rows.emplace_back();
    row_min_k.push_back(min_k);
    rows.back().reserve((size_t)(max_k - min_k) / 2 + 1);

    for (coor k = min_k; k <= max_k; k += 2) {
      coor pre_k;
      if (k == min_k || (k != max_k && V[k - 1 + k_off] < V[k + 1 + k_off])) {
        pre_k = k + 1;
        x = V[k + 1 + k_off];
      } else {
        pre_k = k - 1;
        x = V[k - 1 + k_off] + 1;
      }
      y = x - k;

      // 8-chars-at-a-time snake (see ovlp_match_c; plain byte compare —
      // this variant aligns ASCII buffers)
      while (x + 8 <= q_len && y + 8 <= t_len) {
        uint64_t qw, tw;
        std::memcpy(&qw, q + x, 8);
        std::memcpy(&tw, t + y, 8);
        const uint64_t diff = qw ^ tw;
        if (diff) {
          const coor adv = (coor)(__builtin_ctzll(diff) >> 3);
          x += adv;
          y += adv;
          break;
        }
        x += 8;
        y += 8;
      }
      while (x < q_len && y < t_len && q[x] == t[y]) {
        x++;
        y++;
      }
      rows.back().push_back({x, y, pre_k});

      V[k + k_off] = x;
      U[k + k_off] = x + y;
      if (x + y > best_m) best_m = x + y;
      if (x >= q_len || y >= t_len) {
        aligned = true;
        final_k = k;
        final_d = d;
        break;
      }
    }

    coor new_min_k = max_k, new_max_k = min_k;
    for (coor k2 = min_k; k2 <= max_k; k2 += 2) {
      if (U[k2 + k_off] >= best_m - band_tolerance) {
        if (k2 < new_min_k) new_min_k = k2;
        if (k2 > new_max_k) new_max_k = k2;
      }
    }
    max_k = new_max_k + 1;
    min_k = new_min_k - 1;

    if (aligned) {
      out->aln_q_e = x;
      out->aln_t_e = y;
      out->dist = d;
      out->aln_str_size = (x + y + d) / 2;
      out->aln_q_s = 0;
      out->aln_t_s = 0;

      if (get_aln_str > 0) {
        // Walk the (d, k) chain back to d = 0; each cell contributes its
        // snake end (x2, y2) and snake start (x1, y1).  The start is
        // reconstructed from the predecessor cell's stored end:
        // x1 = pre.x2 when we came from diagonal k+1, pre.x2 + 1 from k-1.
        std::vector<coor> fx, fy;  // alternating end/start, newest first
        coor cd = final_d, ck = final_k;
        while (cd >= 0) {
          const std::vector<TraceCell> &row = rows[cd];
          size_t ci = (size_t)((ck - row_min_k[cd]) / 2);
          if (ci >= row.size()) ci = row.size() - 1;  // safety clamp
          const TraceCell &cell = row[ci];
          coor x1;
          if (cd == 0) {
            x1 = 0;
          } else {
            const std::vector<TraceCell> &prow = rows[cd - 1];
            size_t pi = (size_t)((cell.pre_k - row_min_k[cd - 1]) / 2);
            if (pi >= prow.size()) pi = prow.size() - 1;  // safety clamp
            x1 = (cell.pre_k == ck + 1) ? prow[pi].x2 : prow[pi].x2 + 1;
          }
          coor y1 = x1 - ck;
          fx.push_back(cell.x2);
          fy.push_back(cell.y2);
          fx.push_back(x1);
          fy.push_back(y1);
          ck = cell.pre_k;
          cd -= 1;
        }
        // oldest point = alignment start
        size_t i = fx.size() - 1;
        coor cx = fx[i], cy = fy[i];
        out->aln_q_s = cx;
        out->aln_t_s = cy;
        coor pos = 0;
        while (i > 0) {
          i--;
          const coor nx = fx[i], ny = fy[i];
          if (cx == nx && cy == ny) continue;
          if (nx == cx && ny != cy) {  // gap in query
            for (coor j = 0; j < ny - cy; j++) {
              out->q_aln_str[pos + j] = '-';
              out->t_aln_str[pos + j] = t[cy + j];
            }
            pos += ny - cy;
          } else if (nx != cx && ny == cy) {  // gap in target
            for (coor j = 0; j < nx - cx; j++) {
              out->q_aln_str[pos + j] = q[cx + j];
              out->t_aln_str[pos + j] = '-';
            }
            pos += nx - cx;
          } else {  // snake: equal-length advance
            for (coor j = 0; j < nx - cx; j++) out->q_aln_str[pos + j] = q[cx + j];
            for (coor j = 0; j < ny - cy; j++) out->t_aln_str[pos + j] = t[cy + j];
            pos += ny - cy;
          }
          cx = nx;
          cy = ny;
        }
        out->aln_str_size = pos;
      }
      break;
    }
  }
}

void free_alignment_c(Alignment *a) {
  std::free(a->q_aln_str);
  std::free(a->t_aln_str);
  a->q_aln_str = nullptr;
  a->t_aln_str = nullptr;
}

}  // extern "C"
