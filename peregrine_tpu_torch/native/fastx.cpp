// Streaming FASTA/FASTQ parse + 4-bit encode (the stage-0 hot loop).
//
// io/seqdb.read_fastx (the Python oracle, kseq semantics per reference
// src/kseq.h:100-223) pushes the whole read text through Python
// readline/strip/join — ~90 MB/s, the stage-0 wall at scale (15 GB of
// reads at 500 Mb).  This parser streams the file (gz via zlib) through
// a 4 MB buffer, applies the same record rules, encodes each read with
// the dual-strand codec (encode.cpp), and appends the packed bytes to
// the output file.  Names and lengths return via malloc'd buffers so
// the caller writes the .idx rows.
//
// Replicated oracle semantics (byte-identity asserted in
// tests/test_seqdb.py):
//  * leading junk before the first '>'/'@' is skipped
//  * name = first whitespace-delimited token after the marker (may be
//    empty); the rest of the header line is dropped
//  * sequence lines accumulate stripped (ASCII <= ' ' trimmed at both
//    ends) until a line starts with '>', '@', or '+'
//  * '+' starts a FASTQ quality block consumed until the accumulated
//    stripped quality length reaches the sequence length (so quality
//    lines starting with '@'/'>' are never mistaken for headers)
//  * empty sequences still yield records

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

extern "C" void encode_biseq_c(const char *seq, int64_t n, void *out);

namespace {

class LineReader {
 public:
  explicit LineReader(const char *path) {
    // plain files read via fread — zlib's transparent mode moves every
    // byte through its own buffer layer (~2x slower on uncompressed
    // input); gz detection by magic, not extension
    FILE *probe = fopen(path, "rb");
    if (!probe) return;
    unsigned char magic[2] = {0, 0};
    size_t got = fread(magic, 1, 2, probe);
    if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
      fclose(probe);
      gz_ = gzopen(path, "rb");
      ok_ = gz_ != nullptr;
    } else {
      rewind(probe);
      plain_ = probe;
      ok_ = true;
    }
  }
  ~LineReader() {
    if (gz_) gzclose(gz_);
    if (plain_) fclose(plain_);
  }
  bool ok() const { return ok_; }

  // yields one line INCLUDING its newline as a view valid until the
  // next call: zero-copy when the line sits inside the buffer (the
  // common case — the line-string append was ~1/3 of the parse cost at
  // scale), spilling into the carry string across buffer refills.
  // false at EOF with nothing read.
  bool getline_view(const char **b, int64_t *n) {
    carry_.clear();
    while (true) {
      if (pos_ >= len_) {
        len_ = gz_ ? gzread(gz_, buf_, sizeof buf_)
                   : (int)fread(buf_, 1, sizeof buf_, plain_);
        pos_ = 0;
        if (len_ <= 0) {
          *b = carry_.data();
          *n = (int64_t)carry_.size();
          return !carry_.empty();
        }
      }
      char *nl = (char *)memchr(buf_ + pos_, '\n', len_ - pos_);
      if (nl) {
        if (carry_.empty()) {
          *b = buf_ + pos_;
          *n = nl - (buf_ + pos_) + 1;
        } else {
          carry_.append(buf_ + pos_, nl - (buf_ + pos_) + 1);
          *b = carry_.data();
          *n = (int64_t)carry_.size();
        }
        pos_ = (int)(nl - buf_) + 1;
        return true;
      }
      carry_.append(buf_ + pos_, len_ - pos_);
      pos_ = len_;
    }
  }

 private:
  gzFile gz_ = nullptr;
  FILE *plain_ = nullptr;
  bool ok_ = false;
  char buf_[1 << 22];
  int pos_ = 0, len_ = 0;
  std::string carry_;
};

// Python bytes.strip()/split() whitespace set: " \t\n\r\v\f" exactly
// (NOT all control chars)
inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' ||
         c == '\f';
}

inline void strip_range(const char *s, int64_t len, const char **b,
                        int64_t *n) {
  int64_t lo = 0, hi = len;
  while (lo < hi && is_ws(s[lo])) lo++;
  while (hi > lo && is_ws(s[hi - 1])) hi--;
  *b = s + lo;
  *n = hi - lo;
}

}  // namespace

extern "C" {

// Parse `in_path` (FASTA/FASTQ, optionally gzipped), encode every read,
// append the packed bytes to `out_path`.  Outputs: names (\n-separated,
// malloc'd), lengths (int64, malloc'd), count.  Returns total encoded
// bytes appended, or -1 on error.
int64_t fastx_encode_c(const char *in_path, const char *out_path,
                       char **names_o, int64_t *names_len_o,
                       int64_t **lens_o, int64_t *count_o) {
  LineReader rd(in_path);
  if (!rd.ok()) return -1;
  FILE *out = fopen(out_path, "ab");
  if (!out) return -1;
  char *obuf = new char[1 << 22];
  setvbuf(out, obuf, _IOFBF, 1 << 22);

  std::string seq;
  std::vector<char> names;
  std::vector<int64_t> lens;
  std::vector<uint8_t> enc;
  int64_t total = 0;
  bool err = false;

  const char *lb;
  int64_t ll;
  bool have = rd.getline_view(&lb, &ll);
  while (have && lb[0] != '>' && lb[0] != '@') have = rd.getline_view(&lb, &ll);
  while (have && !err) {
    // header: first whitespace token after the marker
    {
      int64_t i = 1;
      // skip leading whitespace inside the header (Python split())
      while (i < ll && is_ws(lb[i])) i++;
      int64_t j = i;
      while (j < ll && !is_ws(lb[j])) j++;
      names.insert(names.end(), lb + i, lb + j);
      names.push_back('\n');
    }
    seq.clear();
    have = rd.getline_view(&lb, &ll);
    while (have && lb[0] != '>' && lb[0] != '@' && lb[0] != '+') {
      const char *b;
      int64_t n;
      strip_range(lb, ll, &b, &n);
      if (n) seq.append(b, n);
      have = rd.getline_view(&lb, &ll);
    }
    if (have && lb[0] == '+') {  // FASTQ quality block
      int64_t qlen = 0;
      while (qlen < (int64_t)seq.size()) {
        if (!rd.getline_view(&lb, &ll)) {
          have = false;
          break;
        }
        const char *b;
        int64_t n;
        strip_range(lb, ll, &b, &n);
        qlen += n;
      }
      if (have) have = rd.getline_view(&lb, &ll);
    }
    const int64_t ln = (int64_t)seq.size();
    lens.push_back(ln);
    if (ln) {
      enc.resize(ln);
      encode_biseq_c(seq.data(), ln, enc.data());
      if ((int64_t)fwrite(enc.data(), 1, ln, out) != ln) err = true;
      total += ln;
    }
  }
  if (fclose(out) != 0) err = true;
  delete[] obuf;
  if (err) return -1;

  *names_len_o = (int64_t)names.size();
  *names_o = (char *)malloc(names.empty() ? 1 : names.size());
  memcpy(*names_o, names.data(), names.size());
  *count_o = (int64_t)lens.size();
  *lens_o = (int64_t *)malloc(lens.empty() ? 8 : lens.size() * 8);
  memcpy(*lens_o, lens.data(), lens.size() * 8);
  return total;
}

void free_fastx_c(char *names, int64_t *lens) {
  free(names);
  free(lens);
}

}  // extern "C"
