// Native FASTA/FASTQ scanner and N-join: the host-side data-loader hot path.
//
// Gives the records of kmers_tpu/io/native/fastx.cpp's scanner, byte for
// byte, and rejects the inputs it rejects (where that scanner writes past
// its offsets, on FASTQ of more records than four-line groups, this one
// returns every record).  Lines are found with memchr and sequence lines
// copied with memcpy, so no loop tests each byte, and one pass over a
// buffer both writes its records and, when streaming, finds where its
// complete records end.  Built by g++ at first use into
// kmers_tpu_torch/_build/ (kmers_tpu_torch/io/native/__init__.py).
//
// C ABI (loaded with ctypes from kmers_tpu_torch.io.native):
//   fastx_scan(buf, len, cut_rule, seq_out, offsets_out, n_records_out,
//              seq_len_out, cut_out)
//     - buf: raw file bytes; FASTA ('>' records) or FASTQ ('@' records,
//       '+' separator, quality skipped) by its first byte
//     - cut_rule: FASTX_WHOLE parses all of buf.  FASTX_CUT_FASTA and
//       FASTX_CUT_FASTQ parse only the complete records of a streamed batch
//       and store their end in *cut_out: before the last '>' that starts a
//       line past byte 0, or after the last newline whose count is a
//       multiple of four (0 when there is none: nothing is parsed)
//     - seq_out (caller-allocated, len bytes): the sequences concatenated,
//       without newlines, CR bytes or header lines
//     - *offsets_out: record start offsets into seq_out (CSR layout), and
//       the total length last; malloc'd here, released by fastx_free
//     returns 0, FASTX_MALFORMED, or FASTX_NO_MEMORY
//   fastx_join_n(seq, seq_len, offsets, n_records, out)
//     - out (caller-allocated, seq_len + n_records - 1 bytes): the records
//       in order with one 'N' between records; bytes no record fills are 'N'
//     returns 0, or FASTX_MALFORMED when the offsets are not CSR
//   merge_count_tables(...): below

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int FASTX_MALFORMED = -1;
constexpr int FASTX_NO_MEMORY = -2;
constexpr int FASTX_WHOLE = 0;
constexpr int FASTX_CUT_FASTA = 1;
constexpr int FASTX_CUT_FASTQ = 2;

// The end of the line that starts at i: its '\n', or len.
inline int64_t line_end(const uint8_t* buf, int64_t i, int64_t len) {
  const void* p = memchr(buf + i, '\n', len - i);
  return p ? static_cast<const uint8_t*>(p) - buf : len;
}

// Records being written: the sequence bytes and the growing offsets.
struct Records {
  uint8_t* seq;
  int64_t* off = nullptr;
  int64_t n = 0, cap = 0, w = 0;

  bool start() {
    if (n == cap) {
      const int64_t grown = cap ? 2 * cap : 1024;
      void* p = realloc(off, grown * sizeof(int64_t));
      if (!p) return false;
      off = static_cast<int64_t*>(p);
      cap = grown;
    }
    off[n++] = w;
    return true;
  }

  // Appends buf[i, end) without its '\r' bytes.
  void copy(const uint8_t* buf, int64_t i, int64_t end) {
    while (i < end) {
      const void* p = memchr(buf + i, '\r', end - i);
      const int64_t stop = p ? static_cast<const uint8_t*>(p) - buf : end;
      memcpy(seq + w, buf + i, stop - i);
      w += stop - i;
      i = stop + 1;
    }
  }

  // Closes the offsets with the total length.
  int finish() {
    if (!start()) return FASTX_NO_MEMORY;
    --n;
    return 0;
  }
};

// Newlines passed in order.  The reference reads a FASTQ buffer as groups
// of four lines and rejects it when a group does not start with '@', so
// the byte after every fourth newline is a group's start: `after4` is the
// last (a streamed FASTQ batch's cut) and `misplaced` the first that holds
// no '@' (len when there is none).
struct Newlines {
  const uint8_t* buf;
  int64_t len, misplaced;
  int64_t n = 0, after4 = 0;
  Newlines(const uint8_t* b, int64_t l) : buf(b), len(l), misplaced(l) {}
  void pass(int64_t at) {
    if (++n % 4) return;
    after4 = at + 1;
    if (after4 < len && buf[after4] != '@' && misplaced == len) misplaced = after4;
  }
  void pass_all(int64_t i) {
    for (int64_t e = line_end(buf, i, len); e < len; e = line_end(buf, e + 1, len)) pass(e);
  }
};

// A line starting with '>' opens a record and is skipped; every other line
// is sequence.
int scan_fasta(const uint8_t* buf, int64_t len, Records& r) {
  for (int64_t i = 0; i < len;) {
    const int64_t e = line_end(buf, i, len);
    if (buf[i] == '>') {
      if (!r.start()) return FASTX_NO_MEMORY;
    } else {
      r.copy(buf, i, e);
    }
    i = e + 1;
  }
  return 0;
}

// Where a streamed FASTQ batch can end on a record: the state at the last
// record that starts right after a fourth newline.
struct Snapshot {
  int64_t at = -1, n = 0, w = 0;
};

constexpr int64_t FASTQ_END = -1;

// The FASTQ walk of the reference scanner: a header; sequence lines up to a
// line that starts with '+'; that line; then as many quality characters (CR
// not counted) as the sequence has, across lines; then any blank lines.
// Every newline is passed to `nl` in order.  Returns FASTQ_END at the end of
// buf, FASTX_NO_MEMORY, or the position of a record that does not start
// with '@'.
int64_t scan_fastq(const uint8_t* buf, int64_t len, Records& r, Newlines& nl, Snapshot& snap) {
  // past the line at `at` and its newline
  auto skip_line = [&](int64_t at) {
    const int64_t e = line_end(buf, at, len);
    if (e < len) nl.pass(e);
    return e + 1;
  };
  for (int64_t i = 0;;) {
    if (i == nl.after4) snap = {i, r.n, r.w};
    if (i >= len) return FASTQ_END;
    if (buf[i] != '@') return i;
    i = skip_line(i);
    if (!r.start()) return FASTX_NO_MEMORY;
    const int64_t first = r.w;
    while (i < len && buf[i] != '+') {
      const int64_t e = line_end(buf, i, len);
      r.copy(buf, i, e);
      if (e < len) nl.pass(e);
      i = e + 1;
    }
    const int64_t seq_chars = r.w - first;
    if (i < len) i = skip_line(i);
    int64_t q = 0;
    while (i < len && q < seq_chars) {
      const int64_t e = line_end(buf, i, len);
      while (i < e && q < seq_chars) {  // the line's runs between CR bytes
        const void* p = memchr(buf + i, '\r', e - i);
        const int64_t stop = p ? static_cast<const uint8_t*>(p) - buf : e;
        const int64_t take = stop - i < seq_chars - q ? stop - i : seq_chars - q;
        q += take;
        i += take;
        if (q < seq_chars && i < e) ++i;  // past the CR at `stop`
      }
      if (q < seq_chars && i < len) nl.pass(i++);  // a newline inside the quality
    }
    while (i < len && buf[i] == '\n') nl.pass(i++);
  }
}

// All of buf[0, len): its records, or why there are none.
int scan_whole(const uint8_t* buf, int64_t len, Records& r) {
  r.n = r.w = 0;
  int rc = 0;
  if (len > 0 && buf[0] == '>') {
    rc = scan_fasta(buf, len, r);
  } else if (len > 0 && buf[0] == '@') {
    Newlines nl(buf, len);
    Snapshot snap;
    const int64_t end = scan_fastq(buf, len, r, nl, snap);
    rc = end == FASTX_NO_MEMORY ? FASTX_NO_MEMORY
         : end != FASTQ_END || nl.misplaced < len ? FASTX_MALFORMED : 0;
  } else if (len > 0) {
    rc = FASTX_MALFORMED;
  }
  return rc ? rc : r.finish();
}

// A streamed FASTQ batch: one walk parses every record and passes every
// newline.  The batch's records are then those before the cut, which the
// walk saw start a record when the cut falls between records; otherwise
// (input that is not four lines a record) buf[0, cut) is parsed again.
int scan_fastq_batch(const uint8_t* buf, int64_t len, Records& r, int64_t* cut) {
  Newlines nl(buf, len);
  Snapshot snap;
  int64_t bad = 0;
  if (buf[0] == '@') {
    bad = scan_fastq(buf, len, r, nl, snap);
    if (bad == FASTX_NO_MEMORY) return FASTX_NO_MEMORY;
  }
  if (bad != FASTQ_END) nl.pass_all(bad);
  *cut = nl.after4;
  if (*cut == 0) return scan_whole(buf, 0, r);
  if (snap.at != *cut) return scan_whole(buf, *cut, r);
  if ((bad != FASTQ_END && bad < *cut) || nl.misplaced < *cut) return FASTX_MALFORMED;
  r.n = snap.n;
  r.w = snap.w;
  return r.finish();
}

// The start of the last line past byte 0 that starts with '>', or 0.
int64_t fasta_cut(const uint8_t* buf, int64_t len) {
  for (int64_t end = len; end > 1;) {
    const void* p = memrchr(buf + 1, '>', end - 1);
    if (!p) break;
    end = static_cast<const uint8_t*>(p) - buf;
    if (buf[end - 1] == '\n') return end;
  }
  return 0;
}

}  // namespace

extern "C" {

int fastx_scan(const uint8_t* buf, int64_t len, int cut_rule, uint8_t* seq_out,
               int64_t** offsets_out, int64_t* n_records_out, int64_t* seq_len_out,
               int64_t* cut_out) {
  Records r{seq_out};
  int rc;
  if (cut_rule == FASTX_CUT_FASTQ && len > 0) {
    rc = scan_fastq_batch(buf, len, r, cut_out);
  } else {
    *cut_out = cut_rule == FASTX_CUT_FASTA ? fasta_cut(buf, len) : len;
    rc = scan_whole(buf, *cut_out, r);
  }
  *offsets_out = r.off;
  *n_records_out = r.n;
  *seq_len_out = r.w;
  return rc;
}

void fastx_free(int64_t* offsets) { free(offsets); }

int fastx_join_n(const uint8_t* seq, int64_t seq_len, const int64_t* offsets,
                 int64_t n_records, uint8_t* out) {
  const int64_t out_len = seq_len + n_records - 1;
  int64_t pos = 0;
  for (int64_t i = 0; i < n_records; ++i) {
    const int64_t a = offsets[i], b = offsets[i + 1];
    if (a < 0 || b < a || b > seq_len) return FASTX_MALFORMED;
    memcpy(out + pos, seq + a, b - a);
    pos += b - a;
    if (i + 1 < n_records) out[pos++] = 'N';
  }
  memset(out + pos, 'N', out_len - pos);
  return 0;
}

// Two-pointer merge of sorted (kmer, count) tables — the host-side
// reduction for multi-epoch / multi-partition checkpoint merging, where
// numpy's unique+scatter would allocate several table-sized temporaries.
// Inputs must be sorted by kmer; duplicate kmers across inputs sum.
// Returns the merged length (<= n1 + n2).
int64_t merge_count_tables(const uint64_t* k1, const int64_t* c1, int64_t n1,
                           const uint64_t* k2, const int64_t* c2, int64_t n2,
                           uint64_t* k_out, int64_t* c_out) {
  int64_t i = 0, j = 0, w = 0;
  while (i < n1 && j < n2) {
    if (k1[i] < k2[j]) {
      k_out[w] = k1[i];
      c_out[w++] = c1[i++];
    } else if (k2[j] < k1[i]) {
      k_out[w] = k2[j];
      c_out[w++] = c2[j++];
    } else {
      k_out[w] = k1[i];
      c_out[w++] = c1[i++] + c2[j++];
    }
  }
  while (i < n1) {
    k_out[w] = k1[i];
    c_out[w++] = c1[i++];
  }
  while (j < n2) {
    k_out[w] = k2[j];
    c_out[w++] = c2[j++];
  }
  return w;
}

}  // extern "C"
