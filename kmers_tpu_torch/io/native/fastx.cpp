// Native FASTA/FASTQ scanner: the host-side data-loader hot path.
//
// The port's own copy of kmers_tpu/io/native/fastx.cpp, with the same C ABI
// and the same results.  Python-level line parsing holds the streamed
// counting pipeline well below the card's ingest rate, so record scanning
// and newline stripping run here.  Built by g++ at first use into
// kmers_tpu_torch/_build/ (kmers_tpu_torch/io/native/__init__.py).
//
// Exposed via a tiny C ABI (loaded with ctypes from kmers_tpu_torch.io.native):
//   fastx_scan(buf, len, seq_out, offsets_out, n_records_out)
//     - buf: raw file bytes
//     - seq_out (caller-allocated, len bytes): concatenated sequence bytes,
//       newlines/CR and header lines removed
//     - offsets_out (caller-allocated, capacity n_records+1): record start
//       offsets into seq_out (CSR layout); offsets_out[n] = total length
//   returns 0 on success, -1 on malformed input.
//
// FASTA ('>' records) and FASTQ ('@' records, '+' separator, quality lines
// skipped) are auto-detected from the first byte.

#include <cstdint>
#include <cstring>

extern "C" {

// Count records ('>' or '@' at start) so callers can size offsets_out.
int64_t fastx_count_records(const uint8_t* buf, int64_t len) {
  if (len == 0) return 0;
  const char rec = (buf[0] == '@') ? '@' : '>';
  if (buf[0] != '>' && buf[0] != '@') return -1;
  int64_t n = 0;
  bool at_line_start = true;
  if (rec == '>') {
    for (int64_t i = 0; i < len; ++i) {
      if (at_line_start && buf[i] == rec) ++n;
      at_line_start = (buf[i] == '\n');
    }
  } else {
    // FASTQ: records are groups of 4 lines; count '@' headers at even
    // record boundaries by walking the structure.
    int64_t i = 0;
    while (i < len) {
      if (buf[i] != '@') return -1;
      ++n;
      for (int line = 0; line < 4 && i < len; ++line) {
        while (i < len && buf[i] != '\n') ++i;
        ++i;  // skip newline
      }
    }
  }
  return n;
}

int fastx_scan(const uint8_t* buf, int64_t len, uint8_t* seq_out,
               int64_t* offsets_out, int64_t* n_records_out,
               int64_t* seq_len_out) {
  if (len == 0) {
    *n_records_out = 0;
    *seq_len_out = 0;
    offsets_out[0] = 0;
    return 0;
  }
  int64_t nrec = 0;
  int64_t w = 0;
  if (buf[0] == '>') {
    bool in_header = false;
    bool at_line_start = true;
    for (int64_t i = 0; i < len; ++i) {
      const uint8_t c = buf[i];
      if (at_line_start) {
        in_header = (c == '>');
        if (in_header) offsets_out[nrec++] = w;
      }
      at_line_start = (c == '\n');
      if (!in_header && c != '\n' && c != '\r') seq_out[w++] = c;
    }
  } else if (buf[0] == '@') {
    int64_t i = 0;
    while (i < len) {
      if (buf[i] != '@') return -1;
      while (i < len && buf[i] != '\n') ++i;  // header
      ++i;
      offsets_out[nrec++] = w;
      while (i < len && buf[i] != '+') {  // sequence lines until '+'
        while (i < len && buf[i] != '\n') {
          if (buf[i] != '\r') seq_out[w++] = buf[i];
          ++i;
        }
        ++i;
      }
      const int64_t seq_chars = w - offsets_out[nrec - 1];
      while (i < len && buf[i] != '\n') ++i;  // '+' line
      ++i;
      // quality: same number of non-newline chars as the sequence
      int64_t q = 0;
      while (i < len && q < seq_chars) {
        if (buf[i] != '\n' && buf[i] != '\r') ++q;
        ++i;
      }
      while (i < len && buf[i] == '\n') ++i;  // trailing newline(s)
    }
  } else {
    return -1;
  }
  offsets_out[nrec] = w;
  *n_records_out = nrec;
  *seq_len_out = w;
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
