// Native FASTA scanner / encoder for the host-side data pipeline.
//
// The reference (sukui-genomics-cn/hmm_layer) ships no data loading at all
// (SURVEY.md §5); genome-scale production use puts the host parse+encode on
// the critical path of the `predict`/`align` CLI workflows.  The Python
// pipeline (hmm_layer_tpu/data.py) is NumPy-vectorized per *line*, but FASTA
// records interleave sequence bytes with newlines/headers, which NumPy cannot
// skip without a Python-level loop over lines.  These three functions do the
// byte-level work in C++ at memcpy speed; Python (ctypes) keeps ownership of
// all memory — every pointer passed in is a caller-allocated NumPy buffer.
//
// Contract mirrors data.read_fasta exactly (see tests/test_native.py parity
// suite): records start at '>', the name is the first whitespace-delimited
// token after '>', sequence bytes are everything on subsequent lines with
// ASCII whitespace removed, and content before the first '>' is ignored.
//
// Build: g++ -O3 -shared -fPIC (driven lazily by hmm_layer_tpu/native).

#include <cstdint>
#include <cstring>

namespace {

inline bool is_ws(uint8_t c) {
  // ASCII whitespace, the set Python's str.strip() removes from these files:
  // space, \t, \n, \v, \f, \r.
  return c == ' ' || (c >= '\t' && c <= '\r');
}

}  // namespace

extern "C" {

// Scan a FASTA image for record boundaries.
//
// Two-call pattern: with max_records == 0 only the record count is returned;
// the second call fills the five caller-allocated int64 arrays (each of
// length >= count):
//   name_start/name_end  -- byte span of the record name (first token after
//                           '>'; empty span for a bare '>')
//   seq_start/seq_end    -- byte span of the raw sequence region (from the
//                           end of the header line to the next '>'/EOF)
//   seq_len              -- number of sequence bytes after whitespace removal
int64_t hmm_fasta_scan(const uint8_t* buf, int64_t n, int64_t* name_start,
                       int64_t* name_end, int64_t* seq_start, int64_t* seq_end,
                       int64_t* seq_len, int64_t max_records) {
  int64_t count = 0;
  int64_t i = 0;
  // Ignore any content before the first header.
  while (i < n && buf[i] != '>') ++i;
  while (i < n) {
    // buf[i] == '>'
    ++i;
    int64_t ns = i;
    while (ns < n && (buf[ns] == ' ' || buf[ns] == '\t')) ++ns;
    int64_t ne = ns;
    while (ne < n && !is_ws(buf[ne])) ++ne;
    // Rest of the header line is a description; skip to end of line.
    int64_t j = ne;
    while (j < n && buf[j] != '\n') ++j;
    if (j < n) ++j;  // past the newline
    int64_t ss = j;
    while (j < n && buf[j] != '>') ++j;
    if (count < max_records) {
      name_start[count] = ns;
      name_end[count] = ne;
      seq_start[count] = ss;
      seq_end[count] = j;
      int64_t len = 0;
      for (int64_t k = ss; k < j; ++k) len += !is_ws(buf[k]);
      seq_len[count] = len;
    }
    ++count;
    i = j;
  }
  return count;
}

// Copy the sequence bytes of one region, whitespace removed, each byte mapped
// through a 256-entry LUT (identity LUT -> cleaned raw bytes; base->code LUT
// -> dense class indices).  Returns the number of bytes written; `out` must
// hold at least the seq_len reported by hmm_fasta_scan.
int64_t hmm_fasta_extract(const uint8_t* buf, int64_t start, int64_t end,
                          const uint8_t* lut256, uint8_t* out) {
  int64_t w = 0;
  for (int64_t i = start; i < end; ++i) {
    uint8_t c = buf[i];
    if (!is_ws(c)) out[w++] = lut256[c];
  }
  return w;
}

// Fused parse + encode: for each non-whitespace sequence byte, copy the
// byte's c-float row of `lut` (shape (256, c), row-major) into `out`
// (shape (seq_len, c)).  This is the zero-intermediate path from file image
// to the model's one-hot input channels (data.encode_dna / encode_protein
// row tables).  Returns the number of rows written.
int64_t hmm_fasta_extract_onehot(const uint8_t* buf, int64_t start,
                                 int64_t end, const float* lut, int64_t c,
                                 float* out) {
  int64_t w = 0;
  for (int64_t i = start; i < end; ++i) {
    uint8_t ch = buf[i];
    if (!is_ws(ch)) {
      std::memcpy(out + w * c, lut + int64_t(ch) * c, size_t(c) * sizeof(float));
      ++w;
    }
  }
  return w;
}

}  // extern "C"
