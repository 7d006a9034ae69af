// The classifier's whole-read FASTQ parse, streamed: a batch of reads at a
// time from a window of whole lines of the file, never the whole file.
//
// The same records as fastio_parse_reads (csrc/fastio.cpp, which stays the
// JAX package's source byte for byte, so its line reader and base table are
// repeated here), which mirrors io/readers.py::iter_dnaq: codes =
// table[ch] with any non-ACGT (IUPAC or junk) treated as N; phred = qual -
// qoffset, padded with 0 when the qual line is shorter, truncated to the
// seq length; N positions get (code 0, phred 0). Offsets delimit reads
// (empty reads allowed). A blank line where a header belongs is skipped; a
// record cut short by the end of the file ends the parse (a missing qual
// line pads phred with 0). Plain and gzip files (zlib). Loaded via ctypes.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// A=0, G=1, C=2, T=3 (itmo:dna/DnaTools.java:31); N/n/. -> -1; else -2
struct FastqTable {
  int8_t code[256];
  FastqTable() {
    for (int i = 0; i < 256; ++i) code[i] = -2;
    const char* bases = "AGCT";
    for (int v = 0; v < 4; ++v) {
      code[(unsigned char)bases[v]] = (int8_t)v;
      code[(unsigned char)(bases[v] - 'A' + 'a')] = (int8_t)v;
    }
    code[(unsigned char)'N'] = code[(unsigned char)'n'] = -1;
    code[(unsigned char)'.'] = -1;
  }
};

const FastqTable kTable;

// [b, e) of the next line, trimmed of surrounding ' ', '\t', '\r' (the
// Python oracles strip() every line); false at the end
struct LineIter {
  const char* p;
  const char* end;
  bool next(const char** b, const char** e) {
    if (p >= end) return false;
    *b = p;
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* stop = nl ? nl : end;
    p = nl ? nl + 1 : end;
    while (stop > *b &&
           (stop[-1] == '\r' || stop[-1] == ' ' || stop[-1] == '\t')) --stop;
    const char* start = *b;
    while (start < stop &&
           (*start == ' ' || *start == '\t' || *start == '\r')) ++start;
    *b = start;
    *e = stop;
    return true;
  }
};

struct ReadStream {
  gzFile f;
  int qoffset;
  size_t chunk;            // bytes read from the file at a time
  std::string buf;         // the window: unparsed text from `pos` on
  size_t pos = 0;
  bool eof = false;
  std::vector<int8_t> codes;     // the last batch, valid until the next
  std::vector<int16_t> phred;
  std::vector<int64_t> offsets;
};

// true once buf[pos:] holds `lines` whole lines or the file's tail; reads
// on as needed. false on a read error.
bool fill_lines(ReadStream* s, int lines) {
  while (true) {
    const char* p = s->buf.data() + s->pos;
    const char* end = s->buf.data() + s->buf.size();
    int seen = 0;
    while (seen < lines && p < end) {
      const char* nl = (const char*)memchr(p, '\n', end - p);
      if (!nl) break;
      ++seen;
      p = nl + 1;
    }
    if (seen >= lines || s->eof) return true;
    s->buf.erase(0, s->pos);
    s->pos = 0;
    size_t old = s->buf.size();
    s->buf.resize(old + s->chunk);
    int n = gzread(s->f, &s->buf[old], (unsigned)s->chunk);
    if (n < 0) return false;
    s->buf.resize(old + n);
    if (n == 0) s->eof = true;
  }
}

}  // namespace

extern "C" {

void* fastio_reads_open(const char* path, int qoffset, int64_t chunk_bytes,
                        char* errbuf, int errlen) {
  gzFile f = gzopen(path, "rb");
  if (!f) {
    snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  ReadStream* s = new ReadStream;
  s->f = f;
  s->qoffset = qoffset;
  s->chunk = chunk_bytes > 0 ? (size_t)chunk_bytes : (size_t)1 << 20;
  return s;
}

// Parses up to max_reads records. On success returns 0 and points *codes,
// *phred, *offsets at the batch (owned by the stream, valid until the next
// call); *n_reads is 0 at the end of the file.
int fastio_reads_next(void* handle, int64_t max_reads, int8_t** codes_out,
                      int16_t** phred_out, int64_t** offsets_out,
                      int64_t* n_reads, int64_t* total, char* errbuf,
                      int errlen) {
  ReadStream* s = (ReadStream*)handle;
  s->codes.clear();
  s->phred.clear();
  s->offsets.assign(1, 0);
  int64_t n = 0;
  while (n < max_reads) {
    if (!fill_lines(s, 4)) {
      snprintf(errbuf, errlen, "read error");
      return 1;
    }
    LineIter it{s->buf.data() + s->pos, s->buf.data() + s->buf.size()};
    const char *b, *e;
    if (!it.next(&b, &e)) break;  // header
    if (b == e) {
      s->pos = it.p - s->buf.data();
      continue;
    }
    const char *sb, *se, *pb, *pe, *qb, *qe;
    if (!it.next(&sb, &se) || !it.next(&pb, &pe)) {  // seq, '+'
      s->pos = s->buf.size();
      break;
    }
    if (!it.next(&qb, &qe)) qb = qe = sb;  // missing qual -> phred pad 0
    int64_t len = se - sb;
    int64_t qlen = qe - qb;
    for (int64_t i = 0; i < len; ++i) {
      int8_t v = kTable.code[(unsigned char)sb[i]];
      int16_t ph = i < qlen ? (int16_t)((unsigned char)qb[i] - s->qoffset)
                            : (int16_t)0;
      if (v < 0) { v = 0; ph = 0; }  // N / IUPAC / junk -> N semantics
      s->codes.push_back(v);
      s->phred.push_back(ph);
    }
    s->offsets.push_back((int64_t)s->codes.size());
    s->pos = it.p - s->buf.data();
    ++n;
  }
  *n_reads = n;
  *total = (int64_t)s->codes.size();
  *codes_out = s->codes.data();
  *phred_out = s->phred.data();
  *offsets_out = s->offsets.data();
  return 0;
}

void fastio_reads_close(void* handle) {
  ReadStream* s = (ReadStream*)handle;
  gzclose(s->f);
  delete s;
}

}  // extern "C"
