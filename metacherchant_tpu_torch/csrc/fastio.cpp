// Native read ingestion: FASTA/FASTQ (+.gz via zlib) -> 2-bit fragments.
//
// The host-side analogue of the reference's reader stack
// (itmo:io/ReadersUtils.java, itmo:io/readers/FastaReaderFromXQSourceTrunc.java):
// parses a whole file and emits concatenated nucleotide codes plus fragment
// offsets, with FASTQ reads split at phred<1 positions exactly like the
// Python readers (metacherchant_tpu/io/readers.py::_fragments_from_dnaq).
// Loaded via ctypes (plain C ABI); the Python fallback remains authoritative
// for BINQ/bz2 and is the oracle in tests.
//
// Fragment semantics replicated bit-for-bit:
// - FASTA: one fragment per record, never split; IUPAC ambiguity codes map to
//   their deterministic first alternative (same table as io/readers.py);
//   other characters -> error.
// - FASTQ: separator positions are bases where code < 0 (N and friends) OR
//   qual - qoffset < 1 (missing qual chars count as phred 0). A read with no
//   separators emits one fragment even when empty; a read with separators
//   emits only its non-empty segments.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// A=0, G=1, C=2, T=3 (itmo:dna/DnaTools.java:31); IUPAC -> first alternative;
// -1 = N-like separator; -2 = invalid.
void build_tables(int8_t* fasta_tab, int8_t* fastq_tab) {
  for (int i = 0; i < 256; ++i) fasta_tab[i] = -2;
  auto set = [&](char c, int8_t v) {
    fasta_tab[(unsigned char)c] = v;
    fasta_tab[(unsigned char)tolower(c)] = v;
  };
  set('A', 0); set('G', 1); set('C', 2); set('T', 3);
  // deterministic IUPAC resolution (io/readers.py::_IUPAC_FIRST)
  set('R', 0); set('Y', 2); set('S', 1); set('W', 0); set('K', 1);
  set('M', 0); set('B', 2); set('D', 0); set('H', 0); set('V', 0);
  set('N', 0);
  fasta_tab[(unsigned char)'.'] = 0;
  // FASTQ path uses the raw CHAR_TO_CODE table: ACGT codes, N/n/. -> -1
  for (int i = 0; i < 256; ++i) fastq_tab[i] = -2;
  auto setq = [&](char c, int8_t v) {
    fastq_tab[(unsigned char)c] = v;
    fastq_tab[(unsigned char)tolower(c)] = v;
  };
  setq('A', 0); setq('G', 1); setq('C', 2); setq('T', 3);
  fastq_tab[(unsigned char)'N'] = -1;
  fastq_tab[(unsigned char)'n'] = -1;
  fastq_tab[(unsigned char)'.'] = -1;
}

struct Out {
  std::vector<int8_t> codes;
  std::vector<int64_t> offsets;  // fragment start offsets + final end
};

bool read_all(const char* path, std::string* buf, std::string* err) {
  gzFile f = gzopen(path, "rb");
  if (!f) {
    *err = std::string("cannot open ") + path;
    return false;
  }
  char chunk[1 << 20];
  int n;
  while ((n = gzread(f, chunk, sizeof(chunk))) > 0) buf->append(chunk, n);
  bool ok = n == 0;
  if (!ok) *err = std::string("read error in ") + path;
  gzclose(f);
  return ok;
}

struct LineIter {
  const char* p;
  const char* end;
  // returns [b, e) trimmed of surrounding whitespace (the Python oracles
  // strip() every line, so trailing spaces/tabs must not become N bases);
  // false at EOF
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

// malloc-or-error helper: ADVICE r4 flagged the unchecked malloc returns
void* xmalloc(size_t n, char* errbuf, int errlen) {
  void* p = malloc(n ? n : 1);
  if (!p) snprintf(errbuf, errlen, "out of memory (%zu bytes)", n);
  return p;
}

}  // namespace

extern "C" {

// format: 0 = fasta, 1 = fastq. qoffset: phred base (33/64), fastq only.
// On success returns 0 and sets *codes/*offsets (malloc'd; caller frees with
// fastio_free), *n_frags (#fragments), *total (#codes).
int fastio_parse(const char* path, int format, int qoffset, int8_t** codes_out,
                 int64_t** offsets_out, int64_t* n_frags, int64_t* total,
                 char* errbuf, int errlen) {
  static int8_t fasta_tab[256], fastq_tab[256];
  static bool init = (build_tables(fasta_tab, fastq_tab), true);
  (void)init;

  std::string buf, err;
  if (!read_all(path, &buf, &err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return 1;
  }
  Out out;
  out.offsets.push_back(0);
  LineIter it{buf.data(), buf.data() + buf.size()};
  const char *b, *e;

  if (format == 0) {
    bool in_record = false;
    auto close_record = [&]() {
      if (in_record) out.offsets.push_back((int64_t)out.codes.size());
    };
    while (it.next(&b, &e)) {
      if (b == e) continue;
      if (*b == '>') {
        close_record();
        in_record = true;
        continue;
      }
      if (!in_record) continue;  // leading junk
      for (const char* c = b; c < e; ++c) {
        int8_t v = fasta_tab[(unsigned char)*c];
        if (v < 0) {
          snprintf(errbuf, errlen, "Invalid nucleotide '%c' in %s", *c, path);
          return 2;
        }
        out.codes.push_back(v);
      }
    }
    close_record();
  } else {
    while (true) {
      // header
      if (!it.next(&b, &e)) break;
      if (b == e) continue;
      const char *sb, *se, *pb, *pe, *qb, *qe;
      if (!it.next(&sb, &se)) break;
      if (!it.next(&pb, &pe)) break;  // '+'
      if (!it.next(&qb, &qe)) qb = qe = se;  // missing qual -> phred 0 pad
      int64_t len = se - sb;
      int64_t qlen = qe - qb;
      int64_t frag_start = (int64_t)out.codes.size();
      bool any_sep = false;
      for (int64_t i = 0; i < len; ++i) {
        int8_t v = fastq_tab[(unsigned char)sb[i]];
        int phred = i < qlen ? (unsigned char)qb[i] - qoffset : 0;
        bool sep = v < 0 || phred < 1;
        if (sep) {
          any_sep = true;
          if ((int64_t)out.codes.size() > frag_start)
            out.offsets.push_back((int64_t)out.codes.size());
          frag_start = (int64_t)out.codes.size();
        } else {
          out.codes.push_back(v);
        }
      }
      if ((int64_t)out.codes.size() > frag_start) {
        out.offsets.push_back((int64_t)out.codes.size());
      } else if (!any_sep) {
        out.offsets.push_back((int64_t)out.codes.size());  // empty, unsplit
      }
    }
  }

  *n_frags = (int64_t)out.offsets.size() - 1;
  *total = (int64_t)out.codes.size();
  *codes_out = (int8_t*)xmalloc(out.codes.size(), errbuf, errlen);
  if (!*codes_out) return 3;
  memcpy(*codes_out, out.codes.data(), out.codes.size());
  *offsets_out =
      (int64_t*)xmalloc(out.offsets.size() * sizeof(int64_t), errbuf, errlen);
  if (!*offsets_out) { free(*codes_out); return 3; }
  memcpy(*offsets_out, out.offsets.data(),
         out.offsets.size() * sizeof(int64_t));
  return 0;
}

// Whole-read FASTQ parse for the classifier family: NO N-splitting.
// Mirrors io/readers.py::iter_dnaq exactly: codes = table[ch] with any
// non-ACGT (IUPAC or junk) treated as N; phred = qual - qoffset, padded
// with 0 when the qual line is shorter, truncated to the seq length;
// N positions get (code 0, phred 0). One (codes,int8 / phred,int16) pair
// per read, offsets delimit reads (empty reads allowed).
int fastio_parse_reads(const char* path, int qoffset, int8_t** codes_out,
                       int16_t** phred_out, int64_t** offsets_out,
                       int64_t* n_reads, int64_t* total, char* errbuf,
                       int errlen) {
  static int8_t fasta_tab[256], fastq_tab[256];
  static bool init = (build_tables(fasta_tab, fastq_tab), true);
  (void)init;

  std::string buf, err;
  if (!read_all(path, &buf, &err)) {
    snprintf(errbuf, errlen, "%s", err.c_str());
    return 1;
  }
  std::vector<int8_t> codes;
  std::vector<int16_t> phred;
  std::vector<int64_t> offsets;
  offsets.push_back(0);
  codes.reserve(buf.size() / 2);
  phred.reserve(buf.size() / 2);
  LineIter it{buf.data(), buf.data() + buf.size()};
  const char *b, *e;
  while (true) {
    if (!it.next(&b, &e)) break;  // header
    if (b == e) continue;
    const char *sb, *se, *pb, *pe, *qb, *qe;
    if (!it.next(&sb, &se)) break;
    if (!it.next(&pb, &pe)) break;  // '+'
    if (!it.next(&qb, &qe)) qb = qe = sb;  // missing qual -> phred pad 0
    int64_t len = se - sb;
    int64_t qlen = qe - qb;
    for (int64_t i = 0; i < len; ++i) {
      int8_t v = fastq_tab[(unsigned char)sb[i]];
      int16_t ph = i < qlen ? (int16_t)((unsigned char)qb[i] - qoffset)
                            : (int16_t)0;
      if (v < 0) { v = 0; ph = 0; }  // N / IUPAC / junk -> N semantics
      codes.push_back(v);
      phred.push_back(ph);
    }
    offsets.push_back((int64_t)codes.size());
  }

  *n_reads = (int64_t)offsets.size() - 1;
  *total = (int64_t)codes.size();
  *codes_out = (int8_t*)xmalloc(codes.size(), errbuf, errlen);
  if (!*codes_out) return 3;
  memcpy(*codes_out, codes.data(), codes.size());
  *phred_out =
      (int16_t*)xmalloc(phred.size() * sizeof(int16_t), errbuf, errlen);
  if (!*phred_out) { free(*codes_out); return 3; }
  memcpy(*phred_out, phred.data(), phred.size() * sizeof(int16_t));
  *offsets_out =
      (int64_t*)xmalloc(offsets.size() * sizeof(int64_t), errbuf, errlen);
  if (!*offsets_out) { free(*codes_out); free(*phred_out); return 3; }
  memcpy(*offsets_out, offsets.data(), offsets.size() * sizeof(int64_t));
  return 0;
}

void fastio_free(void* p) { free(p); }

}  // extern "C"
