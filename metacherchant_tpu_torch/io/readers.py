"""Read ingestion: FASTA/FASTQ/BINQ with gz/bz2, quality autodetect, N-splitting.

Behavior mirrors the reference ingestion stack:
- format autodetection by extension incl. .gz/.bz2 (itmo:io/ReadersUtils.java:27-54)
- FASTQ quality autodetect: try Illumina (Phred+64, chars 64..126); any char
  outside that range in the first 1000 reads -> Sanger (Phred+33)
  (itmo:io/ReadersUtils.java:57-77, itmo:io/formats/Illumina.java:7-19)
- FASTQ/BINQ reads are split at phred-0 positions (N bases are stored with
  phred 0), each fragment emitted as a separate read
  (itmo:io/readers/FastaReaderFromXQSourceTrunc.java:55-95, itmo:dna/DnaQ.java:21-30)
- FASTA reads are NOT split (reference routes fasta to the plain FastaReader even
  in the "Trunc" path, itmo:io/ReadersUtils.java:104-121); IUPAC ambiguity codes
  are resolved RANDOMLY by the reference (itmo:dna/DnaTools.java:66-118) -- we
  instead resolve deterministically to the first alternative and document the
  divergence (goldens are ACGT-only).

Carried over from metacherchant_tpu/io/readers.py (the paired-read sources
of the classifier tools are not part of the port yet).
"""
from __future__ import annotations

import bz2
import gzip
import os
import struct
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..dna import CHAR_TO_CODE

# IUPAC ambiguity -> deterministic first alternative (reference picks randomly,
# itmo:dna/DnaTools.java:66-118; deterministic here for reproducibility).
_IUPAC_FIRST = {
    "R": "A", "Y": "C", "S": "G", "W": "A", "K": "G", "M": "A",
    "B": "C", "D": "A", "H": "A", "V": "A", "N": "A", ".": "A",
}
_IUPAC_TRANS = str.maketrans({**_IUPAC_FIRST, **{k.lower(): v for k, v in _IUPAC_FIRST.items()}})


class SequenceError(ValueError):
    pass


def open_maybe_compressed(path: str | os.PathLike, mode: str = "rt"):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, mode)
    if p.endswith(".bz2"):
        return bz2.open(p, mode)
    return open(p, mode)


def detect_file_format(path: str) -> str:
    """Extension-based format detection (itmo:io/ReadersUtils.java:27-54)."""
    name = os.path.basename(str(path)).lower()
    suffix = ""
    for comp in (".gz", ".bz2"):
        if name.endswith(comp):
            suffix = comp
            name = name[: -len(comp)]
            break
    if name.endswith(".binq"):
        return "binq" + suffix
    if name.endswith((".fastq", ".fq")):
        return "fastq" + suffix
    if name.endswith((".fasta", ".fa", ".fn", ".fna")):
        return "fasta" + suffix
    raise IOError(f"Can't detect file format for file '{name}'")


@dataclass
class DnaQ:
    """A read with per-base phred scores; nucleotides as 2-bit codes.

    Mirrors itmo:dna/DnaQ.java: N stored as (nuc=0, phred=0).
    """
    codes: np.ndarray  # int8, 0..3
    phred: np.ndarray  # int16

    def __len__(self) -> int:
        return len(self.codes)

    @staticmethod
    def from_string(seq: str, phred: int = 0) -> "DnaQ":
        codes = CHAR_TO_CODE[np.frombuffer(seq.encode("ascii"), np.uint8)].copy()
        ph = np.full(len(seq), phred, np.int16)
        n_mask = codes < 0
        codes[n_mask] = 0
        ph[n_mask] = 0
        return DnaQ(codes, ph)


def _fragments_from_dnaq(codes: np.ndarray, phred: np.ndarray) -> list[np.ndarray]:
    """Split a DnaQ at phred<1 positions, dropping the separator base
    (itmo:io/readers/FastaReaderFromXQSourceTrunc.java:55-95 semantics)."""
    bad = np.flatnonzero(phred < 1)
    if bad.size == 0:
        return [codes]
    out = []
    start = 0
    for b in bad:
        if b > start:
            out.append(codes[start:b])
        start = b + 1
    if start < len(codes):
        out.append(codes[start:])
    return out


def _iter_fasta_records(fh) -> Iterator[tuple[str, str]]:
    name = None
    chunks: list[str] = []
    for line in fh:
        line = line.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield name, "".join(chunks)
            name = line[1:]
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def _iter_fastq_records(fh) -> Iterator[tuple[str, str, str]]:
    while True:
        header = fh.readline()
        if not header:
            return
        header = header.strip()
        if not header:
            continue
        seq = fh.readline().strip()
        fh.readline()  # +
        qual = fh.readline().strip()
        yield header[1:] if header.startswith("@") else header, seq, qual


def determine_quality_format(path: str, head: int = 1000) -> str:
    """'illumina' (Phred+64) unless a quality char < 64 appears in the first
    `head` reads -> 'sanger' (itmo:io/ReadersUtils.java:57-77)."""
    with open_maybe_compressed(path) as fh:
        for i, (_, _, qual) in enumerate(_iter_fastq_records(fh)):
            if i >= head:
                break
            q = np.frombuffer(qual.encode("ascii"), np.uint8)
            if q.size and (q.min() < 64 or q.max() > 126):
                return "sanger"
    return "illumina"


BINQ_MAGIC = b"BINQ"


def iter_dnaq(path: str, fmt: str | None = None, quality: str | None = None) -> Iterator[DnaQ]:
    """Yield DnaQ records from a FASTQ/BINQ/FASTA file."""
    fmt = fmt or detect_file_format(path)
    base = fmt.split(".")[0]
    if base == "fastq":
        offset = None
        if quality in ("sanger", "illumina"):
            offset = 33 if quality == "sanger" else 64
        if offset is None:
            offset = 33 if determine_quality_format(path) == "sanger" else 64
        with open_maybe_compressed(path) as fh:
            for _, seq, qual in _iter_fastq_records(fh):
                codes = CHAR_TO_CODE[np.frombuffer(seq.encode("ascii"), np.uint8)].copy()
                ph = (np.frombuffer(qual.encode("ascii"), np.uint8).astype(np.int16) - offset)
                if len(ph) < len(codes):
                    ph = np.pad(ph, (0, len(codes) - len(ph)))
                n_mask = codes < 0
                codes[n_mask] = 0
                ph = ph.copy()
                ph[n_mask] = 0
                yield DnaQ(codes, ph[: len(codes)])
    elif base == "binq":
        with open_maybe_compressed(path, "rb") as fh:
            yield from _iter_binq(fh)
    elif base == "fasta":
        # FASTA -> DnaQ with default phred 20 (itmo:io/ReadersUtils.java:176,201-209)
        with open_maybe_compressed(path) as fh:
            for _, seq in _iter_fasta_records(fh):
                yield DnaQ.from_string(seq.translate(_IUPAC_TRANS), phred=20)
    else:
        raise IOError(f"Illegal format {fmt}, file {path}")


def _iter_binq(fh) -> Iterator[DnaQ]:
    """BINQ: sequence of records, each int32 length + length bytes of
    (phred<<2 | nuc) (itmo:io/readers/BinqReader.java; itmo:dna/DnaQ.java:140-150)."""
    while True:
        raw = fh.read(4)
        if len(raw) < 4:
            return
        (n,) = struct.unpack(">i", raw)
        data = np.frombuffer(fh.read(n), np.uint8)
        yield DnaQ((data & 3).astype(np.int8), (data >> 2).astype(np.int16))


def iter_reads_split(path: str, fmt: str | None = None, quality: str | None = None) -> Iterator[np.ndarray]:
    """Yield 2-bit code arrays, with FASTQ/BINQ reads split at phred-0 positions.

    This defines exactly which k-mers get counted
    (src/io/IOUtils.java:200-214 + itmo Trunc reader).
    FASTA records pass through unsplit (see module docstring).
    """
    fmt = fmt or detect_file_format(path)
    base = fmt.split(".")[0]
    native_frags = _try_native(path, fmt, quality)
    if native_frags is not None:
        codes, offs = native_frags
        for i in range(offs.size - 1):
            yield codes[offs[i]:offs[i + 1]]
        return
    if base == "fasta":
        with open_maybe_compressed(path) as fh:
            for _, seq in _iter_fasta_records(fh):
                codes = CHAR_TO_CODE[np.frombuffer(
                    seq.translate(_IUPAC_TRANS).encode("ascii"), np.uint8)]
                if codes.size and codes.min() < 0:
                    raise SequenceError(f"Invalid nucleotide in {path}")
                yield codes.astype(np.int8)
    else:
        for dnaq in iter_dnaq(path, fmt, quality):
            yield from _fragments_from_dnaq(dnaq.codes, dnaq.phred)


def _try_native(path: str, fmt: str, quality: str | None):
    """Native (C++) parse when available; None -> use the Python readers."""
    from .. import native
    if not (native.supports(fmt) and native.available()):
        return None
    base = fmt.split(".")[0]
    qoffset = 33
    if base == "fastq":
        if quality in ("sanger", "illumina"):
            qoffset = 33 if quality == "sanger" else 64
        else:
            qoffset = 33 if determine_quality_format(path) == "sanger" else 64
    try:
        return native.parse_fragments(path, fmt, qoffset)
    except native.NativeIOError as e:
        if "Invalid nucleotide" in str(e):
            raise SequenceError(str(e)) from None
        return None


@dataclass
class FastaRecord:
    comment: str
    seq: str


def read_rich_fasta(path: str) -> list[FastaRecord]:
    """FASTA reader that keeps per-record comments, used to name per-gene output
    dirs (src/io/RichFastaReader.java:38-76). Accepts '>' and ';' comment lines;
    consecutive comment lines concatenate."""
    records: list[FastaRecord] = []
    cur_comment: list[str] = []
    cur_seq: list[str] = []
    last_comment = True
    comments: list[str] = []
    dnas: list[str] = []
    with open_maybe_compressed(path) as fh:
        for line in fh:
            line = line.rstrip("\n").rstrip("\r")
            if line.startswith(">") or line.startswith(";"):
                if not last_comment:
                    dnas.append("".join(cur_seq))
                    cur_seq = []
                    cur_comment = []
                cur_comment.append(line[1:])
                last_comment = True
            else:
                if last_comment:
                    comments.append("".join(cur_comment))
                    cur_seq = []
                    cur_comment = []
                cur_seq.append(line)
                last_comment = False
    if cur_comment:
        comments.append("".join(cur_comment))
    if cur_seq and "".join(cur_seq):
        dnas.append("".join(cur_seq))
    for c, d in zip(comments, dnas):
        records.append(FastaRecord(c, d))
    return records
