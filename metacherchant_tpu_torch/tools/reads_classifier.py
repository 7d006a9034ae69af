"""reads-classifier: classify paired reads against a weighted dBG.

Reimplements src/tools/ReadsClassifier.java: build the graph from one
metagenome's reads (or a *kmers.bin dump), classify paired reads of another
into found/not-found bins with the Poisson-interval breadth test, write the
six fastq outputs and the quality stats block. Carried over from
metacherchant_tpu/tools/reads_classifier.py; counting runs on the device of
device.py, and so does the coverage under MC_DEVICE_CLASSIFY.
"""
from __future__ import annotations

import os

import numpy as np

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..kmer_map import KmerMap
from ..counting import count_kmers
from ..io.writers import read_kmers_bin, FastqWriter
from ..algo.classify import (device_classify, find_reads, FoundStats,
                             iter_read_batch_pairs)

CLASSIFY_BATCH = 8192


def _mix_rows(b1, b2, rows: np.ndarray, use1: np.ndarray):
    """Select per-row from two ReadBatches: row i of the result is
    b1[rows[i]] where use1[i] else b2[rows[i]], padded to the wider batch.
    Returns (codes, phred, lengths) arrays for FastqWriter.write_batch."""
    w1 = b1.codes.shape[1]
    w2 = b2.codes.shape[1]
    w = max(w1, w2)
    ns = rows.size
    codes = np.zeros((ns, w), np.int32)
    phred = np.full((ns, w), 99, np.int16)
    lengths = np.where(use1, b1.lengths[rows], b2.lengths[rows])
    codes[use1, :w1] = b1.codes[rows[use1]]
    phred[use1, :w1] = b1.phred[rows[use1]]
    codes[~use1, :w2] = b2.codes[rows[~use1]]
    phred[~use1, :w2] = b2.phred[rows[~use1]]
    return codes, phred, lengths


def check_reads_files(files: list[str]) -> None:
    for f in files:
        if not os.path.exists(f):
            raise ExecutionFailedException(f"Could not load reads from {f}")


def load_classifier_graph(tool: Tool, input_files: list[str], k: int,
                          hash_name: str) -> tuple[KmerMap, str | None]:
    """loadGraph (src/tools/ReadsClassifier.java:95-114): *kmers.bin dump or
    raw reads; hashing regime only when k > 31 (no --forcehash here)."""
    hasher = None
    if k > 31:
        hasher = "fnv1a" if hash_name.lower() == "fnv1a" else "poly"
        tool.info("Using %s hash function",
                  "FNV1a" if hasher == "fnv1a" else "default polynomial")
    if input_files and input_files[0].lower().endswith("kmers.bin"):
        keys_all, counts_all = [], []
        for f in input_files:
            kk, cc = read_kmers_bin(f, threshold=0)
            keys_all.append(kk)
            counts_all.append(cc)
        kmap = KmerMap.from_pairs(np.concatenate(keys_all),
                                  np.concatenate(counts_all))
    else:
        for f in input_files:
            if not os.path.exists(f):
                raise ExecutionFailedException(f"Could not load reads from {f}")
        kmap = count_kmers(input_files, k, hasher, device=tool_device())
    tool.info("Hashtable size: %d kmers", len(kmap))
    return kmap, hasher


def prepare_lookups(kmap: KmerMap) -> None:
    """Build the lookup structure find_reads probes, before the first batch
    (and the pool): the first mate tasks would otherwise wait on its build,
    and a batch's million lookups pay for the map's probe table at once.
    The device route probes only the device copy of the map, the host route
    only the probe table."""
    if device_classify():
        kmap.device_arrays(tool_device())
    else:
        kmap._probe_table()


def _classified_stream(files: list[str], kmap: KmerMap, k: int,
                       hasher: str | None, z: float, thr: float, corr: bool):
    """Yield (b1, b2, found1, found2) per batch pair, classification run on a
    small thread pool with bounded prefetch.

    The reference classifies one task per pair on every core
    (src/tools/ReadsClassifier.java:158-187); here each find_reads call is a
    batch of 8192 reads of numpy/probe-table work that releases the GIL, so
    a pool of MC_CLASSIFY_THREADS workers overlaps the two mates'
    classification and lets the writer thread drain finished batches while
    the next ones compute. Results are consumed IN SUBMISSION ORDER, so the
    six bin files stay byte-identical to the sequential path.

    Default policy MEASURED round 5 (interleaved A/B, 600K-read runs): on a
    2-core host the mate-parallel pipeline is ~10% SLOWER than sequential
    (GIL handoffs + cache contention beat the overlap), so hosts with <= 2
    cores default to sequential; wider hosts default to one worker per core
    (capped at 8), where per-pair task parallelism -- the reference's own
    design -- has headroom. MC_CLASSIFY_THREADS overrides either way."""
    from concurrent.futures import ThreadPoolExecutor
    import collections

    ncpu = os.cpu_count() or 2
    workers = int(os.environ.get("MC_CLASSIFY_THREADS",
                                 str(min(ncpu, 8) if ncpu > 2 else 1)))
    prepare_lookups(kmap)
    it = iter_read_batch_pairs(files, CLASSIFY_BATCH)
    if workers <= 1:
        for b1, b2 in it:
            yield (b1, b2,
                   find_reads(b1, kmap, k, hasher, z, thr, corr),
                   find_reads(b2, kmap, k, hasher, z, thr, corr))
            del b1, b2  # drop the generator's stale refs before the packer
            #            builds the next pair (keeps peak at one pair)
        return

    def work(b):
        return find_reads(b, kmap, k, hasher, z, thr, corr)

    # bounded prefetch: each mate is its own task. On a 2-core host the win
    # is mate-vs-mate parallelism (depth 0: no pair queued beyond the one
    # being consumed); wider hosts also pipeline ahead one pair per 2 spare
    # workers. Deeper queues only add memory (the streams-constant-memory
    # test pins the O(batch) bound).
    depth = max(workers // 2 - 1, 0)
    with ThreadPoolExecutor(workers) as ex:
        q: collections.deque = collections.deque()
        for b1, b2 in it:
            q.append((b1, b2, ex.submit(work, b1), ex.submit(work, b2)))
            while len(q) > depth:
                p1, p2, fu1, fu2 = q.popleft()
                yield p1, p2, fu1.result(), fu2.result()
        while q:
            p1, p2, fu1, fu2 = q.popleft()
            yield p1, p2, fu1.result(), fu2.result()


class ReadsClassifier(Tool):
    NAME = "reads-classifier"
    DESCRIPTION = "classifies reads based on weighted De Bruijn graph"

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.input_files = self.add_parameter(Parameter(
            "input-files", str, short="i", multi=True, mandatory=True,
            description="file with paired input reads for De Bruijn graph OR "
                        "file with k-mers in binary format"))
        self.reads_files = self.add_parameter(Parameter(
            "read-files", str, short="r", multi=True, mandatory=True,
            description="files with paired reads to classify"))
        self.output_dir = self.add_parameter(Parameter(
            "output-dir", str, short="o",
            lazy_default=lambda t: os.path.join(t.work_dir.get(t),
                                                "reads_classifier"),
            description="directory to output found reads"))
        self.do_correction = self.add_parameter(Parameter(
            "correction", bool, short="corr", default=False,
            description="Do replacement of nucleotide in read with one low "
                        "quality position"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))
        self.interval95 = self.add_parameter(Parameter(
            "interval95", bool, default=False,
            description="Set the interval width to probability 0.95"))
        self.found_threshold = self.add_parameter(Parameter(
            "found-threshold", int, short="found", default=90,
            description="Minimum coverage breadth for class `found` [0 - 100 %]"))

    def run_impl(self) -> None:
        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        k = self.k.get(self)
        if device_classify():
            tool_device()
        kmap, hasher = load_classifier_graph(
            self, self.input_files.get(self), k, self.hash_function.get(self))

        self.info("Loading reads...")
        files = self.reads_files.get(self)
        check_reads_files(files)
        z = 1.96 if self.interval95.get(self) else 1.0
        thr = self.found_threshold.get(self) / 100.0
        corr = self.do_correction.get(self)
        self.info("Searching for%s reads in graph...",
                  " corrected" if corr else "")

        # Batched classification: pairs stream as (B, L) ReadBatch arrays
        # (native C++ whole-read parse + vectorized packing when available,
        # algo/classify.py::iter_read_batch_pairs) and route straight to the
        # six bin writers as vectorized blob writes -- the reference runs
        # one task per pair with per-record I/O
        # (src/tools/ReadsClassifier.java:160-187,206-222,
        # itmo:io/sources/PairSource.java:22-57).
        n_both = n_first = n_second = n_neither = 0
        writers = {name: FastqWriter(os.path.join(out, name + ".fastq"))
                   for name in ("found_1", "found_2", "not_found_1",
                                "not_found_2", "found_s", "not_found_s")}
        try:
            for b1, b2, f1, f2 in _classified_stream(
                    files, kmap, k, hasher, z, thr, corr):
                # single-end convention (PairFinder.java:42-44)
                f2 = np.where(b2.lengths == 0, ~f1, f2)
                # Vectorized bin routing: partition the batch by (f1, f2)
                # once with numpy and write each bin as one slice -- per-read
                # Python work is gone; order within each bin matches the
                # reference's sequential pair loop (ReadsClassifier.java:160-187)
                # because flatnonzero preserves batch order.
                both = np.flatnonzero(f1 & f2)
                neither = np.flatnonzero(~f1 & ~f2)
                single = np.flatnonzero(f1 != f2)
                n_both += both.size
                n_neither += neither.size
                n_first += int(np.count_nonzero(f1[single]))
                n_second += single.size - int(np.count_nonzero(f1[single]))
                # Bin I/O is vectorized end-to-end: each bin is one numpy
                # blob assembly + one file write (io/writers.py::
                # format_fastq_blob) straight from the ReadBatch arrays --
                # no DnaQ object lists, no per-record formatting
                # (reference writes record-by-record,
                # src/tools/ReadsClassifier.java:206-222).
                writers["found_1"].write_batch(
                    b1.codes, b1.phred, b1.lengths, both)
                writers["found_2"].write_batch(
                    b2.codes, b2.phred, b2.lengths, both)
                writers["not_found_1"].write_batch(
                    b1.codes, b1.phred, b1.lengths, neither)
                writers["not_found_2"].write_batch(
                    b2.codes, b2.phred, b2.lengths, neither)
                # single bins: the found mate goes to found_s, the other to
                # not_found_s, empty mates skipped (PairFinder.java:46-54)
                use1 = f1[single]
                sc, sp, sl = _mix_rows(b1, b2, single, use1)
                writers["found_s"].write_batch(
                    sc, sp, sl, np.flatnonzero(sl > 0))
                nc, np_, nl = _mix_rows(b1, b2, single, ~use1)
                writers["not_found_s"].write_batch(
                    nc, np_, nl, np.flatnonzero(nl > 0))
        finally:
            for w in writers.values():
                w.close()

        stats = FoundStats(n_both, n_first, n_second, n_neither)
        self._log_stats(stats)
        self.info("Reads have been written. Finishing...")

    def _log_stats(self, stats: FoundStats) -> None:
        """Stats block (ReadsClassifier.java:189-199)."""
        self.info("|\tTotal: %d reads", stats.total)
        self.info("|\tPaired: %d reads", stats.paired)
        self.info("|\tTotal quality: %.2f %%",
                  100 * stats.paired / stats.total if stats.total else 0)
        self.info("|\tFound: %d reads", stats.found)
        self.info("|\tPercent of found reads: %.2f %%",
                  100 * stats.found / stats.total if stats.total else 0)
        self.info("|\tQuality of found bin: %.2f %%", stats.quality_found)
        self.info("|\tNot found: %d reads", stats.not_found)
        self.info("|\tPercent of not found reads: %.2f %%",
                  100 * stats.not_found / stats.total if stats.total else 0)
        self.info("|\tQuality of not found bin: %.2f %%", stats.quality_not_found)
