"""Faults planted underneath a run's timed path, each of which has to turn
`correct` false: the CPU tests plant them at a tiny size, the card's tests
at each cell's own size. Each takes pytest's monkeypatch."""
import numpy as np


def consolidate_unchanged(monkeypatch):
    from metacherchant_tpu_torch.ops import sortcount
    monkeypatch.setattr(sortcount.StreamCounter, "_consolidate",
                        lambda self: setattr(self, "offset", 0))


def half_of_each_launch(monkeypatch):
    from metacherchant_tpu_torch.ops import sortcount
    from metacherchant_tpu_torch.ops.kmers import SENTINEL
    orig = sortcount.extract_append_ragged

    def half(codes, starts, lens, offs, k, out):
        orig(codes, starts, lens, offs, k, out)
        out[out.numel() // 2:] = SENTINEL

    monkeypatch.setattr(sortcount, "extract_append_ragged", half)


def count_altered(monkeypatch):
    from metacherchant_tpu_torch.algo import calculator
    from metacherchant_tpu_torch.tools import kmer_counter
    orig_graph = calculator.write_graph_txt_codes
    orig_bin = kmer_counter.write_kmers_bin

    def graph(path, codes, counts, k):
        counts = np.array(counts)
        counts[0] += 1
        orig_graph(path, codes, counts, k)

    def dump(path, stat_path, keys, counts, threshold=0):
        counts = np.array(counts)
        counts[np.flatnonzero(counts > threshold)[0]] += 1
        return orig_bin(path, stat_path, keys, counts, threshold)

    monkeypatch.setattr(calculator, "write_graph_txt_codes", graph)
    monkeypatch.setattr(kmer_counter, "write_kmers_bin", dump)


def unitig_altered(monkeypatch):
    from metacherchant_tpu_torch.algo import calculator
    orig = calculator.write_seqs_fasta

    def write(path, nodes, chunk_length):
        orig(path, nodes, chunk_length)
        with open(path) as fh:
            lines = fh.read().split("\n")
        seq = lines[1]
        lines[1] = ("C" if seq[0] != "C" else "G") + seq[1:]
        with open(path, "w") as fh:
            fh.write("\n".join(lines))

    monkeypatch.setattr(calculator, "write_seqs_fasta", write)


FAULTS = {"state_unchanged": consolidate_unchanged,
          "half_the_batch": half_of_each_launch,
          "answer_altered": count_altered}
