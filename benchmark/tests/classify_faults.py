"""Faults planted underneath a reads-classifier run's timed path, each of
which has to turn `correct` false: the CPU tests plant them at a tiny size,
the card's tests at the cell's own size. Each takes pytest's monkeypatch."""
import numpy as np


def lookups_half_dropped(monkeypatch):
    """The second half of each batch's lookups on the device find
    nothing."""
    from metacherchant_tpu_torch.kmer_map import KmerMap
    orig = KmerMap.lookup_device

    def half(self, query):
        out = orig(self, query).clone()
        out[out.numel() // 2:] = -1
        return out

    monkeypatch.setattr(KmerMap, "lookup_device", half)


def found_pair_not_found(monkeypatch):
    """The first pair of each batch pair whose mates were both found goes
    to the not_found bins."""
    from metacherchant_tpu_torch.tools import reads_classifier
    orig = reads_classifier._classified_stream

    def stream(*args, **kwargs):
        for b1, b2, f1, f2 in orig(*args, **kwargs):
            both = np.flatnonzero(f1 & f2)
            if both.size:
                f1, f2 = f1.copy(), f2.copy()
                f1[both[0]] = f2[both[0]] = False
            yield b1, b2, f1, f2

    monkeypatch.setattr(reads_classifier, "_classified_stream", stream)


def bin_record_altered(monkeypatch):
    """The first base of the first record of each bin write is replaced."""
    from metacherchant_tpu_torch.io import writers
    orig = writers.format_fastq_blob

    def blob(*args):
        out = orig(*args)
        if not out:
            return out
        at = out.index(b"\n") + 1
        base = b"G" if out[at:at + 1] == b"C" else b"C"
        return out[:at] + base + out[at + 1:]

    monkeypatch.setattr(writers, "format_fastq_blob", blob)


FAULTS = {"lookups_half_dropped": lookups_half_dropped,
          "found_pair_not_found": found_pair_not_found,
          "bin_record_altered": bin_record_altered}
