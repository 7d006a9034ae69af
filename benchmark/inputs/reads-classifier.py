"""Input hook of reads-classifier: the donor's k-mer dump and the
recipient's paired-end run.

The donor is the configuration's community, whose reads the harness wrote
(inputs.reads). Its dump is what kmer-counter -b <threshold> writes of those
reads: the recount of every canonical k-mer (reference/recount.py), the
records whose count exceeds the threshold, ascending by key as the port's
kmer-counter writes them, each a big-endian int64 key and an int16 count.

The recipient is cfg["recipient_pairs"] pairs of read_bp mates from
fragments of fragment_bp (datagen.sample_pairs), with
recipient_substitution_rate substitutions: a share recipient_donor_share
from the donor's genomes by the donor's abundances, the rest from a
recipient community of the same shape, drawn with the pairs from this
hook's stream of the seed.

The warm-up job gets the same dump and the first quarter of the pairs.
"""
import os

import numpy as np
import torch

from benchmark import datagen
from benchmark.reference import recount

#: this hook's stream of the seed, apart from the reads'
SALT = 17
MATES = ("mate1", "mate2")
RECORD = np.dtype([("k", ">i8"), ("c", ">i2")])


def write_dump(path: str, keys: np.ndarray, counts: np.ndarray) -> None:
    """kmers.bin records of (keys, counts), in the order given."""
    rec = np.empty(keys.size, RECORD)
    rec["k"], rec["c"] = keys, counts
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rec.tofile(path)


def make(cfg, mix, seed, where, device, inputs):
    keys, counts = recount.count(recount.read_fastq_codes(inputs.reads),
                                 cfg["k"], device)
    keep = counts > cfg["threshold"]
    dump = os.path.join(where, "donor", "donor.kmers.bin")
    write_dump(dump, keys[keep], counts[keep])
    del keys, counts, keep

    donor = datagen.make_community(cfg, datagen.generator(seed, device),
                                   device)
    gen = datagen.generator(seed, device, SALT)
    recipient = datagen.make_community(cfg, gen, device)
    total = cfg["recipient_pairs"]
    from_donor = round(total * cfg["recipient_donor_share"])
    per_genome = np.concatenate([
        datagen.reads_per_genome(com.reads / com.reads.sum(), n)
        for com, n in ((donor, from_donor), (recipient, total - from_donor))])
    which = datagen.draw_sources(per_genome, gen, device)
    files = {m: os.path.join(where, "recipient", f"{m}.fastq")
             for m in MATES}
    warm = {m: os.path.join(where, "recipient", "warm", f"{m}.fastq")
            for m in MATES}
    datagen.write_pairs([files[m] for m in MATES], [warm[m] for m in MATES],
                        torch.cat([donor.genomes, recipient.genomes]), which,
                        cfg["read_bp"], cfg["fragment_bp"],
                        cfg["recipient_substitution_rate"], gen)
    return {"dump": dump, **files}, {"dump": dump, **warm}
