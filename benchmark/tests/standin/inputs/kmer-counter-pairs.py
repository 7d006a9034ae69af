"""Input hook of the stand-in tool kmer-counter-pairs: the configuration's
community as a paired-end run, two FASTQ files of mates under the same
record numbers, and the warm-up's first quarter of the pairs under the same
file names. The pairs take the community's shares of the genomes, half as
many pairs as the configuration has reads."""
import os

from benchmark import datagen

#: this hook's stream of the seed, apart from the reads'
SALT = 1
MATES = ("mate1", "mate2")


def make(cfg, mix, seed, where, device, inputs):
    com = datagen.make_community(cfg, datagen.generator(seed, device), device)
    gen = datagen.generator(seed, device, SALT)
    counts = datagen.reads_per_genome(com.reads / com.reads.sum(),
                                      cfg["reads"] // 2)
    which = datagen.draw_sources(counts, gen, device)
    files = {m: os.path.join(where, "pairs", f"{m}.fastq") for m in MATES}
    warm = {m: os.path.join(where, "pairs", "warm", f"{m}.fastq")
            for m in MATES}
    datagen.write_pairs([files[m] for m in MATES], [warm[m] for m in MATES],
                        com.genomes, which, cfg["read_bp"], cfg["fragment_bp"],
                        cfg["substitution_rate"], gen)
    return files, warm
