"""Per-gene environment calculator: BFS -> contraction -> writers.

Equivalent of src/algo/OneSequenceCalculator.java run():98-114 + createPicture
():326-339 for the exact (k<=31) regime; carried over from
metacherchant_tpu/algo/calculator.py. The hashed regime is not ported yet.
"""
from __future__ import annotations

import logging
import os

from ..kmer_map import KmerMap
from .environment import build_environment, Environment
from .contraction import (build_node_graph, do_merge, gene_kmer_checker,
                          refuse_device_contraction)
from ..io.writers import (
    write_graph_txt_codes, write_seqs_fasta, write_gfa, write_tsvs)

logger = logging.getLogger("metacherchant")


def shorten_label(label: str, k: int) -> str:
    """src/utils/StringUtils.java:43-49."""
    if len(label) >= 2 * k:
        return f"{label[:k]}...{label[-k:]} (length={len(label)})"
    return label


def run_one_sequence(sequences: list[str], k: int, kmap: KmerMap,
                     min_occ: int, output_prefix: str,
                     both_directions: bool, chunk_length: int,
                     max_radius: int | None, max_kmers: int | None,
                     trim: bool, merged: bool,
                     hic_sequences: list[str] | None = None
                     ) -> Environment | None:
    """Returns the Environment, or None when no gene k-mer was found
    (fail+halt, OneSequenceCalculator.java:193-196, run():106-109)."""
    if not merged:
        logger.info("Finding environment for sequence %s",
                    shorten_label(sequences[0], k))
    else:
        logger.info("Finding single environment for %d sequences", len(sequences))

    env = build_environment(sequences, k, kmap, min_occ, both_directions,
                            max_radius, max_kmers, trim, hic_sequences)
    if env.fail:
        logger.info("Could not find any k-mers of the target gene in the input, halting.")
        return None
    logger.info("Extending endings by %d kmers", env.extend_count)

    # vectorized writer straight from oriented codes (byte-identical to
    # write_graph_txt(env.as_dict()))
    write_graph_txt_codes(os.path.join(output_prefix, "graph.txt"),
                          env.codes, env.counts, k)
    create_picture(env.as_dict(), sequences, k, output_prefix, chunk_length)
    return env


def create_picture(subgraph: dict[str, int], gene_sequences: list[str], k: int,
                   output_prefix: str, chunk_length: int) -> None:
    """createPicture (OneSequenceCalculator.java:326-339): build doubled-node
    graph, contract on the host, emit seqs.fasta + graph.gfa + tsvs/."""
    refuse_device_contraction()
    kmer_list = sorted(subgraph)
    nodes = build_node_graph(kmer_list, k,
                             is_gene=gene_kmer_checker(gene_sequences, k))
    do_merge(nodes, k)
    write_seqs_fasta(os.path.join(output_prefix, "seqs.fasta"), nodes, chunk_length)
    write_gfa(os.path.join(output_prefix, "graph.gfa"), nodes, k, subgraph)
    write_tsvs(os.path.join(output_prefix, "tsvs"), nodes, k)
