"""Per-gene environment calculator: BFS -> contraction -> writers.

Equivalent of src/algo/OneSequenceCalculator.java run():98-114 + createPicture
():326-339 for the exact (k<=31) regime; the hashed regime routes through
algo.environment_hashed (string states). Carried over from
metacherchant_tpu/algo/calculator.py.
"""
from __future__ import annotations

import logging
import os

from .. import trace
from ..kmer_map import KmerMap
from .environment import build_environment, Environment
from .contraction import (build_node_graph, do_merge, gene_kmer_checker,
                          use_device_contraction)
from ..io.writers import (
    write_graph_txt, write_graph_txt_codes, write_seqs_fasta, write_gfa,
    write_tsvs)

logger = logging.getLogger("metacherchant")


def shorten_label(label: str, k: int) -> str:
    """src/utils/StringUtils.java:43-49."""
    if len(label) >= 2 * k:
        return f"{label[:k]}...{label[-k:]} (length={len(label)})"
    return label


@trace.traced("env.gene")
def run_one_sequence(sequences: list[str], k: int, kmap: KmerMap,
                     min_occ: int, output_prefix: str,
                     both_directions: bool, chunk_length: int,
                     max_radius: int | None, max_kmers: int | None,
                     trim: bool, merged: bool,
                     hic_sequences: list[str] | None = None,
                     hasher: str | None = None) -> Environment | None:
    """Returns the Environment, or None when no gene k-mer was found
    (fail+halt, OneSequenceCalculator.java:193-196, run():106-109)."""
    if not merged:
        logger.info("Finding environment for sequence %s",
                    shorten_label(sequences[0], k))
    else:
        logger.info("Finding single environment for %d sequences", len(sequences))

    if hasher is None:
        env = build_environment(sequences, k, kmap, min_occ, both_directions,
                                max_radius, max_kmers, trim, hic_sequences)
    else:
        from .environment_hashed import build_environment_hashed
        env = build_environment_hashed(sequences, k, kmap, min_occ, hasher,
                                       both_directions, max_radius, max_kmers,
                                       trim, hic_sequences)
    if env.fail:
        logger.info("Could not find any k-mers of the target gene in the input, halting.")
        return None
    logger.info("Extending endings by %d kmers", env.extend_count)

    graph_txt = os.path.join(output_prefix, "graph.txt")
    if hasher is None:
        # exact regime: vectorized writer straight from oriented codes
        # (byte-identical to write_graph_txt(env.as_dict()))
        write_graph_txt_codes(graph_txt, env.codes, env.counts, k)
    else:
        write_graph_txt(graph_txt, env.as_dict())
    create_picture(env.as_dict(), sequences, k, output_prefix, chunk_length)
    return env


def create_picture(subgraph: dict[str, int], gene_sequences: list[str], k: int,
                   output_prefix: str, chunk_length: int) -> None:
    """createPicture (OneSequenceCalculator.java:326-339): build doubled-node
    graph, contract, emit seqs.fasta + graph.gfa + tsvs/.

    The pointer-jumping contraction on the device of device.py
    (ops/contraction_device.py) is opt-in, as in the JAX package:
    MC_DEVICE_CONTRACT=1, or an explicit MC_DEVICE_CONTRACT_MIN
    (use_device_contraction). It gives the same unitig SET as the host
    sweep, but seqs.fasta/graph.gfa/tsv record ORDER and per-unitig strand
    choice may differ; its files are byte-identical to the JAX package's
    device route. MC_DEVICE_CONTRACT=0 keeps the host sweep at any size."""
    with trace.span("picture", kmers=len(subgraph)):
        kmer_list = sorted(subgraph)
        is_gene = gene_kmer_checker(gene_sequences, k)
        with trace.span("picture.contract") as sp:
            if use_device_contraction(len(kmer_list), k):
                from ..ops.contraction_device import contract_device
                nodes = contract_device(kmer_list, k, tag_of=is_gene)
            else:
                nodes = build_node_graph(kmer_list, k, is_gene=is_gene)
                do_merge(nodes, k)
            sp.set(nodes=len(nodes))
        write_seqs_fasta(os.path.join(output_prefix, "seqs.fasta"), nodes,
                         chunk_length)
        write_gfa(os.path.join(output_prefix, "graph.gfa"), nodes, k,
                  subgraph)
        write_tsvs(os.path.join(output_prefix, "tsvs"), nodes, k)
