"""Inputs of a cell, made from the seed: a simulated metagenome's reads as
one FASTQ file (and their first quarter for the warm-up job), and the genes
each job asks about.

The community follows CAMISIM's de novo design (Fritz et al., Microbiome
7:17, 2019, as in the CAMI challenge, Sczyrba et al., Nature Methods 14:1063,
2017): every genome, a species or a strain of one, takes its share of the
reads from a log-normal abundance (mu 1, sigma 2), so a few genomes are deep
and most are shallow. Strains differ from their species' genome by
substitutions. Each gene of the configuration's panel (a resistance gene,
say) sits in several hosts with different flanks, as a gene that moves
between genomes does.

Every seed gets the same sizes: the abundances are the log-normal's
quantiles, given to the genomes in one fixed order, and each gene's hosts
are taken at fixed abundance ranks; the seed draws the sequences, the
places, and which read comes from where. Everything is drawn with one
torch.Generator on the run's device, in blocks of reads.

fastq_records keeps the record layout of chip_smoke.py:207-224 (write_fastq:
'@r<i>' with zero-padded digits, the bases, '+', quality 'I'), in torch so
that each block is formatted on the device; sample_reads follows chip_smoke.py:226-237
(half of the reads reverse complemented, uniform substitutions).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np
import torch

#: the warm-up job reads this share of the reads (the first ones)
WARM_SHARE = 4
#: reads drawn and written per block
BLOCK = 1 << 20
#: the fixed order in which genomes take the abundances (the same for every
#: seed, so that strains and gene hosts sit at the same ranks)
ORDER_SEED = 20190227


def abundances(n: int, mu: float, sigma: float) -> np.ndarray:
    """Shares of n genomes from the log-normal's quantiles at (i + 1/2)/n,
    largest first."""
    z = [NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    v = np.array(sorted((math.exp(mu + sigma * x) for x in z), reverse=True))
    return v / v.sum()


def reads_per_genome(shares: np.ndarray, total: int) -> np.ndarray:
    """Whole read counts that follow `shares` and sum to `total`."""
    n = np.floor(shares * total).astype(np.int64)
    n[np.argsort(-(shares * total - n), kind="stable")[:total - n.sum()]] += 1
    return n


def _substitute(x: torch.Tensor, rate: float, gen: torch.Generator
                ) -> torch.Tensor:
    """Each base replaced by one of the other three with probability rate."""
    hit = torch.rand(x.shape, generator=gen, device=x.device) < rate
    shift = torch.randint(1, 4, x.shape, generator=gen, device=x.device,
                          dtype=torch.int8)
    return torch.where(hit, (x + shift) % 4, x)


def _revcomp(x: torch.Tensor) -> torch.Tensor:
    return 3 - x.flip(-1)


@dataclass
class Community:
    genomes: torch.Tensor      # (G, genome_bp) int8 codes, A=0 G=1 C=2 T=3
    reads: np.ndarray          # reads drawn from each genome
    genes: list[torch.Tensor]  # the panel's gene sequences


def make_community(cfg: dict, gen: torch.Generator, device) -> Community:
    """The configuration's genomes with its panel genes placed in them."""
    species, strained = cfg["species"], cfg["strain_species"]
    length = cfg["genome_bp"]
    genomes = torch.randint(0, 4, (species, length), generator=gen,
                            device=device, dtype=torch.int8)
    strains = _substitute(genomes[:strained], cfg["strain_divergence"], gen)
    genomes = torch.cat([genomes, strains])
    n = genomes.shape[0]
    rank = np.random.default_rng(ORDER_SEED).permutation(n)
    shares = abundances(n, cfg["abundance_mu"], cfg["abundance_sigma"])
    reads = reads_per_genome(shares, cfg["reads"])[rank]
    genes = []
    panel = cfg.get("panel_genes", 0)
    if panel:
        gl = cfg["gene_bp"]
        genes = list(torch.randint(0, 4, (panel, gl), generator=gen,
                                   device=device, dtype=torch.int8))
        by_rank = np.argsort(rank)
        # hosts take genes at places on a grid of slots away from the
        # genome's ends, a slot each, so that environments stay apart
        slot_bp = 10 * gl
        first = length // 10
        slots = (length - 2 * first) // slot_bp
        free = {}
        for g, seq in enumerate(genes):
            for lo, hi in cfg["gene_host_ranks"]:
                host = int(by_rank[lo + g % (hi - lo)])
                if host not in free:
                    free[host] = torch.randperm(
                        slots, generator=gen, device=device).tolist()
                if not free[host]:
                    raise ValueError(f"genome {host} has no slot left for "
                                     f"gene {g}")
                at = first + free[host].pop() * slot_bp + \
                    int(torch.randint(0, slot_bp - gl, (1,), generator=gen,
                                      device=device))
                flip = bool(torch.rand(1, generator=gen, device=device) < 0.5)
                genomes[host, at:at + gl] = _revcomp(seq) if flip else seq
    return Community(genomes, reads, genes)


def sample_reads(genomes: torch.Tensor, which: torch.Tensor,
                 read_bp: int, sub_rate: float, gen: torch.Generator
                 ) -> torch.Tensor:
    """A read of read_bp from each genome of `which` at a uniform offset,
    half reverse complemented, with uniform substitutions."""
    n, length = which.numel(), genomes.shape[1]
    at = torch.randint(0, length - read_bp + 1, (n,), generator=gen,
                       device=genomes.device)
    idx = (which * length + at)[:, None] + torch.arange(
        read_bp, device=genomes.device)
    reads = genomes.reshape(-1)[idx]
    flip = torch.rand(n, generator=gen, device=genomes.device) < 0.5
    reads = torch.where(flip[:, None], _revcomp(reads), reads)
    return _substitute(reads, sub_rate, gen)


def fastq_records(codes: torch.Tensor, first: int, width: int
                  ) -> torch.Tensor:
    """(n, L) int8 codes (A=0,G=1,C=2,T=3) -> (n, record) uint8 FASTQ
    records '@r<first + i>' with `width` digits, quality 'I'."""
    n, L = codes.shape
    dev = codes.device
    pw = 10 ** torch.arange(width - 1, -1, -1, dtype=torch.int64, device=dev)
    num = torch.arange(first, first + n, dtype=torch.int64, device=dev)
    rec = torch.empty((n, 3 + width + L + 3 + L + 1), dtype=torch.uint8,
                      device=dev)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    rec[:, 2:2 + width] = (num[:, None] // pw % 10 + ord("0")).to(torch.uint8)
    rec[:, 2 + width] = ord("\n")
    o = 3 + width
    lut = torch.tensor(list(b"AGCT"), dtype=torch.uint8, device=dev)
    rec[:, o:o + L] = lut[codes.long()]
    rec[:, o + L:o + L + 3] = torch.tensor(list(b"\n+\n"), dtype=torch.uint8,
                                           device=dev)
    rec[:, o + L + 3:o + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    return rec


def write_genes(path: str, genes: list[tuple[int, torch.Tensor]]) -> None:
    """A FASTA of (panel index, codes) genes, named gene<index + 1>."""
    with open(path, "w") as f:
        for i, g in genes:
            seq = np.frombuffer(b"AGCT", np.uint8)[g.cpu().numpy()]
            f.write(f">gene{i + 1}\n{seq.tobytes().decode()}\n")


@dataclass
class Inputs:
    reads: str                 # the community's reads, one FASTQ file
    warm_reads: str            # the first 1/WARM_SHARE of them
    genes: list[str | None]    # per job slot, a FASTA of its genes or None

    def genes_of(self, job: int) -> str | None:
        """The genes of job `job` (slot 0 is the warm-up's); the slots
        repeat when a window runs more jobs than there are slots."""
        return self.genes[job % len(self.genes)]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    return gen


def make_inputs(cfg: dict, mix: dict, seed: int, where: str,
                device="cpu") -> Inputs:
    """Write the reads of configuration `cfg` and the warm-up's share of
    them (under the same file name, so that a tool names its outputs alike)
    and, when the traffic mix asks for genes, one FASTA of
    mix["genes_per_job"] panel genes for each job slot, all under `where`.
    Slot j takes the panel's genes from j * genes_per_job on, wrapping, so
    the slots cycle through the whole panel."""
    gen = generator(seed, device)
    com = make_community(cfg, gen, device)
    total = int(com.reads.sum())
    which = torch.repeat_interleave(
        torch.arange(len(com.reads), device=device),
        torch.from_numpy(com.reads).to(device))
    which = which[torch.randperm(total, generator=gen, device=device)]
    reads = os.path.join(where, "reads.fastq")
    warm = os.path.join(where, "warm", "reads.fastq")
    os.makedirs(os.path.dirname(warm), exist_ok=True)
    n_warm = max(1, total // WARM_SHARE)
    width = len(str(max(total - 1, 1)))
    with open(reads, "wb") as out, open(warm, "wb") as wout:
        for r0 in range(0, total, BLOCK):
            codes = sample_reads(com.genomes, which[r0:r0 + BLOCK],
                                 cfg["read_bp"], cfg["substitution_rate"],
                                 gen)
            rec = fastq_records(codes, r0, width).cpu().numpy()
            rec.tofile(out)
            if r0 < n_warm:
                rec[:n_warm - r0].tofile(wout)
    per_job = mix.get("genes_per_job", 0)
    if not per_job:
        return Inputs(reads, warm, [None])
    panel = len(com.genes)
    slots = panel // math.gcd(panel, per_job)
    genes = []
    for slot in range(slots):
        pick = [(slot * per_job + t) % panel for t in range(per_job)]
        path = os.path.join(where, f"genes_{slot}.fasta")
        write_genes(path, [(i, com.genes[i]) for i in pick])
        genes.append(path)
    return Inputs(reads, warm, genes)
