"""Inputs of a cell, made from the seed: a simulated metagenome's reads as
one FASTQ file (and their first quarter for the warm-up job), the genes
each job asks about, and whatever else the cell's tool needs (mate files, a
donor's dump), which the tool's input hook, inputs/<tool>.py, writes.

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
places, and which read comes from where. The reads and genes are drawn
with one torch.Generator on the run's device, in blocks of reads; an input
hook draws from a second (below).

fastq_records keeps the record layout of chip_smoke.py:207-224 (write_fastq:
'@r<i>' with zero-padded digits, the bases, '+', quality 'I'), in torch so
that each block is formatted on the device; sample_reads follows chip_smoke.py:226-237
(half of the reads reverse complemented, uniform substitutions), and
sample_pairs chip_smoke.py:1058-1072 (mates from the two ends of a fragment,
mate 2 reverse complemented, uniform substitutions).

An input hook is a module with one function,

    make(cfg, mix, seed, where, device, inputs) -> (files, warm_files)

called once a run, in set-up, after the reads and genes are written
(`inputs`); it returns two dicts of named paths under `where`, the window
jobs' files and the warm-up job's, which a launcher reads as
job.files[name] and the reference gets as solve(..., files=files). It draws
from generator(seed, device, salt) with a salt of its own, never from the
reads' generator, so that it cannot move the reads; make_community(cfg,
generator(seed, device), device) gives it the genomes the reads came from,
since the community is that generator's first draw.
"""
from __future__ import annotations

import math
import os
from contextlib import ExitStack
from dataclasses import dataclass, field
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


def sample_pairs(genomes: torch.Tensor, which: torch.Tensor, read_bp: int,
                 fragment_bp: int, sub_rate: float, gen: torch.Generator
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """A pair of read_bp mates from a fragment of fragment_bp of each genome
    of `which` at a uniform offset: mate 1 the fragment's first read_bp
    bases, mate 2 the reverse complement of its last read_bp, each with
    uniform substitutions."""
    n, length = which.numel(), genomes.shape[1]
    at = torch.randint(0, length - fragment_bp + 1, (n,), generator=gen,
                       device=genomes.device)
    first = (which * length + at)[:, None] + torch.arange(
        read_bp, device=genomes.device)
    flat = genomes.reshape(-1)
    mate1 = flat[first]
    mate2 = _revcomp(flat[first + (fragment_bp - read_bp)])
    return (_substitute(mate1, sub_rate, gen),
            _substitute(mate2, sub_rate, gen))


def draw_sources(counts: np.ndarray, gen: torch.Generator, device
                 ) -> torch.Tensor:
    """The genome of each of counts.sum() reads (or pairs), counts[g] from
    genome g, in an order drawn from gen."""
    which = torch.repeat_interleave(
        torch.arange(len(counts), device=device),
        torch.from_numpy(counts).to(device))
    return which[torch.randperm(which.numel(), generator=gen, device=device)]


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


def write_fastq(paths: list[str], warm_paths: list[str], total: int,
                draw) -> None:
    """FASTQ files of `total` records each, drawn in blocks: draw(r0, r1)
    gives one (r1 - r0, L) code tensor per path, all written under the
    record numbers r0..r1-1 (so mates share their numbers); the first
    1/WARM_SHARE records of each path go to its warm path as well."""
    if len(warm_paths) != len(paths):
        raise ValueError("one warm path for each path")
    n_warm = max(1, total // WARM_SHARE)
    width = len(str(max(total - 1, 1)))
    for p in list(paths) + list(warm_paths):
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
    with ExitStack() as stack:
        outs = [stack.enter_context(open(p, "wb")) for p in paths]
        warms = [stack.enter_context(open(p, "wb")) for p in warm_paths]
        for r0 in range(0, total, BLOCK):
            blocks = draw(r0, min(r0 + BLOCK, total))
            for out, wout, codes in zip(outs, warms, blocks):
                rec = fastq_records(codes, r0, width).cpu().numpy()
                rec.tofile(out)
                if r0 < n_warm:
                    rec[:n_warm - r0].tofile(wout)


def write_pairs(paths: list[str], warm_paths: list[str],
                genomes: torch.Tensor, which: torch.Tensor, read_bp: int,
                fragment_bp: int, sub_rate: float, gen: torch.Generator
                ) -> None:
    """Pairs from the genomes of `which` (sample_pairs), mate 1 to paths[0]
    and mate 2 to paths[1] under the same record numbers, the first
    1/WARM_SHARE of the pairs to warm_paths as well."""
    write_fastq(paths, warm_paths, which.numel(),
                lambda r0, r1: sample_pairs(genomes, which[r0:r1], read_bp,
                                            fragment_bp, sub_rate, gen))


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
    # the input hook's named files: the window jobs' and the warm-up's
    files: dict[str, str] = field(default_factory=dict)
    warm_files: dict[str, str] = field(default_factory=dict)

    def genes_of(self, job: int) -> str | None:
        """The genes of job `job` (slot 0 is the warm-up's); the slots
        repeat when a window runs more jobs than there are slots."""
        return self.genes[job % len(self.genes)]


#: Fibonacci hashing's multiplier, which spreads a salt over the seed
_SALT_MIX = 0x9E3779B97F4A7C15


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """The generator of `seed`; a nonzero salt gives a stream of its own
    (an input hook's), apart from the reads'."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + salt * _SALT_MIX) % (1 << 63))
    return gen


def make_inputs(cfg: dict, mix: dict, seed: int, where: str,
                device="cpu", hook=None) -> Inputs:
    """Write the reads of configuration `cfg` and the warm-up's share of
    them (under the same file name, so that a tool names its outputs alike)
    and, when the traffic mix asks for genes, one FASTA of
    mix["genes_per_job"] panel genes for each job slot, all under `where`.
    Slot j takes the panel's genes from j * genes_per_job on, wrapping, so
    the slots cycle through the whole panel. Then, where the tool has an
    input hook (a module, see above), its files."""
    gen = generator(seed, device)
    com = make_community(cfg, gen, device)
    which = draw_sources(com.reads, gen, device)
    reads = os.path.join(where, "reads.fastq")
    warm = os.path.join(where, "warm", "reads.fastq")
    write_fastq([reads], [warm], which.numel(),
                lambda r0, r1: [sample_reads(
                    com.genomes, which[r0:r1], cfg["read_bp"],
                    cfg["substitution_rate"], gen)])
    inputs = Inputs(reads, warm, [None])
    per_job = mix.get("genes_per_job", 0)
    if per_job:
        panel = len(com.genes)
        slots = panel // math.gcd(panel, per_job)
        inputs.genes = []
        for slot in range(slots):
            pick = [(slot * per_job + t) % panel for t in range(per_job)]
            path = os.path.join(where, f"genes_{slot}.fasta")
            write_genes(path, [(i, com.genes[i]) for i in pick])
            inputs.genes.append(path)
    if hook is not None:
        inputs.files, inputs.warm_files = hook.make(cfg, mix, seed, where,
                                                    device, inputs)
    return inputs
