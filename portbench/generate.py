"""The one generator of the benchmark's inputs: a random reference and
batches of simulated paired-end reads, drawn on the device from the seed.

Pairs follow the usual Illumina model (Mason's, and the program's own
host simulator): a fragment of normal insert length starts uniformly in
the genome, mate 1 is read forward from its start and mate 2 backward
from its end, and every sequencing step is an insertion of a random
base, a deletion of a reference base, a substitution or a copy, drawn
independently.  A traffic file may send a share of the pairs from a
second random genome that the index does not hold (host-read removal).

Everything is drawn in bulk with one `torch.Generator` per stream on the
device, so a seed gives the same inputs on the same device, and a
reference of hundreds of millions of bases or a batch of 262,144 pairs
takes milliseconds of the card.
"""
from __future__ import annotations

import dataclasses

import torch

#: extra sequencing steps drawn beyond the read length: a read of R bases
#: needs R steps plus one per deletion; past them every step copies
_SPARE_STEPS = 32


@dataclasses.dataclass(frozen=True)
class Library:
    """What one traffic mix sends, with the library of its configuration."""

    read_len: int
    insert_mean: float
    insert_std: float
    sub_rate: float
    ins_rate: float
    del_rate: float
    foreign_share: float = 0.0   # pairs drawn from a genome not indexed
    edge_pad: int = 64           # fragments keep this far from the ends


def stream_seed(seed: int, tag: int) -> int:
    """An independent 63-bit seed for stream ``tag`` of run seed ``seed``."""
    return (seed * 0x9E3779B1 + tag * 0x85EBCA77 + 1) % (2**63 - 1)


def generator(seed: int, tag: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, tag))
    return g


def random_genome(length: int, g: torch.Generator, device) -> torch.Tensor:
    """(length,) uint8 bases, uniform."""
    return torch.randint(0, 4, (length,), generator=g, device=device,
                         dtype=torch.uint8)


def _sequence(genome: torch.Tensor, start: torch.Tensor, lib: Library,
              g: torch.Generator) -> torch.Tensor:
    """(N, R) uint8 reads sequenced forward from ``start`` with independent
    insertion, deletion and substitution steps."""
    dev = genome.device
    N, R = start.shape[0], lib.read_len
    steps = R + _SPARE_STEPS
    u = torch.rand((N, steps), generator=g, device=dev)
    ins = u < lib.ins_rate
    dele = (u >= lib.ins_rate) & (u < lib.ins_rate + lib.del_rate)
    sub = ((u >= lib.ins_rate + lib.del_rate)
           & (u < lib.ins_rate + lib.del_rate + lib.sub_rate))
    # the copy steps past the drawn ones guarantee R emitted bases
    tail = torch.zeros((N, R), dtype=torch.bool, device=dev)
    ins, dele, sub = (torch.cat([x, tail], 1) for x in (ins, dele, sub))
    advance = (~ins).to(torch.int64)
    ref_pos = start[:, None] + torch.cumsum(advance, 1) - advance
    emitted = ~dele
    order = torch.argsort((~emitted).to(torch.uint8), dim=1, stable=True)
    take = order[:, :R]                                 # the first R emits
    pos = torch.gather(ref_pos, 1, take).clamp(0, genome.shape[0] - 1)
    base = genome[pos]
    shift = torch.randint(1, 4, (N, R), generator=g, device=dev,
                          dtype=torch.uint8)
    rand_base = torch.randint(0, 4, (N, R), generator=g, device=dev,
                              dtype=torch.uint8)
    base = torch.where(torch.gather(sub, 1, take), (base + shift) % 4, base)
    return torch.where(torch.gather(ins, 1, take), rand_base, base)


def read_pairs(genome: torch.Tensor, n: int, lib: Library,
               g: torch.Generator):
    """``n`` FR pairs from ``genome``: (reads1, reads2 as sequenced,
    fragment starts, inserts), all on the genome's device."""
    dev = genome.device
    R = lib.read_len
    insert = torch.normal(float(lib.insert_mean), float(lib.insert_std),
                          (n,), generator=g, device=dev)
    insert = insert.round().to(torch.int64).clamp(min=R)
    lo = lib.edge_pad
    span = (genome.shape[0] - lib.edge_pad - insert - R - lo).clamp(min=1)
    start = lo + (torch.rand((n,), generator=g, device=dev,
                             dtype=torch.float64) * span).to(torch.int64)
    r1 = _sequence(genome, start, lib, g)
    r2_fwd = _sequence(genome, start + insert - R, lib, g)
    return r1, (3 - r2_fwd).flip(-1), start, insert


def batch(genome: torch.Tensor, foreign: torch.Tensor | None, n: int,
          lib: Library, g: torch.Generator):
    """One batch of ``n`` pairs: ``round(foreign_share * n)`` of them from
    ``foreign``, the rest from ``genome``, interleaved by a permutation
    drawn from ``g``.  Returns (reads1, reads2, start, insert, foreign
    mask) on the device."""
    n_f = int(round(lib.foreign_share * n)) if foreign is not None else 0
    parts = [read_pairs(genome, n - n_f, lib, g)]
    if n_f:
        parts.append(read_pairs(foreign, n_f, lib, g))
    r1, r2, start, insert = (torch.cat(x) for x in zip(*parts))
    mask = torch.arange(n, device=genome.device) >= n - n_f
    perm = torch.randperm(n, generator=g, device=genome.device)
    return r1[perm], r2[perm], start[perm], insert[perm], mask[perm]
