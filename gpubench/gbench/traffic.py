"""The one generator of the benchmark's input files.

A configuration file gives the shape of the reads (length, names, bases,
quality model) and the file's size; ``reads`` draws a file's reads from
a seed, and ``fastq`` lays them out.  The same seed gives the same
bytes; every seed gives the same number of reads of the same lengths, so
only the values change between seeds.  A read length is one number, or a
histogram of lengths drawn from the configuration's own length seed.

Bases come from a virtual genome far longer than a file: each read is a
stretch of unique sequence (an order-1 Markov chain), or of a copy of
one of the genome's repeat families, with the copy's own substitutions;
either strand.  Reads of one file do not overlap, as in some GB of a
human WGS run, so only what repeats across the genome (its families and
its dinucleotide skew) is there for a context model to learn.  The
families' consensus sequences come from the configuration's genome
seed, the same for every seed.  Qualities fall along the read around a
per-read level, with noise correlated from base to base, single-base
dips, and runs of the lowest value at the ends of some reads.

Names follow a format whose placeholders n (the read's number), tile, x
and y may each appear more than once, with a width and zero fill
(``{y:05d}``); its other fields are the configuration's fixed values.
"""

from __future__ import annotations

import re
import string
from statistics import NormalDist

import numpy as np

from gbench.ref_archive import Reads

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mean_width(lo: int, hi: int, width: int = 0) -> float:
    """Mean printed width of the integers lo..hi: their decimal digits,
    padded to width."""
    total, d = 0, 1
    while 10 ** (d - 1) <= hi:
        a, b = max(lo, 10 ** (d - 1)), min(hi, 10 ** d - 1)
        if a <= b:
            total += max(d, width) * (b - a + 1)
        d += 1
    return total / (hi - lo + 1)


_FIELDS = ("n", "tile", "x", "y")


def _name_format(names: dict) -> tuple[str, int, list[tuple[str, int]]]:
    """The name format as printf text, with the fixed fields filled in;
    the length of that fixed text; and the placeholders in their order,
    each with its width."""
    text, fixed, fields = [], 0, []
    for lit, field, spec, conv in string.Formatter().parse(names["format"]):
        text.append(lit.replace("%", "%%"))
        fixed += len(lit)
        if field is None:
            continue
        if field in _FIELDS:
            m = re.fullmatch(r"(0?)(\d*)d?", spec)
            if conv or not m:
                raise ValueError(f"name field {{{field}:{spec}}}: only a "
                                 "width and zero fill are allowed")
            text.append("%" + spec.rstrip("d") + "d")
            fields.append((field, int(m[2] or 0)))
        else:
            value = format(names["fixed"][field], spec)
            text.append(value.replace("%", "%%"))
            fixed += len(value)
    return "".join(text), fixed, fields


def lengths(cfg: dict, n: int) -> np.ndarray:
    """The lengths of the first n reads: the configured read_length, or
    drawn from its histogram ([lo, hi, weight] bins, a length uniform
    within its bin) with its length_seed, the same for every seed."""
    rl = cfg["read_length"]
    if isinstance(rl, int):
        return np.full(n, rl, np.int64)
    lo, hi, w = np.array(rl["histogram"], float).T
    share = w / w.sum()
    top = np.cumsum(share)
    # one uniform a read picks its bin and its place in the bin, so that
    # a file's lengths are the first of a longer file's
    u = np.random.default_rng(rl["length_seed"]).random(n)
    k = np.minimum(np.searchsorted(top, u, side="right"), len(w) - 1)
    within = (u - (top[k] - share[k])) / share[k]
    span = hi[k] - lo[k] + 1
    return (lo[k] + np.minimum(np.floor(within * span), span - 1)).astype(
        np.int64)


def record_bytes(cfg: dict, n: int = 10 ** 5) -> float:
    """The mean size of a record in a file of n reads: the names' fixed
    text, the expected widths of their numbers, and the reads' mean
    length."""
    names = cfg["names"]
    _, name, fields = _name_format(names)
    first = names["first_read"]
    ylo, yhi = names["y_range"]
    climb = n * (yhi - ylo) / names["reads_per_tile"]
    ranges = {"n": (first, first + n - 1), "x": names["x_range"],
              "y": (ylo, int(min(yhi, ylo + climb)))}
    for f, width in fields:
        name += (max(width, len(str(names["tiles"][0]))) if f == "tile"
                 else _mean_width(*ranges[f], width))
    L = cfg["read_length"]
    if not isinstance(L, int):
        L = float(lengths(cfg, n).mean())
    return 1 + name + 1 + L + 3 + L + 1


def nreads(cfg: dict) -> int:
    """Reads in a file of the configured size (the same for every seed)."""
    n = 10 ** 5
    for _ in range(4):
        n = int(cfg["file_bytes"] // record_bytes(cfg, n))
    return n


_STEPS = 1 << 12          # a uniform draw's resolution: probabilities in 1/4096


def _steps(P: np.ndarray) -> np.ndarray:
    """(4, _STEPS) next code for each previous code and uniform step."""
    edges = np.rint(np.cumsum(P, axis=1) * _STEPS)[:, :3]
    u = np.arange(_STEPS)
    return (u[None, :, None] >= edges[:, None, :]).sum(2).astype(np.uint8)


def _chain(P: np.ndarray, draws: np.ndarray, first: np.ndarray) -> np.ndarray:
    """(rows, length) walks of the Markov chain with transition rows P
    (codes 0..3) from the codes first, taking steps from draws (length,
    rows) of uniform integers below _STEPS."""
    nxt = _steps(P).ravel()
    out = np.empty(draws.shape, np.uint8)
    out[0] = first
    for t in range(1, draws.shape[0]):
        out[t] = nxt[(out[t - 1].astype(np.int32) << 12) | draws[t]]
    return out.T


def _uniform(rng, shape) -> np.ndarray:
    return rng.integers(0, _STEPS, shape, dtype=np.uint16)


def _draw(rng, p: np.ndarray, shape) -> np.ndarray:
    """Codes 0..len(p)-1 drawn with the probabilities p."""
    edges = np.rint(np.cumsum(p) * _STEPS)[:-1]
    return np.searchsorted(edges, _uniform(rng, shape),
                           side="right").astype(np.uint8)


# a standard normal draw at the uniform's resolution (its quantiles)
_NORMAL = np.array([NormalDist().inv_cdf((k + 0.5) / _STEPS)
                    for k in range(_STEPS)], np.float32)


def _stationary(P: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eig(P.T)
    pi = np.real(v[:, np.argmin(abs(w - 1))])
    return pi / pi.sum()


def _families(bases: dict) -> list[tuple[np.ndarray, dict]]:
    """Each repeat family's consensus (codes 0..3), from the genome seed:
    a unit the configuration spells out, or a stretch of the chain."""
    P = np.array(bases["transitions"], float)
    rng = np.random.default_rng(bases["genome_seed"])
    out = []
    for fam in bases["families"]:
        if "unit" in fam:
            cons = np.searchsorted(_BASES, np.frombuffer(
                fam["unit"].encode(), np.uint8)).astype(np.uint8)
        else:
            m = fam["length"]
            first = rng.choice(4, p=_stationary(P))
            cons = _chain(P, _uniform(rng, (m, 1)), np.array([first]))[0]
        out.append((cons, fam))
    return out


def _bases(bases: dict, rng, n: int, L: int,
           lens: np.ndarray | None = None) -> np.ndarray:
    """(n, L) base codes 0..3: unique stretches and repeat copies.  With
    lens, read k is its row's first lens[k] codes, a copy fits the read's
    own length, and a read longer than its family's consensus holds the
    whole copy, then unique flank."""
    P = np.array(bases["transitions"], float)
    pi = _stationary(P)
    seq = _chain(P, _uniform(rng, (L, n)), _draw(rng, pi, n))
    fams = _families(bases)
    shares = np.array([f["share"] for _, f in fams])
    pick = rng.choice(len(fams) + 1, size=n,
                      p=np.append(shares, 1 - shares.sum()))
    for k, (cons, fam) in enumerate(fams):
        rows = np.flatnonzero(pick == k)
        m = len(cons)
        if fam.get("tandem"):
            start = rng.integers(0, m, len(rows))
        elif lens is None:
            start = rng.integers(0, m - L + 1, len(rows))
        else:
            start = rng.integers(0, np.maximum(m - lens[rows], 0) + 1)
        at = start[:, None] + np.arange(L)
        copy = cons[at % m]
        swap = _uniform(rng, copy.shape) < fam["divergence"] * _STEPS
        copy[swap] = _draw(rng, pi, int(swap.sum()))
        if lens is not None and not fam.get("tandem"):
            copy = np.where(at < m, copy, seq[rows])
        seq[rows] = copy
    flip = rng.random(n) < 0.5
    if lens is None:
        seq[flip] = 3 - seq[flip, ::-1]              # the other strand
    else:
        # each read's own stretch reversed: its code t is code lens - 1 - t
        back = lens[flip, None] - 1 - np.arange(L, dtype=np.int64)
        seq[flip] = 3 - np.take_along_axis(seq[flip], np.maximum(back, 0), 1)
    return seq


def _runs(codes: np.ndarray) -> np.ndarray:
    """(L, n): how many bases of a homopolymer each base of codes (n, L)
    follows (0 at a run's first base)."""
    run = np.zeros(codes.shape[::-1], np.int64)
    for t in range(1, codes.shape[1]):
        run[t] = np.where(codes[:, t] == codes[:, t - 1], run[t - 1] + 1, 0)
    return run


def _quals(q: dict, rng, n: int, L: int, lens: np.ndarray,
           codes: np.ndarray) -> np.ndarray:
    """(n, L) Phred values.  The mean and the noise's spread change along
    the cycles (fall_along "cycle", the default) or along each read's own
    length (fall_along "read"); the run's offsets stay with the cycles.
    With homopolymer_drop, a base k bases into a homopolymer of codes
    loses its k-th value (the last past the list's end), as in flow-based
    reads, whose calls within a run are least sure."""
    if q.get("fall_along", "cycle") == "read":
        pos = np.minimum(np.arange(L)[:, None]
                         / np.maximum(1, lens - 1)[None, :], 1.0)
    else:
        pos = np.arange(L) / max(1, L - 1)
    mean = q["start_mean"] + (q["end_mean"] - q["start_mean"]) * (
        pos ** q["fall_power"])
    offsets = np.random.default_rng(q["run_seed"]).normal(0.0, q["cycle_sd"],
                                                          L)
    mean += offsets.reshape((L,) + (1,) * (pos.ndim - 1))
    mean = mean.astype(np.float32)
    sd = (q["noise_sd"] + (q["noise_sd_end"] - q["noise_sd"]) * pos).astype(
        np.float32)
    level = q["read_sd"] * _NORMAL[_uniform(rng, n)]
    noise = _NORMAL[_uniform(rng, (L, n))]
    x = np.zeros(n, np.float32)
    for t in range(L):                   # noise carried from base to base
        x *= q["noise_carry"]
        x += sd[t] * noise[t]
        noise[t] = x + level + mean[t]
    if q.get("homopolymer_drop"):
        drop = np.array([0.0] + q["homopolymer_drop"], np.float32)
        noise -= drop[np.minimum(_runs(codes), len(drop) - 1)]
    dips = _uniform(rng, (L, n)) < q["dip_rate"] * _STEPS
    noise[dips] = rng.integers(q["dip_range"][0], q["dip_range"][1] + 1,
                               int(dips.sum()))
    np.rint(noise, out=noise)
    np.clip(noise, q["phred_min"], q["phred_max"], out=noise)
    qual = noise.astype(np.uint8).T.copy()
    tail = rng.random(n) < q["tail_share"]
    start = rng.integers(q["tail_start"][0], q["tail_start"][1] + 1, n)
    qual[tail[:, None] & (np.arange(L) >= start[:, None])] = q["tail_phred"]
    return qual


def _names(names: dict, rng, n: int) -> list[bytes]:
    x = rng.integers(names["x_range"][0], names["x_range"][1] + 1, n)
    # clusters come off a tile in rows: y climbs by a fraction a read
    per_tile = names["reads_per_tile"]
    ny = names["y_range"][1] - names["y_range"][0]
    y = names["y_range"][0] + np.minimum(
        np.cumsum(rng.poisson(ny / per_tile, n)) % (ny + 1), ny)
    tiles = np.array(names["tiles"])[(np.arange(n) // per_tile)
                                     % len(names["tiles"])]
    fmt, _, fields = _name_format(names)
    fmt = fmt.encode()
    cols = {"n": range(names["first_read"], names["first_read"] + n),
            "tile": tiles.tolist(), "x": x.tolist(), "y": y.tolist()}
    return [fmt % v for v in zip(*(cols[f] for f, _ in fields))]


def reads(cfg: dict, seed: int, n: int | None = None) -> Reads:
    """The reads of a file of this configuration, drawn from seed (the
    first n of them, where n is given).  Reads of varying length are
    drawn as planes as wide as the longest, each cut to its length."""
    n = nreads(cfg) if n is None else n
    rng = np.random.default_rng(seed)
    lens = lengths(cfg, n)
    fixed = isinstance(cfg["read_length"], int)
    L = cfg["read_length"] if fixed else int(lens.max(initial=0))
    codes = _bases(cfg["bases"], rng, n, L, None if fixed else lens)
    qual = _quals(cfg["quality"], rng, n, L, lens, codes) + 33
    return Reads(_names(cfg["names"], rng, n), _BASES[codes], qual, lens)


def fastq(r: Reads, n: int | None = None) -> bytes:
    """The FASTQ text of the first n reads (all by default)."""
    n = len(r) if n is None else n
    seq, qual = r.seq, r.qual
    return b"".join(b"@%s\n%s\n+\n%s\n" % (r.names[k], seq[k, :m].tobytes(),
                                            qual[k, :m].tobytes())
                    for k, m in enumerate(r.lens[:n].tolist()))
