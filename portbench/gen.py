"""Input generators of the benchmark, all drawn from the run's seed.

Copies of the generators the repository's card smoke test uses for the
same shapes (its site FASTA, read, cohort and rotation makers), kept here
so that a later change to the program cannot change the yardstick.  They
import nothing of the program.

* :func:`site_windows`, :func:`write_sites`: a human-sized site set, one
  A/T <-> C/G SNP a site, each allele as its window's k-mers joined by N
  (the layout of ntsmSiteGen's interleaved REF/VAR FASTA);
* :func:`make_reads`, :func:`write_fastq`: whole-genome-like reads (a
  small share carry a site allele's window), substitution errors, Ns,
  reverse complements, Casava 1.8 headers and Phred+33 qualities;
* :func:`make_cohort`: a cohort's [N, L, 2] allele max counts drawn on the
  card (Poisson coverage, cross-talk, a planted swap and duplicates, and
  for -p a 16-cluster spread with dirty samples);
* :func:`rotation`, :func:`write_pca_artifacts`: a -p rotation TSV and its
  center file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

LETTERS = np.frombuffer(b"ACGTN", dtype=np.uint8)
COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator for one input of the run."""
    return np.random.default_rng([int(seed), stream])


def site_windows(rng, n_sites: int, window: int, k: int):
    """(at_win, cg_win) [n_sites, window] u8 codes: per site a random
    window whose middle base is the SNP, A/T in one allele and C/G in the
    other."""
    win = rng.integers(0, 4, size=(n_sites, window), dtype=np.uint8)
    half = window // 2
    ref = win[:, half]
    at_ref = (ref == 0) | (ref == 3)
    var = np.where(at_ref, rng.integers(1, 3, n_sites), 3 * rng.integers(0, 2, n_sites))
    at_win, cg_win = win.copy(), win.copy()
    at_win[:, half] = np.where(at_ref, ref, var)
    cg_win[:, half] = np.where(at_ref, var, ref)
    return at_win, cg_win


def site_names(n_sites: int) -> list:
    return [f"rs{100000 + i}" for i in range(n_sites)]


def write_sites(path: str, at_win: np.ndarray, cg_win: np.ndarray, k: int) -> None:
    """The interleaved REF/VAR site FASTA: per site the A/T allele's entry
    then the C/G allele's, each its window's window - k + 1 k-mers joined
    by 'N'."""
    n_sites, window = at_win.shape
    n_sub = window - k + 1

    def entries(w):
        e = np.full((n_sites, n_sub * (k + 1) - 1), 4, dtype=np.uint8)
        for p in range(n_sub):
            e[:, p * (k + 1): p * (k + 1) + k] = w[:, p: p + k]
        return LETTERS[e]

    at_e, cg_e = entries(at_win), entries(cg_win)
    with open(path, "wb") as fh:
        fh.write(b"".join(
            b">rs%d ref\n%s\n>rs%d var\n%s\n"
            % (100000 + i, at_e[i].tobytes(), 100000 + i, cg_e[i].tobytes())
            for i in range(n_sites)
        ))


def _scatter(rng, shape, rate: float) -> np.ndarray:
    """Flat indices of a Binomial(size, rate) share of the cells of
    `shape`, drawn without a [shape] float array."""
    size = int(np.prod(shape))
    n = int(rng.binomial(size, rate))
    return rng.integers(0, size, n)


def make_reads(rng, at_win, cg_win, n_reads: int, read_len: int, carry: float,
               sub_rate: float, n_rate: float, rc_share: float) -> np.ndarray:
    """[n_reads, read_len] u8 codes (4 = N): random bases, a `carry` share
    of reads holding one random site allele's window at a random offset,
    then substitutions at `sub_rate`, Ns at `n_rate` and a `rc_share` of
    reads reverse-complemented."""
    n_sites, window = at_win.shape
    reads = rng.integers(0, 4, size=(n_reads, read_len), dtype=np.uint8)
    carriers = np.flatnonzero(rng.random(n_reads) < carry)
    site = rng.integers(0, n_sites, carriers.size)
    wins = np.where(rng.integers(0, 2, carriers.size)[:, None] == 0, at_win[site], cg_win[site])
    off = rng.integers(0, read_len - window + 1, carriers.size)
    reads[carriers[:, None], off[:, None] + np.arange(window)] = wins
    flat = reads.reshape(-1)
    sub = _scatter(rng, reads.shape, sub_rate)
    flat[sub] = (flat[sub] + rng.integers(1, 4, sub.size, dtype=np.uint8)) % 4
    flat[_scatter(rng, reads.shape, n_rate)] = 4
    rc = np.flatnonzero(rng.random(n_reads) < rc_share)
    reads[rc] = COMP[reads[rc, ::-1]]
    return reads


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """[n, width] ASCII digits of values, zero-padded."""
    return (values[:, None] // 10 ** np.arange(width - 1, -1, -1) % 10 + ord("0")).astype(np.uint8)


def write_fastq(path: str, rng, reads: np.ndarray, mate: int, q_lo: int, q_hi: int) -> int:
    """FASTQ of `reads` with Casava 1.8 headers
    (@A00217:77:HFLWKDSXX:<lane>:<tile>:<x>:<y> <mate>:N:0:<index>, 54
    bytes) and Phred+33 qualities uniform in [q_lo, q_hi]; returns the
    bytes written."""
    n, read_len = reads.shape
    head = b"@A00217:77:HFLWKDSXX:"
    index = b" %d:N:0:CGATGTTT" % mate
    lane = rng.integers(1, 5, n)
    tile = rng.integers(1101, 2679, n)
    x = rng.integers(1000, 32000, n)
    y = rng.integers(1000, 38000, n)
    body = [np.frombuffer(head, np.uint8)[None, :].repeat(n, 0), _digits(lane, 1),
            np.full((n, 1), ord(":"), np.uint8), _digits(tile, 4),
            np.full((n, 1), ord(":"), np.uint8), _digits(x, 5),
            np.full((n, 1), ord(":"), np.uint8), _digits(y, 5),
            np.frombuffer(index + b"\n", np.uint8)[None, :].repeat(n, 0),
            LETTERS[reads], np.frombuffer(b"\n+\n", np.uint8)[None, :].repeat(n, 0),
            rng.integers(33 + q_lo, 33 + q_hi + 1, size=(n, read_len), dtype=np.uint8),
            np.full((n, 1), ord("\n"), np.uint8)]
    rec = np.concatenate(body, axis=1)
    rec.tofile(path)
    return int(rec.size)


def make_cohort(device, seed: int, n_samples: int, n_sites: int, cov_lo: float,
                cov_hi: float, crosstalk: float, dup_share: float, rotation=None,
                clusters: int = 16, cluster_step: float = 0.04, dirty_every: int = 0,
                dirty_share: float = 0.0):
    """([n_samples, n_sites, 2] int32 max counts, [D, 2] duplicate pairs).

    Per-site allele frequencies in [0.05, 0.95], diploid genotypes,
    Poisson counts around a coverage uniform in [cov_lo, cov_hi] with a
    `crosstalk` share of error reads; sample 1 has sample 0's genotypes (a
    swap) and a `dup_share` of the other samples each have an earlier
    sample's genotypes (re-sequenced duplicates).  With a `rotation`
    [n_sites, >= 2]: sample s belongs to cluster s % clusters, whose
    frequencies shift by cluster_step a grid step along the signs of the
    rotation's first two components (clipped to [0.02, 0.98]), and every
    dirty_every-th sample loses a dirty_share of its sites.  Drawn on
    `device` from a seeded torch generator."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))

    def u(*shape):
        return torch.rand(shape, generator=g, device=device, dtype=torch.float64)

    freq = 0.05 + 0.9 * u(n_sites)
    deltas = None
    if rotation is not None:
        side = int(np.ceil(np.sqrt(clusters)))
        s0_, s1_ = (torch.from_numpy(np.sign(rotation[:, c])).to(device) for c in (0, 1))
        deltas = torch.stack([
            cluster_step * ((c % side - (side - 1) / 2) * s0_ + (c // side - (side - 1) / 2) * s1_)
            for c in range(clusters)
        ])
    # duplicate pairs (src < dst): the swap (0, 1), then dup_share of the rest
    pick = np.random.default_rng([int(seed), 99])
    n_dup = int(round(dup_share * n_samples))
    dst = np.sort(pick.choice(np.arange(2, n_samples), size=n_dup, replace=False))
    src = np.array([pick.integers(0, d) for d in dst], dtype=np.int64)
    pairs = np.concatenate([[[0, 1]], np.stack([src, dst], axis=1)]).astype(np.int64)
    geno = torch.empty((n_samples, n_sites), dtype=torch.uint8, device=device)
    step = 256
    for s0 in range(0, n_samples, step):
        m = min(step, n_samples - s0)
        rows = torch.arange(s0, s0 + m, device=device)
        fs = freq.expand(m, n_sites)
        if deltas is not None:
            fs = torch.clamp(freq + deltas[rows % clusters], 0.02, 0.98)
        geno[s0: s0 + m] = ((u(m, n_sites) < fs).to(torch.uint8)
                            + (u(m, n_sites) < fs).to(torch.uint8))
    for s, d in pairs:  # ascending dst: a chain copies the original
        geno[d] = geno[s]
    out = torch.empty((n_samples, n_sites, 2), dtype=torch.int32, device=device)
    for s0 in range(0, n_samples, step):
        m = min(step, n_samples - s0)
        rows = torch.arange(s0, s0 + m, device=device)
        gm = geno[s0: s0 + m].double()
        lam = (cov_lo + (cov_hi - cov_lo) * u(m, 1)) / 2.0
        err = (crosstalk * lam).expand(m, n_sites)
        at = torch.poisson(lam * (2 - gm), generator=g) + torch.poisson(err, generator=g)
        cg = torch.poisson(lam * gm, generator=g) + torch.poisson(err, generator=g)
        if dirty_every:
            dirty = ((rows % dirty_every) == dirty_every - 1)[:, None] & (u(m, n_sites) < dirty_share)
            at[dirty] = 0
            cg[dirty] = 0
        out[s0: s0 + m] = torch.stack([at, cg], dim=2).to(torch.int32)
    return out.cpu().numpy(), pairs


def rotation(seed: int, n_sites: int, n_pcs: int, scale: float):
    """([n_sites, n_pcs] rotation, [n_sites] centers): components normal(0,
    scale), centers uniform in [0, 1)."""
    rng = rng_for(seed, 7)
    return rng.normal(0, scale, size=(n_sites, n_pcs)), rng.uniform(0, 1, n_sites)


def write_pca_artifacts(work: str, rot: np.ndarray, centers: np.ndarray) -> tuple:
    """rot.tsv (a header, then a site id and its components a line, %.8f)
    and norm.txt (one %.6f center a line), as the reference's rotation and
    center files; returns their paths and the values as written."""
    rot_path, norm_path = os.path.join(work, "rot.tsv"), os.path.join(work, "norm.txt")
    rot_txt = np.char.mod("%.8f", rot)
    cen_txt = np.char.mod("%.6f", centers)
    with open(norm_path, "w") as fh:
        fh.write("\n".join(cen_txt.tolist()) + "\n")
    names = site_names(rot.shape[0])
    with open(rot_path, "w") as fh:
        fh.write("AlleleID\t" + "\t".join(f"PC{i}" for i in range(rot.shape[1])) + "\n")
        fh.write("".join(n + "\t" + "\t".join(r) + "\n" for n, r in zip(names, rot_txt.tolist())))
    return rot_path, norm_path, rot_txt.astype(np.float64), cen_txt.astype(np.float64)
