"""Site k-mer table construction from an interleaved site FASTA
(counterpart of ntsm_tpu/io/sites.py).

The site FASTA alternates a REF(AT) entry and a VAR(CG) entry per SNP site
(entries may hold several 'N'-separated k-mers).  The reference loads it
into a robin_map hash table keyed by canonical hash, records per-allele
k-mer lists, warns on cross-entry duplicate k-mers and (unless -d) removes
them (reference: src/FingerPrint.hpp:490-564).

Duplicate semantics replicated here:

* the FIRST occurrence of a k-mer claims it (joins that allele's list);
* later occurrences trigger the reference's exact warning text and mark
  the hash as a dupe;
* without ``dupes``: the hash is dropped from the lookup table.  NB the
  reference additionally leaves a dangling hash in the first allele's list,
  which makes its count printer throw (FingerPrint.hpp:275,282 calls .at()
  on an erased key) — i.e. the reference crashes on real duplicate input
  unless -d is given.  We instead drop the k-mer from the first allele's
  list too, which changes the distinct column only in inputs where the
  reference cannot run at all.
* with ``dupes``: the hash stays and only the first allele's list holds it,
  so a shared k-mer's counts are attributed to the first site that used it.

The result is a :class:`SiteTable` of dense arrays: hash list in insertion
order and per-k-mer site + allele indices.  The device probe planes are
built from the hash list by count/kernel_v3.TableV3.from_hashes;
:func:`build_lookup` is their host (numpy) reference layout (the hash is
already uniform, so its low bits are the bucket address).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np

from ntsm_tpu_torch.io.fastx import read_fastx

EMPTY_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


@dataclass
class LookupTable:
    """Bucketed open-addressing table: bucket = hash & (n_buckets-1)."""

    keys: np.ndarray  # [n_buckets, slots] uint64, EMPTY_KEY where unused
    vals: np.ndarray  # [n_buckets, slots] int32 k-mer index (miss slot = n)
    n_buckets: int
    slots: int


@dataclass
class SiteTable:
    site_ids: list  # [n_sites] locus names
    kmer_hashes: np.ndarray  # [n_kmers] uint64, insertion order
    kmer_site: np.ndarray  # [n_kmers] int32
    kmer_allele: np.ndarray  # [n_kmers] uint8 (0 = REF/AT, 1 = VAR/CG)
    distinct: np.ndarray  # [n_sites, 2] int64 k-mers per allele
    k: int

    @property
    def n_sites(self) -> int:
        return len(self.site_ids)

    @property
    def n_kmers(self) -> int:
        return int(self.kmer_hashes.shape[0])


def size_buckets(hashes: np.ndarray, slots: int) -> int:
    """Bucket sizing shared by the host and device table builders: the
    smallest power-of-two bucket count >= 2n/slots where no bucket holds
    more than `slots` entries.  Parity-critical — build_lookup and
    kernel_v3.TableV3.from_hashes must agree on this decision."""
    n = int(hashes.shape[0])
    n_buckets = 1
    target = max(2 * n, 16)
    while n_buckets * slots < target:
        n_buckets *= 2
    while True:
        bucket = (hashes & np.uint64(n_buckets - 1)).astype(np.int64)
        if np.bincount(bucket, minlength=n_buckets).max(initial=0) <= slots:
            return n_buckets
        n_buckets *= 2


def build_lookup(hashes: np.ndarray, slots: int = 8) -> LookupTable:
    """Build the bucketed lookup table on the host (numpy)."""
    n = int(hashes.shape[0])
    n_buckets = size_buckets(hashes, slots)
    bucket = (hashes & np.uint64(n_buckets - 1)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    counts = np.bincount(sb, minlength=n_buckets)
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    within = np.arange(n) - starts[sb]
    keys = np.full((n_buckets, slots), EMPTY_KEY, dtype=np.uint64)
    vals = np.full((n_buckets, slots), n, dtype=np.int32)
    keys[sb, within] = hashes[order]
    vals[sb, within] = order.astype(np.int32)
    return LookupTable(keys=keys, vals=vals, n_buckets=n_buckets, slots=slots)


def load_site_table(path: str, k: int, allow_dupes: bool, err=sys.stderr) -> SiteTable:
    """Load the interleaved site FASTA (REF entry then VAR entry per site,
    FingerPrint.hpp:509-554) into a SiteTable.

    Vectorized: all entries are encoded as one flat stream joined by a
    single invalid byte (any window crossing an entry boundary contains it
    and is masked), hashed in one pass, and duplicate k-mers are detected
    with a stream-ordered unique — 43 s -> ~2 s for the 96287-site human
    set. Warning text/order and erase semantics match the per-entry loop
    (FingerPrint.hpp:521-527,541-549,557-563) exactly.
    """
    from ntsm_tpu_torch.core.encode import encode_bytes
    from ntsm_tpu_torch.core.kmers import flat_window_hashes

    recs = list(read_fastx(path))
    if len(recs) % 2 != 0:
        raise ValueError(f"{path}: interleaved site FASTA has an odd entry count")
    site_ids = [recs[i].name for i in range(0, len(recs), 2)]

    if recs:
        lens = np.array([len(r.seq) for r in recs], dtype=np.int64)
        starts = np.zeros(len(recs), dtype=np.int64)
        np.cumsum(lens[:-1] + 1, out=starts[1:])  # +1 for the separator
        codes = encode_bytes(b"N".join(r.seq for r in recs))
        h, valid = flat_window_hashes(codes, k)
        wpos = np.nonzero(valid)[0]
        hh = h[valid]
        entry = (np.searchsorted(starts, wpos, side="right") - 1).astype(np.int64)
    else:
        hh = np.zeros(0, dtype=np.uint64)
        entry = np.zeros(0, dtype=np.int64)
        wpos = np.zeros(0, dtype=np.int64)
        starts = np.zeros(0, dtype=np.int64)

    u, first_idx, inv, ucounts = np.unique(
        hh, return_index=True, return_inverse=True, return_counts=True
    )
    is_first = np.arange(hh.shape[0]) == first_idx[inv]
    for j in np.nonzero(~is_first)[0]:
        e = int(entry[j])
        kind = "REF" if e % 2 == 0 else "VAR"
        pos = int(wpos[j] - starts[e]) + k
        # exact warning text: FingerPrint.hpp:521-523,542-544
        print(
            f"Warning: {recs[e].name} of {kind} file has a k-mer "
            f"collision at pos: {pos}",
            file=err,
        )

    keep = is_first
    if not allow_dupes:
        dup_hashes = u[ucounts > 1]
        if dup_hashes.size:
            keep = keep & ~np.isin(hh, dup_hashes)

    kmer_hashes = hh[keep]
    kmer_site = (entry[keep] // 2).astype(np.int32)
    kmer_allele = (entry[keep] % 2).astype(np.uint8)

    n_sites = len(site_ids)
    distinct = np.zeros((n_sites, 2), dtype=np.int64)
    if kmer_hashes.shape[0]:
        np.add.at(distinct, (kmer_site, kmer_allele.astype(np.int64)), 1)

    return SiteTable(
        site_ids=site_ids,
        kmer_hashes=kmer_hashes,
        kmer_site=kmer_site,
        kmer_allele=kmer_allele,
        distinct=distinct,
        k=k,
    )
