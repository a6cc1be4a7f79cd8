"""Offline site-set generation (`ntsm sitegen`; counterpart of
ntsm_tpu/sitegen/pipeline.py, on the host as there).

Replaces the reference's make+python+perl+bwa pipeline (ntsmSiteGen,
ntsm-scripts/makefile:32-34,91-114) with one self-contained Python module:

1. **SNP window extraction** (extractSNPsfromVCF.py semantics): per VCF
   SNP, take a `window`-bp region centered on the site, build REF and VAR
   window strings, keep only A/T <-> C/G conversions by default
   (extractSNPsfromVCF.py:52-62,113-114), drop sites whose reference base
   disagrees with the genome, and collect each window's `window-k+1`
   sub-k-mers.  Sub-k-mers whose canonical encoding occurs more than once
   within the whole candidate pool are dropped (in-memory dedup,
   :24-50,118-120).

2. **Genome-uniqueness filter**: the reference maps every sub-k-mer back to
   the genome with `bwa aln -n 1` and keeps those with X0+X1 == 1
   (makefile:100-104, filterRepetiveSNP.pl:35-54).  We replace the external
   aligner with an exact canonical k-mer scan of the genome (vectorized
   numpy, chunked), optionally extended with the 1-mismatch neighborhood to
   approximate `-n 1`.  A k-mer passes if its (neighborhood) genome
   occurrence count is exactly 1.

3. **Tier assembly** (filterRepetiveSNP.pl:81-113): per site and allele the
   retained sub-k-mers are joined with 'N' separators; site tier n = max
   number of *missing* sub-k-mers on either allele; `{name}_n{i}.fa` holds
   all sites with tier <= i, for i in 0..window-k.

4. **PCA training** (makefile:110-114, convertTSVtoPCA.py): the multi-VCF
   is converted to the genotype-fraction matrix (`vcf/convert.py`), read
   back from its file and fitted over samples with the exact SVD that
   sklearn's `PCA(svd_solver="full")` runs, in numpy/scipy (no pandas or
   sklearn); writes `{name}_rotationalMatrix.tsv` and
   `{name}_components.tsv` in the pandas/sklearn layout the eval CLI
   consumes.
"""

from __future__ import annotations

import sys
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ntsm_tpu_torch.core.encode import encode_bytes
from ntsm_tpu_torch.core.hash import kmer_mask
from ntsm_tpu_torch.core.kmers import window_encodings
from ntsm_tpu_torch.io.fastx import read_fastx

AT = set(b"AT")
CG = set(b"CG")


def canonical_codes(seq: bytes, k: int) -> np.ndarray:
    """Canonical 2-bit encodings (NOT hashed) of every valid k-mer."""
    codes = encode_bytes(seq)
    fw, rv, valid = window_encodings(codes, k)
    return np.minimum(fw, rv)[valid]


@dataclass
class SiteCandidate:
    snp_id: str
    chrom: str
    pos: int  # 1-based
    at_win: bytes
    cg_win: bytes
    # retained sub-k-mers per allele, in position order
    at_kmers: list = field(default_factory=list)
    cg_kmers: list = field(default_factory=list)


def extract_candidates(
    vcf_path: str,
    ref_path: str,
    window: int = 31,
    k: int = 19,
    require_at_cg: bool = True,
    err=sys.stderr,
):
    """Stage 1: windows + in-pool-unique sub-k-mers per site."""
    genome = {rec.name: rec.seq.upper() for rec in read_fastx(ref_path)}
    half = window // 2

    entries = []
    id_counter = 0
    with open(vcf_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 5:
                continue
            snp_id = f[2]
            if snp_id == ".":
                snp_id = str(id_counter)
                id_counter += 1
            if len(f[4]) > 1:
                print("Error: Multiple alternate alleles found in VCF", file=err)
                raise SystemExit(1)
            entries.append((snp_id, f[0], int(f[1]), f[3].encode(), f[4].encode()))

    pool = Counter()
    sites: list[SiteCandidate] = []
    removed = 0
    at_cg_filtered = 0
    for snp_id, chrom, pos, wt, var in entries:
        seq = genome.get(chrom)
        if seq is None:
            removed += 1
            continue
        off = pos - 1 - half
        if off < 0 or off + window > len(seq):
            removed += 1
            continue
        win = seq[off : off + window]
        if win[half : half + 1] != wt:
            print("Wildtype allele does not match", file=err)
            removed += 1
            continue
        same_group = (wt[0] in AT and var[0] in AT) or (wt[0] in CG and var[0] in CG)
        if same_group and require_at_cg:
            removed += 1
            at_cg_filtered += 1
            continue
        var_win = win[:half] + var + win[half + 1 :]
        at_win, cg_win = (win, var_win) if wt[0] in AT else (var_win, win)
        sites.append(SiteCandidate(snp_id, chrom, pos, at_win, cg_win))
        for s in (win, var_win):
            for c in canonical_codes(s, k):
                pool[int(c)] += 1

    dup_removed = 0
    for site in sites:
        for win, dest in ((site.at_win, site.at_kmers), (site.cg_win, site.cg_kmers)):
            n_sub = window - k + 1
            cc = canonical_codes(win, k)
            # windows are clean ACGT so every position is valid
            for p in range(n_sub):
                kmer = win[p : p + k]
                if pool[int(cc[p])] == 1:
                    dest.append((p, kmer))
                else:
                    dup_removed += 1
    print(
        f"Processed {len(sites)} SNPs. Removed {removed} SNPs. "
        f"{dup_removed} duplicate k-mers removed.",
        file=err,
    )
    if at_cg_filtered:
        print(
            f"Filtered {at_cg_filtered} SNPs that did not have A/T to C/G variants",
            file=err,
        )
    return sites


def genome_kmer_counts(ref_path: str, candidates: np.ndarray, k: int) -> np.ndarray:
    """Occurrences of each candidate canonical encoding in the genome.

    Streamed per chromosome, vectorized searchsorted against the sorted
    candidate set — the self-contained replacement for the bwa mapping
    stage (exact matches; see filter_unique for 1-mismatch extension).
    """
    order = np.argsort(candidates)
    sorted_c = candidates[order]
    counts = np.zeros(candidates.shape[0], dtype=np.int64)
    for rec in read_fastx(ref_path):
        cc = canonical_codes(rec.seq.upper(), k)
        if cc.shape[0] == 0:
            continue
        pos = np.searchsorted(sorted_c, cc)
        pos = np.minimum(pos, sorted_c.shape[0] - 1)
        hit = sorted_c[pos] == cc
        np.add.at(counts, order[pos[hit]], 1)
    return counts


def one_mismatch_neighbors(kmer: bytes, k: int) -> np.ndarray:
    """Canonical encodings of the 3k single-base substitutions.

    Deduplicated, and excluding the k-mer's own canonical code: bwa
    counts alignment LOCI (filterRepetiveSNP.pl:35-45 keys on X0+X1),
    so a genome locus must count once even when two substitutions
    canonicalize to the same code (near-rc-symmetric k-mers) or a
    substitution canonicalizes back onto the k-mer itself (its exact
    occurrences are already counted by the exact pass)."""
    base = encode_bytes(kmer).astype(np.int64)
    neigh = []
    mask = kmer_mask(k)
    fw0 = 0
    rv0 = 0
    for j in range(k):
        fw0 = (fw0 << 2) | int(base[j])
        rv0 |= (3 ^ int(base[j])) << (2 * j)
    self_code = min(fw0 & int(mask), rv0 & int(mask))
    for p in range(k):
        for b in range(4):
            if b == base[p]:
                continue
            codes = base.copy()
            codes[p] = b
            fw = 0
            rv = 0
            for j in range(k):
                fw = (fw << 2) | int(codes[j])
                rv |= (3 ^ int(codes[j])) << (2 * j)
            neigh.append(min(fw & int(mask), rv & int(mask)))
    out = np.unique(np.array(neigh, dtype=np.uint64))
    return out[out != np.uint64(self_code)]


def _canon_of_codes(codes, klen: int) -> int:
    """Canonical 2-bit encoding of a base-code sequence of length klen."""
    mask = int(kmer_mask(klen))
    fw = 0
    rv = 0
    for j in range(klen):
        fw = (fw << 2) | int(codes[j])
        rv |= (3 ^ int(codes[j])) << (2 * j)
    return min(fw & mask, rv & mask)


def indel_neighbors(kmer: bytes, k: int):
    """Canonical encodings of the edit-distance-1 indel neighborhood.

    Returns (del_codes, ins_codes): the deduped canonical codes of the k
    length-(k-1) single-deletion patterns and the 4(k+1) length-(k+1)
    single-insertion patterns.  A genome occurrence of a deletion pattern
    is a locus aligning to the k-mer with one genome-side deletion; an
    insertion pattern occurrence aligns with one genome-side insertion —
    together with the substitution neighborhood this is bwa `aln -n 1`'s
    full edit-distance-1 reach (ntsm-scripts/makefile:100-104)."""
    base = encode_bytes(kmer).astype(np.int64)
    dels = {
        _canon_of_codes(np.delete(base, p), k - 1) for p in range(k)
    }
    inss = set()
    for p in range(k + 1):
        for b in range(4):
            inss.add(_canon_of_codes(np.insert(base, p, b), k + 1))
    return (
        np.array(sorted(dels), dtype=np.uint64),
        np.array(sorted(inss), dtype=np.uint64),
    )


_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)


def _revcomp_batch(x: np.ndarray, klen: int) -> np.ndarray:
    """Reverse-complement of [*] u64 2-bit encodings, vectorized: reverse
    the 2-bit groups (pair swap, nibble swap, byte swap), right-align to
    2·klen bits, complement.  Matches the rv accumulation of
    _canon_of_codes bit for bit (unit-pinned in tests)."""
    v = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    v = ((v >> np.uint64(4)) & _M4) | ((v & _M4) << np.uint64(4))
    v = v.byteswap()
    v >>= np.uint64(64 - 2 * klen)
    return v ^ np.uint64(kmer_mask(klen))


def _sub_neighbor_block(fw: np.ndarray, rv: np.ndarray, k: int) -> np.ndarray:
    """[m] fw/rv encodings -> [m, 3k] canonical substitution neighbors.

    A substitution of delta d (= old_code ^ new_code) at position p flips
    bits 2(k-1-p) of fw and 2p of rv (the complement of a delta is the
    same delta), so each neighbor costs three vector ops instead of a
    Python re-encode — the per-k-mer form (one_mismatch_neighbors) is the
    oracle this is tested against."""
    m = fw.shape[0]
    out = np.empty((m, 3 * k), np.uint64)
    col = 0
    for p in range(k):
        sf = np.uint64(2 * (k - 1 - p))
        sr = np.uint64(2 * p)
        for d in (1, 2, 3):
            nf = fw ^ (np.uint64(d) << sf)
            nr = rv ^ (np.uint64(d) << sr)
            np.minimum(nf, nr, out=out[:, col])
            col += 1
    return out


def _del_neighbor_block(fw: np.ndarray, k: int) -> np.ndarray:
    """[m] fw encodings -> [m, k] canonical single-deletion (k-1)-mers."""
    m = fw.shape[0]
    out = np.empty((m, k), np.uint64)
    for p in range(k):
        low = fw & np.uint64((1 << (2 * (k - 1 - p))) - 1)
        high = (fw >> np.uint64(2 * (k - p))) << np.uint64(2 * (k - 1 - p))
        d = high | low
        np.minimum(d, _revcomp_batch(d, k - 1), out=out[:, p])
    return out


def _ins_neighbor_block(fw: np.ndarray, k: int) -> np.ndarray:
    """[m] fw encodings -> [m, 4(k+1)] canonical single-insertion
    (k+1)-mers."""
    m = fw.shape[0]
    out = np.empty((m, 4 * (k + 1)), np.uint64)
    col = 0
    for p in range(k + 1):
        low = fw & np.uint64((1 << (2 * (k - p))) - 1)
        high = (fw >> np.uint64(2 * (k - p))) << np.uint64(2 * (k - p + 1))
        for b in range(4):
            v = high | (np.uint64(b) << np.uint64(2 * (k - p))) | low
            np.minimum(v, _revcomp_batch(v, k + 1), out=out[:, col])
            col += 1
    return out


def _row_dedup_mask(blk: np.ndarray) -> np.ndarray:
    """Sort each row of blk IN PLACE and return the first-occurrence
    mask (the per-row set semantics of the per-k-mer oracles)."""
    blk.sort(axis=1)
    mask = np.ones(blk.shape, bool)
    mask[:, 1:] = blk[:, 1:] != blk[:, :-1]
    return mask


def _lookup_counts(sorted_codes, counts, q):
    """counts for each code in q ([m, W]) against the sorted global
    table; absent codes count 0."""
    pos = np.searchsorted(sorted_codes, q.ravel())
    np.minimum(pos, sorted_codes.shape[0] - 1, out=pos)
    c = counts[pos]
    c[sorted_codes[pos] != q.ravel()] = 0
    return c.reshape(q.shape)


_SLAB = 1 << 18  # k-mers per vectorized neighbor slab (~bounds scratch)


def filter_unique(
    sites: list[SiteCandidate],
    ref_path: str,
    k: int,
    mismatch: bool = True,
    indel: bool = True,
    err=sys.stderr,
):
    """Stage 2: drop sub-k-mers that are not genome-unique.

    The reference keeps a sub-k-mer when `bwa aln -n 1` reports exactly one
    hit within edit distance 1 (X0+X1 == 1, filterRepetiveSNP.pl:35-54) —
    this is essential for VARIANT k-mers, which have zero exact genome hits
    and exactly one 1-mismatch hit (the reference allele's locus).  With
    mismatch=True (default) we count exact + single-substitution neighbor
    LOCI (deduped canonical neighborhood, validated against a brute-force
    string oracle in tests/test_sitegen_uniqueness.py); with indel=True
    (default) the edit-distance-1 reach is completed with the length-(k∓1)
    single-deletion/insertion patterns, so a k-mer whose only extra genome
    hit is via one indel is dropped exactly as bwa drops it.  The total
    locus count must be exactly 1.

    Self-overlap correction: every exact occurrence of the k-mer itself
    contains its own (k-1) prefix/suffix deletion patterns and extends to
    two flanking (k+1) insertion patterns — those are the SAME locus, not
    extra hits, so 2·exact is subtracted from each indel category
    (clamped at 0 for chromosome-boundary occurrences whose flanking
    insertion pattern does not exist).  Remaining divergence from bwa is
    the locus bookkeeping of multiply-reachable repeats (e.g. a
    substitution hit whose edge deletion pattern also matches inflates an
    already-repetitive count) — never flips a unique verdict.

    mismatch=False counts only exact occurrences (stricter on REF,
    unusable for VAR — kept for diagnostics) and implies no indel pass."""
    all_kmers = []
    for site in sites:
        for _, kmer in site.at_kmers + site.cg_kmers:
            all_kmers.append(kmer)
    if not all_kmers:
        return
    uniq_kmers = sorted(set(all_kmers))
    M = len(uniq_kmers)
    # fw/rv encodings of every unique sub-k-mer at once (the windows are
    # clean ACGT, so every code is valid)
    base = encode_bytes(b"".join(uniq_kmers)).reshape(M, k)
    fw = np.zeros(M, np.uint64)
    for j in range(k):
        fw = (fw << np.uint64(2)) | base[:, j].astype(np.uint64)
    rv = _revcomp_batch(fw, k)
    self_canon = np.minimum(fw, rv)

    cand = np.unique(self_canon)
    counts = genome_kmer_counts(ref_path, cand, k)
    exact = counts[np.searchsorted(cand, self_canon)].astype(np.int64)
    total = exact.copy()

    # The neighborhoods are generated twice (collect-unique pass, then
    # count pass) in _SLAB-bounded batches: regeneration is ~vector ops,
    # while retaining [M, 3k..4(k+1)] u64 arrays would be GBs of fresh
    # pages (slow on this VM) — the per-k-mer set/dict form of round 3
    # was ~hours at the 96,287-site scale.
    def _sweep(block_fn, klen, exclude_self):
        parts = [
            np.unique(block_fn(s0))
            for s0 in range(0, M, _SLAB)
        ]
        allc = np.unique(np.concatenate(parts))
        ccounts = genome_kmer_counts(ref_path, allc, klen)
        sums = np.empty(M, np.int64)
        for s0 in range(0, M, _SLAB):
            s1 = min(s0 + _SLAB, M)
            blk = block_fn(s0)
            mask = _row_dedup_mask(blk)
            if exclude_self:
                mask &= blk != self_canon[s0:s1, None]
            c = _lookup_counts(allc, ccounts, blk)
            c *= mask
            sums[s0:s1] = c.sum(axis=1)
        return sums

    if mismatch:
        total += _sweep(
            lambda s0: _sub_neighbor_block(
                fw[s0 : s0 + _SLAB], rv[s0 : s0 + _SLAB], k
            ),
            k, exclude_self=True,
        )
    if mismatch and indel:
        dh = _sweep(lambda s0: _del_neighbor_block(fw[s0 : s0 + _SLAB], k),
                    k - 1, exclude_self=False)
        ih = _sweep(lambda s0: _ins_neighbor_block(fw[s0 : s0 + _SLAB], k),
                    k + 1, exclude_self=False)
        total += np.maximum(0, dh - 2 * exact) + np.maximum(0, ih - 2 * exact)
    total_hits = dict(zip(uniq_kmers, total.tolist()))

    dropped = 0
    for site in sites:
        for attr in ("at_kmers", "cg_kmers"):
            kept = []
            for p, km in getattr(site, attr):
                if total_hits[km] == 1:
                    kept.append((p, km))
                else:
                    dropped += 1
            setattr(site, attr, kept)
    print(f"Uniqueness filter dropped {dropped} sub-k-mers", file=err)


def write_tiers(
    sites: list[SiteCandidate], prefix: str, window: int, k: int, err=sys.stderr
):
    """Stage 3: {prefix}_n{i}.fa tier files (filterRepetiveSNP.pl:81-113)."""
    max_count = window - k + 1
    outs = [open(f"{prefix}_n{i}.fa", "w") for i in range(max_count)]
    try:
        for site in sorted(sites, key=lambda s: s.snp_id):
            miss_at = max_count - len(site.at_kmers)
            miss_cg = max_count - len(site.cg_kmers)
            if not site.at_kmers or not site.cg_kmers:
                continue
            at_str = b"N".join(km for _, km in site.at_kmers).decode()
            cg_str = b"N".join(km for _, km in site.cg_kmers).decode()
            tier = max(miss_at, miss_cg)
            for i in range(tier, max_count):
                outs[i].write(f">{site.snp_id} ref\n{at_str}\n")
                outs[i].write(f">{site.snp_id} var\n{cg_str}\n")
    finally:
        for fh in outs:
            fh.close()


def generate_sites(
    name: str,
    ref: str,
    vcf: str,
    window: int = 31,
    k: int = 19,
    mismatch: bool = True,
    indel: bool = True,
    err=sys.stderr,
):
    sites = extract_candidates(vcf, ref, window=window, k=k, err=err)
    filter_unique(sites, ref, k, mismatch=mismatch, indel=indel, err=err)
    write_tiers(sites, name, window, k, err=err)
    return sites


def generate_pca_rotation(
    name: str,
    ref: str,
    multivcf: str,
    sites_fa: str,
    dims: int = 20,
    window: int = 31,
    k: int = 19,
    err=sys.stderr,
):
    """Stage 4: genotype matrix + PCA (convertTSVtoPCA.py:16-25 layout)."""
    from ntsm_tpu_torch.io.sites import load_site_table
    from ntsm_tpu_torch.options import Options
    from ntsm_tpu_torch.vcf.convert import VCFConverter

    opts = Options(snp=sites_fa, ref=ref, k=k, window=window)
    table = load_site_table(sites_fa, k, allow_dupes=False, err=err)
    conv = VCFConverter(table, opts, err=err)
    conv.count(multivcf)
    conv.output_matrix(name)

    # the printed (rounded) values, as pandas.read_csv reads them
    site_ids, sample_ids, dataset = read_matrix(f"{name}_matrix.tsv")
    max_dims = min(dataset.shape)
    if dims > max_dims:
        print(
            f"Warning: dims={dims} exceeds min(samples, sites)={max_dims}; "
            f"training {max_dims} components",
            file=err,
        )
        dims = max_dims
    reduced, components = pca_full(dataset.T, dims)
    write_table(f"{name}_rotationalMatrix.tsv", "AlleleID", site_ids, components.T)
    write_table(f"{name}_components.tsv", "SampleID", sample_ids, reduced)


def read_matrix(path: str):
    """(site ids, sample ids, [sites, samples] float64) of a
    `{name}_matrix.tsv` (alleleID header, one row per site)."""
    with open(path) as fh:
        sample_ids = fh.readline().rstrip("\n").split("\t")[1:]
        site_ids, rows = [], []
        for line in fh:
            f = line.rstrip("\n").split("\t")
            site_ids.append(f[0])
            rows.append(f[1:])
    data = np.array(rows, dtype=np.float64).reshape(len(site_ids), len(sample_ids))
    return site_ids, sample_ids, data


def pca_full(X: np.ndarray, dims: int):
    """sklearn's exact PCA of X [samples, features]: (fit_transform's
    [samples, dims], components_ [dims, features]), step for step as
    PCA(n_components=dims, svd_solver="full") computes them
    (sklearn/decomposition/_pca.py:_fit_full, fit_transform;
    sklearn/utils/extmath.py:svd_flip with u_based_decision=False)."""
    from scipy import linalg

    mean = np.mean(X, axis=0)
    U, S, Vt = linalg.svd(X - mean, full_matrices=False)
    # flip each component so that its largest |value| is positive
    signs = np.sign(Vt[np.arange(Vt.shape[0]), np.argmax(np.abs(Vt), axis=1)])
    U *= signs[np.newaxis, :]
    Vt *= signs[:, np.newaxis]
    return U[:, :dims] * S[:dims], Vt[:dims]


def write_table(path: str, index_label: str, index, values: np.ndarray) -> None:
    """`DataFrame(values, index=index).to_csv(path, sep="\t",
    index_label=index_label)`: a header of column numbers, each float as
    Python's repr of the float64."""
    with open(path, "w") as fh:
        fh.write("\t".join([index_label, *map(str, range(values.shape[1]))]) + "\n")
        for name, row in zip(index, values.tolist()):
            fh.write("\t".join([name, *map(repr, row)]) + "\n")
