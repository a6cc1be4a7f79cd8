"""Multi-sample VCF -> synthetic count matrix / PCA training matrix
(counterpart of ntsm_tpu/vcf/convert.py).

Replaces VCFConvert + MultiCount (src/VCFConvert.hpp, src/MultiCount.hpp):
each site window's k-mers are mapped to site-table indices and a dense
[n_samples, n_kmers] uint8 matrix is filled.

Semantics preserved:

* genotype parsing "0|0"->hom-ref, "0|1"/"1|0"->het, "1|1"->hom-alt, and,
  faithfully to the reference's value-initialized enum (VCFConvert.hpp:138),
  any OTHER genotype string (./., unphased 0/1, ...) counts as hom-ref.
* counts are multi*2 for hom, multi for het (:151-170), stored uint8 with
  the same wraparound for multi > 127.
* first write wins per (sample, k-mer); a differing later write emits the
  reference's "Inconsistent k-mer counts" warning (MultiCount.hpp:51-68).
  Rows are processed in file order, so results match a -t 1 reference run.
* non-SNP rows skipped: REF == "." or len(ALT) != 1 (:122-129); REF length
  itself is (quirkily) not checked, as in the reference.
* windows of opt::window bp centered at pos, variant base substituted at
  window/2 (getSeqFromSite, :207-218).
* the PCA matrix writer reproduces printNormMatrix (MultiCount.hpp:148-203)
  including its sticky setprecision(19) after the first missing value and
  the long-double center file.

Where the JAX package inserts k-mer by k-mer, the windows of all rows are
hashed at once and a k-mer that one row alone hits is filled in one vector
step: within a row every write to a sample carries the same value (its
genotype's), so such a k-mer can neither conflict nor warn.  The k-mers
that several rows hit (overlapping sites) replay the row-ordered inserts,
warnings included.  The center file's long double is computed exactly
(:func:`x87_quotient`), so it does not depend on the host's long double.
"""

from __future__ import annotations

import math
import os
import sys
from decimal import ROUND_HALF_EVEN, Context, Decimal
from fractions import Fraction

import numpy as np

from ntsm_tpu_torch.core.encode import encode_bytes
from ntsm_tpu_torch.core.kmers import flat_window_hashes
from ntsm_tpu_torch.io.fastx import read_fastx
from ntsm_tpu_torch.io.sites import SiteTable
from ntsm_tpu_torch.options import Options

HOM1, HET, HOM2 = 0, 1, 2
_BLOCK_BYTES = 1 << 26  # bounds each block's temporaries (k-mer columns, sites)


def x87_quotient(num: float, den: int) -> Fraction:
    """num / den rounded as an x87 80-bit division rounds it (a 64-bit
    significand, half to even), as an exact Fraction: the reference's
    `(long double) sum / n` (MultiCount.hpp:196)."""
    q = Fraction(num) / den
    if q == 0:
        return q
    a = abs(q)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if a < Fraction(2) ** e:
        e -= 1  # now 2^e <= |q| < 2^(e+1)
    unit = Fraction(2) ** (e - 63)
    return round(q / unit) * unit  # round() on a Fraction: half to even


def _format_longdouble_g(x, precision: int = 19) -> str:
    """printf %.19Lg of x, an exact Fraction (from :func:`x87_quotient`) or
    a float: rounded once to `precision` significant digits, half to even,
    from the exact value, with C's %g choice of fixed or scientific form
    made on the rounded exponent (9.99...e-5 at 19 digits rounds to 1e-4
    and prints fixed).  0 prints "0" whatever its sign, as in the JAX
    package."""
    if isinstance(x, float):
        if math.isnan(x):
            return "-nan" if math.copysign(1.0, x) < 0 else "nan"
        if math.isinf(x):
            return "-inf" if x < 0 else "inf"
    if x == 0:
        return "0"
    q = Fraction(x)
    d = Context(prec=precision, rounding=ROUND_HALF_EVEN).divide(
        Decimal(q.numerator), Decimal(q.denominator)
    )
    exp = d.adjusted()
    if exp < -4 or exp >= precision:
        sign, digits, _ = d.as_tuple()
        mant = "".join(map(str, digits)).rstrip("0")
        s = ("-" if sign else "") + mant[0] + ("." + mant[1:] if len(mant) > 1 else "")
        return f"{s}e{'+' if exp >= 0 else '-'}{abs(exp):02d}"
    s = format(d, "f")
    return s.rstrip("0").rstrip(".") if "." in s else s


def _format_double_g(x: float, precision: int) -> str:
    """C++ `stream << double` at the stream's current precision (%g)."""
    return f"{float(x):.{precision}g}"


def _ratio_strings(precision: int) -> np.ndarray:
    """[65536] object: a/(a+b) at `precision` for key a*256 + b, the
    u8 max counts of the REF and VAR alleles ("" where a + b == 0)."""
    out = np.empty(1 << 16, dtype=object)
    for a in range(256):
        for b in range(256):
            out[a * 256 + b] = _format_double_g(a / (a + b), precision) if a + b else ""
    return out


class VCFConverter:
    def __init__(self, table: SiteTable, opts: Options, err=sys.stderr):
        self.table = table
        self.opts = opts
        self.err = err
        if opts.verbose > 1:
            print(f"Loading Reference {opts.ref}", file=err)
        self.ref = {rec.name: rec.seq.upper() for rec in read_fastx(opts.ref)}
        self.sample_ids: list[str] = []
        self.mat: np.ndarray | None = None  # [n_samples, n_kmers] uint8
        # site k-mer lookup: table hashes are unique (io/sites keeps the first)
        self._order = np.argsort(table.kmer_hashes, kind="stable")
        self._sorted = table.kmer_hashes[self._order]

    def _window(self, chrom: str, pos: int, var: str) -> tuple[bytes, bytes]:
        w = self.opts.window
        seq = self.ref[chrom]
        offset = pos - w // 2 - 1
        if offset < 0 or offset + w > len(seq):
            raise IndexError(
                f"window for {chrom}:{pos} out of reference bounds "
                "(the reference tool reads out of bounds here)"
            )
        ref_win = seq[offset : offset + w]
        var_win = ref_win[: w // 2] + var.encode("ascii") + ref_win[w // 2 + 1 :]
        return ref_win, var_win

    def _insert(self, kmer_idx: int, sample_sel: np.ndarray, value: int):
        """First-write-wins insert with the reference's warning."""
        col = self.mat[:, kmer_idx]
        existing = col[sample_sel]
        conflict = (existing > 0) & (existing != value)
        if conflict.any():
            old = int(existing[conflict][0])
            print(
                "Warning: Inconsistent k-mer counts, check for overlapping "
                f"sites: {old} vs {value}",
                file=self.err,
            )
        write = sample_sel.copy()
        write[sample_sel] = existing == 0
        col[write] = value

    def _parse_genotypes(self, tail: str, n: int) -> np.ndarray:
        """[n] genotype codes from the tab-joined sample columns.

        Fast path: every field is a 3-char phased genotype (the 1000
        Genomes layout), parsed as one byte array instead of a Python loop
        over the samples.  Reference semantics: only the exact strings
        0|0 / 0|1 / 1|0 / 1|1 classify; anything else defaults to hom-ref
        (VCFConvert.hpp:139-148)."""
        gts = np.zeros(n, dtype=np.int8)  # default hom1 (quirk)
        raw = tail.encode("ascii", "replace")
        b = None
        if len(raw) == 4 * n - 1:
            b = np.frombuffer(b"\t" + raw, dtype=np.uint8).reshape(n, 4)
            if not (b[:, 0] == 9).all():
                # mixed-width fields that happen to sum to 4n-1 (FORMAT
                # subfields, haploid chrX calls) are misaligned: with n-1
                # tabs all on stride-4 positions every field IS 3 chars,
                # so this check makes the fast path exact
                b = None
        if b is not None:
            ok = (
                ((b[:, 1] == 48) | (b[:, 1] == 49))
                & (b[:, 2] == 124)
                & ((b[:, 3] == 48) | (b[:, 3] == 49))
            )
            a1 = b[:, 1] == 49
            a2 = b[:, 3] == 49
            gts[ok & ~a1 & ~a2] = HOM1
            gts[ok & (a1 ^ a2)] = HET
            gts[ok & a1 & a2] = HOM2
            return gts
        for s, g in enumerate(tail.split("\t")[:n]):
            if g == "0|0":
                gts[s] = HOM1
            elif g in ("0|1", "1|0"):
                gts[s] = HET
            elif g == "1|1":
                gts[s] = HOM2
        return gts

    def _lookup(self, wins: list) -> np.ndarray:
        """[R, window - k + 1] site k-mer index of each window position of
        the R windows (canonical_hashes order), -1 where none."""
        w, k = self.opts.window, self.opts.k
        n_pos = max(w - k + 1, 0)
        out = np.full((len(wins), n_pos), -1, dtype=np.int64)
        if not wins or not n_pos or not self.table.n_kmers:
            return out
        h, valid = flat_window_hashes(encode_bytes(b"N".join(wins)), k)
        at = np.arange(len(wins))[:, None] * (w + 1) + np.arange(n_pos)
        h, valid = h[at], valid[at]
        pos = np.minimum(np.searchsorted(self._sorted, h), self._sorted.size - 1)
        hit = valid & (self._sorted[pos] == h)
        out[hit] = self._order[pos[hit]]
        return out

    def count(self, vcf_path: str) -> None:
        opts = self.opts
        if opts.verbose > 1:
            print(f"Reading VCF file: {vcf_path}", file=self.err)
        names = []  # ID of every data row (-v -v -v prints them)
        rows = []  # index into names of each SNP row
        ref_wins, var_wins, gts = [], [], []
        failure = None
        with open(vcf_path) as fh:
            for line in fh:
                if line.startswith("#"):
                    if line.startswith("#CHROM"):
                        self.sample_ids = line.rstrip("\n").split("\t")[9:]
                        break
            if opts.verbose > 1:
                print(
                    f"Starting multicount of each rsID for "
                    f"{len(self.sample_ids)} samples.",
                    file=self.err,
                )
            n = len(self.sample_ids)
            self.mat = np.zeros((n, self.table.n_kmers), dtype=np.uint8)
            try:
                for line in fh:
                    fields = line.rstrip("\n").split("\t", 9)
                    if len(fields) < 10:
                        continue
                    chrom, pos_s, rsid, ref_col, alt = fields[:5]
                    names.append(rsid)
                    if ref_col == "." or len(alt) != 1:
                        continue
                    ref_win, var_win = self._window(chrom, int(pos_s), alt)
                    gts.append(self._parse_genotypes(fields[9], n))
                    rows.append(len(names) - 1)
                    ref_wins.append(ref_win)
                    var_wins.append(var_win)
            except (IndexError, KeyError, ValueError) as e:
                # the rows before the bad one are counted (and warn) first,
                # as in the reference's row-by-row loop
                failure = e
        gts = np.stack(gts) if gts else np.zeros((0, n), dtype=np.int8)
        self._fill(names, rows, self._lookup(ref_wins), self._lookup(var_wins), gts)
        if failure is not None:
            raise failure

    def _fill(self, names, rows, ref_idx, var_idx, gts) -> None:
        """Write every row's inserts into self.mat: ref windows' k-mers get
        multi2 for hom-ref and multi for het, var windows' multi2 for
        hom-alt and multi for het (VCFConvert.hpp:151-170)."""
        opts = self.opts
        multi = opts.multi & 0xFF
        multi2 = (opts.multi * 2) & 0xFF
        n_kmers = self.table.n_kmers
        n_rows = max(gts.shape[0], 1)
        r_ref, p_ref = np.nonzero(ref_idx >= 0)
        r_var, p_var = np.nonzero(var_idx >= 0)
        i_ref, i_var = ref_idx[r_ref, p_ref], var_idx[r_var, p_var]
        # the distinct (k-mer, row) hits, and how many rows hit each k-mer
        pairs = np.unique(np.concatenate([i_ref, i_var]) * n_rows + np.concatenate([r_ref, r_var]))
        pair_idx = pairs // n_rows
        n_rows_of = np.bincount(pair_idx, minlength=n_kmers)

        # k-mers one row hits: its genotypes' values, in one step a block
        row_of = np.zeros(n_kmers, dtype=np.int64)
        row_of[pair_idx] = pairs % n_rows
        hom1_val = np.zeros(n_kmers, dtype=np.uint8)
        hom1_val[i_ref] = multi2
        hom2_val = np.zeros(n_kmers, dtype=np.uint8)
        hom2_val[i_var] = multi2
        one = np.flatnonzero(n_rows_of == 1)
        step = max(1, _BLOCK_BYTES // max(1, 8 * gts.shape[1]))
        for b0 in range(0, one.size, step):
            cols = one[b0 : b0 + step]
            g = gts[row_of[cols]]
            val = np.where(
                g == HET, np.uint8(multi),
                np.where(g == HOM1, hom1_val[cols, None], hom2_val[cols, None]),
            )
            self.mat[:, cols] = val.T

        # k-mers several rows hit: the inserts in row order, with warnings
        shared = n_rows_of > 1
        sel_ref, sel_var = shared[i_ref], shared[i_var]
        ev_r = np.concatenate([r_ref[sel_ref], r_var[sel_var]])
        ev_side = np.concatenate([np.zeros(int(sel_ref.sum()), np.int64),
                                  np.ones(int(sel_var.sum()), np.int64)])
        ev_p = np.concatenate([p_ref[sel_ref], p_var[sel_var]])
        ev_i = np.concatenate([i_ref[sel_ref], i_var[sel_var]])
        order = np.lexsort((ev_p, ev_side, ev_r))
        shown = 0
        for r, side, idx in zip(ev_r[order].tolist(), ev_side[order].tolist(),
                                ev_i[order].tolist()):
            if opts.verbose > 2:
                shown = self._show(names, shown, rows[r] + 1)
            g = gts[r]
            self._insert(idx, g == (HOM2 if side else HOM1), multi2)
            self._insert(idx, g == HET, multi)
        if opts.verbose > 2:
            self._show(names, shown, len(names))

    def _show(self, names, start: int, stop: int) -> int:
        for rsid in names[start:stop]:
            print(f"Processing site: {rsid}", file=self.err)
        return max(start, stop)

    # ---- outputs ----

    def site_max_matrix(self) -> tuple[np.ndarray, np.ndarray]:
        """Per (sample, site, allele) max and sum of the k-mer counts."""
        n = len(self.sample_ids)
        L = self.table.n_sites
        mx = np.zeros((n, L, 2), dtype=np.int64)
        sm = np.zeros((n, L, 2), dtype=np.int64)
        if self.table.n_kmers:
            group = self.table.kmer_site.astype(np.int64) * 2 + self.table.kmer_allele
            order = np.argsort(group, kind="stable")
            g = group[order]
            starts = np.flatnonzero(np.concatenate([[True], g[1:] != g[:-1]]))
            keys = g[starts]
            mx2, sm2 = mx.reshape(n, 2 * L), sm.reshape(n, 2 * L)
            step = max(1, _BLOCK_BYTES // self.table.n_kmers)
            for s0 in range(0, n, step):
                m = self.mat[s0 : s0 + step][:, order]
                mx2[s0 : s0 + step, keys] = np.maximum.reduceat(m, starts, axis=1)
                sm2[s0 : s0 + step, keys] = np.add.reduceat(m, starts, axis=1, dtype=np.int64)
        return mx, sm

    def output_counts(self, out_dir: str = ".") -> None:
        """Per-sample count files, MultiCount::printCountsMax layout (no #@
        header).  NB the reference CLI never invokes this without -p
        (src/ntSeqMatchVCF.cpp:201-204); exposed here as API + --output-counts."""
        from ntsm_tpu_torch.io.countfile import format_counts

        mx, sm = self.site_max_matrix()
        for s, sid in enumerate(self.sample_ids):
            path = os.path.join(out_dir, f"{sid}.counts.txt")
            with open(path, "w") as fh:
                fh.write(
                    format_counts(
                        self.table.site_ids, mx[s], sm[s], self.table.distinct, None, None
                    )
                )

    def output_matrix(self, prefix: str) -> None:
        """PCA training matrix + center file (printNormMatrix,
        src/MultiCount.hpp:148-203)."""
        mx, _ = self.site_max_matrix()
        n = len(self.sample_ids)
        if n == 0:
            raise SystemExit(
                "ntsm vcf: the VCF has no sample columns - the PCA training "
                "matrix needs a multi-sample VCF (e.g. 1000 Genomes)"
            )
        # a site's values are max_ref / (max_ref + max_var) of u8 counts, so
        # each is one of 65536 strings at either precision
        p6, p19 = _ratio_strings(6), _ratio_strings(19)
        centers: dict[float, str] = {}
        sticky = False  # setprecision(19) is sticky from the first missing value (:194)
        step = max(1, _BLOCK_BYTES // (8 * n))
        with open(prefix + "_matrix.tsv", "w") as out, open(
            prefix + "_center.txt", "w"
        ) as centerf:
            out.write("alleleID" + "".join("\t" + sid for sid in self.sample_ids) + "\n")
            for i0 in range(0, self.table.n_sites, step):
                a = mx[:, i0 : i0 + step, 0].T  # [sites, n]
                b = mx[:, i0 : i0 + step, 1].T
                present = (a + b) > 0
                values = np.where(present, a / np.maximum(a + b, 1), 0.0)
                # cumsum, not sum: np.sum's pairwise tree differs from the
                # reference's sequential `sum += values[j]` (MultiCount.hpp:
                # 159-200) in the last ulp for > 8 samples; add.accumulate is
                # strictly left to right and absent samples add an exact +0.0
                ssums = np.cumsum(values, axis=1)[:, -1].tolist()
                keys = a * 256 + b
                lines, clines = [], []
                for r, ssum in enumerate(ssums):
                    center = centers.get(ssum)
                    if center is None:
                        center = centers[ssum] = _format_longdouble_g(x87_quotient(ssum, n))
                    if sticky:
                        cells = p19[keys[r]]
                    elif present[r].all():
                        cells = p6[keys[r]]
                    else:
                        j0 = int(np.argmin(present[r]))
                        cells = np.concatenate([p6[keys[r, :j0]], p19[keys[r, j0:]]])
                        sticky = True
                    cells[~present[r]] = center
                    lines.append(self.table.site_ids[i0 + r] + "\t" + "\t".join(cells) + "\n")
                    clines.append(center + "\n")
                out.write("".join(lines))
                centerf.write("".join(clines))
