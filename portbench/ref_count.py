"""The plain reference of ``count``: per-k-mer counts and totals of reads
that the benchmark made, in plain PyTorch.  It imports nothing of the
program.

It restates ntsmCount's semantics (FingerPrint.hpp: every window of k
bases without an N is one k-mer, keyed by the minimap2-style 64-bit hash
of the smaller of its forward and reverse-complement 2-bit encodings; a
k-mer of the site table counts one a window; k-mers that occur more than
once in the site set are dropped) on [reads, length] code arrays, with a
frozen copy of the hash.  `key_bits` below 64 is the control: the table
keyed by the low bits of the hash alone, the cheaper table that would
break the configuration's exact counts.
"""

from __future__ import annotations

import numpy as np
import torch


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash64(key: torch.Tensor, k: int) -> torch.Tensor:
    """The invertible hash under the 2k-bit mask (vendor/KseqHashIterator.hpp
    hash64), on int64 bit patterns."""
    mask = -1 if k == 32 else (1 << (2 * k)) - 1
    key = (~key + (key << 21)) & mask
    key = key ^ _srl(key, 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ _srl(key, 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ _srl(key, 28)
    key = (key + (key << 31)) & mask
    return key


def window_hashes(codes: torch.Tensor, k: int):
    """(hashes [R, W] int64, valid [R, W] bool) of every window of the [R,
    n] u8 code rows (4 = not a base); W = n - k + 1."""
    R, n = codes.shape
    W = n - k + 1
    c = codes.long()
    base = c & 3
    fw = torch.zeros((R, W), dtype=torch.int64, device=codes.device)
    rv = torch.zeros_like(fw)
    bad = torch.zeros((R, W), dtype=torch.bool, device=codes.device)
    for j in range(k):
        col = base[:, j: j + W]
        fw = (fw << 2) | col
        rv = rv | ((3 - col) << (2 * j))
        bad |= c[:, j: j + W] >= 4
    top = -(1 << 63)  # unsigned order is signed order with the top bit flipped
    canon = torch.where((fw ^ top) < (rv ^ top), fw, rv)
    return hash64(canon, k), ~bad


class SiteKmers:
    """The site table: the hashes of every site allele's k-mers in the
    FASTA's order (site, then A/T before C/G, then offset), less every
    hash that occurs more than once."""

    def __init__(self, at_win: np.ndarray, cg_win: np.ndarray, k: int, device):
        n_sites, window = at_win.shape
        w = torch.from_numpy(np.stack([at_win, cg_win], axis=1).reshape(2 * n_sites, window))
        h, valid = window_hashes(w.to(device), k)
        h = h.reshape(-1)
        u, counts = torch.unique(h, return_counts=True)
        keep = counts[torch.searchsorted(u, h)] == 1
        self.hashes = h[keep]  # [n_kmers] in table order
        self.n_kmers = int(self.hashes.numel())
        order = torch.argsort(self.hashes)
        self.sorted = self.hashes[order]
        self.index = order

    def keyed(self, key_bits: int):
        """(sorted keys, k-mer index a key) of the table keyed by the low
        key_bits of each hash; a key that several k-mers share goes to
        the first of them."""
        if key_bits >= 64:
            return self.sorted, self.index
        key = self.hashes & ((1 << key_bits) - 1)
        order = torch.argsort(key, stable=True)
        sk = key[order]
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        return sk[first], order[first]


def count(reads: np.ndarray, sites: SiteKmers, k: int, device, key_bits: int = 64,
          block: int = 131072) -> dict:
    """counts [n_kmers] int64 and the totals of the [R, n] read codes,
    counted on `device` in blocks of rows."""
    keys, idx = sites.keyed(key_bits)
    counts = torch.zeros(sites.n_kmers, dtype=torch.int64, device=device)
    total_kmers = total_hits = 0
    mask = (1 << key_bits) - 1 if key_bits < 64 else -1
    for r0 in range(0, reads.shape[0], block):
        codes = torch.from_numpy(reads[r0: r0 + block]).to(device)
        h, valid = window_hashes(codes, k)
        h = h[valid] & mask
        total_kmers += int(h.numel())
        pos = torch.clamp(torch.searchsorted(keys, h), max=max(keys.numel() - 1, 0))
        hit = keys[pos] == h
        total_hits += int(hit.sum())
        counts += torch.bincount(idx[pos[hit]], minlength=sites.n_kmers)
    return dict(counts=counts.cpu().numpy(), total_kmers=total_kmers, total_hits=total_hits,
                total_bases=int(reads.size), total_reads=int(reads.shape[0]))
