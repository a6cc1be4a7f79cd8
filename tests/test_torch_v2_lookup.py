"""numpy models of the v2 step's two kernels (csrc/hash_bucket_hits.cu),
held to the plain version and to the JAX step on the CPU.

The lookup (bucket_hits_kernel) reads a bucket a 32-byte sector of 4 slots
at a time and stops at the lowest matching slot or at the first sector
whose last slot is empty; in the last bucket, where a key of all ones may
be real, it reads on until it finds the hash, and for the all-ones hash
reads the vals.  The ordering stage (order_hits_kernel) bins the stored ids
by their top bits, sorts each bin in shared memory at its offset (the
count of the higher bins), cuts a bin larger than shared memory into
windows found by sub-range histograms, writes a value with more ids than
that as a run, and pads with zeros to cap.  The models restate both, step
for step, with the kernel's constants read from its source; the tests
hold them to a plain lookup, to count_step_v2_plain, to the JAX
count_step_v2 and to torch.topk, on seeded tables built to reach every
branch (the engine's load, half full, full buckets, duplicate keys, the
all-ones key in the last bucket, lookups of ~0, 1- and 2-bucket tables).
Integer data: every comparison is exact (tolerance 0)."""

import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ntsm_tpu.count import kernel_v2 as jax_v2
from ntsm_tpu_torch.count import kernel_v2
from ntsm_tpu_torch.count.golden import count_codes_batch
from ntsm_tpu_torch.io.sites import build_lookup
from tests.test_torch_cuda import all_ones_world

torch.set_num_threads(1)

SOURCE = pathlib.Path(kernel_v2.__file__).parents[1] / "csrc" / "hash_bucket_hits.cu"
U64 = (1 << 64) - 1
EMPTY = np.int64(-1)


def kernel_constant(name: str) -> int:
    text = SOURCE.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


BINS = kernel_constant("kBins")
ORDER_CAP = kernel_constant("kOrderCap")
SUB = kernel_constant("kSub")
SECTOR = kernel_constant("kSectorSlots")


# ---------------------------------------------------------------- models


def sector_lookup(table: kernel_v2.TableV2, h: np.ndarray):
    """The lookup kernel's slot of each uint64 hash in h (-1: a miss) and
    the sectors it reads, from the table's sectors at its strides: sector
    by sector, up to the lowest match or, but in the last bucket, the first
    sector whose last key is empty."""
    flat = table.sectors.reshape(-1).numpy()
    bstride, pstride = table.strides
    mask = table.n_buckets - 1
    hb = h.view(np.int64)
    bucket = (h & np.uint64(mask)).astype(np.int64)
    slot = np.full(h.size, -1, dtype=np.int64)
    reads = np.zeros(h.size, dtype=np.int64)
    last = bucket == mask
    go = np.flatnonzero(~last)
    for p in range(kernel_v2.SLOTS_V2 // SECTOR):
        at = bucket[go] * bstride + p * pstride
        keys = flat[at[:, None] + np.arange(SECTOR)]
        reads[go] += 1
        eq = keys == hb[go, None]
        hit = eq.any(axis=1)
        slot[go[hit]] = SECTOR * p + eq.argmax(axis=1)[hit]
        go = go[~hit & (keys[:, -1] != EMPTY)]
    vals = table.vals.numpy()
    for i in np.flatnonzero(last):  # read on past keys of all ones, as they may be real
        b = bucket[i]
        for p in range(kernel_v2.SLOTS_V2 // SECTOR):
            keys = flat[b * bstride + p * pstride + np.arange(SECTOR)]
            reads[i] += 1
            ok = (keys == hb[i]) & ~((keys == EMPTY)
                                     & (vals[b, SECTOR * p: SECTOR * (p + 1)] == table.n_kmers))
            if ok.any():
                slot[i] = SECTOR * p + np.argmax(ok)
                break
    return slot, reads


def bin_shift(n_buckets: int) -> int:
    bits = (n_buckets * kernel_v2.SLOTS_V2).bit_length() - 1
    return max(bits - (BINS.bit_length() - 1), 0)


def order_model(ids: np.ndarray, n_found: int, cap: int, n_buckets: int,
                order_cap: int = ORDER_CAP):
    """The ordering stage: (top [cap] int32, what it did: windows sorted,
    histogram passes, runs written)."""
    n = min(n_found, cap)
    v = ids[:n].astype(np.int64) - 1
    shift = bin_shift(n_buckets)
    n_values = n_buckets * kernel_v2.SLOTS_V2
    hist = np.bincount(v >> shift, minlength=BINS)
    assert hist.size == BINS
    top = np.zeros(cap, dtype=np.int32)
    did = dict(windows=0, passes=0, runs=0)
    for b in range(BINS):
        remaining, cursor = int(hist[b]), int(hist[b + 1:].sum())
        lo, a_hi = b << shift, min((b + 1) << shift, n_values)
        while remaining > 0:
            w_lo, w_n, single = lo, remaining, False
            if remaining > order_cap:
                base = lo
                while True:
                    width = a_hi - base
                    step = -(-width // SUB)
                    inside = v[(v >= base) & (v < a_hi)]
                    sub = np.bincount((inside - base) // step, minlength=SUB)
                    did["passes"] += 1
                    top_j = (width - 1) // step
                    acc, j = 0, top_j
                    while j >= 0 and acc + sub[j] <= order_cap:
                        acc += int(sub[j])
                        j -= 1
                    if j < top_j:
                        w_lo, w_n = base + (j + 1) * step, acc
                        break
                    if step == 1:
                        w_lo, w_n, single = a_hi - 1, int(sub[top_j]), True
                        break
                    base += top_j * step
            if single:
                top[cursor:cursor + w_n] = w_lo + 1
                did["runs"] += 1
            elif w_n:
                got = v[(v >= w_lo) & (v < a_hi)]
                assert got.size == w_n <= order_cap
                top[cursor:cursor + w_n] = np.sort(got)[::-1] + 1
                did["windows"] += 1
            cursor += w_n
            remaining -= w_n
            a_hi = w_lo
    return top, did


def model_step(packed, vbits, table, k: int, L: int, rng):
    """The step as the two kernels compute it: the plain window hashes, the
    sector lookup of each valid one, its hit ids in an arbitrary order (the
    warps' appends: a seeded shuffle), the first cap stored, then the
    ordering stage."""
    h, valid = kernel_v2.window_hashes_packed(packed, vbits, k, L)
    hv = h[valid].numpy().view(np.uint64)
    slot, _ = sector_lookup(table, hv)
    bucket = (hv & np.uint64(table.n_buckets - 1)).astype(np.int64)
    ids = ((bucket << 4) | slot)[slot >= 0] + 1
    ids = rng.permutation(ids).astype(np.int32)
    cap = min(kernel_v2.TOPK, h.numel())
    top, _ = order_model(ids[:cap], ids.size, cap, table.n_buckets)
    return top, ids.size, hv.size


# ---------------------------------------------------------------- tables


def bucket_table(rows, n_buckets: int) -> kernel_v2.TableV2:
    """A TableV2 whose bucket b holds rows[b] (uint64 keys) from slot 0 up,
    vals the keys' order of listing, n_kmers where empty."""
    keys = np.full((n_buckets, kernel_v2.SLOTS_V2), EMPTY, dtype=np.int64)
    vals = np.zeros((n_buckets, kernel_v2.SLOTS_V2), dtype=np.int32)
    n = sum(len(r) for r in rows.values())
    vals[:] = n
    i = 0
    for b, r in rows.items():
        keys[b, :len(r)] = np.asarray(r, dtype=np.uint64).view(np.int64)
        vals[b, :len(r)] = np.arange(i, i + len(r))
        i += len(r)
    return kernel_v2.TableV2(torch.from_numpy(keys), torch.from_numpy(vals), n)


def in_bucket(rng, b: int, n_buckets: int, n: int) -> list:
    """n random keys of bucket b, never all ones."""
    bits = n_buckets.bit_length() - 1
    high = rng.integers(0, 1 << (62 - bits), size=n, dtype=np.uint64)
    return list((high << np.uint64(bits)) | np.uint64(b))


def shaped_rows(rng, n_buckets: int, own: np.ndarray, kind: str) -> dict:
    """Per-bucket key lists: `own` hashes (the batch's, to be hits) mixed
    with random keys of the same bucket (misses), with per-bucket counts
    for `kind`: "load" Poisson(2.39) (the engine's: 2.5M keys in 2^20
    buckets), "half" 8 (size_buckets' 50%), "full" 16, "dups" Poisson(4)
    with each bucket's first key repeated."""
    by_bucket = {}
    for x in own:
        by_bucket.setdefault(int(x & np.uint64(n_buckets - 1)), []).append(x)
    rows = {}
    for b in range(n_buckets):
        c = {"load": min(int(rng.poisson(2.39)), 16), "half": 8, "full": 16,
             "dups": min(int(rng.poisson(4.0)), 15)}[kind]
        mine = by_bucket.get(b, [])[: rng.integers(min(c, 1), c + 1)]
        r = list(mine) + in_bucket(rng, b, n_buckets, c - len(mine))
        r = [r[i] for i in rng.permutation(len(r))]
        if kind == "dups" and r:
            r.insert(int(rng.integers(1, len(r) + 1)), r[0])
        rows[b] = r
    return rows


def _batch(rng, k: int, B: int, L: int) -> np.ndarray:
    codes = rng.integers(0, 4, size=(B, L), dtype=np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    ends = rng.integers(0, L + 1, size=B)
    codes[np.arange(L)[None, :] >= ends[:, None]] = 4
    return codes


def _packed(codes):
    p, v = kernel_v2.pack_batch(codes)
    return torch.from_numpy(p), torch.from_numpy(v)


def plain_slots(table: kernel_v2.TableV2, h: np.ndarray) -> np.ndarray:
    """The lowest slot holding h that is not empty (key EMPTY_KEY, val
    n_kmers), as the plain step and the JAX step (but for the empty rule)
    define it."""
    keys, vals = table.keys.numpy(), table.vals.numpy()
    bucket = (h & np.uint64(table.n_buckets - 1)).astype(np.int64)
    ok = (keys[bucket] == h.view(np.int64)[:, None]) & ~(
        (keys[bucket] == EMPTY) & (vals[bucket] == table.n_kmers))
    return np.where(ok.any(axis=1), ok.argmax(axis=1), -1)


# ---------------------------------------------------------------- tests


def test_models_read_the_kernels_constants():
    assert (BINS, ORDER_CAP, SUB, SECTOR) == (128, 8192, 1024, 4)
    assert kernel_v2.SECTOR_SLOTS == SECTOR


@pytest.mark.parametrize("n_buckets", [1, 2, 16, 1024])
@pytest.mark.parametrize("layout", kernel_v2.LAYOUTS)
def test_sector_layout_round_trip(n_buckets, layout):
    """Sector p of bucket b at b * bucket_stride + p * plane_stride holds
    slots 4p .. 4p + 3 of row b, in either layout; the planes are [4,
    n_buckets, 4] and give the rows back."""
    rng = np.random.default_rng(n_buckets)
    rows = {b: in_bucket(rng, b, n_buckets, int(rng.integers(0, 17))) for b in range(n_buckets)}
    table = bucket_table(rows, n_buckets)
    if layout == "rows":
        table = kernel_v2.TableV2(table.keys, table.vals, table.n_kmers, layout="rows")
    flat = table.sectors.reshape(-1)
    bs, ps = table.strides
    for b in range(n_buckets):
        got = torch.cat([flat[b * bs + p * ps: b * bs + p * ps + SECTOR] for p in range(4)])
        assert torch.equal(got, table.keys[b])
    if layout == "planes":
        assert table.sectors.shape == (4, n_buckets, 4)
        assert torch.equal(table.sectors.transpose(0, 1).reshape(n_buckets, 16), table.keys)


@pytest.mark.parametrize("case", ["gap", "foreign", "layout", "strided", "unaligned"])
def test_table_v2_refuses_what_the_lookup_cannot_read(case):
    """The lookup stops at a bucket's first empty slot: a key after an
    empty slot, or a key outside its bucket, is refused, and so are keys it
    cannot read as 16-byte-aligned sectors."""
    rng = np.random.default_rng(5)
    table = bucket_table({b: in_bucket(rng, b, 8, 3) for b in range(8)}, 8)
    keys, vals = table.keys.clone(), table.vals.clone()
    layout = "planes"
    if case == "gap":
        keys[2, 5] = keys[2, 0]
        vals[2, 5] = 0
    elif case == "foreign":
        keys[3, 1] = keys[4, 0]
    elif case == "layout":
        layout = "sectors"
    elif case == "strided":
        keys = torch.cat([keys, keys], dim=1)[:, ::2]
    else:  # rows one key (8 bytes) into a buffer
        layout = "rows"
        keys = torch.cat([keys.reshape(-1)[:1], keys.reshape(-1)])[1:].view(8, 16)
    with pytest.raises(ValueError):
        kernel_v2.TableV2(keys, vals, table.n_kmers, layout=layout)


@pytest.mark.parametrize("kind,n_buckets", [("load", 4096), ("half", 256), ("full", 64),
                                            ("dups", 512), ("load", 1), ("full", 1),
                                            ("half", 2), ("full", 2)])
@pytest.mark.parametrize("layout", kernel_v2.LAYOUTS)
def test_sector_lookup_matches_plain(kind, n_buckets, layout):
    """The sector lookup's slot equals the plain lowest non-empty match on
    hits, misses in every bucket (all four sectors of full buckets), the
    hashes' duplicates and lookups of ~0; a miss reads the sectors up to
    its bucket's first empty slot."""
    rng = np.random.default_rng(len(kind) * 1000 + n_buckets)
    rows = shaped_rows(rng, n_buckets, np.zeros(0, dtype=np.uint64), kind)
    table = bucket_table(rows, n_buckets)
    if layout == "rows":
        table = kernel_v2.TableV2(table.keys, table.vals, table.n_kmers, layout="rows")
    present = np.array([x for r in rows.values() for x in r], dtype=np.uint64)
    absent = np.concatenate([in_bucket(rng, b, n_buckets, 3) for b in range(n_buckets)])
    h = np.concatenate([present, absent.astype(np.uint64),
                        np.array([U64, U64 - 1], dtype=np.uint64)])
    slot, reads = sector_lookup(table, h)
    np.testing.assert_array_equal(slot, plain_slots(table, h))
    assert (slot[: present.size] >= 0).all() and (slot[present.size:] == -1).all()
    counts = np.array([len(rows[b]) for b in range(n_buckets)])
    bucket = (h & np.uint64(n_buckets - 1)).astype(np.int64)
    last = bucket == n_buckets - 1
    miss = (slot < 0) & ~last
    np.testing.assert_array_equal(reads[miss], np.minimum(counts[bucket[miss]] // 4 + 1, 4))
    np.testing.assert_array_equal(reads[(slot < 0) & last], 4)
    np.testing.assert_array_equal(reads[slot >= 0], slot[slot >= 0] // 4 + 1)


@pytest.mark.parametrize("after", [0, 1, 12])
@pytest.mark.parametrize("n_buckets", [1, 2, 64])
def test_sector_lookup_all_ones_key_in_the_last_bucket(after, n_buckets):
    """A real all-ones key lies in bucket n_buckets - 1, with `after` keys
    after it (none: empty slots follow) or a full row; ~0 finds it there
    and nowhere else, and a key after it is found too."""
    rng = np.random.default_rng(after + n_buckets)
    last = n_buckets - 1
    rows = {b: in_bucket(rng, b, n_buckets, 2) for b in range(n_buckets)}
    tail = in_bucket(rng, last, n_buckets, after)
    rows[last] = in_bucket(rng, last, n_buckets, 3) + [U64] + tail
    table = bucket_table(rows, n_buckets)
    h = np.array([U64] + tail + in_bucket(rng, last, n_buckets, 2), dtype=np.uint64)
    slot, reads = sector_lookup(table, h)
    np.testing.assert_array_equal(slot, plain_slots(table, h))
    assert slot[0] == 3 and list(slot[1:1 + after]) == list(range(4, 4 + after))
    np.testing.assert_array_equal(reads, np.where(slot >= 0, slot // 4 + 1, 4))
    # without it, ~0 in the last bucket matches empty slots only: a miss
    rows[last] = rows[last][:3]
    table = bucket_table(rows, n_buckets)
    assert sector_lookup(table, np.array([U64], dtype=np.uint64))[0][0] == -1


@pytest.mark.parametrize("kind,n_buckets,k", [("load", 4096, 19), ("half", 1024, 19),
                                              ("full", 256, 19), ("dups", 1024, 31),
                                              ("load", 1, 19), ("full", 2, 19),
                                              ("half", 2048, 32)])
def test_model_step_matches_plain_and_jax(kind, n_buckets, k):
    """The two kernels' models, end to end, give count_step_v2_plain's and
    the JAX step's triple on a batch whose table holds some of its own
    k-mers, laid into buckets of the given shape."""
    rng = np.random.default_rng(n_buckets + k)
    codes = _batch(rng, k, 96, 128)
    packed, vbits = _packed(codes)
    h, v = kernel_v2.window_hashes_packed(packed, vbits, k, 128)
    own = np.unique(h[v].numpy().view(np.uint64))
    rows = shaped_rows(rng, n_buckets, own, kind)
    table = bucket_table(rows, n_buckets)
    top, n_found, n_valid = model_step(packed, vbits, table, k, 128, rng)
    p_top, p_found, p_valid = kernel_v2.count_step_v2_plain(
        packed, vbits, table.keys, table.vals, k=k, L=128, n_kmers=table.n_kmers)
    assert 0 < n_found <= kernel_v2.TOPK
    np.testing.assert_array_equal(top, p_top.numpy())
    assert (n_found, n_valid) == (int(p_found), int(p_valid))
    j_top, j_found, j_valid = jax_v2.count_step_v2(
        jnp.asarray(packed.numpy()), jnp.asarray(vbits.numpy()),
        jnp.asarray(table.keys.numpy().view(np.uint64)), k=k, L=128)
    np.testing.assert_array_equal(top, np.asarray(j_top))
    assert (n_found, n_valid) == (int(j_found), int(j_valid))


@pytest.mark.parametrize("case", ["empty", "full", "site"])
def test_model_step_all_ones_kmer_counts_as_golden(case):
    """k = 32, the 32-mer whose hash is all ones (all_ones_world): the
    models find what count_step_v2_plain and the golden engine find (0, 0,
    8), where the JAX step reports the empty slots' matches."""
    codes, lengths, hashes, planted = all_ones_world(case)
    codes = codes.copy()
    codes[np.arange(codes.shape[1])[None, :] >= lengths[:, None]] = 4
    packed, vbits = _packed(codes)
    table = kernel_v2.make_table_v2(build_lookup(hashes, slots=16), hashes.size)
    top, n_found, n_valid = model_step(packed, vbits, table, 32, codes.shape[1],
                                       np.random.default_rng(3))
    p_top, p_found, p_valid = kernel_v2.count_step_v2_plain(
        packed, vbits, table.keys, table.vals, k=32, L=codes.shape[1], n_kmers=hashes.size)
    np.testing.assert_array_equal(top, p_top.numpy())
    assert (n_found, n_valid) == (int(p_found), int(p_valid))
    hit_idx, _ = count_codes_batch(codes, 32, np.sort(hashes), np.argsort(hashes, kind="stable"))
    assert n_found == hit_idx.size == (planted if case == "site" else 0)


def _topk_padded(ids: np.ndarray, n_found: int, cap: int) -> np.ndarray:
    n = min(n_found, cap)
    padded = torch.zeros(cap, dtype=torch.int32)
    padded[:n] = torch.from_numpy(ids[:n])
    return torch.topk(padded, cap).values.numpy()


@pytest.mark.parametrize("n_found", ["0", "1", "cap-1", "cap", "cap+9"])
@pytest.mark.parametrize("n_buckets", [1, 4, 2 ** 20])
def test_order_model_matches_topk(n_found, n_buckets):
    """The ordering stage's bins, offsets, per-bin sorts and padding give
    torch.topk's array for none, one, cap - 1, cap and more than cap hits,
    on tables of 1 and 4 buckets (fewer ids than bins) and 2^20; so does
    its plain version, order_hits_plain."""
    cap = 4096
    rng = np.random.default_rng(n_buckets)
    n = {"0": 0, "1": 1, "cap-1": cap - 1, "cap": cap, "cap+9": cap + 9}[n_found]
    ids = rng.integers(1, n_buckets * 16 + 1, size=n).astype(np.int32)
    stored = ids[:cap]
    top, did = order_model(stored, n, cap, n_buckets)
    want = _topk_padded(ids, n, cap)
    np.testing.assert_array_equal(top, want)
    assert did["passes"] == did["runs"] == 0
    # the stage's plain version, which the card's kernel is held to
    plain = kernel_v2.order_hits_plain(torch.from_numpy(stored), n, cap)
    np.testing.assert_array_equal(plain.numpy(), want)


@pytest.mark.parametrize("spread", ["one_value", "narrow", "wide"])
def test_order_model_bin_past_shared_memory(spread):
    """Every hit in one bin, more than shared memory holds: the bin is cut
    into windows by sub-range histograms, and a value with more ids than
    the capacity is written as a run.  The model runs at a capacity of 64
    (the kernel's 8192 scaled down, as the tests' batch is) and at the
    kernel's own on 65,536 ids."""
    rng = np.random.default_rng(len(spread))
    n_buckets, cap = 2 ** 20, 4096
    lo = 77 << bin_shift(n_buckets)  # bin 77
    width = {"one_value": 1, "narrow": 300, "wide": 1 << bin_shift(n_buckets)}[spread]
    ids = (lo + 1 + rng.integers(0, width, size=cap - 5)).astype(np.int32)
    if spread == "narrow":
        ids[: cap // 2] = lo + 1 + 150  # one value held more often than the capacity
    top, did = order_model(ids, ids.size, cap, n_buckets, order_cap=64)
    np.testing.assert_array_equal(top, _topk_padded(ids, ids.size, cap))
    assert did["passes"] > 0 and (did["runs"] > 0) == (spread != "wide")
    big = (lo + 1 + rng.integers(0, width, size=65536)).astype(np.int32)
    top, did = order_model(big, big.size, big.size, n_buckets)
    np.testing.assert_array_equal(top, _topk_padded(big, big.size, big.size))
    assert did["passes"] > 0


@pytest.mark.parametrize("kind,n_buckets", [("load", 1024), ("full", 64), ("half", 1)])
def test_bound_counts_the_sectors_the_lookups_read(kind, n_buckets):
    """experiments/exp_v2_step.bounds' "sectors" bound counts, for each
    distinct bucket, the most sectors any of its lookups reads in the
    model, and its "rows" bound 128 B a distinct bucket."""
    from ntsm_tpu_torch.experiments.exp_v2_step import bounds

    rng = np.random.default_rng(n_buckets)
    codes = _batch(rng, 19, 64, 128)
    packed, vbits = _packed(codes)
    h, v = kernel_v2.window_hashes_packed(packed, vbits, 19, 128)
    own = np.unique(h[v].numpy().view(np.uint64))
    table = bucket_table(shaped_rows(rng, n_buckets, own, kind), n_buckets)
    hv = h[v].numpy().view(np.uint64)
    _, reads = sector_lookup(table, hv)
    bucket = (hv & np.uint64(n_buckets - 1)).astype(np.int64)
    most = np.zeros(n_buckets, dtype=np.int64)
    np.maximum.at(most, bucket, reads)
    cap = min(kernel_v2.TOPK, h.numel())
    got = bounds(packed, vbits, h, v, table.keys, table.vals, table.n_kmers, cap)
    assert got["sectors_needed"] == most.sum()
    assert got["distinct_buckets"] == np.unique(bucket).size
    batch = packed.numel() + vbits.numel()
    assert got["sectors"]["bytes"] == batch + most.sum() * 32 + cap * 4 + 16
    assert got["rows"]["bytes"] == batch + np.unique(bucket).size * 128 + got["n_found"] * 4 + 16
