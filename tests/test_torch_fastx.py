"""The port's host reader (its own copy of io/fastx.py, and the native
reader it builds from ntsm_tpu/native/fastx_reader.cpp) yields exactly the
JAX package's batches: codes, lengths, read and base counts, in order."""

import gzip

import numpy as np
import pytest
import torch

from ntsm_tpu.io.fastx import PyBatchReader as JaxPyBatchReader
from ntsm_tpu.io.fastx import read_fastx as jax_read_fastx
from ntsm_tpu_torch import native
from ntsm_tpu_torch.io.fastx import (
    BatchReader,
    NativeBatchReader,
    ParallelFileReader,
    PyBatchReader,
    read_fastx,
)

torch.set_num_threads(1)


def _rand_seq(rng, n, n_frac=0.04):
    bases = np.array(list("ACGTacgtN"), dtype="U1")
    p = np.array([0.12] * 8 + [n_frac])
    return "".join(rng.choice(bases, size=n, p=p / p.sum()))


def _write_fastq(path, seqs, gz=False):
    op = gzip.open if gz else open
    with op(path, "wt") as fh:
        for i, s in enumerate(seqs):
            fh.write(f"@r{i} extra\n{s}\n+\n{'I' * len(s)}\n")


def _batches(reader):
    return [(b.codes, b.lengths, b.n_reads, b.n_bases) for b in reader]


def _assert_same(got, want):
    assert len(got) == len(want)
    for (gc, gl, gr, gb), (wc, wl, wr, wb) in zip(got, want):
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gl, wl)
        assert (gr, gb) == (wr, wb)


def _files(rng, tmp_path, kind):
    if kind == "fastq":
        p = str(tmp_path / "a.fq")
        _write_fastq(p, [_rand_seq(rng, int(n)) for n in rng.integers(10, 400, 60)])
        return [p]
    if kind == "gzip":
        p = str(tmp_path / "a.fq.gz")
        _write_fastq(p, [_rand_seq(rng, int(n)) for n in rng.integers(10, 400, 60)], gz=True)
        return [p]
    if kind == "long_reads":
        p = str(tmp_path / "long.fq")
        _write_fastq(p, [_rand_seq(rng, 2500) for _ in range(6)])
        return [p]
    # multi-line FASTA, junk before the first header, and a second file
    fa, fq = str(tmp_path / "a.fa"), str(tmp_path / "b.fq")
    with open(fa, "w") as fh:
        fh.write("junk before the header\n")
        for i in range(12):
            s = _rand_seq(rng, int(rng.integers(50, 700)))
            fh.write(f">ctg{i} desc\n" + "".join(s[j:j + 60] + "\n" for j in range(0, len(s), 60)))
    _write_fastq(fq, [_rand_seq(rng, 150) for _ in range(20)])
    return [fa, fq]


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("kind", ["fastq", "gzip", "long_reads", "fasta_mixed"])
def test_batches_match_jax_reader(rng, tmp_path, kind, dense):
    paths = _files(rng, tmp_path, kind)
    kw = dict(k=19, seglen=96, batch=5, dense=dense)
    want = _batches(JaxPyBatchReader(paths, **kw))
    _assert_same(_batches(PyBatchReader(paths, **kw)), want)
    assert native.available()
    _assert_same(_batches(NativeBatchReader(paths, **kw)), want)
    assert isinstance(BatchReader(paths, **kw), NativeBatchReader)


def test_read_fastx_matches_jax(rng, tmp_path):
    paths = _files(rng, tmp_path, "fasta_mixed")
    for p in paths:
        got = [(r.name, r.seq, r.qual) for r in read_fastx(p)]
        want = [(r.name, r.seq, r.qual) for r in jax_read_fastx(p)]
        assert got == want


def test_parallel_reader_same_multiset(rng, tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"f{i}.fq")
        _write_fastq(p, [_rand_seq(rng, int(n)) for n in rng.integers(30, 300, 20)])
        paths.append(p)

    def rows(reader):
        out, nr, nb = [], 0, 0
        for b in reader:
            nr += b.n_reads
            nb += b.n_bases
            out += [bytes(b.codes[r, : b.lengths[r]]) for r in range(b.codes.shape[0])
                    if b.lengths[r] > 0]
        return sorted(out), nr, nb

    kw = dict(k=19, seglen=128, batch=8)
    assert rows(ParallelFileReader(paths, threads=3, **kw)) == rows(
        JaxPyBatchReader(paths, **kw))
