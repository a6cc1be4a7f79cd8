"""``--distributed`` over torch.distributed (gloo) on the CPU: the JAX
package's tests/test_distributed.py rerun on the port, each rank a
``python -m ntsm_tpu_torch ... --device cpu`` process.

count: 2 and 4 ranks, even and uneven file shards, both engines, launched
through the JAX package's variables, torchrun's, or torchrun itself,
byte-identical to the
JAX golden stdout on rank 0 and silent on the others; rank-tagged
checkpoints resumed; the -m recheck on the merged totals; the stale
world-size error in the JAX text.  eval -a: 2 ranks byte-identical to the
port's one-process table (with the default row blocks, and with blocks of
a few pairs so that both ranks score some), within the stated tolerance of
the JAX exact engine; the -e merge file written once.  NTSM_DISTRIBUTED=1
without a process group is one process, with a plain run's output.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ntsm_tpu_torch.cli import count_cmd, eval_cmd
from ntsm_tpu_torch.count.golden import CountResult
from ntsm_tpu_torch.parallel.distributed import host_file_shard, merge_count_results
from tests.synth import make_reads_fastq, make_site_fasta

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures")
EVAL_FILES = [os.path.join(FIX, f"sample{s}_counts.txt") for s in ("A", "A2", "B", "C", "Low")]
TIMEOUT = 120  # seconds a cluster's processes may take


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(rank: int, world: int, port: int, launcher: str) -> dict:
    env = dict(os.environ)
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(name, None)
    if launcher == "jax":
        env.update(JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", JAX_NUM_PROCESSES=str(world),
                   JAX_PROCESS_ID=str(rank))
    else:  # torchrun's variables
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank))
    env.update(NTSM_DISTRIBUTED="1", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _run_cluster(argv, world, tmp_path, launcher="jax", block_pairs=None, _retry=True):
    """[(rc, stdout, stderr)] of `world` ranks of ``ntsm argv``; with
    block_pairs, eval's row blocks hold that many pairs."""
    port = _free_port()
    if block_pairs is None:
        cmd = [sys.executable, "-m", "ntsm_tpu_torch"]
    else:
        cmd = [sys.executable, "-c",
               "import sys; from ntsm_tpu_torch.eval import rect; "
               f"rect.BLOCK_PAIRS = {block_pairs}; from ntsm_tpu_torch.cli import main; "
               "sys.exit(main(sys.argv[1:]))"]
    procs = [subprocess.Popen([*cmd, *argv], env=_env(r, world, port, launcher),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=str(tmp_path))
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if _retry and any(rc != 0 for rc, _, _ in outs):
        # one retry with a fresh port: a rendezvous can time out under a
        # loaded suite, and the probed port can be taken before it is bound
        return _run_cluster(argv, world, tmp_path, launcher, block_pairs, _retry=False)
    return outs


def _world(rng, tmp_path, n_files=4):
    sites_path = str(tmp_path / "sites.fa")
    _, sites = make_site_fasta(rng, n_sites=16, path=sites_path)
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"part{i}.fq")
        make_reads_fastq(rng, sites[i::n_files] or sites, coverage=5, genotype="het", path=p)
        paths.append(p)
    return sites_path, paths


def _golden_stdout(sites_path, paths):
    """The JAX golden engine's counts.txt over all the files."""
    from ntsm_tpu.count.golden import count_files
    from ntsm_tpu.io.countfile import format_counts
    from ntsm_tpu.io.sites import load_site_table

    table = load_site_table(sites_path, 19, allow_dupes=False)
    g = count_files(table, paths)
    mx, sm = g.site_max_sum(table)
    return format_counts(table.site_ids, mx, sm, table.distinct, g.total_kmers, 19)


def _assert_rank0_prints(outs, expect: str):
    for rc, _, err in outs:
        assert rc == 0, err.decode()
    assert outs[0][1].decode() == expect
    assert b"Time:" in outs[0][2]
    for _, out, err in outs[1:]:
        assert out == b"" and b"Time:" not in err


@pytest.mark.parametrize("launcher,engine", [("jax", "cuda"), ("torchrun", "cuda"),
                                             ("jax", "golden")])
def test_two_process_count_matches_golden(rng, tmp_path, launcher, engine):
    sites_path, paths = _world(rng, tmp_path)
    outs = _run_cluster(["count", "-v", "--device", "cpu", "--engine", engine,
                         "-s", sites_path, *paths], 2, tmp_path, launcher)
    _assert_rank0_prints(outs, _golden_stdout(sites_path, paths))
    for r, (_, _, err) in enumerate(outs):
        assert f"ntsm count: process {r}/2 counting 2/4 files".encode() in err


def test_torchrun_count_matches_golden(rng, tmp_path):
    """torchrun itself (its agent holds the rendezvous store): the ranks'
    stdout, which torchrun passes through, is rank 0's counts.txt."""
    sites_path, paths = _world(rng, tmp_path, n_files=3)
    env = _env(0, 2, 0, "jax")
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        env.pop(name)
    del env["NTSM_DISTRIBUTED"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(_free_port()), "-m", "ntsm_tpu_torch", "count", "--distributed",
           "--device", "cpu", "-s", sites_path, *paths]
    res = subprocess.run(cmd, env=env, capture_output=True, cwd=str(tmp_path), timeout=TIMEOUT)
    if res.returncode:  # once more on a fresh port, as _run_cluster does
        cmd[6] = str(_free_port())
        res = subprocess.run(cmd, env=env, capture_output=True, cwd=str(tmp_path),
                             timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr.decode()
    assert res.stdout.decode() == _golden_stdout(sites_path, paths)


def test_two_process_count_uneven_shards(rng, tmp_path):
    """3 files over 2 ranks: rank 0 counts two, rank 1 one."""
    sites_path, paths = _world(rng, tmp_path, n_files=3)
    outs = _run_cluster(["count", "--device", "cpu", "-s", sites_path, *paths], 2, tmp_path)
    _assert_rank0_prints(outs, _golden_stdout(sites_path, paths))


def test_four_process_count_matches_golden(rng, tmp_path):
    sites_path, paths = _world(rng, tmp_path, n_files=6)
    outs = _run_cluster(["count", "--device", "cpu", "-s", sites_path, *paths], 4, tmp_path)
    _assert_rank0_prints(outs, _golden_stdout(sites_path, paths))


def test_distributed_checkpoint_rank_tagged_and_resumable(rng, tmp_path):
    sites_path, paths = _world(rng, tmp_path, n_files=4)
    expect = _golden_stdout(sites_path, paths)
    ck = str(tmp_path / "snap.npz")
    argv = ["count", "--device", "cpu", "--checkpoint", ck, "--checkpoint-every", "1",
            "-s", sites_path, *paths]
    _assert_rank0_prints(_run_cluster(argv, 2, tmp_path), expect)
    assert os.path.exists(ck + ".rank0of2") and os.path.exists(ck + ".rank1of2")
    assert not os.path.exists(ck)
    outs = _run_cluster(argv, 2, tmp_path)  # the snapshots cover the whole run
    _assert_rank0_prints(outs, expect)
    assert b"Resuming from checkpoint" in outs[0][2]


def test_distributed_early_term_rechecked_on_merged_totals(rng, tmp_path):
    """A -m threshold between the largest rank's hits and the total: no
    rank stops on its own, the merged result reports the threshold."""
    from ntsm_tpu_torch.count.golden import count_files
    from ntsm_tpu_torch.io.sites import load_site_table

    sites_path, paths = _world(rng, tmp_path, n_files=4)
    table = load_site_table(sites_path, 19, allow_dupes=False)
    shard_hits = [count_files(table, host_file_shard(paths, process_id=p, num=2)).total_hits
                  for p in range(2)]
    total = sum(shard_hits)
    thr = (max(shard_hits) + total) / 2.0
    assert max(shard_hits) < thr < total
    m = 2.0 * thr / table.n_kmers  # max_counts = n_kmers * m / 2 == thr
    outs = _run_cluster(["count", "--device", "cpu", "-m", f"{m:.9f}", "-s", sites_path, *paths],
                        2, tmp_path)
    for rc, _, err in outs:
        assert rc == 0, err.decode()
        assert b"Reached desired (-m) threshold" in err
    assert outs[0][1].decode() == _golden_stdout(sites_path, paths)


def _stale_world(rng, tmp_path):
    sites_path, paths = _world(rng, tmp_path, n_files=4)
    ck = str(tmp_path / "snap.npz")
    with open(ck + ".rank0of4", "wb") as fh:  # from an earlier run of 4 processes
        fh.write(b"stale")
    return ["count", "--checkpoint", ck, "--checkpoint-every", "1", "-s", sites_path, *paths]


def test_distributed_checkpoint_world_size_mismatch_errors(rng, tmp_path):
    argv = _stale_world(rng, tmp_path)
    outs = _run_cluster([argv[0], "--device", "cpu", *argv[1:]], 2, tmp_path)
    assert all(rc == 1 for rc, _, _ in outs), outs[0][2].decode()
    assert b"different world size" in outs[0][2]
    assert outs[0][1] == b""


def test_world_size_mismatch_text_is_jax(rng, tmp_path):
    """One process under NTSM_DISTRIBUTED=1 (world 1, tag .rank0of1) with a
    snapshot of 4 processes: the port's stderr and exit code are the JAX
    CLI's, which exits there before it counts."""
    argv = _stale_world(rng, tmp_path)
    env = dict(os.environ, NTSM_DISTRIBUTED="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE"):
        env.pop(name, None)
    runs = [subprocess.run([sys.executable, "-m", pkg, argv[0], *extra, *argv[1:]], env=env,
                           capture_output=True, cwd=str(tmp_path), timeout=TIMEOUT)
            for pkg, extra in (("ntsm_tpu", []), ("ntsm_tpu_torch", ["--device", "cpu"]))]
    want, got = runs
    assert want.returncode == got.returncode == 1
    line = [ln for ln in want.stderr.decode().splitlines() if "different world size" in ln]
    assert line and line[0] in got.stderr.decode().splitlines()
    assert got.stdout == b""


def _one_process_eval(capsys, args) -> str:
    assert eval_cmd.run(["--device", "cpu", *args]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("block_pairs", [None, 2])
def test_two_process_eval_matches_one_process(capsys, tmp_path, block_pairs):
    """Rank 0's table byte-identical to the one-process port's; with
    blocks of 2 pairs both ranks score blocks and rank 0 gathers them.
    Scores within 1e-9 max(1, |score|) of the JAX exact engine, the
    tolerance the device engine holds (the integer columns equal); the
    -e merge file written once, equal to the one-process one."""
    import io

    from ntsm_tpu.eval.driver import run_eval as jax_run_eval
    from ntsm_tpu.eval.model import load_count_data as jax_load
    from ntsm_tpu.options import Options as JaxOptions

    merged = tmp_path / "merged.txt"
    one_merged = tmp_path / "one_merged.txt"
    expect = _one_process_eval(capsys, ["-a", "-e", str(one_merged), *EVAL_FILES])
    outs = _run_cluster(["eval", "-a", "--device", "cpu", "-e", str(merged), *EVAL_FILES], 2,
                        tmp_path, block_pairs=block_pairs)
    _assert_rank0_prints(outs, expect)
    assert merged.read_bytes() == one_merged.read_bytes()

    opts = JaxOptions(all=True, engine="exact")
    buf = io.StringIO()
    jax_run_eval(jax_load(EVAL_FILES, opts), opts, buf)
    got, want = expect.splitlines(), buf.getvalue().splitlines()
    assert len(got) == len(want) == 11 and got[0] == want[0]
    for lg, lw in zip(got[1:], want[1:]):
        fg, fw = lg.split("\t"), lw.split("\t")
        assert fg[:2] == fw[:2] and fg[3:] == fw[3:]
        assert abs(float(fg[2]) - float(fw[2])) <= 1e-9 * max(1.0, abs(float(fw[2])))


def test_two_process_eval_pca_runs_whole_on_every_rank(capsys, tmp_path):
    """-p has no row blocks to deal out: each rank scores it whole, and
    rank 0's table is the one-process one."""
    args = ["-a", "-d", "5", "-p", os.path.join(FIX, "rotation.tsv"),
            "-n", os.path.join(FIX, "center.txt"), *EVAL_FILES]
    expect = _one_process_eval(capsys, args)
    outs = _run_cluster(["eval", "--device", "cpu", *args], 2, tmp_path)
    _assert_rank0_prints(outs, expect)


def test_host_file_shard_partition():
    paths = [f"f{i}" for i in range(7)]
    shards = [host_file_shard(paths, process_id=p, num=3) for p in range(3)]
    assert sorted(x for s in shards for x in s) == sorted(paths)
    assert shards[0] == ["f0", "f3", "f6"]
    assert host_file_shard(paths) == paths  # one process


def test_merge_count_results_single_process_identity():
    r = CountResult(counts=np.arange(5, dtype=np.int64), total_kmers=10, total_hits=4,
                    total_bases=100, total_reads=2, early_term=False)
    assert merge_count_results(r) is r


@pytest.mark.parametrize("cmd", ["count", "eval"])
def test_ntsm_distributed_without_a_group_is_one_process(capsys, monkeypatch, cmd):
    """NTSM_DISTRIBUTED=1 and no rendezvous variables: one process, whose
    output is a plain run's."""
    for name in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
                 "MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    if cmd == "count":
        mod, args = count_cmd, ["--device", "cpu", "-s", os.path.join(FIX, "sites.fa"),
                                os.path.join(FIX, "sampleA.fq")]
    else:
        mod, args = eval_cmd, ["--device", "cpu", "-a", *EVAL_FILES]
    assert mod.run(args) == 0
    plain = capsys.readouterr().out
    monkeypatch.setenv("NTSM_DISTRIBUTED", "1")
    assert mod.run(args) == 0
    out = capsys.readouterr()
    assert out.out == plain and "Time:" in out.err
    assert not torch.distributed.is_initialized()
