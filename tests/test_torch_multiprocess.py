"""Multi-process counting in the port: two torch.distributed (gloo)
processes x two CPU shards each, one 4-shard store (the twins of
tests/test_multiprocess.py, whose 2 x 4 jax processes stay kmc_tpu's).
Rank 0's database must be byte-identical to the port's single-process
distributed_count on 4 CPU shards and to kmc_tpu's on a 4-device mesh, in
every mode, with both ranks reporting the same global stats.  Workers are
fresh interpreters (tests/torch_multiproc_worker.py) that meet through a
file:// store under tmp_path, so parallel test workers race for no port;
each spawn runs several modes in sequence."""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_multiproc_worker import MODES

HERE = os.path.dirname(__file__)
KNOBS = dict(k=25, batch_positions=1 << 10, cutoff_min=1)
# per-process parse accounting and clocks
LOCAL = ("n_reads_local", "consumed_bytes_local", "timings")
# follow the deal of batches to shards, which a process group changes
# unless every process reads the whole stream
DEAL = ("n_compactions", "n_spills", "n_remerges", "exchange_bytes",
        "merge_launches")


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    rng = np.random.default_rng(11)
    path = tmp_path_factory.mktemp("mp") / "reads.fastq"
    genome = rng.integers(0, 4, 30000)
    with open(path, "w") as f:
        for i in range(500):
            start = rng.integers(0, len(genome) - 130)
            seq = "".join("ACGT"[c] for c in genome[start : start + 130])
            if i % 40 == 3:
                seq = seq[:60] + "N" + seq[61:]
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    return str(path)


def run_workers(d: Path, reads, env_extra, n_procs=2, timeout=600):
    """Spawn the workers into directory d; returns d / "out"."""
    d.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ)
    env.update(env_extra)
    init = f"file://{d / 'pg_init'}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multiproc_worker.py"),
         init, str(n_procs), str(pid), reads, str(d / "out")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(n_procs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{o[-4000:]}"
    return d / "out"


def results(out: Path, mode: str, n_procs: int = 2):
    """Every rank's result file of one mode."""
    name = mode.replace("@", "_")
    return [json.loads(Path(f"{out}.{name}.stats.{pid}").read_text())
            for pid in range(n_procs)]


def global_stats(st):
    return {k: v for k, v in st.items() if k not in LOCAL}


def single(reads, out, mode, **kw):
    """The port's single-process count on 4 CPU shards with the workers'
    default shard rows (the spill mode's 2^11), JSON round-tripped like the
    workers' stats."""
    from kmc_tpu_torch.parallel.multihost import distributed_count

    rows = dict(capacity_rows_per_device=1 << 11 if mode == "spill"
                else 1 << 12)
    st = distributed_count([reads], str(out), devices=["cpu"] * 4,
                           **dict(KNOBS, **MODES[mode], **dict(rows, **kw)))
    return json.loads(json.dumps(st))


def files_of(prefix: Path, mode: str):
    sufs = (".kff",) if mode == "kff" else (
        () if mode == "e" else (".kmc_pre", ".kmc_suf"))
    return [Path(f"{prefix}{suf}") for suf in sufs]


def same_files(a: Path, b: Path, mode: str):
    for fa, fb in zip(files_of(a, mode), files_of(b, mode)):
        assert fa.read_bytes() == fb.read_bytes(), fa.name


@pytest.fixture(scope="module")
def modes_run(tmp_path_factory, reads_file):
    """One spawn, every mode; the input is below min_shard_bytes, so
    process 1 parses all of it and process 0 pads its shards."""
    d = tmp_path_factory.mktemp("mp_modes")
    return run_workers(d, reads_file, {"MP_MODES": ",".join(MODES)})


@pytest.mark.parametrize("mode", list(MODES))
def test_two_process_modes_match_single(modes_run, reads_file, tmp_path,
                                        mode):
    r0, r1 = results(modes_run, mode)
    s0, s1 = r0["stats"], r1["stats"]
    assert global_stats(s0) == global_stats(s1)
    assert s0["n_processes"] == 2 and s0["n_devices"] == 4
    assert r0["launches"] == r1["launches"] == 0  # CPU shards: the plain route
    if mode not in ("e", "k13"):
        assert s0["timings"]["exchange_route"] == "plain"
    sp = single(reads_file, tmp_path / "sp", mode)
    skip = LOCAL + DEAL + ("n_processes",)
    assert {k: v for k, v in s0.items() if k not in skip} == \
           {k: v for k, v in sp.items() if k not in skip}
    assert s0["n_reads"] == 500
    same_files(Path(f"{modes_run}.{mode}"), tmp_path / "sp", mode)


def test_two_process_count_matches_kmc_tpu(modes_run, reads_file, tmp_path):
    from kmc_tpu import oracle
    from kmc_tpu.formats import dump_db_file
    from kmc_tpu.parallel.distributed import make_mesh
    from kmc_tpu.parallel.multihost import distributed_count

    out = Path(f"{modes_run}.default")
    s0 = results(modes_run, "default")[0]["stats"]
    records, ostats = oracle.oracle_count_file(reads_file, 25, "fastq",
                                               cutoff_min=1)
    assert dump_db_file(str(out)) == oracle.dump_text(records)
    assert (s0["n_unique"], s0["n_total"]) == (ostats["n_unique"],
                                               ostats["n_total"])
    sj = distributed_count([reads_file], str(tmp_path / "jax"),
                           mesh=make_mesh(4),
                           capacity_rows_per_device=1 << 12, **KNOBS)
    assert (s0["n_super_kmers"], s0["n_reads"]) == (sj["n_super_kmers"],
                                                    sj["n_reads"])
    same_files(out, tmp_path / "jax", "default")


def test_two_process_sharded_input_exact(reads_file, tmp_path):
    """MP_MIN_SHARD=4096 splits the file: each process parses a disjoint
    byte range and threads the super-k-mer carry through its own shards,
    and the database and n_super_kmers still equal one process's."""
    from kmc_tpu_torch.io.readers import process_input_shards

    parts = process_input_shards([reads_file], "fastq", 2,
                                 min_shard_bytes=4096)
    assert all(parts), [len(p) for p in parts]
    modes = ("default", "kff", "greedy")
    out = run_workers(tmp_path / "mp", reads_file,
                      {"MP_MIN_SHARD": "4096", "MP_MODES": ",".join(modes)})
    for mode in modes:
        r0, r1 = results(out, mode)
        s0, s1 = r0["stats"], r1["stats"]
        assert global_stats(s0) == global_stats(s1), mode
        assert (s0["consumed_bytes_local"] + s1["consumed_bytes_local"]
                == os.path.getsize(reads_file))
        assert s0["consumed_bytes_local"] > 0 and s1["consumed_bytes_local"] > 0
        assert s0["n_reads_local"] + s1["n_reads_local"] == 500
        assert s0["n_reads"] == 500
        sp = single(reads_file, tmp_path / f"sp_{mode}", mode)
        for key in ("n_super_kmers", "n_total", "n_unique", "n_below",
                    "n_above"):
            assert s0[key] == sp[key], (mode, key)
        same_files(Path(f"{out}.{mode}"), tmp_path / f"sp_{mode}", mode)


def test_two_process_compaction_and_spill(reads_file, tmp_path):
    """Shards of 2^11 rows compact and spill.  With every process reading
    the whole stream the deal is one process's, so the spills, re-merges
    (a budget of 700 kB), the bytes and the MemoryError of a 1 kB budget
    fall as in the single-process count, on both ranks."""
    modes = ("default", "default@700000", "default@1024", "kff")
    out = run_workers(tmp_path / "mp", reads_file, {
        "MP_CAPACITY": str(1 << 11), "MP_SHARD_INPUT": "0",
        "MP_MODES": ",".join(modes)})
    import dataclasses

    from kmc_tpu_torch import memory

    planned = memory.plan_memory
    for mode in modes:
        name, _, budget = mode.partition("@")
        r0, r1 = results(out, mode)
        if budget:
            memory.plan_memory = lambda *a, **kw: dataclasses.replace(
                planned(*a, **kw), spill_budget_bytes=int(budget))
        try:
            sp = single(reads_file, tmp_path / "sp", name,
                        capacity_rows_per_device=1 << 11)
        except MemoryError as e:
            assert r0 == r1 == {"error": "MemoryError", "message": str(e)}
            assert "-m" in str(e)
            assert not Path(f"{out}.default_1024.kmc_pre").exists()
            continue
        finally:
            memory.plan_memory = planned
        assert "error" not in r0 and "error" not in r1, mode
        s0, s1 = r0["stats"], r1["stats"]
        assert global_stats(s0) == global_stats(s1), mode
        assert {k: v for k, v in s0.items()
                if k not in LOCAL + ("n_processes",)} == \
               {k: v for k, v in sp.items()
                if k not in LOCAL + ("n_processes",)}, mode
        assert s0["n_spills"] >= 2, mode
        if budget:
            assert s0["n_remerges"] >= 1
        same_files(Path(f"{out}.{mode.replace('@', '_')}"), tmp_path / "sp",
                   name)
    assert results(out, "default@1024")[0].get("error") == "MemoryError"


def test_two_process_sharded_input_spill_matches_kmc_tpu(reads_file,
                                                         tmp_path):
    """The twin of kmc_tpu's two-process compaction and spill test: shards
    of 2^11 rows with the input parsed by one process, the database
    byte-identical to kmc_tpu's distributed_count on a 4-device mesh."""
    from kmc_tpu.parallel.distributed import make_mesh
    from kmc_tpu.parallel.multihost import distributed_count

    out = run_workers(tmp_path / "mp", reads_file,
                      {"MP_CAPACITY": str(1 << 11)})
    r0, r1 = results(out, "default")
    assert global_stats(r0["stats"]) == global_stats(r1["stats"])
    assert r0["stats"]["n_spills"] >= 1
    distributed_count([reads_file], str(tmp_path / "jax"), mesh=make_mesh(4),
                      capacity_rows_per_device=1 << 11, **KNOBS)
    same_files(Path(f"{out}.default"), tmp_path / "jax", "default")


@pytest.mark.parametrize("positions,want", [
    ([0, 1], [([0, 1], None), ([4, 5], 3), ([8, 9], 7)]),
    ([2, 3], [([2, 3], 1), ([6, 7], 5), ([], None)]),
    ([3], [([3], 2), ([7], 6), ([], None)]),
])
def test_serial_deal_takes_own_positions(positions, want):
    """Without sharded input a process takes its positions of each group
    of D batches, its first shard's carry from the batch before (another
    process's), and nothing of a last group too short to reach it."""
    from types import SimpleNamespace

    from kmc_tpu_torch.parallel.multihost import _serial_deal

    fleet = SimpleNamespace(D=4, positions=positions)
    got = list(_serial_deal(iter(range(10)), fleet, lambda b: b,
                            lambda b: b))
    assert got == want


@pytest.mark.parametrize("k", [14, 25, 33])
def test_last_signature_is_the_ingest_carry(k):
    """_last_signature (the host's plain scan of a batch's last positions)
    equals the prev_sig the store's ingest leaves after the batch."""
    from kmc_tpu_torch.io.native import pack_codes_fused
    from kmc_tpu_torch.io.readers import batch_len
    from kmc_tpu_torch.ops.store import DeviceKmerStore
    from kmc_tpu_torch.parallel.multihost import _last_signature

    s = 1 << 10
    rng = np.random.default_rng(k)
    for trial in range(4):
        batch = rng.integers(0, 4, batch_len(s, k)).astype(np.uint8)
        if trial == 1:
            batch[s - 1 + k // 2] = 4  # the last window holds a sentinel
        if trial == 2:
            batch[rng.random(len(batch)) < 0.02] = 4
        st = DeviceKmerStore(1 << 12, k=k, sig_len=9, both_strands=True,
                             n_bins=512, device="cpu")
        st.ingest_fused(pack_codes_fused(batch), s=s)
        want = st.prev_sig
        got = _last_signature(batch, s=s, k=k, sig_len=9, both_strands=True)
        assert got.dtype == want.dtype and torch.equal(got, want), trial


def test_four_processes_one_shard_each(reads_file, tmp_path):
    """Four processes of one CPU shard each, the input split four ways:
    one owner a process, so a process whose owner's bins hold no spilled
    row sends rank 0 no records; the files still equal one process's."""
    modes = ("default", "kff", "greedy", "spill")
    out = run_workers(tmp_path / "mp", reads_file, {
        "MP_DEVICES": "cpu", "MP_MIN_SHARD": "4096",
        "MP_MODES": ",".join(modes)}, n_procs=4)
    for mode in modes:
        res = results(out, mode, n_procs=4)
        assert all(global_stats(r["stats"]) == global_stats(res[0]["stats"])
                   for r in res), mode
        st = res[0]["stats"]
        assert st["n_processes"] == 4 and st["n_devices"] == 4
        assert sum(r["stats"]["consumed_bytes_local"] for r in res) == \
            os.path.getsize(reads_file)
        sp = single(reads_file, tmp_path / f"sp_{mode}", mode)
        for key in ("n_super_kmers", "n_total", "n_unique", "n_below",
                    "n_above", "n_reads"):
            assert st[key] == sp[key], (mode, key)
        if mode == "spill":
            assert st["n_spills"] >= 1
        same_files(Path(f"{out}.{mode}"), tmp_path / f"sp_{mode}", mode)
