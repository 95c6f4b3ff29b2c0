"""Fault injection for the port's threaded and distributed paths (the twins
of tests/test_fault_injection.py): a failing component must surface a
clean exception within a bounded time, never hang the pipeline.  The port
has no NumPy parser fallback (its native runtime is built or the parse
raises), so these tests never skip for want of it."""
import gzip
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from util import random_reads, write_fastq

HERE = os.path.dirname(__file__)


# ---- parser threads ----

def test_corrupt_gz_mid_stream_raises(tmp_path):
    """A parser thread hitting a corrupt .gz mid-stream propagates the
    error to the consumer (no hang, no silent truncation)."""
    from kmc_tpu_torch.io import readers

    paths = [str(write_fastq(tmp_path / f"g{i}.fastq",
                             random_reads(50, 90, seed=i))) for i in range(3)]
    bad = tmp_path / "bad.fastq.gz"
    good_gz = gzip.compress(open(paths[1], "rb").read())
    bad.write_bytes(good_gz[: len(good_gz) // 2] + b"\x00garbage\xff" * 200)
    t0 = time.monotonic()
    with pytest.raises(OSError):
        for _ in readers.parallel_code_stream([paths[0], str(bad), paths[2]],
                                              "fastq", n_threads=3):
            pass
    assert time.monotonic() - t0 < 60, "error took too long to surface"


def test_parser_exception_does_not_hang_consumer(tmp_path, monkeypatch):
    """An arbitrary exception inside a reader thread (not just an IO
    error) unwinds through the queue protocol."""
    from kmc_tpu_torch.io import native, readers

    paths = [str(write_fastq(tmp_path / f"h{i}.fastq",
                             random_reads(2000, 90, seed=i)))
             for i in range(4)]
    calls = []
    real_parse = native.NativeParser.parse

    def exploding(self, buf):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected parser fault")
        return real_parse(self, buf)

    monkeypatch.setattr(native.NativeParser, "parse", exploding)
    monkeypatch.setattr(readers, "CHUNK_BYTES", 1 << 12)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected parser fault"):
        for _ in readers.parallel_code_stream(paths, "fastq", n_threads=3):
            pass
    assert time.monotonic() - t0 < 60


def test_runner_propagates_reader_fault(tmp_path):
    """count() over a truncated gzip input raises instead of writing a
    wrong database."""
    from kmc_tpu_torch import count

    plain = write_fastq(tmp_path / "ok.fastq", random_reads(100, 90, seed=7))
    gz = tmp_path / "broken.fastq.gz"
    blob = gzip.compress(open(plain, "rb").read())
    gz.write_bytes(blob[: len(blob) - 40])  # truncated member
    with pytest.raises(Exception):
        count([str(gz)], str(tmp_path / "out"), k=25, cutoff_min=1,
              batch_positions=1 << 12, device="cpu")
    assert not (tmp_path / "out.kmc_pre").exists()


# ---- checkpoint integrity ----

def test_truncated_checkpoint_raises_cleanly(tmp_path):
    """Resuming from a truncated stage-1 checkpoint raises instead of
    feeding garbage rows to stage 2."""
    from kmc_tpu_torch import Runner, Stage1Params

    fq = write_fastq(tmp_path / "c.fastq", random_reads(200, 90, seed=3))
    r = Runner(device="cpu")
    p1 = Stage1Params(input_files=[str(fq)], kmer_len=21,
                      batch_positions=1 << 12)
    r.run_stage1(p1)
    r.save_stage1_checkpoint(str(tmp_path / "ck"))
    path = next(tmp_path.glob("ck*"))
    blob = path.read_bytes()
    path.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(Exception):
        Runner(device="cpu").resume_stage1_checkpoint(
            str(path).replace(".npz", ""), p1)


# ---- a peer process dies ----

def test_peer_death_fails_survivor_within_heartbeat(tmp_path):
    """One of two torch.distributed processes dies abruptly mid-run; the
    survivor's next collective must fail (a dead peer closes its
    connections; the 10 s timeout bounds a hung one) rather than hang."""
    rng = np.random.default_rng(0)
    genome = rng.integers(0, 4, 60_000)
    fq = tmp_path / "big.fastq"
    with open(fq, "w") as f:
        for i in range(6000):
            start = rng.integers(0, len(genome) - 130)
            seq = "".join("ACGT"[c] for c in genome[start : start + 130])
            f.write(f"@r{i}\n{seq}\n+\n{'I' * len(seq)}\n")
    env = dict(os.environ)
    env.update({
        "MP_HEARTBEAT_SECS": "10",
        "MP_CRASH_SECS": "2.0",
        "MP_CRASH_PID": "1",
        "MP_BATCH": str(1 << 9),  # many lockstep groups: the crash lands mid-run
        "MP_CAPACITY": str(1 << 12),
    })
    init = f"file://{tmp_path / 'pg_init'}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multiproc_worker.py"),
         init, "2", str(pid), str(fq), str(tmp_path / "fi_db")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    t0 = time.monotonic()
    outs, codes = [], []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0].decode(
                errors="replace"))
            codes.append(p.returncode)
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        pytest.fail("survivor hung past the failure-detection bound")
    wall = time.monotonic() - t0
    assert codes[1] == 17, f"crasher exited {codes[1]}:\n{outs[1][-2000:]}"
    assert codes[0] not in (0, None), (
        f"survivor claimed success after peer death:\n{outs[0][-2000:]}")
    assert wall < 180, f"took {wall:.0f}s to fail"
    assert not (tmp_path / "fi_db.default.kmc_pre").exists()
