"""chip_smoke.py on the CPU: its input generation, its BAM comparison, and
its refusal to report a result without a GPU."""

import gzip
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

TINY = dict(scale=0.0005, barcodes=3, pairs_per_bc=4)


def _snapshot(fa, fq):
    files = {"fa": open(fa, "rb").read(),
             "fq": gzip.open(fq, "rb").read()}
    d = fa + ".lariat.d"
    for name in sorted(os.listdir(d)):
        files[name] = open(os.path.join(d, name), "rb").read()
    return files


def test_inputs_deterministic_under_seed(tmp_path):
    """The same --seed makes the same genome, index and reads; another
    seed makes other ones."""
    a = _snapshot(*chip_smoke.make_inputs(str(tmp_path / "a"), 3,
                                          **TINY)[:2])
    b = _snapshot(*chip_smoke.make_inputs(str(tmp_path / "b"), 3,
                                          **TINY)[:2])
    c = _snapshot(*chip_smoke.make_inputs(str(tmp_path / "c"), 4,
                                          **TINY)[:2])
    assert a == b
    assert a["fa"] != c["fa"] and a["fq"] != c["fq"]
    assert a["fq"].count(b"\n") == 9 * 3 * 4    # 9-line records


def test_compare_bams_catches_changed_record(tmp_path):
    """compare_bams passes identical outputs and flags one changed MAPQ."""
    from lariat_tpu import cli
    from lariat_tpu.io.bamread import BamFile
    fa, fq, _ = chip_smoke.make_inputs(str(tmp_path / "d"), 5, **TINY)
    out = tmp_path / "out"
    assert cli.main(["-reads", fq, "-genome", fa, "-output", str(out),
                     "-threads", "1"]) == 0
    n = chip_smoke.compare_bams(str(out), str(out))
    assert n > 0
    bad = tmp_path / "bad"
    shutil.copytree(out, bad)
    path = str(bad / "bc_sorted_bam.bam")
    start = BamFile(path)._records_start
    data = bytearray(gzip.open(path, "rb").read())
    data[start + 4 + 9] ^= 0x01          # MAPQ byte of the first record
    with gzip.open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(AssertionError, match="record 0 differs"):
        chip_smoke.compare_bams(str(out), str(bad))


def test_smoke_fails_without_gpu(tmp_path):
    """On the CPU the smoke stops at its environment phase: non-zero exit
    and no result line."""
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--data",
         str(tmp_path / "data")],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stdout + r.stderr
    assert not os.path.exists(tmp_path / "data")


def test_smoke_fails_outside_checkout(tmp_path):
    """Alone in a directory, without the repository, the smoke refuses to
    run: non-zero exit and no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
