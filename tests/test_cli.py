"""End-to-end CLI test: fastq.gz + FASTA -> BAM outputs."""

import gzip
import os

import numpy as np
import pytest

from lariat_tpu import cli
from lariat_tpu.io.bamread import BamFile

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_end_to_end(tmp_path):
    rng = np.random.default_rng(11)
    genome = BASES[rng.integers(0, 4, 30000)].tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")

    def pair(pos, insert=300):
        r1 = genome[pos:pos + 100]
        r2 = genome[pos + insert - 100:pos + insert].translate(COMP)[::-1]
        return r1.decode(), r2.decode()

    fq = tmp_path / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        qual = "I" * 100
        for bc_i, bc in enumerate(["AAACAGAGAAAGAT-1", "CCCTGAGAAAAGAT-1"]):
            for i in range(8):
                pos = 2000 + bc_i * 9000 + i * 250
                r1, r2 = pair(pos)
                f.write(f"@bc{bc_i}:r{i} rg1\n{r1}\n{qual}\n{r2}\n{qual}\n"
                        f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    out = tmp_path / "out"
    rc = cli.main(["-reads", str(fq), "-genome", str(fasta),
                   "-output", str(out), "-read_groups", "s:lib:1:fc:1",
                   "-first_chunk"])
    assert rc == 0
    bam = BamFile(str(out / "bc_sorted_bam.bam"))
    recs = list(bam)
    assert len(recs) == 32  # 16 pairs
    assert all(not r.is_unmapped for r in recs)
    assert all(r.is_proper_pair for r in recs)
    # barcode order preserved (bc0 reads before bc1)
    bx = [r.tags["BX"] for r in recs]
    assert bx == sorted(bx)
    # index reused on second run
    assert os.path.exists(str(fasta) + ".lariat.npz")


def test_cli_debug_flags(tmp_path, capfd):
    """-debugBamTags emits the full debug tag set; -debugPrintMove prints."""
    rng = np.random.default_rng(21)
    genome = bytearray(BASES[rng.integers(0, 4, 40000)].tobytes())
    genome[22000:23000] = genome[2000:3000]  # duplication -> second-best hits
    genome = bytes(genome)
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "reads.fastq.gz"
    import gzip
    with gzip.open(fq, "wt") as f:
        qual = "I" * 100
        bc = "AAACAGAGAAAGAT-1"
        for i in range(8):
            pos = 1900 + i * 150
            r1 = genome[pos:pos + 100].decode()
            r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1].decode()
            f.write(f"@d:r{i} rg\n{r1}\n{qual}\n{r2}\n{qual}\n"
                    f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                    f"ACGTACGT\nIIIIIIII\n")
    out = tmp_path / "out"
    rc = cli.main(["-reads", str(fq), "-genome", str(fasta),
                   "-output", str(out), "-debugBamTags", "-debugPrintMove",
                   "-debug", "-threads", "1", "-first_chunk"])
    from lariat_tpu.rfa import debug as rfa_debug
    rfa_debug.PRINT_MOVE = False  # reset for other tests
    rfa_debug.DEBUG = False
    assert rc == 0
    captured = capfd.readouterr()
    assert "NOW TESTING MAPQS" in captured.out
    raw = open(out / "bc_sorted_bam.bam", "rb").read()
    import zlib
    # decompress all BGZF blocks and look for the debug tags
    data = b""
    off = 0
    while off < len(raw):
        xlen = int.from_bytes(raw[off + 10:off + 12], "little")
        bsize = None
        x = raw[off + 12:off + 12 + xlen]
        i = 0
        while i < len(x):
            if x[i:i + 2] == b"BC":
                bsize = int.from_bytes(x[i + 4:i + 6], "little") + 1
            i += 4 + int.from_bytes(x[i + 2:i + 4], "little")
        data += zlib.decompress(raw[off + 12 + xlen:off + bsize - 8],
                                -15)
        off += bsize
    for tag in (b"AAZ", b"CPZ", b"CMZ", b"CUZ", b"CSZ", b"RDZ", b"MSZ",
                b"MCZ", b"PPZ", b"PSZ", b"PLZ", b"ACZ", b"PCZ"):
        assert tag in data, tag
    # duplicated region should yield second-best debug tags on some read
    assert b"XLZ" in data and b"XPZ" in data and b"XRZ" in data
    # -debug populates the AA tag with molecule-move diagnostics
    # (debugStrings, lariat.go:994-1046)
    assert b"mv_S->T" in data and b"mv_T->S" in data


def test_cli_byte_determinism(tmp_path):
    """Two runs with identical arguments produce byte-identical BAMs
    (4 workers; ordering and compression must be deterministic)."""
    import glob
    import gzip
    import subprocess
    import sys as _sys
    rng = np.random.default_rng(5)
    genome = BASES[rng.integers(0, 4, 50000)].tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "r.fastq.gz"
    qual = "I" * 100
    with gzip.open(fq, "wt") as f:
        for b in range(6):
            bc = f"AAACAGAGAAAG{'ACGT'[b % 4]}{'ACGT'[b // 4]}-1"
            for i in range(6):
                pos = 2000 + b * 7000 + i * 300
                r1 = genome[pos:pos + 100].decode()
                r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1].decode()
                f.write(f"@d{b}:r{i} x\n{r1}\n{qual}\n{r2}\n{qual}\n"
                        f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    out = tmp_path / "out"
    snap = None
    for _run in range(2):
        r = subprocess.run(
            [_sys.executable, "-m", "lariat_tpu.cli", "-reads", str(fq),
             "-genome", str(fasta), "-output", str(out), "-threads", "2",
             "-first_chunk"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr[-2000:]
        cur = {p.split("/")[-1]: open(p, "rb").read()
               for p in glob.glob(str(out / "*.bam"))}
        if snap is None:
            snap = cur
        else:
            assert sorted(cur) == sorted(snap)
            assert not [k for k in cur if cur[k] != snap[k]]


def test_cli_native_vs_python_stacks_identical(tmp_path):
    """The C++ engine stack (align1/reg2aln/walks/ksw) and the pure-Python
    reference stack must produce byte-identical BAMs end to end
    (LARIAT_NO_NATIVE_* flip every native dispatch at once)."""
    import glob
    import gzip
    import subprocess
    import sys as _sys
    rng = np.random.default_rng(29)
    genome = bytearray(BASES[rng.integers(0, 4, 60000)].tobytes())
    genome[31000:32000] = genome[3000:4000]  # ambiguity for RFA
    genome = bytes(genome)
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "r.fastq.gz"
    qual = "I" * 100
    with gzip.open(fq, "wt") as f:
        for b in range(4):
            bc = f"AAACAGAGAAAG{'ACGT'[b]}T-1"
            for i in range(8):
                pos = 2500 + b * 8000 + i * 400
                r1b = bytearray(genome[pos:pos + 100])
                r1b[int(rng.integers(0, 100))] = BASES[int(rng.integers(0, 4))]
                r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1]
                f.write(f"@s{b}:r{i} x\n{bytes(r1b).decode()}\n{qual}\n"
                        f"{r2.decode()}\n{qual}\n"
                        f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    out = tmp_path / "out"
    snap = None
    for env_extra in ({}, {"LARIAT_NO_NATIVE_KSW": "1",
                           "LARIAT_NO_NATIVE_ALIGN1": "1"}):
        r = subprocess.run(
            [_sys.executable, "-m", "lariat_tpu.cli", "-reads", str(fq),
             "-genome", str(fasta), "-output", str(out), "-threads", "2",
             "-first_chunk"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu", **env_extra})
        assert r.returncode == 0, r.stderr[-1500:]
        cur = {p.split("/")[-1]: open(p, "rb").read()
               for p in glob.glob(str(out / "*.bam"))}
        if snap is None:
            snap = cur
        else:
            assert sorted(cur) == sorted(snap)
            assert not [k for k in cur if cur[k] != snap[k]]


def test_cli_device_primed_matches_host(tmp_path):
    """-use_device on (CPU backend: same priming code path — threads,
    groups, shipped sras) must produce byte-identical BAMs to the host
    path."""
    import glob
    import gzip
    import subprocess
    import sys as _sys
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 60000)].tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "r.fastq.gz"
    qual = "I" * 100
    with gzip.open(fq, "wt") as f:
        for b in range(5):
            bc = f"AAACAGAGAAAG{'ACGT'[b % 4]}{'ACGT'[b // 4]}-1"
            for i in range(7):
                pos = 1500 + b * 9000 + i * 310
                r1 = genome[pos:pos + 100].decode()
                r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1].decode()
                f.write(f"@p{b}:r{i} x\n{r1}\n{qual}\n{r2}\n{qual}\n"
                        f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    outs = {}
    for mode in ("off", "on"):
        out = tmp_path / f"out_{mode}"
        r = subprocess.run(
            [_sys.executable, "-m", "lariat_tpu.cli", "-reads", str(fq),
             "-genome", str(fasta), "-output", str(out), "-threads", "2",
             "-use_device", mode, "-first_chunk"],
            capture_output=True, text=True, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "LARIAT_PRIME_THREADS": "2"})
        assert r.returncode == 0, r.stderr[-2000:]
        outs[mode] = {p.split("/")[-1]: open(p, "rb").read()
                      for p in glob.glob(str(out / "*.bam"))}
        if mode == "on":
            # every pair primed on the device, none host-routed
            assert "primed pairs 35  host pairs 0" in r.stdout, r.stdout
    assert sorted(outs["on"]) == sorted(outs["off"])
    # @PG CL embeds -output and -use_device: compare past the header block
    for k in outs["off"]:
        a, b = outs["off"][k], outs["on"][k]
        # BGZF blocks differ only if contents differ; headers contain the
        # CL line, so compare decompressed bodies
        from lariat_tpu.io.bamread import BamFile
        ra = list(BamFile(str(tmp_path / "out_off" / k)))
        rb = list(BamFile(str(tmp_path / "out_on" / k)))
        assert ra == rb, k


def _tiny_inputs(tmp_path):
    rng = np.random.default_rng(3)
    genome = BASES[rng.integers(0, 4, 20000)].tobytes()
    fasta = tmp_path / "g.fa"
    fasta.write_text(">chr1\n" + genome.decode() + "\n")
    fq = tmp_path / "r.fastq"
    qual = "I" * 100
    with open(fq, "w") as f:
        bc = "AAACAGAGAAAGAT-1"
        for i in range(4):
            pos = 1000 + i * 400
            r1 = genome[pos:pos + 100].decode()
            r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1].decode()
            f.write(f"@t:r{i} x\n{r1}\n{qual}\n{r2}\n{qual}\n"
                    f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                    f"ACGTACGT\nIIIIIIII\n")
    return fasta, fq


def test_cli_use_device_on_without_gpu_fails(tmp_path):
    """-use_device on means the card: with no GPU and no explicit CPU pin
    the run fails instead of host-routing every pair."""
    import subprocess
    import sys as _sys
    fasta, fq = _tiny_inputs(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run(
        [_sys.executable, "-m", "lariat_tpu.cli", "-reads", str(fq),
         "-genome", str(fasta), "-output", str(tmp_path / "out"),
         "-threads", "2", "-use_device", "on"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode != 0
    assert "-use_device on needs a GPU" in r.stderr
    assert "Lariat completed successfully" not in r.stdout


def test_cli_use_device_on_needs_worker_pool(tmp_path):
    """-threads 1 runs no device priming, so -use_device on refuses it."""
    fasta, fq = _tiny_inputs(tmp_path)
    with pytest.raises(SystemExit, match="needs -threads >= 2"):
        cli.main(["-reads", str(fq), "-genome", str(fasta), "-output",
                  str(tmp_path / "out"), "-threads", "1",
                  "-use_device", "on"])


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_dir(tmp_path, set_env):
    """JAX_COMPILATION_CACHE_DIR is honoured as set; without it the cache
    is the fixed .jax_cache/ at the root of the checkout."""
    import subprocess
    import sys as _sys
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache")
    if set_env:
        want = str(tmp_path / "cache")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [_sys.executable, "-c", "import jax, lariat_tpu.ops; "
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, cwd=str(tmp_path),
        env={**env, "PYTHONPATH": REPO}, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want
