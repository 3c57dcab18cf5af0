"""Merge engine: device int8 contingency vs oracle vs the executed reference."""

import json
import os

import numpy as np
import pytest

from pykmer_tpu.formats import kin as kinfmt
from pykmer_tpu.formats.kma import read_kma
from pykmer_tpu.index import create_fasta_index
from pykmer_tpu.merge import merge, pair_counts_stream
from pykmer_tpu.oracle import oracle_pair_counts
from conftest import make_random_fasta
from reference_runner import run_reference_merger


def _make_indexes(tmp_path, rng, n=3, kmer_len=5):
    paths = []
    for i in range(n):
        fasta = make_random_fasta(
            str(tmp_path / f"s{i}.fa"), rng, n_records=3,
            lengths=(300 + 40 * i, 150, 80),
        )
        header = create_fasta_index(fasta, f"s{i}", fasta, kmer_len, verbose=False)
        paths.append(header.index_file_root)
    return paths


def test_pair_counts_stream_matches_oracle(tmp_path, rng):
    kmer_len = 5
    paths = _make_indexes(tmp_path, rng, n=2, kmer_len=kmer_len)
    a = kinfmt.read_kin_array(*kinfmt.parse_kin_filename(paths[0]))
    b = kinfmt.read_kin_array(*kinfmt.parse_kin_filename(paths[1]))
    for mn, mx in [(1, 255), (1, 1), (2, 200)]:
        want = oracle_pair_counts(a, b, mn, mx)
        got = pair_counts_stream(paths[0], paths[1], 4**kmer_len, mn, mx,
                                 block_size=97)
        assert got == want


@pytest.mark.parametrize("engine", ["host", "device"])
def test_merge_matches_pairwise_stream(tmp_path, rng, monkeypatch, engine):
    kmer_len = 5
    paths = _make_indexes(tmp_path, rng, n=4, kmer_len=kmer_len)
    monkeypatch.chdir(tmp_path)
    project = str(tmp_path / "proj")
    data, matrix = merge(project, paths, block_size=101, engine=engine,
                         verbose=False)
    n = len(paths)
    assert matrix.shape == (n, n, 3)
    for k in range(n):
        for l in range(k + 1, n):
            kc, lc, sc = pair_counts_stream(paths[k], paths[l], 4**kmer_len)
            assert tuple(int(x) for x in matrix[k, l]) == (kc, lc, sc)
            assert tuple(int(x) for x in matrix[l, k]) == (lc, kc, sc)
    # outputs exist
    assert os.path.exists(f"{project}.001-255.kma")
    assert os.path.exists(f"{project}.001-255.kma.json")
    again = read_kma(f"{project}.001-255.kma")
    assert np.array_equal(again, matrix)


def test_merge_matches_reference(tmp_path, rng):
    kmer_len = 5
    paths = _make_indexes(tmp_path, rng, n=3, kmer_len=kmer_len)
    paths = sorted(paths)

    proc, refcwd = run_reference_merger("proj", paths, str(tmp_path))
    ref_kma = os.path.join(refcwd, "proj.001-255.kma")
    ref_matrix = read_kma(ref_kma)
    with open(ref_kma + ".json") as fh:
        ref_json = json.load(fh)

    ourdir = tmp_path / "ourmerge"
    ourdir.mkdir()
    project = str(ourdir / "proj")
    _, our_matrix = merge(project, paths, verbose=False)
    with open(f"{project}.001-255.kma.json") as fh:
        our_json = json.load(fh)

    n = len(paths)
    off = ~np.eye(n, dtype=bool)
    assert np.array_equal(our_matrix[off], ref_matrix[off]), \
        "off-diagonal .kma matrices differ (diagonal is unspecified in reference)"

    assert our_json["project_name"].endswith("proj")
    for key in ("min_count", "max_count"):
        assert our_json[key] == ref_json[key]
    assert len(our_json["data"]) == len(ref_json["data"])
    volatile = {"creation_time_start", "creation_time_end", "creation_duration",
                "output_file_ctime", "checksum_script"}
    for ours, refs in zip(our_json["data"], ref_json["data"]):
        assert ours["pos"] == refs["pos"]
        assert ours["index_file"] == refs["index_file"]
        assert ours["description_file"] == refs["description_file"]
        assert set(ours["header"]) == set(refs["header"])
        for key in refs["header"]:
            if key not in volatile:
                assert ours["header"][key] == refs["header"][key], f"header {key}"


def test_merge_guards(tmp_path, rng, monkeypatch):
    kmer_len = 3
    paths = _make_indexes(tmp_path, rng, n=2, kmer_len=kmer_len)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError):
        merge(str(tmp_path / "p"), paths, min_count=0, verbose=False)
    with pytest.raises(ValueError):
        merge(str(tmp_path / "p"), [str(tmp_path / "s0.fa")], verbose=False)
    merge(str(tmp_path / "p"), paths, verbose=False)
    with pytest.raises(FileExistsError):
        merge(str(tmp_path / "p"), paths, verbose=False)


def test_host_engine_numpy_fallback(tmp_path, rng, monkeypatch):
    """Host engine without the native library (numpy bitwise_count path)."""
    import sys

    kmer_len = 5
    paths = _make_indexes(tmp_path, rng, n=3, kmer_len=kmer_len)
    project = str(tmp_path / "np_proj")
    # sys.modules[name] = None makes `import name` raise ImportError, which
    # is exactly the native-less condition the fallback guards
    monkeypatch.setitem(sys.modules, "pykmer_tpu.io.native", None)
    _, matrix = merge(project, paths, block_size=77, engine="host",
                      verbose=False)
    for k in range(3):
        for l in range(k + 1, 3):
            kc, lc, sc = pair_counts_stream(paths[k], paths[l], 4**kmer_len)
            assert tuple(int(x) for x in matrix[k, l]) == (kc, lc, sc)


def test_host_engine_cli_and_bgz(tmp_path, rng, monkeypatch):
    """--engine host over mixed raw + .bgz inputs matches the device engine."""
    from pykmer_tpu.cli import main
    from pykmer_tpu.io.bgzf import compress_file

    monkeypatch.chdir(tmp_path)
    paths = _make_indexes(tmp_path, rng, n=3, kmer_len=5)
    bgz = paths[1] + ".bgz"
    compress_file(paths[1], bgz)
    os.remove(paths[1])
    inputs = [paths[0], bgz, paths[2]]
    assert main(["merge", "hosteng", *inputs, "--quiet",
                 "--engine", "host"]) == 0
    assert main(["merge", "deveng", *inputs, "--quiet",
                 "--engine", "device"]) == 0
    a = read_kma("hosteng.001-255.kma")
    b = read_kma("deveng.001-255.kma")
    assert np.array_equal(a, b)


def test_merge_large_n_hbm_clamp(tmp_path, rng, monkeypatch):
    """An N=128 merge completes on the device engine with default flags, with
    the block clamped to the HBM budget (VERDICT r3 #4); result matches the
    host engine."""
    import shutil

    kmer_len = 5
    base = _make_indexes(tmp_path, rng, n=2, kmer_len=kmer_len)
    paths = list(base)
    for i in range(126):
        dup = str(tmp_path / f"dup{i:03d}.fa.05.kin")
        shutil.copyfile(base[i % 2], dup)
        shutil.copyfile(base[i % 2] + ".json", dup + ".json")
        paths.append(dup)
    # a 16 KiB budget forces the clamp (128 samples -> 128-cell blocks)
    monkeypatch.setenv("PYKMER_TPU_MERGE_HBM_BYTES", str(16384))
    _, matrix = merge(str(tmp_path / "big"), paths, verbose=False)
    monkeypatch.setenv("PYKMER_TPU_MERGE_HOST_MAX_N", "200")
    _, matrix_host = merge(str(tmp_path / "bigh"), paths, verbose=False)
    assert np.array_equal(matrix, matrix_host)
    # spot-check one pair against the stream oracle
    kc, lc, sc = pair_counts_stream(paths[0], paths[5], 4**kmer_len)
    assert tuple(int(x) for x in matrix[0, 5]) == (kc, lc, sc)


def test_sharded_merge_matches_single_device(tmp_path, rng, monkeypatch):
    """merge(n_shards=4) is bit-identical to the single-device engine (and
    reachable from the CLI via --shards)."""
    import numpy as np

    from conftest import make_random_fasta
    from pykmer_tpu.cli import main
    from pykmer_tpu.index import create_fasta_index

    monkeypatch.chdir(tmp_path)
    kins = []
    for i in range(3):
        fa = make_random_fasta(str(tmp_path / f"sm{i}.fa"), rng, n_records=2,
                               lengths=(260, 120))
        create_fasta_index(fa, "s", fa, 5, verbose=False)
        kins.append(f"{fa}.05.kin")

    assert main(["merge", "single", *kins, "--quiet",
                 "--engine", "device"]) == 0
    assert main(["merge", "sharded", *kins, "--quiet", "--shards", "4",
                 "--block-size", "1024"]) == 0
    a = np.load("single.001-255.kma")["matrix"]
    b = np.load("sharded.001-255.kma")["matrix"]
    assert np.array_equal(a, b)
    import json

    ja = json.load(open("single.001-255.kma.json"))
    jb = json.load(open("sharded.001-255.kma.json"))
    ja["project_name"] = jb["project_name"] = "X"
    assert ja == jb


def test_pair_counts_scalar_matches_stream(tmp_path, rng):
    """The reference's unused scalar fallback (calculate_distance2,
    tools.py:495-512) ported for completeness: byte-at-a-time cell iteration
    agrees with the streamed counts on raw and .bgz inputs."""
    from pykmer_tpu.io.bgzf import compress_file
    from pykmer_tpu.merge.merger import pair_counts_scalar

    kmer_len = 5
    paths = _make_indexes(tmp_path, rng, n=2, kmer_len=kmer_len)
    for mn, mx in [(1, 255), (2, 100)]:
        want = pair_counts_stream(paths[0], paths[1], 4**kmer_len, mn, mx)
        assert pair_counts_scalar(paths[0], paths[1], mn, mx) == want
    # .bgz input path (reference opens those through gzip, tools.py:294-302)
    bgz, _ = compress_file(paths[0], paths[0] + ".bgz")
    want = pair_counts_stream(paths[0], paths[1], 4**kmer_len)
    assert pair_counts_scalar(bgz, paths[1]) == want
