"""Oracle gold implementation: enumeration-fixture invariants, saturation,
flush-partition independence, and byte parity with the executed reference."""

import json
import os

import numpy as np
import pytest

from pykmer_tpu import testgen
from pykmer_tpu.formats import kin as kinfmt
from pykmer_tpu.oracle import (
    oracle_canonical_codes,
    oracle_canonical_codes_vec,
    oracle_count_stream,
    oracle_index_arrays,
    oracle_write_index,
)


def test_canonical_codes_tiny():
    # seq ACGTA, K=3: windows ACG(6), CGT(27), GTA(44|rc TAC=49 -> 44)
    codes = np.array([0, 1, 2, 3, 0], dtype=np.uint8)
    out = oracle_canonical_codes(codes, 3)
    # ACG fwd=0*16+1*4+2=6 rc of ACG = CGT = 27 -> 6
    # CGT fwd=27, rc ACG=6 -> 6
    # GTA fwd=2*16+3*4+0=44, rc TAC=3*16+0*4+1=49 -> 44
    assert out.tolist() == [6, 6, 44]


def test_invalid_windows_dropped():
    codes = np.array([0, 1, 4, 2, 3, 0], dtype=np.uint8)
    out = oracle_canonical_codes(codes, 3)
    # only window at pos 3 (2,3,0)=GTA is N-free
    assert out.tolist() == [44]


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 9, 11, 15, 17])
def test_vectorised_canonical_codes_match_loop(rng, kmer_len):
    """The vectorised oracle (the reference the GPU smoke run compares
    genome-sized outputs with) equals the per-window loop, across N runs,
    block boundaries and inputs shorter than K."""
    seq = rng.integers(0, 4, size=3000).astype(np.uint8)
    seq[rng.integers(0, 3000, size=40)] = 4  # scattered Ns
    seq[1200:1230] = 4  # an N run
    for codes in (seq, seq[: kmer_len - 1], seq[:kmer_len]):
        want = oracle_canonical_codes(codes, kmer_len)
        got = oracle_canonical_codes_vec(codes, kmer_len, block=257)
        assert got.dtype == (np.uint32 if kmer_len <= 15 else np.uint64)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kmer_len", [3, 5])
def test_enumeration_fixture_invariants(tmp_path, kmer_len):
    prefix = str(tmp_path / "ex")
    fasta = testgen.create_test_fasta(prefix, kmer_len)
    dense, num_kmers, chromosomes = oracle_index_arrays(fasta, kmer_len)
    assert num_kmers == 4**kmer_len
    assert len(chromosomes) == 4**kmer_len
    # odd K: no palindromic canonical kmers; every canonical cell == 2
    assert int((dense == 2).sum()) == 4**kmer_len // 2
    assert int((dense == 0).sum()) == 4**kmer_len // 2
    assert int(dense.sum()) == 4**kmer_len


def test_saturation_at_255():
    codes = [np.zeros(300, dtype=np.int64)]  # 300x code 0
    dense = oracle_count_stream(codes, 3)
    assert dense[0] == 255


def test_flush_partition_independence(rng):
    codes = rng.integers(0, 64, size=2000).astype(np.int64)
    a = oracle_count_stream([codes], 3, flush_every=7)
    b = oracle_count_stream([codes], 3, flush_every=10**9)
    c = oracle_count_stream(np.array_split(codes, 13), 3, flush_every=29)
    assert np.array_equal(a, b)
    assert np.array_equal(a, c)
    # and equals the plain clipped bincount
    bc = np.minimum(np.bincount(codes, minlength=64), 255).astype(np.uint8)
    assert np.array_equal(a, bc)


@pytest.mark.parametrize("kmer_len", [3, 5])
def test_oracle_matches_reference_bytes(tmp_path, kmer_len):
    """Run the actual reference indexer; compare .kin bytes and .kin.json."""
    from reference_runner import (
        VOLATILE_KIN_JSON_KEYS,
        run_reference_indexer,
    )

    prefix = str(tmp_path / "ex")
    fasta = testgen.create_test_fasta(prefix, kmer_len)

    run_reference_indexer(fasta, "sample", kmer_len, str(tmp_path))
    root = kinfmt.kin_root_path(fasta, kmer_len)
    meta = kinfmt.metadata_path(fasta, kmer_len)
    ref_kin = root + ".refgolden"
    ref_json = meta + ".refgolden"
    os.rename(root, ref_kin)
    os.rename(meta, ref_json)

    oracle_write_index(fasta, fasta, kmer_len)

    with open(ref_kin, "rb") as fh:
        ref_bytes = fh.read()
    with open(root, "rb") as fh:
        our_bytes = fh.read()
    assert ref_bytes == our_bytes, "dense .kin arrays differ"

    with open(ref_json) as fh:
        ref_meta = json.load(fh)
    with open(meta) as fh:
        our_meta = json.load(fh)
    assert set(ref_meta) == set(our_meta)
    for key in ref_meta:
        if key in VOLATILE_KIN_JSON_KEYS:
            continue
        assert our_meta[key] == ref_meta[key], f"mismatch in {key}"
