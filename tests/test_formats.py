"""Formats layer: naming, frag-size autotune, stats — compared directly
against the imported reference implementation (tools.py)."""

import json
import os

import numpy as np
import pytest

from pykmer_tpu.formats import (
    KinHeader,
    frag_size_autotune,
    stats_from_counts256,
)
from pykmer_tpu.formats import kin as kinfmt
from reference_runner import import_reference_tools


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 9, 11, 13, 15, 17, 19, 21])
def test_frag_size_matches_reference(kmer_len):
    tools = import_reference_tools()
    ref = tools.Header("proj", input_file="/tmp/x.fa", kmer_len=kmer_len)
    assert frag_size_autotune(4**kmer_len) == ref.frag_size


@pytest.mark.parametrize("kmer_len", [3, 15])
def test_naming_matches_reference(tmp_path, kmer_len):
    tools = import_reference_tools()
    input_file = str(tmp_path / "genome.fa.gz")
    ref = tools.Header("proj", input_file=input_file, kmer_len=kmer_len)
    ours = KinHeader("proj", input_file=input_file, kmer_len=kmer_len)
    assert ours.index_file_root == ref.index_file_root
    assert ours.index_tmp_file == ref.index_tmp_file
    assert ours.metadata_file == ref.metadata_file
    assert ours.index_file == ref.index_file
    assert ours.kmer_size == ref.kmer_size
    assert ours.data_size == ref.data_size
    assert ours.max_size == ref.max_size
    assert ours.max_val == ref.max_val
    assert ours.file_ver == ref.HEADER_VER


def test_parse_kin_filename_roundtrip(tmp_path):
    input_file = str(tmp_path / "genome.fa.gz")
    root = kinfmt.kin_root_path(input_file, 15)
    assert kinfmt.parse_kin_filename(root) == (os.path.abspath(input_file), 15)
    assert kinfmt.parse_kin_filename(root + ".bgz") == (
        os.path.abspath(input_file), 15)
    with pytest.raises(ValueError):
        kinfmt.parse_kin_filename("whatever.txt")


def test_even_kmer_len_rejected(tmp_path):
    with pytest.raises(ValueError):
        KinHeader("p", input_file=str(tmp_path / "x.fa"), kmer_len=4)


def test_stats_match_numpy_histogram(rng):
    """Our bincount-derived stats == reference np.histogram(bins=255,range=(1,255))."""
    arr = rng.integers(0, 256, size=10_000).astype(np.uint8)
    # make sure every value occurs at least once, incl. 0 and 255
    arr = np.concatenate([arr, np.arange(256, dtype=np.uint8)])
    stats = stats_from_counts256(np.bincount(arr, minlength=256))

    hist_v, _ = np.histogram(arr, bins=255, range=(1, 255))
    assert stats["hist"] == hist_v.tolist()
    assert stats["hist_sum"] == int(np.sum(hist_v))
    assert stats["hist_count"] == int(np.count_nonzero(hist_v))
    assert stats["hist_min"] == int(np.min(hist_v))
    assert stats["hist_max"] == int(np.max(hist_v))
    assert stats["vals_sum"] == int(np.sum(arr))
    assert stats["vals_count"] == int(np.count_nonzero(arr))
    assert stats["vals_min"] == int(np.min(arr))
    assert stats["vals_max"] == int(np.max(arr))


def test_kin_sparse_init_and_blocks(tmp_path):
    path = str(tmp_path / "a.kin")
    kinfmt.init_sparse_file(path, 1000)
    assert os.path.getsize(path) == 1000
    blocks = list(kinfmt.iter_kin_blocks(path, 1000, 256))
    assert [b.shape[0] for b in blocks] == [256, 256, 256, 232]
    assert all((b == 0).all() for b in blocks)


def test_header_json_roundtrip(tmp_path):
    input_file = str(tmp_path / "g.fa")
    with open(input_file, "w") as fh:
        fh.write(">r\nACGT\n")
    header = KinHeader("proj", input_file=input_file, kmer_len=3)
    dense = np.zeros(64, dtype=np.uint8)
    dense[:5] = [2, 2, 0, 1, 255]
    kinfmt.write_kin_array(header.index_tmp_file, dense)
    header.num_kmers = 2
    header.chromosomes = [("r", 4)]
    header.write_metadata(header.index_tmp_file,
                          stats_counts256=np.bincount(dense, minlength=256))
    os.rename(header.index_tmp_file, header.index_file_root)

    again = KinHeader("proj", input_file=input_file, kmer_len=3)
    again.read_metadata()
    assert again.num_kmers == 2
    assert again.chromosomes == [["r", 4]]
    assert again.vals_sum == int(dense.sum())
    again.check_data()

    with open(header.metadata_file) as fh:
        meta = json.load(fh)
    assert meta["file_ver"] == "KMER001"
    assert sorted(meta.keys()) == sorted(
        ["file_ver", "kmer_size", "data_size", "max_size"]
        + [k for k in meta if k not in ("file_ver", "kmer_size", "data_size", "max_size")]
    )


def test_custom_frag_size_survives_reload(tmp_path):
    """A non-default frag_size stored in .kin.json must NOT be clobbered by
    the autotuner when the header is reconstructed from the index file."""
    input_file = str(tmp_path / "g2.fa")
    with open(input_file, "w") as fh:
        fh.write(">r\nACGTACGT\n")
    header = KinHeader("proj", input_file=input_file, kmer_len=3,
                       frag_size=7)
    dense = np.zeros(64, dtype=np.uint8)
    dense[3] = 2
    kinfmt.write_kin_array(header.index_tmp_file, dense)
    header.num_kmers = 1
    header.chromosomes = [("r", 8)]
    header.write_metadata(header.index_tmp_file,
                          stats_counts256=np.bincount(dense, minlength=256))
    os.rename(header.index_tmp_file, header.index_file_root)

    again = KinHeader("proj", index_file=header.index_file_root)
    assert again.frag_size == 7
    # re-serialization must match the stored JSON, not a re-autotuned value
    assert again.to_dict()["frag_size"] == 7


def test_resolve_chunk_windows_clamps_to_input():
    """The DEFAULT chunk size clamps down to the input's scale (a tiny
    fixture must not pad to a 16M-window chunk of sentinels); explicit
    values are honoured as-is."""
    from pykmer_tpu.config import IndexConfig, resolve_chunk_windows

    base = resolve_chunk_windows(IndexConfig(kmer_len=5)).chunk_windows
    assert base >= (1 << 22)
    tiny = resolve_chunk_windows(
        IndexConfig(kmer_len=5), input_hint_bytes=5_000).chunk_windows
    assert tiny == 1 << 16
    mid = resolve_chunk_windows(
        IndexConfig(kmer_len=5), input_hint_bytes=100_000).chunk_windows
    assert mid == 1 << 17
    big = resolve_chunk_windows(
        IndexConfig(kmer_len=5), input_hint_bytes=10**9).chunk_windows
    assert big == base
    explicit = resolve_chunk_windows(
        IndexConfig(kmer_len=5, chunk_windows=1024), input_hint_bytes=10)
    assert explicit.chunk_windows == 1024


@pytest.mark.parametrize("bytes_limit,want", [
    (None, "host"),  # the CPU backend reports no limit
    (8 << 30, "host"),  # an 8 GiB folded plane leaves no step headroom
    (60 << 30, "device"),  # a card's share holds the plane and the steps
])
def test_accumulate_strategy_from_device_memory(monkeypatch, bytes_limit,
                                                want):
    """K=17 stays on the device only where the device reports memory for
    the folded plane plus the step working sets; K <= 15 always does."""
    import jax

    from pykmer_tpu import config

    class FakeDevice:
        def memory_stats(self):
            if bytes_limit is None:
                return None
            return {"bytes_limit": bytes_limit}

    monkeypatch.setattr(jax, "local_devices", lambda: [FakeDevice()])
    assert config.device_bytes_limit() == bytes_limit
    got = config.accumulate_strategy(
        "auto", 17, 1 << 24, config.device_bytes_limit())
    assert got == want
    assert config.accumulate_strategy(
        "auto", 15, 1 << 24, config.device_bytes_limit()) == "device"
    assert config.accumulate_strategy(
        "host", 15, 1 << 24, config.device_bytes_limit()) == "host"
