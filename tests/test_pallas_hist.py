"""Sub-plane (K >= 17 layout) saturating accumulate vs the oracle, and the
readback paths that consume the sub-plane tuple."""

import jax.numpy as jnp
import numpy as np
import pytest

from pykmer_tpu.oracle import oracle_count_stream


def _batch(rng, kind, total):
    """One code batch: 'mixed' has a saturating hotspot, codes in every
    sub-plane (so each sub-plane sees codes below and above its range) and
    sentinels; 'empty' has no codes; 'all_sentinel' only sentinels."""
    if kind == "empty":
        return np.empty(0, dtype=np.int64)
    if kind == "all_sentinel":
        return np.full(64, total, dtype=np.int64)
    codes = rng.integers(0, total, size=1500).astype(np.int64)
    codes[:400] = rng.integers(0, 8, size=400)  # saturation hotspot
    codes[400:420] = total  # sentinels (ignored)
    codes[420:700] = rng.integers(total - 16, total, size=280)  # last plane
    return codes


@pytest.mark.parametrize("kind", ["mixed", "empty", "all_sentinel"])
@pytest.mark.parametrize("n_planes", [2, 4])
def test_xla_accumulate_sorted_planes_matches_oracle(rng, n_planes, kind):
    """The XLA sub-plane apply equals the flush-faithful oracle: codes
    below a sub-plane must be dropped there (not wrapped into its last
    cell), codes past the last plane are ignored, counts saturate at 255."""
    from pykmer_tpu.ops.histogram import (
        accumulate_sorted_planes,
        dense_plane_shape,
    )

    kmer_len = 7
    total = 4**kmer_len // 2  # folded space of K=7: 8192 cells
    per = total // n_planes
    planes = tuple(jnp.zeros(dense_plane_shape(per), dtype=jnp.uint8)
                   for _ in range(n_planes))
    stream = []
    for _ in range(3):
        codes = _batch(rng, kind, total)
        stream.append(codes[codes < total])
        planes = accumulate_sorted_planes(planes, jnp.sort(jnp.asarray(codes)))
    got = np.concatenate([np.asarray(p).reshape(-1) for p in planes])
    # the oracle counts a full 4^K space; the folded space is its low half
    want = oracle_count_stream(stream, kmer_len, flush_every=10**9)[:total]
    assert np.array_equal(got, want)


def test_fetch_dense_packed_roundtrip(rng):
    import jax.numpy as jnp
    from pykmer_tpu.ops.readback import fetch_dense, pack_nibbles, unpack_nibbles

    # values crossing the escape boundary incl. 15 and 255
    host = rng.integers(0, 256, size=4096).astype(np.uint8)
    host[::7] = 0
    host[3] = 15
    host[5] = 255
    dense = jnp.asarray(host)
    assert np.array_equal(fetch_dense(dense, mode="raw"), host)
    assert np.array_equal(fetch_dense(dense, mode="packed"), host)
    assert np.array_equal(fetch_dense(dense, mode="2bit"), host)
    packed = np.asarray(pack_nibbles(dense))
    un = unpack_nibbles(packed)
    assert np.array_equal(un, np.minimum(host, 15))


def test_fetch_dense_2bit_roundtrip(rng):
    import jax.numpy as jnp
    from pykmer_tpu.ops.readback import fetch_dense, pack_2bit, unpack_2bit

    host = rng.integers(0, 256, size=4096).astype(np.uint8)
    host[::5] = 0
    host[7] = 3
    host[11] = 255
    dense = jnp.asarray(host)
    assert np.array_equal(fetch_dense(dense, mode="2bit"), host)
    un = unpack_2bit(np.asarray(pack_2bit(dense)))
    assert np.array_equal(un, np.minimum(host, 3))


def test_fetch_dense_3bit_roundtrip(rng):
    import jax.numpy as jnp
    from pykmer_tpu.ops.readback import fetch_dense, pack_3bit, unpack_3bit

    host = rng.integers(0, 256, size=4096).astype(np.uint8)
    host[::3] = 0
    host[5] = 7
    host[13] = 6
    host[17] = 255
    dense = jnp.asarray(host)
    assert np.array_equal(fetch_dense(dense, mode="3bit"), host)
    un = unpack_3bit(np.asarray(pack_3bit(dense)))
    assert np.array_equal(un, np.minimum(host, 7))


def test_unpack_native_matches_numpy(rng, monkeypatch):
    from pykmer_tpu.ops import readback as rb

    packed = rng.integers(0, 256, size=1024).astype(np.uint8)
    got2, got4 = rb.unpack_2bit(packed), rb.unpack_nibbles(packed)
    # force the numpy fallback path
    monkeypatch.setenv("PYKMER_TPU_NO_NATIVE", "1")
    import sys

    for m in [m for m in sys.modules if m == "pykmer_tpu.io.native"]:
        del sys.modules[m]
    assert np.array_equal(rb.unpack_2bit(packed), got2)
    assert np.array_equal(rb.unpack_nibbles(packed), got4)


def test_fetch_array_mt_slices(rng):
    import jax.numpy as jnp
    from pykmer_tpu.ops.readback import fetch_array_mt

    host = rng.integers(0, 256, size=(512, 256)).astype(np.uint8)
    dev = jnp.asarray(host)
    # force many slices: 1 row per slice
    got = fetch_array_mt(dev, slice_bytes=256, threads=4)
    assert np.array_equal(got, host)


def test_fetch_dense_packed_no_escapes(rng):
    import jax.numpy as jnp
    from pykmer_tpu.ops.readback import fetch_dense

    host = rng.integers(0, 15, size=2048).astype(np.uint8)
    dense = jnp.asarray(host)
    assert np.array_equal(fetch_dense(dense, mode="packed"), host)


def test_localize_sorted_bands():
    """Below-range → -1, in-range → code-lo, above-range → int32 max; all
    monotone so the sub-plane scatter may treat its indices as sorted."""
    from pykmer_tpu.ops.histogram import localize_sorted

    codes = jnp.asarray(
        np.array([0, 5, 99, 100, 150, 199, 200, 2**33], dtype=np.int64)
    )
    got = np.asarray(localize_sorted(codes, 100, 200))
    imax = np.iinfo(np.int32).max
    want = np.array([-1, -1, -1, 0, 50, 99, imax, imax], dtype=np.int32)
    assert np.array_equal(got, want)
    assert got.dtype == np.int32
    assert (np.diff(got) >= 0).all()


@pytest.mark.parametrize("n_planes", [2, 4])
def test_accumulate_sorted_planes_matches_numpy(rng, n_planes):
    """Multi-sub-plane apply (K>=17 folded-space layout at test scale):
    codes crossing plane boundaries, sentinels past the last plane, and
    saturation all match min(total, 255)."""
    from pykmer_tpu.ops.histogram import accumulate_sorted_planes

    total = 4096
    per = total // n_planes
    planes = tuple(
        jnp.zeros((per // 128, 128), dtype=jnp.uint8) for _ in range(n_planes)
    )
    want = np.zeros(total, dtype=np.int64)
    for _ in range(3):
        codes = rng.integers(0, total, size=1500).astype(np.int64)
        codes[:400] = rng.integers(0, 8, size=400)  # saturation hotspot
        codes[400:420] = total  # sentinels (ignored)
        want += np.bincount(codes[codes < total], minlength=total)
        planes = accumulate_sorted_planes(
            planes, jnp.sort(jnp.asarray(codes))
        )
    got = np.concatenate([np.asarray(p).reshape(-1) for p in planes])
    assert np.array_equal(got, np.minimum(want, 255))


def test_stream_planes_readback_matches_unfold(rng, tmp_path):
    """stream_dense_planes_to_out (sub-plane readback with global base
    offsets) reproduces unfold_canonical of the concatenated folded plane,
    for both the forced 3-bit packed path (escape patching at base>0) and
    the auto(raw) path."""
    from pykmer_tpu.formats.header import fast_counts256
    from pykmer_tpu.ops.readback import (
        stream_dense_planes_to_out,
        unfold_canonical,
    )

    kmer_len = 7
    fold = 4**kmer_len // 2  # 8192
    host = rng.integers(0, 256, size=fold).astype(np.uint8)
    host[::3] = 0
    host[5] = 7  # 3-bit escape marker value
    host[4099] = 255  # escape in the second plane
    want = unfold_canonical(host.copy(), kmer_len)
    for mode in ("3bit", "auto"):
        planes = [
            jnp.asarray(host[:4096].copy()),
            jnp.asarray(host[4096:].copy()),
        ]
        out = np.zeros(2 * fold, dtype=np.uint8)
        counts = stream_dense_planes_to_out(planes, kmer_len, out, mode=mode)
        assert np.array_equal(out, want), mode
        assert np.array_equal(counts, fast_counts256(host)), mode


def test_indexer_multiplane_device_path(rng, tmp_path, monkeypatch):
    """End-to-end: forcing the tuple-of-sub-planes device strategy (the
    K>=17 layout) at K=7 yields a byte-identical .kin to the default run."""
    import conftest

    from pykmer_tpu.config import IndexConfig
    from pykmer_tpu.index import create_fasta_index

    fa = str(tmp_path / "mp.fa")
    conftest.make_random_fasta(fa, rng, n_records=2, lengths=(400, 300))
    cfg = IndexConfig(kmer_len=7, chunk_windows=1 << 10)
    h1 = create_fasta_index(fa, "s", fa, 7, config=cfg, verbose=False)
    ref_bytes = open(h1.index_file_root, "rb").read()
    ref_kmers = h1.num_kmers

    monkeypatch.setenv("PYKMER_TPU_MAX_SWEEP_CELLS", "2048")  # fold 8192 → 4
    from pykmer_tpu.index import indexer as ix

    assert ix._n_planes(4**7 // 2) == 4
    h2 = create_fasta_index(fa, "s", fa, 7, overwrite=True, config=cfg,
                            verbose=False)
    assert h2.num_kmers == ref_kmers
    assert open(h2.index_file_root, "rb").read() == ref_bytes


def test_indexer_multiplane_packed_readback(rng, tmp_path, monkeypatch):
    """K>=17-shaped branch conditions through create_fasta_index: forced
    3-bit packed readback over a tuple of sub-planes exercises the per-plane
    escapes list and base-offset escape patching (not just the raw path)."""
    import conftest

    from pykmer_tpu.config import IndexConfig
    from pykmer_tpu.index import create_fasta_index

    fa = str(tmp_path / "mp3.fa")
    # enough depth that some folded cells exceed the 3-bit escape value (7)
    seq = "".join(rng.choice(list("ACGT"), size=600))
    with open(fa, "w") as fh:
        for i in range(4):
            fh.write(f">r{i}\n{seq}\n")
    cfg = IndexConfig(kmer_len=7, chunk_windows=1 << 10)
    h1 = create_fasta_index(fa, "s", fa, 7, config=cfg, verbose=False)
    ref_bytes = open(h1.index_file_root, "rb").read()

    monkeypatch.setenv("PYKMER_TPU_MAX_SWEEP_CELLS", "2048")  # fold 8192 → 4
    cfg3 = IndexConfig(kmer_len=7, chunk_windows=1 << 10, readback="3bit")
    h2 = create_fasta_index(fa, "s", fa, 7, overwrite=True, config=cfg3,
                            verbose=False)
    assert h2.num_kmers == h1.num_kmers
    assert open(h2.index_file_root, "rb").read() == ref_bytes
    assert h2.hist == h1.hist


def test_bad_max_sweep_cells_raises(monkeypatch):
    """A non-divisor PYKMER_TPU_MAX_SWEEP_CELLS fails with a descriptive
    error, not a bare assert."""
    import pytest

    from pykmer_tpu.index import indexer as ix

    monkeypatch.setenv("PYKMER_TPU_MAX_SWEEP_CELLS", "3000")
    with pytest.raises(ValueError, match="PYKMER_TPU_MAX_SWEEP_CELLS"):
        ix._n_planes(4**7 // 2)


def test_stream_dense_chase_write_hash(rng, tmp_path):
    """Chase-mode readback (fd + hash_out: escape pre-scan during drain,
    per-slice patch, write+hash following the unfold) must produce the same
    file bytes, counts, and checksum as the non-chase path."""
    import hashlib

    import jax.numpy as jnp

    from pykmer_tpu.io.direct import DirectWriter
    from pykmer_tpu.ops.readback import stream_dense_to_out

    kmer_len = 9
    fold = 4**kmer_len // 2  # 2^17 cells
    vals = rng.poisson(1.5, size=fold).astype(np.uint8)
    hot = rng.integers(0, fold, size=200)
    vals[hot] = rng.integers(7, 255, size=200).astype(np.uint8)  # escapes
    dense = jnp.asarray(vals.reshape(-1, 128))

    for lanes in (128, 512):  # incl. the wide-lane production layout
        dense = jnp.asarray(vals.reshape(-1, lanes))
        for mode in ("2bit", "3bit", "packed"):
            ref = np.zeros(2 * fold, dtype=np.uint8)
            counts_ref = stream_dense_to_out(dense, kmer_len, ref, mode=mode)

            out = np.zeros(2 * fold, dtype=np.uint8)
            path = str(tmp_path / f"chase_{lanes}_{mode}.bin")
            # tiny slices force many chase steps
            with DirectWriter(path, size=2 * fold) as fd:
                counts, hex_ = stream_dense_to_out(
                    dense, kmer_len, out, mode=mode, slice_bytes=1 << 12,
                    fd=fd, hash_out=True,
                )
            assert np.array_equal(counts, counts_ref), (lanes, mode)
            assert np.array_equal(out, ref), (lanes, mode)
            file_bytes = open(path, "rb").read()
            assert file_bytes == ref.tobytes(), (lanes, mode)
            assert hex_ == hashlib.sha256(ref).hexdigest(), (lanes, mode)


def test_indexer_chase_readback_end_to_end(rng, tmp_path):
    """create_fasta_index through the chase tail (forced packed readback on
    the single-plane device strategy): bytes + stored output checksum must
    match the default run and the real file hash."""
    import hashlib
    import json

    import conftest

    from pykmer_tpu.config import IndexConfig
    from pykmer_tpu.index import create_fasta_index

    fa = str(tmp_path / "chase.fa")
    conftest.make_random_fasta(fa, rng, n_records=3, lengths=(700, 400, 300))
    k = 7
    h1 = create_fasta_index(
        fa, "s", fa, k, config=IndexConfig(kmer_len=k, chunk_windows=1 << 10),
        verbose=False,
    )
    ref_bytes = open(h1.index_file_root, "rb").read()

    cfg = IndexConfig(kmer_len=k, chunk_windows=1 << 10, accumulate="device",
                      readback="3bit")
    h2 = create_fasta_index(fa, "s", fa, k, overwrite=True, config=cfg,
                            verbose=False)
    got = open(h2.index_file_root, "rb").read()
    assert got == ref_bytes
    meta = json.load(open(h2.metadata_file))
    # reference's key spelling ("cheksum") is part of the byte-exact schema
    assert meta["output_file_cheksum"] == hashlib.sha256(got).hexdigest()


def test_stream_dense_planes_chase_write_hash(rng, tmp_path):
    """One chase sink spanning multiple sub-planes (the K>=17 layout):
    write + hash chase unfolds across plane boundaries and must match the
    non-chase result byte-for-byte."""
    import hashlib

    import jax.numpy as jnp

    from pykmer_tpu.io.direct import DirectWriter
    from pykmer_tpu.ops.readback import (
        stream_dense_planes_to_out,
        stream_dense_to_out,
    )

    kmer_len = 9
    fold = 4**kmer_len // 2
    vals = rng.poisson(1.5, size=fold).astype(np.uint8)
    hot = rng.integers(0, fold, size=300)
    vals[hot] = rng.integers(7, 255, size=300).astype(np.uint8)
    dense = jnp.asarray(vals.reshape(-1, 128))

    ref = np.zeros(2 * fold, dtype=np.uint8)
    counts_ref = stream_dense_to_out(dense, kmer_len, ref, mode="3bit")

    n_planes = 4
    per_rows = (fold // 128) // n_planes
    planes = [jnp.asarray(vals.reshape(-1, 128)[q * per_rows:(q + 1) * per_rows])
              for q in range(n_planes)]
    out = np.zeros(2 * fold, dtype=np.uint8)
    path = str(tmp_path / "planes_chase.bin")
    with DirectWriter(path, size=2 * fold) as fd:
        counts, hex_ = stream_dense_planes_to_out(
            planes, kmer_len, out, mode="3bit", slice_bytes=1 << 12,
            fd=fd, hash_out=True,
        )
    assert np.array_equal(counts, counts_ref)
    assert np.array_equal(out, ref)
    assert open(path, "rb").read() == ref.tobytes()
    assert hex_ == hashlib.sha256(ref).hexdigest()


def test_stream_dense_chase_coarse_without_native_scan(rng, tmp_path, monkeypatch):
    """Without the native packed-domain escape scan, a sink-carrying call
    degrades to one coarse whole-plane region after the batched patch —
    same bytes, counts, and hash as the fine-grained chase."""
    import hashlib

    import jax.numpy as jnp

    from pykmer_tpu.io import native as _native
    from pykmer_tpu.io.direct import DirectWriter
    from pykmer_tpu.ops.readback import stream_dense_to_out

    kmer_len = 9
    fold = 4**kmer_len // 2
    vals = rng.poisson(1.2, size=fold).astype(np.uint8)
    hot = rng.integers(0, fold, size=150)
    vals[hot] = rng.integers(7, 200, size=150).astype(np.uint8)
    dense = jnp.asarray(vals.reshape(-1, 128))

    ref = np.zeros(2 * fold, dtype=np.uint8)
    counts_ref = stream_dense_to_out(dense, kmer_len, ref, mode="3bit")

    monkeypatch.setattr(_native, "_HAVE_SCAN_ESCAPES", False)
    out = np.zeros(2 * fold, dtype=np.uint8)
    path = str(tmp_path / "coarse.bin")
    with DirectWriter(path, size=2 * fold) as fd:
        counts, hex_ = stream_dense_to_out(
            dense, kmer_len, out, mode="3bit", slice_bytes=1 << 12,
            fd=fd, hash_out=True,
        )
    assert np.array_equal(counts, counts_ref)
    assert np.array_equal(out, ref)
    assert open(path, "rb").read() == ref.tobytes()
    assert hex_ == hashlib.sha256(ref).hexdigest()


def test_chase_sink_surfaces_write_errors(tmp_path):
    """A failed region pwrite (e.g. ENOSPC) must raise at finish(), not be
    silently dropped with the run reporting success."""
    import pytest

    from pykmer_tpu.ops import readback as rb

    out = np.zeros(4096, dtype=np.uint8)

    class BoomFd:
        def pwrite(self, arr, offset):
            raise OSError(28, "No space left on device")

    sink = rb._ChaseSink(out, BoomFd(), hash_out=False)
    sink.region_done(0, 1024)
    with pytest.raises(OSError, match="No space left"):
        sink.finish()


def test_direct_writer_fallback_keeps_fd_open(tmp_path, monkeypatch):
    """O_DIRECT rejection mid-run retires the direct fd WITHOUT closing it
    (concurrent writer threads may still hold the fd number); the write
    still lands via the buffered fd and close() releases both."""
    from pykmer_tpu.io import direct as d

    path = str(tmp_path / "fb.bin")
    w = d.DirectWriter(path, size=8192)
    if w.dfd is None:
        w.close()
        import pytest

        pytest.skip("no O_DIRECT on this filesystem")
    dfd = w.dfd
    real_loop = d._pwrite_loop

    def failing_loop(fd, view, pos):
        if fd == dfd:
            raise OSError(22, "Invalid argument")
        return real_loop(fd, view, pos)

    monkeypatch.setattr(d, "_pwrite_loop", failing_loop)
    # ALIGN-aligned buffer so the O_DIRECT head path actually engages
    raw = np.zeros(8192 + d.ALIGN, dtype=np.uint8)
    a0 = (-raw.ctypes.data) % d.ALIGN
    data = raw[a0 : a0 + 8192]
    data[:] = np.arange(8192, dtype=np.uint64).astype(np.uint8) % 251
    w.pwrite(data, 0)
    assert w.dfd is None and w._retired_dfd == dfd
    import os as _os

    _os.fstat(dfd)  # still open — not recycled
    monkeypatch.setattr(d, "_pwrite_loop", real_loop)
    w.close()
    assert open(path, "rb").read() == data.tobytes()
