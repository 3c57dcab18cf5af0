"""Device ops vs the oracle: encoding and the saturating histogram."""

import jax.numpy as jnp
import numpy as np
import pytest

from pykmer_tpu.ops import (
    canonical_codes,
    code_dtype,
    saturating_accumulate,
)
from pykmer_tpu.ops.encode import chunk_stream, iter_chunks
from pykmer_tpu.oracle import oracle_canonical_codes, oracle_count_stream


@pytest.mark.parametrize("kmer_len", [3, 5, 7])
def test_canonical_codes_match_oracle(rng, kmer_len):
    seq = rng.integers(0, 5, size=500).astype(np.uint8)  # includes invalid 4s
    want = oracle_canonical_codes(seq, kmer_len)
    got = np.asarray(canonical_codes(jnp.asarray(seq), kmer_len))
    sentinel = 4**kmer_len
    got_valid = got[got < sentinel]
    assert np.array_equal(got_valid, want)
    # invalid windows are exactly those containing a 4
    k = kmer_len
    for i in range(seq.shape[0] - k + 1):
        is_valid = (seq[i : i + k] < 4).all()
        assert (got[i] < sentinel) == is_valid


def test_code_dtype_boundaries():
    assert code_dtype(15) == jnp.int32
    assert code_dtype(17) == jnp.int64


def test_canonical_codes_k17_dtype(rng):
    seq = rng.integers(0, 4, size=40).astype(np.uint8)
    got = np.asarray(canonical_codes(jnp.asarray(seq), 17))
    want = oracle_canonical_codes(seq, 17)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


@pytest.mark.parametrize("size,nbatch", [(64, 1), (64, 5), (1024, 3)])
def test_saturating_accumulate_matches_oracle(rng, size, nbatch):
    dense = jnp.zeros(size, dtype=jnp.uint8)
    batches = []
    for _ in range(nbatch):
        # heavy repetition to exercise saturation
        codes = rng.integers(0, 8, size=700).astype(np.int64) * (size // 8)
        codes = np.minimum(codes + rng.integers(0, 3, size=700), size - 1)
        batches.append(codes)
        # pad with sentinels
        padded = np.concatenate([codes, np.full(41, size, dtype=np.int64)])
        dense, nvalid = saturating_accumulate(
            dense, jnp.asarray(padded), sentinel=size
        )
        assert int(nvalid) == codes.shape[0]
    want = oracle_count_stream(batches, int(np.log2(size) // 2), flush_every=123)
    assert np.array_equal(np.asarray(dense), want)


def test_accumulate_empty_batch():
    dense = jnp.zeros(64, dtype=jnp.uint8)
    codes = jnp.full((16,), 64, dtype=jnp.int64)  # all sentinel
    dense, nvalid = saturating_accumulate(dense, codes, sentinel=64)
    assert int(nvalid) == 0
    assert int(np.asarray(dense).sum()) == 0


def test_chunk_stream_framing(rng):
    k = 5
    seq = rng.integers(0, 4, size=1000).astype(np.uint8)
    want = oracle_canonical_codes(seq, k)
    padded, n_chunks = chunk_stream(seq, k, chunk_windows=128)
    got = []
    for chunk in iter_chunks(padded, k, 128, n_chunks):
        codes = np.asarray(canonical_codes(jnp.asarray(chunk), k))
        got.append(codes[codes < 4**k])
    got = np.concatenate(got)
    assert np.array_equal(got, want)


def test_packed_chunk_stream_roundtrip(rng):
    from pykmer_tpu.ops.encode import (
        chunk_stream,
        iter_chunks,
        iter_chunks_packed,
        pack_base_stream,
        unpack_base_2bit_mask,
    )

    k = 7
    seq = rng.integers(0, 5, size=1111).astype(np.uint8)
    padded, n_chunks = chunk_stream(seq, k, chunk_windows=128)
    packed = pack_base_stream(padded)
    # numpy fallback agrees with the (possibly native) default path
    pad8 = padded
    if pad8.shape[0] % 8:
        pad8 = np.concatenate([pad8, np.full(8 - pad8.shape[0] % 8, 4, np.uint8)])
    valid = pad8 < 4
    b = np.where(valid, pad8, 0).reshape(-1, 4)
    fb_bases = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(
        np.uint8
    )
    fb_mask = np.packbits(valid.reshape(-1, 8), axis=1, bitorder="little").reshape(-1)
    assert np.array_equal(packed[0], fb_bases)
    assert np.array_equal(packed[1], fb_mask)
    span = 128 + k - 1
    plain = list(iter_chunks(padded, k, 128, n_chunks))
    for chunk, (b2, m) in zip(plain, iter_chunks_packed(packed, k, 128, n_chunks)):
        bases = np.asarray(
            unpack_base_2bit_mask(jnp.asarray(b2), jnp.asarray(m), span)
        )
        # invalid codes normalise to exactly 4 on device; plain chunks carry 4s
        assert np.array_equal(bases, chunk)


def test_lazy_packed_chunks_match_eager(rng):
    from pykmer_tpu.ops.encode import (
        chunk_stream,
        iter_chunks_packed,
        iter_chunks_packed_lazy,
        pack_base_stream,
    )

    from pykmer_tpu.ops.encode import unpack_base_2bit_mask

    for k, cw, n in [(7, 128, 1111), (15, 64, 64 * 3 + 14), (5, 8, 9)]:
        span = cw + k - 1
        seq = rng.integers(0, 5, size=n).astype(np.uint8)
        padded, n_chunks = chunk_stream(seq, k, chunk_windows=cw)
        eager = list(iter_chunks_packed(pack_base_stream(padded), k, cw, n_chunks))
        lazy = list(iter_chunks_packed_lazy(padded, k, cw, n_chunks))
        assert len(eager) == len(lazy) == n_chunks
        for (eb, em), (lb, lm) in zip(eager, lazy):
            assert eb.shape == lb.shape and em.shape == lm.shape
            # raw bytes may differ in bits beyond `span` (eager sees the next
            # chunk's bases, lazy sees padding) — the decoded span is the
            # contract
            de = unpack_base_2bit_mask(jnp.asarray(eb), jnp.asarray(em), span)
            dl = unpack_base_2bit_mask(jnp.asarray(lb), jnp.asarray(lm), span)
            assert np.array_equal(np.asarray(de), np.asarray(dl))


@pytest.mark.parametrize("kmer_len", [3, 5, 7, 9])
def test_fold_unfold_roundtrip(rng, kmer_len):
    """Accumulating in the folded half-space then unfolding equals the
    unfolded accumulation (fold_codes pairs {u, M-u}; exactly one member is
    canonical for odd K, so the fold is lossless)."""
    from pykmer_tpu.ops.encode import fold_codes
    from pykmer_tpu.ops.readback import unfold_canonical

    size = 4**kmer_len
    codes_np = oracle_canonical_codes(
        rng.integers(0, 5, 4096).astype(np.uint8), kmer_len
    )
    codes = jnp.asarray(
        np.where(codes_np < 0, size, codes_np), dtype=code_dtype(kmer_len)
    )

    dense_full, _ = saturating_accumulate(
        jnp.zeros(size, jnp.uint8), codes, sentinel=size
    )
    folded_codes = fold_codes(codes, kmer_len)
    dense_fold, nvalid = saturating_accumulate(
        jnp.zeros(size // 2, jnp.uint8), folded_codes, sentinel=size // 2
    )
    assert int(nvalid) == int((codes_np >= 0).sum())
    unfolded = unfold_canonical(np.asarray(dense_fold), kmer_len)
    assert np.array_equal(unfolded, np.asarray(dense_full))


@pytest.mark.parametrize("kmer_len", [5, 9])
def test_unfold_native_matches_numpy(rng, kmer_len):
    from pykmer_tpu.ops.readback import _rc_codes_np, unfold_canonical

    half = 4**kmer_len // 2
    folded = rng.integers(0, 256, half, dtype=np.uint8)
    u = np.arange(half, dtype=np.uint64)
    canon = u <= _rc_codes_np(u, kmer_len)
    expect = np.empty(4**kmer_len, np.uint8)
    expect[:half] = np.where(canon, folded, 0)
    expect[half:] = np.where(canon, 0, folded)[::-1]
    assert np.array_equal(unfold_canonical(folded, kmer_len), expect)


@pytest.mark.parametrize("mode", ["raw", "2bit", "3bit", "packed", "auto"])
def test_stream_dense_to_out_matches_fetch(rng, mode):
    """The streaming fetch→unfold tail (stream_dense_to_out) must produce
    the same 4^K plane as fetch_dense + unfold_canonical, and exact folded
    counts (used for .kin.json stats)."""
    from pykmer_tpu.formats.header import fast_counts256
    from pykmer_tpu.ops.readback import (
        fetch_dense,
        stream_dense_to_out,
        unfold_canonical,
    )

    kmer_len = 9
    half = 4**kmer_len // 2
    # escape-heavy distribution so every plane's patch path is exercised
    folded_np = rng.integers(0, 64, half, dtype=np.uint8) \
        * (rng.random(half) < 0.3)
    dense = jnp.asarray(folded_np.reshape(-1, 128))

    expect = unfold_canonical(fetch_dense(dense, mode="raw"), kmer_len)
    out = np.zeros(4**kmer_len, np.uint8)
    counts = stream_dense_to_out(
        dense, kmer_len, out, mode=mode, slice_bytes=1 << 14
    )
    assert np.array_equal(out, expect)
    assert np.array_equal(counts, fast_counts256(folded_np))


def test_unfold_range_matches_whole(rng):
    from pykmer_tpu.ops.readback import unfold_canonical, unfold_range

    kmer_len = 7
    half = 4**kmer_len // 2
    folded = rng.integers(0, 256, half, dtype=np.uint8)
    expect = unfold_canonical(folded, kmer_len)
    out = np.zeros(4**kmer_len, np.uint8)
    for lo in range(0, half, 1000):
        hi = min(half, lo + 1000)
        unfold_range(folded[lo:hi], out, kmer_len, lo)
    assert np.array_equal(out, expect)


@pytest.mark.parametrize("width,escape", [(2, 3), (3, 7), (4, 15)])
def test_native_fused_unfold_matches_numpy(rng, width, escape):
    """The native fused readback tail (unpack + unfold + counts + escapes,
    including the BMI2/pdep fast path when the CPU has it) must match the
    reference semantics for every pack width, at aligned and unaligned lo."""
    native = pytest.importorskip("pykmer_tpu.io.native")
    from pykmer_tpu.ops.readback import _rc_codes_np

    k = 7
    size = 4**k
    half = size // 2
    folded = rng.poisson(1.5, half).clip(0, 255).astype(np.uint8)
    stored = np.minimum(folded, escape)
    if width == 2:
        q = stored.reshape(-1, 4)
        packed = (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8)
    elif width == 4:
        q = stored.reshape(-1, 2)
        packed = (q[:, 0] | (q[:, 1] << 4)).astype(np.uint8)
    else:
        g = stored.reshape(-1, 8).astype(np.uint32)
        w = sum(g[:, i].astype(np.uint32) << np.uint32(3 * i) for i in range(8))
        packed = np.stack([w & 255, (w >> 8) & 255, (w >> 16) & 255], 1).astype(np.uint8).reshape(-1)

    u = np.arange(half, dtype=np.uint64)
    canon = u <= _rc_codes_np(u, k)
    expect = np.empty(size, np.uint8)
    expect[:half] = np.where(canon, stored, 0)
    expect[half:] = np.where(canon, 0, stored)[::-1]

    out = np.zeros(size, np.uint8)
    counts, esc_idx = native.unpack_unfold_native(packed, width, out, k, 0)
    assert np.array_equal(out, expect)
    assert np.array_equal(counts, np.bincount(stored, minlength=256))
    assert np.array_equal(np.sort(esc_idx), np.flatnonzero(stored == escape))

    # slice starting mid-plane (aligned to 8 cells -> fast path eligible)
    cells_per_byte = 8 // width if width != 3 else None
    lo = half // 2
    n_bytes = len(packed) // 2
    out2 = np.zeros(size, np.uint8)
    c2, e2 = native.unpack_unfold_native(packed[len(packed) - n_bytes:], width, out2, k, lo)
    expect2 = np.zeros(size, np.uint8)
    tail = stored[lo:]
    expect2[lo:half] = np.where(canon[lo:], tail, 0)
    expect2[half : size - lo] = np.where(canon[lo:], 0, tail)[::-1]
    assert np.array_equal(out2, expect2)
    assert np.array_equal(c2, np.bincount(tail, minlength=256))
    want_esc = np.flatnonzero(stored == escape)
    assert np.array_equal(np.sort(e2.astype(np.int64)) + lo, want_esc[want_esc >= lo])


def test_stream_dense_to_out_with_predispatched_escapes(rng):
    """`escapes=` (the indexer queues count_all_escapes behind the last
    accumulate step) must select the same plane and produce identical output
    as the internally-computed counts."""
    from pykmer_tpu.formats.header import fast_counts256
    from pykmer_tpu.ops.readback import (
        count_all_escapes,
        fetch_dense,
        stream_dense_to_out,
        unfold_canonical,
    )

    kmer_len = 9
    half = 4**kmer_len // 2
    folded_np = (rng.integers(0, 16, half, dtype=np.uint8)
                 * (rng.random(half) < 0.5))
    dense = jnp.asarray(folded_np.reshape(-1, 128))
    expect = unfold_canonical(fetch_dense(dense, mode="raw"), kmer_len)
    out = np.zeros(4**kmer_len, np.uint8)
    counts = stream_dense_to_out(
        dense, kmer_len, out, mode="auto", slice_bytes=1 << 14,
        escapes=count_all_escapes(dense),
    )
    assert np.array_equal(out, expect)
    assert np.array_equal(counts, fast_counts256(folded_np))


@pytest.mark.parametrize("kmer_len", [3, 7, 11, 15])
def test_packed_encoder_matches_slice_encoder(rng, kmer_len):
    """The bit-field packed encoder must be bit-exact vs unpack + slice
    encode + fold, including N/separator/padding windows -> sentinel."""
    from pykmer_tpu.ops.encode import (
        canonical_codes,
        canonical_codes_packed,
        fold_codes,
        pack_base_stream,
        unpack_base_2bit,
        unpack_base_2bit_mask,
    )

    span = 3000 + kmer_len - 1
    seq = rng.integers(0, 4, size=span).astype(np.uint8)
    # Ns, separators, and a run shorter than K
    seq[100:110] = 4
    seq[500] = 4
    seq[502] = 4
    seq[-3:] = 4
    bases2, maskbits = pack_base_stream(seq)
    want = fold_codes(
        canonical_codes(
            unpack_base_2bit_mask(
                jnp.asarray(bases2), jnp.asarray(maskbits), span
            ),
            kmer_len,
        ),
        kmer_len,
    )
    got = canonical_codes_packed(
        jnp.asarray(bases2), jnp.asarray(maskbits), span, kmer_len
    )
    assert np.array_equal(np.asarray(got), np.asarray(want))

    # all-valid variant
    seq2 = rng.integers(0, 4, size=span).astype(np.uint8)
    b2, _ = pack_base_stream(seq2)
    want2 = fold_codes(
        canonical_codes(unpack_base_2bit(jnp.asarray(b2), span), kmer_len),
        kmer_len,
    )
    got2 = canonical_codes_packed(jnp.asarray(b2), None, span, kmer_len)
    assert np.array_equal(np.asarray(got2), np.asarray(want2))


@pytest.mark.parametrize("n_windows", [1, 3, 15, 16, 17, 31, 33])
def test_packed_encoder_tiny_spans(rng, n_windows):
    """Window counts around the u32-group boundaries (1 window, partial
    first group, exact multiples) must stay bit-exact."""
    from pykmer_tpu.ops.encode import (
        canonical_codes,
        canonical_codes_packed,
        fold_codes,
        pack_base_stream,
        unpack_base_2bit_mask,
    )

    k = 15
    span = n_windows + k - 1
    seq = rng.integers(0, 4, size=span).astype(np.uint8)
    if n_windows > 2:
        seq[1] = 4  # an N near the start poisons the first k windows
    bases2, maskbits = pack_base_stream(seq)
    want = fold_codes(
        canonical_codes(
            unpack_base_2bit_mask(
                jnp.asarray(bases2), jnp.asarray(maskbits), span
            ),
            k,
        ),
        k,
    )
    got = canonical_codes_packed(
        jnp.asarray(bases2), jnp.asarray(maskbits), span, k
    )
    assert np.array_equal(np.asarray(got), np.asarray(want)), n_windows


def test_encoder_env_override_validated(monkeypatch):
    """A typo'd PYKMER_TPU_ENCODER must raise, not silently read as
    'slice' (ADVICE r4)."""
    from pykmer_tpu.ops.encode import use_packed_encoder

    monkeypatch.setenv("PYKMER_TPU_ENCODER", "packed")
    assert use_packed_encoder(15, masked=True) is True
    monkeypatch.setenv("PYKMER_TPU_ENCODER", "slice")
    assert use_packed_encoder(15, masked=False) is False
    monkeypatch.delenv("PYKMER_TPU_ENCODER")
    assert use_packed_encoder(15, masked=False) is True
    for bad in ("Packed", "slicee", "1"):
        monkeypatch.setenv("PYKMER_TPU_ENCODER", bad)
        with pytest.raises(ValueError, match="PYKMER_TPU_ENCODER"):
            use_packed_encoder(15, masked=False)
