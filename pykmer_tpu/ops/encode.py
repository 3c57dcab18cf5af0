"""Canonical k-mer encoding as a vectorised XLA program.

Semantics (must match reference indexer.py:130-160 and indexer.py:341):
forward code ``sum_p base[i+p] * 4^(K-1-p)``; reverse-complement code
``sum_p (3 - base[i+p]) * 4^p``; canonical = min(fwd, rev); any window
containing an invalid base (code >= 4) is dropped. Dropped/padded windows
encode as the sentinel ``4^K`` so downstream static-shape code can carry them.

Layout: two vectorised formulations, no per-window loop anywhere.
:func:`canonical_codes` (any K) computes all ``S`` windows from K shifted
slices — the formulation hinted at by the reference's unused numpy
prototype (tools.py:562-675). :func:`canonical_codes_packed` (K <= 15)
skips the unpack entirely: it treats the packed upload plane as a
big-endian bit stream, extracts each window's 2K-bit field from a uint32
pair, and derives the reverse complement with an in-register 2-bit-group
reversal butterfly. The default per chunk variant is packed for ALL-VALID
chunks and slice for MASKED chunks (chosen on the previous accelerator;
not yet re-timed on the GPU). ``PYKMER_TPU_ENCODER=packed|slice`` forces
one for both variants; they are bit-exact and tested against each other.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def code_dtype(kmer_len: int):
    """Smallest integer dtype holding 4^K (plus the invalid-base headroom).

    fwd sums reach ``4 * (4^K - 1) / 3`` when invalid bases (code 4) are
    present, so K=15 still fits int32 (1.43e9 < 2^31); K>=17 needs int64.
    """
    return jnp.int32 if kmer_len <= 15 else jnp.int64


def SENTINEL_FACTORY(kmer_len: int) -> int:
    return 4**kmer_len


def use_packed_encoder(kmer_len: int, masked: bool) -> bool:
    """Single source of truth for the encoder choice (see module docstring:
    per-variant defaults from production A/B; PYKMER_TPU_ENCODER=packed|
    slice forces one for both variants). Resolve this OUTSIDE lru-cached
    program builders and pass the bool in, so the env var participates in
    the build cache key."""
    import os

    env = os.environ.get("PYKMER_TPU_ENCODER", "")
    if env not in ("", "packed", "slice"):
        # a typo'd override would otherwise silently read as 'slice' and be
        # indistinguishable from the per-variant default during an A/B
        # (ADVICE r4)
        raise ValueError(
            f"PYKMER_TPU_ENCODER must be 'packed' or 'slice' (or unset), "
            f"got {env!r}"
        )
    if kmer_len > 15:  # 2K-bit fields stop fitting u32 pairs
        return False
    return env == "packed" if env else not masked


def canonical_codes(chunk: jax.Array, kmer_len: int) -> jax.Array:
    """All window codes of a chunk.

    chunk: uint8[(S + K - 1)] base codes (0..3 valid, >=4 invalid).
    returns: [S] canonical codes in ``code_dtype``; invalid windows = 4^K.
    """
    k = kmer_len
    s = chunk.shape[0] - k + 1
    assert s > 0, "chunk shorter than one window"
    dt = code_dtype(k)
    x = chunk.astype(dt)

    fwd = jnp.zeros((s,), dtype=dt)
    rev = jnp.zeros((s,), dtype=dt)
    bad = jnp.zeros((s,), dtype=jnp.uint8)
    for p in range(k):
        sl = jax.lax.dynamic_slice_in_dim(x, p, s)
        fwd = fwd + sl * (4 ** (k - p - 1))
        rev = rev + (3 - sl) * (4**p)
        bad = bad | (chunk[p : p + s] >= 4)

    canon = jnp.minimum(fwd, rev)
    sentinel = jnp.asarray(4**k, dtype=dt)
    return jnp.where(bad.astype(bool), sentinel, canon)


def fold_codes(codes: jax.Array, kmer_len: int) -> jax.Array:
    """Map canonical codes into the folded half-space ``min(c, M - c)``.

    Complementing every base maps code c to ``M - c`` (M = 4^K - 1), and for
    odd K at most one of each pair {u, M - u} is canonical (both would force
    u == revcomp(u)), so storing counts at the folded position is lossless:
    the host expands with :func:`pykmer_tpu.ops.readback.unfold_canonical`.
    Halves dense device memory, per-batch apply traffic, and readback bytes
    — and folded codes are uniformly distributed over [0, 4^K/2) (canonical
    codes skew low; the fold flattens the triangular density), which
    balances accumulate tiles. Sentinel 4^K maps to the folded sentinel
    4^K/2.
    """
    dt = codes.dtype
    m = jnp.asarray(4**kmer_len - 1, dt)
    half = jnp.asarray(4**kmer_len // 2, dt)
    folded = jnp.minimum(codes, m - codes)
    return jnp.where(codes > m, half, folded)


def _swizzle_2bit_bytes(b: "jax.Array") -> "jax.Array":
    """Reverse the four 2-bit groups of every byte (little-endian per-byte
    packing → big-endian bit-stream order)."""
    b = b.astype(jnp.uint32)
    return (
        ((b & 0x03) << 6) | ((b & 0x0C) << 2)
        | ((b & 0x30) >> 2) | ((b & 0xC0) >> 6)
    ).astype(jnp.uint32)


def _bitrev_bytes(b: "jax.Array") -> "jax.Array":
    """Reverse the bits of every byte (validity bit-plane to stream order)."""
    b = b.astype(jnp.uint32)
    b = ((b & 0xF0) >> 4) | ((b & 0x0F) << 4)
    b = ((b & 0xCC) >> 2) | ((b & 0x33) << 2)
    b = ((b & 0xAA) >> 1) | ((b & 0x55) << 1)
    return b


def _words_from_bytes(by: "jax.Array", pad_words: int) -> "jax.Array":
    """Big-endian uint32 words from a byte stream (padded, +pad_words 0s)."""
    n = by.shape[0]
    rem = (-n) % 4
    if rem:
        by = jnp.concatenate([by, jnp.zeros((rem,), by.dtype)])
    w = by.reshape(-1, 4).astype(jnp.uint32)
    words = (w[:, 0] << 24) | (w[:, 1] << 16) | (w[:, 2] << 8) | w[:, 3]
    return jnp.concatenate(
        [words, jnp.zeros((pad_words,), jnp.uint32)]
    )


def _revgroup_u32(x: "jax.Array") -> "jax.Array":
    """Reverse the sixteen 2-bit groups of each uint32 (butterfly)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0x0000FFFF) << 16) | (x >> 16)


def canonical_codes_packed(
    bases2: "jax.Array",
    maskbits: "Optional[jax.Array]",
    span: int,
    kmer_len: int,
) -> "jax.Array":
    """Folded canonical codes straight from the PACKED upload planes.

    The shifted-slice encoder (:func:`canonical_codes`) materialises K
    full-size int32 slices (~45 vector ops + ~15 memory passes per window at
    K=15). This formulation keeps the chunk as a big-endian bit stream and
    extracts each window's 2K-bit field with two uint32 words and a shift
    (~6 ops), derives the reverse complement in-register via a 2-bit-group
    reversal butterfly + complement (~12 ops, no second stream), and tests
    validity as one K-bit field compare — ~26 uint32 ops per window total.
    K <= 15 only (2K + alignment slack must fit 32 bits); bit-exact vs the
    slice encoder + fold (tested), including N/separator/padding windows
    folding to the sentinel.
    """
    k = kmer_len
    assert k <= 15, "packed encoder extracts 2K-bit fields from u32 pairs"
    m = span - k + 1
    assert m > 0
    mask2k = jnp.uint32((1 << (2 * k)) - 1)
    top = jnp.uint32(32 - 2 * k)

    # --- forward codes: window i = bits [2i, 2i+2K) of the stream --------
    words = _words_from_bytes(_swizzle_2bit_bytes(bases2).astype(jnp.uint8),
                              pad_words=2)
    n_groups = (m + 15) // 16
    lo = words[:n_groups][:, None]                      # [G, 1]
    hi = words[1 : n_groups + 1][:, None]
    sh = (2 * jnp.arange(16, dtype=jnp.uint32))[None, :]  # [1, 16]
    # A = 32-bit window at bit offset 2i (t = i mod 16); t == 0 needs no
    # hi bits and a << 32 is undefined — select it away
    a = jnp.where(
        sh == 0, lo, (lo << sh) | (hi >> (jnp.uint32(32) - sh))
    )
    fwd = (a >> top).reshape(-1)[:m] & mask2k

    # --- reverse complement in-register ----------------------------------
    # top-align the 2K bits and reverse all 16 groups: the window's groups
    # land at the LOW end in reversed order (b_p now weighted 4^p), then
    # complement within the mask
    r = _revgroup_u32(fwd << top)
    rev = (~r) & mask2k

    canon = jnp.minimum(fwd, rev)
    folded_dt = code_dtype(k)
    mm = jnp.asarray(4**k - 1, jnp.uint32)
    half = 4**k // 2
    folded = jnp.minimum(canon, mm - canon)

    if maskbits is None:
        return folded.astype(folded_dt)

    # --- validity: window i valid iff its K mask bits are all set --------
    vwords = _words_from_bytes(_bitrev_bytes(maskbits).astype(jnp.uint8),
                               pad_words=2)
    vg = (m + 31) // 32
    vlo = vwords[:vg][:, None]
    vhi = vwords[1 : vg + 1][:, None]
    vsh = jnp.arange(32, dtype=jnp.uint32)[None, :]
    va = jnp.where(
        vsh == 0, vlo, (vlo << vsh) | (vhi >> (jnp.uint32(32) - vsh))
    )
    want = jnp.uint32((1 << k) - 1)
    valid = ((va >> jnp.uint32(32 - k)) & want) == want
    valid = valid.reshape(-1)[:m]
    return jnp.where(
        valid, folded.astype(folded_dt), jnp.asarray(half, folded_dt)
    )


def make_canonical_codes_fn(
    kmer_len: int, chunk_windows: int
) -> Callable[[jax.Array], jax.Array]:
    """jit-compiled encoder for fixed (K, S)."""

    @jax.jit
    def fn(chunk: jax.Array) -> jax.Array:
        assert chunk.shape == (chunk_windows + kmer_len - 1,)
        return canonical_codes(chunk, kmer_len)

    return fn


def chunk_stream(
    concat_codes: np.ndarray, kmer_len: int, chunk_windows: int
) -> Tuple[np.ndarray, int]:
    """Host-side framing: pad the concatenated code stream so it splits into
    fixed-size chunks of ``chunk_windows`` window starts with K-1 halo overlap.

    Returns (padded array, number of chunks). Padding uses the invalid code 4,
    so windows that touch padding are dropped on device.
    """
    k = kmer_len
    n = concat_codes.shape[0]
    n_windows = max(n - k + 1, 0)
    n_chunks = max((n_windows + chunk_windows - 1) // chunk_windows, 1)
    need = n_chunks * chunk_windows + k - 1
    if need > n:
        # pad in place when the stream's pooled block has tail capacity
        # (the decode path over-allocates for exactly this; a fresh
        # GiB-scale block would pay this environment's slow populate)
        from ..utils.bigmem import extend_view

        ext = extend_view(concat_codes, need)
        if ext is None:
            pad = np.full(need - n, 4, dtype=np.uint8)
            concat_codes = np.concatenate([concat_codes, pad])
        else:
            ext[n:need] = 4
            concat_codes = ext
    return concat_codes, n_chunks


def iter_chunks(padded: np.ndarray, kmer_len: int, chunk_windows: int, n_chunks: int):
    """Yield the overlapping device chunks of a padded stream."""
    span = chunk_windows + kmer_len - 1
    for c in range(n_chunks):
        start = c * chunk_windows
        yield padded[start : start + span]


def pack_base_stream(padded: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: pack base codes to (2-bit bases, 1-bit validity bitmap) —
    0.375 bytes/base of host→device upload (vs 1). Invalid codes (>= 4) pack
    as base 0 with validity bit 0; the device restores them to 4. Base
    ``4j+i`` is bits [2i, 2i+2) of ``bases[j]``; validity of base ``8j+i``
    is bit i of ``mask[j]``. Native threaded pass with a numpy fallback.
    Tail-pads to a multiple of 8 with invalid bases (unused by any chunk)."""
    n = padded.shape[0]
    if n % 8:
        padded = np.concatenate([padded, np.full(8 - n % 8, 4, np.uint8)])
    try:
        from ..io.native import pack_base_2bit_mask_native

        # thread spawn/join costs more than the work below ~8 MB (the lazy
        # per-chunk path packs ~1.5 MB pieces inside the dispatch loop)
        threads = 8 if padded.shape[0] >= (8 << 20) else 1
        return pack_base_2bit_mask_native(padded, threads=threads)
    except ImportError:
        valid = padded < 4
        b = np.where(valid, padded, 0).reshape(-1, 4)
        bases = (b[:, 0] | (b[:, 1] << 2) | (b[:, 2] << 4) | (b[:, 3] << 6)).astype(
            np.uint8
        )
        mask = np.packbits(valid.reshape(-1, 8), axis=1, bitorder="little")
        return bases, mask.reshape(-1)


def mask_all_valid(mask: np.ndarray, span: int) -> bool:
    """True iff the first ``span`` validity bits are all set — the chunk has
    no Ns, no record separators, no tail padding."""
    full = span // 8
    if full and not (mask[:full] == 0xFF).all():
        return False
    rem = span % 8
    if rem:
        want = (1 << rem) - 1
        return (int(mask[full]) & want) == want
    return True


def iter_chunks_packed(
    packed: Tuple[np.ndarray, np.ndarray],
    kmer_len: int,
    chunk_windows: int,
    n_chunks: int,
):
    """Yield (bases2, maskbits) device chunks: chunk c covers bases
    [c*W, c*W + W + K - 1); W % 8 == 0 keeps every chunk start aligned in
    both planes, and the final partial bytes exist because chunk_stream pads
    to exactly W*n_chunks + K - 1 bases."""
    assert chunk_windows % 8 == 0
    bases, mask = packed
    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    for c in range(n_chunks):
        start = c * chunk_windows
        b0 = start // 4
        m0 = start // 8
        yield bases[b0 : b0 + b_span], mask[m0 : m0 + m_span]


def iter_chunks_packed_lazy(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_chunks: int
):
    """Yield (bases2, maskbits) chunks packed on the fly — same shapes as
    :func:`iter_chunks_packed` but each ~1.5 MB chunk is packed just before
    its (async) upload, so the pack cost hides behind device compute instead
    of being an up-front pass over the whole stream."""
    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    from concurrent.futures import ThreadPoolExecutor

    def pack_one(piece):
        from ..utils import renice_current_thread

        renice_current_thread(10)  # yield the cores to h2d transport threads
        bases, mask = pack_base_stream(piece)
        mask = mask[:m_span]
        # all-valid chunks (no Ns / separators / padding — the common case
        # for chromosome-scale records) skip the mask upload entirely; the
        # indexer dispatches them to the mask-free device step
        return bases[:b_span], (None if mask_all_valid(mask, span) else mask)

    # one pack kept in flight: chunk i+1 packs (native, GIL-free) while the
    # consumer dispatches chunk i's upload + device step
    with ThreadPoolExecutor(1) as ex:
        fut = None
        for piece in iter_chunks(padded, kmer_len, chunk_windows, n_chunks):
            nxt = ex.submit(pack_one, piece)
            if fut is not None:
                yield fut.result()
            fut = nxt
        if fut is not None:
            yield fut.result()


def unpack_base_2bit_mask(
    bases: "jax.Array", mask: "jax.Array", span: int
) -> "jax.Array":
    """Device-side inverse of pack_base_stream (fused into the jit step):
    [span] uint8 base codes with invalid positions restored to 4."""
    shifts2 = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    b = ((bases[:, None] >> shifts2) & 3).reshape(-1)[:span]
    shifts1 = jnp.arange(8, dtype=jnp.uint8)
    v = ((mask[:, None] >> shifts1) & 1).reshape(-1)[:span]
    return jnp.where(v == 1, b, jnp.uint8(4))


def unpack_base_2bit(bases: "jax.Array", span: int) -> "jax.Array":
    """Mask-free variant for all-valid chunks (see mask_all_valid)."""
    shifts2 = jnp.arange(0, 8, 2, dtype=jnp.uint8)
    return ((bases[:, None] >> shifts2) & 3).reshape(-1)[:span]


def iter_chunks_prepacked(
    bases: np.ndarray,
    mask: np.ndarray,
    n_codes: int,
    kmer_len: int,
    chunk_windows: int,
):
    """Yield (bases2, maskbits-or-None) chunks as zero-copy VIEWS of
    pre-packed planes (io.native.fasta_decode_joined_packed_native output:
    planes invalid-padded past ``n_codes`` with capacity for the final
    chunk's span). No per-chunk packing happens here at all — during the
    dispatch loop the CPUs belong to the h2d transport."""
    assert chunk_windows % 8 == 0
    k = kmer_len
    n_windows = max(n_codes - k + 1, 0)
    n_chunks = max((n_windows + chunk_windows - 1) // chunk_windows, 1)
    span = chunk_windows + k - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    assert (n_chunks - 1) * chunk_windows // 4 + b_span <= bases.shape[0]
    assert (n_chunks - 1) * chunk_windows // 8 + m_span <= mask.shape[0]
    for c in range(n_chunks):
        start = c * chunk_windows
        b = bases[start // 4 : start // 4 + b_span]
        m = mask[start // 8 : start // 8 + m_span]
        yield b, (None if mask_all_valid(m, span) else m)
