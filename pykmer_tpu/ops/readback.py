"""Packed, multi-stream device→host readback of the dense array.

The final 4^K-byte fetch crosses the host link, which is far slower than
device memory, so this module can move fewer bytes than a raw copy. Two
independent reductions:

1. **Bit-packing with escapes.** Counts at realistic coverage are tiny
   (Poisson λ<1 for K=15 plant genomes), so cells are packed on device to
   2-bit codes (value 3 = ">= 3") or 4-bit nibbles (15 = ">= 15"); the host
   unpacks and patches escape cells with one device index-gather whose size
   is ∝ the escape count. Mode auto-selects from device-side escape counts
   (raw fallback for small/saturated arrays).

2. **Multi-stream fetch.** The transfer is split into SLICE_BYTES row
   slices fetched by a thread pool into a preallocated host buffer, so the
   host-side unpack of early slices overlaps the copies of later ones.

Whether either reduction still pays at PCIe rates is open (ROADMAP 1.5):
the pack programs and the host unpack may cost more than a raw copy.

All device programs here work on a 2D [rows, lanes] view of the plane.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.bigmem import big_empty

ESCAPE4 = 15
ESCAPE3 = 7
ESCAPE2 = 3
_PACK_LANES = 256
SLICE_BYTES = 4 << 20
FETCH_THREADS = 16


def _as2d(dense: jax.Array) -> jax.Array:
    """[rows, >=256-lane] view for the pack kernels.

    The packed BIT layout depends only on the flat cell order (all three
    packs group adjacent cells within a row), so a plane already 2D with a
    lane count that is a multiple of 256 packs in its NATIVE shape instead
    of paying a reshape."""
    if dense.ndim == 2 and dense.shape[1] % _PACK_LANES == 0:
        return dense
    return dense.reshape(-1, _PACK_LANES)


@jax.jit
def pack_nibbles(dense: jax.Array) -> jax.Array:
    """dense (any shape, size % 256 == 0) → uint8[rows,128]: min(v,15)
    nibbles, even cell of each adjacent pair in the low bits."""
    d2 = _as2d(dense)
    nib = jnp.minimum(d2, ESCAPE4)
    return (nib[:, 0::2] | (nib[:, 1::2] << 4)).astype(jnp.uint8)


@jax.jit
def pack_2bit(dense: jax.Array) -> jax.Array:
    """dense → uint8[rows,64]: min(v,3) crumbs, cell i of each group of 4 in
    bits [2i, 2i+2)."""
    d2 = _as2d(dense)
    q = jnp.minimum(d2, ESCAPE2)
    return (
        q[:, 0::4] | (q[:, 1::4] << 2) | (q[:, 2::4] << 4) | (q[:, 3::4] << 6)
    ).astype(jnp.uint8)


@jax.jit
def pack_3bit(dense: jax.Array) -> jax.Array:
    """dense → uint8[rows,96]: min(v,7) 3-bit fields; cell group
    (8g..8g+7) of a row packs into bytes (3g, 3g+1, 3g+2) little-endian
    (cell 8g+i occupies bits [3i, 3i+3) of the 24-bit group)."""
    d2 = _as2d(dense)
    q = jnp.minimum(d2, ESCAPE3)
    c = [q[:, i::8] for i in range(8)]
    b0 = c[0] | (c[1] << 3) | ((c[2] & 3) << 6)
    b1 = (c[2] >> 2) | (c[3] << 1) | (c[4] << 4) | ((c[5] & 1) << 7)
    b2 = (c[5] >> 1) | (c[6] << 2) | (c[7] << 5)
    rows = d2.shape[0]
    out_cols = 3 * d2.shape[1] // 8
    return jnp.stack([b0, b1, b2], axis=2).reshape(rows, out_cols) \
        .astype(jnp.uint8)


@jax.jit
def count_escapes(dense: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """(cells >= 3, cells >= 15) — one device pass, both pack thresholds.

    No ``_as2d``: reductions are shape-agnostic, so the plane is reduced
    in its native layout without a reshaped temporary."""
    ge3 = (dense >= ESCAPE2).sum(dtype=jnp.int64)
    ge15 = (dense >= ESCAPE4).sum(dtype=jnp.int64)
    return ge3, ge15


@jax.jit
def count_all_escapes(dense: jax.Array):
    """(cells >= 1, >= 3, >= 7, >= 15) — one cheap device pass ahead of
    choosing the pack mode; the scalars cost one tiny dispatch round-trip.
    The >= 1 count (nonzeros) prices the sparse token stream; the others
    price each fixed-width plane's escape patches. Reduces the plane in its
    native layout (see count_escapes on why no _as2d)."""
    return (
        (dense >= 1).sum(dtype=jnp.int64),
        (dense >= ESCAPE2).sum(dtype=jnp.int64),
        (dense >= ESCAPE3).sum(dtype=jnp.int64),
        (dense >= ESCAPE4).sum(dtype=jnp.int64),
    )


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """packed nibble plane → flat uint8[2 * size] (host side).

    Flat layout: cell ``2p + i`` lives in bits [4i, 4i+4) of packed byte
    ``p`` (row-major flattening of the device's [rows, 256] view commutes
    with the column interleave). Native threaded LUT pass when available;
    the numpy fallback expands via one broadcast shift into a contiguous
    [n, 2] buffer (strided column stores are ~10x slower at GiB scale)."""
    flat = np.ascontiguousarray(packed).reshape(-1)
    out = big_empty(2 * flat.shape[0])
    try:
        from ..io.native import unpack_4bit_native

        unpack_4bit_native(flat, out)
    except ImportError:
        pairs = out.reshape(-1, 2)
        np.right_shift(flat[:, None], np.array([0, 4], np.uint8), out=pairs)
        pairs &= 0x0F
    return out


def unpack_3bit(packed: np.ndarray) -> np.ndarray:
    """packed 3-bit plane → flat uint8[8 * size / 3] (host side).

    Flat layout: 3-byte group p holds cells 8p..8p+7, cell i in bits
    [3i, 3i+3) of the little-endian 24-bit group."""
    flat = np.ascontiguousarray(packed).reshape(-1)
    assert flat.shape[0] % 3 == 0
    n_groups = flat.shape[0] // 3
    out = big_empty(8 * n_groups)
    try:
        from ..io.native import unpack_3bit_native

        unpack_3bit_native(flat, out)
    except ImportError:
        g = flat.reshape(-1, 3).astype(np.uint32)
        word = g[:, 0] | (g[:, 1] << 8) | (g[:, 2] << 16)
        cells = out.reshape(-1, 8)
        for i in range(8):
            cells[:, i] = (word >> (3 * i)) & 7
    return out


def unpack_2bit(packed: np.ndarray) -> np.ndarray:
    """packed 2-bit plane → flat uint8[4 * size] (host side).

    Flat layout: cell ``4p + i`` is bits [2i, 2i+2) of packed byte ``p``."""
    flat = np.ascontiguousarray(packed).reshape(-1)
    out = big_empty(4 * flat.shape[0])
    try:
        from ..io.native import unpack_2bit_native

        unpack_2bit_native(flat, out)
    except ImportError:
        quads = out.reshape(-1, 4)
        np.right_shift(flat[:, None], np.array([0, 2, 4, 6], np.uint8), out=quads)
        quads &= 0x03
    return out


@jax.jit
def _gather_cells(dense: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather dense cells at flat folded indices (int32/int64; divmod on
    device — one index upload instead of separate row/col planes). Uses the
    plane's NATIVE lane count when it is already 2D, so no reshaped
    temporary of the plane is made."""
    d2 = dense if dense.ndim == 2 else _as2d(dense)
    lanes = d2.shape[1]
    return d2[idx // lanes, idx % lanes]


def fetch_array_mt(
    dev: jax.Array,
    out: np.ndarray = None,
    slice_bytes: int = SLICE_BYTES,
    threads: int = FETCH_THREADS,
) -> np.ndarray:
    """Fetch a 2D device array into host memory via concurrent row-slice
    transfers (returns ``out`` or a new array of matching shape/dtype)."""
    rows, cols = dev.shape
    itemsize = np.dtype(dev.dtype).itemsize
    row_bytes = cols * itemsize
    if out is None:
        out = big_empty((rows, cols), dtype=dev.dtype)
    rows_per = max(1, slice_bytes // max(row_bytes, 1))
    if rows <= rows_per:
        out[...] = np.asarray(dev)
        return out
    bounds = list(range(0, rows, rows_per)) + [rows]

    parts = [dev[bounds[i] : bounds[i + 1]] for i in range(len(bounds) - 1)]
    for p in parts:
        try:
            p.copy_to_host_async()
        except AttributeError:
            break

    def work(i: int) -> None:
        out[bounds[i] : bounds[i + 1]] = np.asarray(parts[i])

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(work, range(len(bounds) - 1)))
    return out


_GATHER_SHAPES = (1 << 16, 1 << 20, 1 << 22)


def _gather_batched(dense: jax.Array, idx: np.ndarray) -> np.ndarray:
    """Gather dense cells at flat (row-major) indices via fixed-shape device
    gathers.

    Exactly three gather shapes exist ever (all preloadable): padding to the
    next power of two would mint a fresh executable per run, and its
    compile would land in the middle of the readback. Indices upload once
    as int32 (4 B each;
    the old separate int32 row/col planes were 2x that) — unless the folded
    plane exceeds int32 indexing (K >= 17 forced onto the device strategy),
    where int64 indices are required (numpy would otherwise downcast
    silently and the gather would patch the wrong cells)."""
    n = idx.shape[0]
    idt = (np.int64 if int(np.prod(dense.shape)) > np.iinfo(np.int32).max
           else np.int32)
    out = np.empty(n, dtype=np.uint8)
    pos = 0
    while pos < n:
        take = min(n - pos, _GATHER_SHAPES[-1])
        shape = next(s for s in _GATHER_SHAPES if take <= s)
        pad = np.zeros(shape, dtype=idt)
        pad[:take] = idx[pos : pos + take]
        vals = np.asarray(_gather_cells(dense, jnp.asarray(pad)))
        out[pos : pos + take] = vals[:take]
        pos += take
    return out


def _patch_escapes(dense: jax.Array, out: np.ndarray, escape: int) -> None:
    """Overwrite host cells equal to ``escape`` with their true device values
    (batched fixed-shape index gathers)."""
    esc_idx = np.flatnonzero(out == escape)
    if esc_idx.shape[0] == 0:
        return
    out[esc_idx] = _gather_batched(dense, esc_idx)


def _rc_codes_np(u: np.ndarray, kmer_len: int) -> np.ndarray:
    """Vectorised reverse-complement of K 2-bit symbol codes (host numpy)."""
    v = u.astype(np.uint64)
    r = np.zeros_like(v)
    for _ in range(kmer_len):
        r = (r << np.uint64(2)) | (~v & np.uint64(3))
        v = v >> np.uint64(2)
    return r


def unfold_canonical(
    folded: np.ndarray, kmer_len: int, out: Optional[np.ndarray] = None
) -> np.ndarray:
    """Expand the folded half-plane (counts stored at min(c, M-c), see
    ops.encode.fold_codes) to the full 4^K dense array.

    For each pair {u, M-u} exactly one member is canonical (odd K); it gets
    folded[u], the other 0. Native threaded kernel with a blockwise numpy
    fallback. ``out`` may be any writable uint8[4^K] buffer — passing a
    file-backed memmap writes the `.kin` directly, fusing the expand and the
    file write into one pass (no intermediate 4^K-byte array)."""
    half = folded.shape[0]
    size = 2 * half
    assert size == 4**kmer_len
    if out is None:
        out = big_empty(size)
    assert out.shape[0] == size and out.dtype == np.uint8
    try:
        from ..io.native import unfold_canonical_native

        unfold_canonical_native(np.ascontiguousarray(folded), out, kmer_len)
        return out
    except ImportError:
        pass
    m = size - 1
    block = 1 << 22
    for lo in range(0, half, block):
        hi = min(half, lo + block)
        u = np.arange(lo, hi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded[lo:hi]
        out[lo:hi] = np.where(canon, vals, 0)
        # mirror cells [m-hi+1, m-lo] in descending-u order
        mirror = np.where(canon, 0, vals)[::-1]
        out[m - hi + 1 : m - lo + 1] = mirror
    return out


def unfold_range(
    folded_slice: np.ndarray, out: np.ndarray, kmer_len: int, lo: int
) -> None:
    """Expand folded indices [lo, lo+len(slice)) into the full 4^K array
    ``out`` (slice variant of :func:`unfold_canonical`)."""
    try:
        from ..io.native import unfold_canonical_range_native

        unfold_canonical_range_native(
            np.ascontiguousarray(folded_slice), out, kmer_len, lo
        )
        return
    except ImportError:
        pass
    size = out.shape[0]
    m = size - 1
    end = lo + folded_slice.shape[0]
    # blockwise like unfold_canonical: a 2^30-cell sub-plane in one shot
    # would allocate tens-of-GiB uint64 temps
    block = 1 << 22
    for blo in range(lo, end, block):
        bhi = min(end, blo + block)
        u = np.arange(blo, bhi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded_slice[blo - lo : bhi - lo]
        out[blo:bhi] = np.where(canon, vals, 0)
        out[m - bhi + 1 : m - blo + 1] = np.where(canon, 0, vals)[::-1]


def unfold_piece(
    folded_piece: np.ndarray, kmer_len: int, g0: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Expand folded cells [g0, g0+n) WITHOUT the full 4^K output buffer.

    Returns (primary, mirror, mirror_offset): the piece's two contiguous
    unfolded regions — primary belongs at offset ``g0``, mirror at
    ``mirror_offset = 4^K - g0 - n``. The sharded multi-host writer pwrites
    each host's owner pieces directly into the shared output file, so no
    host materialises the whole plane (index/multihost)."""
    n = folded_piece.shape[0]
    size = 4**kmer_len
    m = size - 1
    assert g0 + n <= size // 2
    primary = np.empty(n, dtype=np.uint8)
    mirror = np.empty(n, dtype=np.uint8)
    try:
        from ..io.native import unfold_canonical_piece_native

        unfold_canonical_piece_native(
            np.ascontiguousarray(folded_piece), primary, mirror, kmer_len, g0
        )
        return primary, mirror, size - g0 - n
    except ImportError:
        pass
    block = 1 << 22
    for blo in range(0, n, block):
        bhi = min(n, blo + block)
        u = np.arange(g0 + blo, g0 + bhi, dtype=np.uint64)
        canon = u <= _rc_codes_np(u, kmer_len)
        vals = folded_piece[blo:bhi]
        primary[blo:bhi] = np.where(canon, vals, 0)
        # mirror cells [m-(g0+bhi-1), m-(g0+blo)] in descending-u order →
        # positions [n-bhi, n-blo) of the mirror buffer
        mirror[n - bhi : n - blo] = np.where(canon, 0, vals)[::-1]
    return primary, mirror, size - g0 - n


def _pick_mode(dense: jax.Array, size: int, mode: str, escapes=None) -> str:
    """Resolve "auto" to a concrete plane via the device escape counts.

    ``escapes``: optional pre-dispatched ``count_all_escapes`` result — the
    indexer queues it right after the last accumulate step so the scalars are
    already on their way back when the readback starts (saves the round trip
    behind a drained dispatch queue)."""
    if mode == "raw" or (mode == "auto" and size < (1 << 26)) or size % _PACK_LANES:
        return "raw"
    if mode != "auto":
        return mode
    if escapes is None:
        escapes = count_all_escapes(dense)
    vals = tuple(int(v) for v in escapes)
    # pre-r4 callers may still hand a 3-tuple (no nonzero count): price the
    # fixed-width planes only
    n_nz = vals[0] if len(vals) == 4 else None
    n_ge3, n_ge7, n_ge15 = vals[-3:]
    # bytes moved per plane: plane bits/8 per cell + ~9 bytes per escape
    # (index upload + value download + dispatch overheads)
    costs = {
        "2bit": size // 4 + 9 * n_ge3,
        "3bit": 3 * size // 8 + 9 * n_ge7,
        "packed": size // 2 + 9 * n_ge15,
    }
    if (n_nz is not None and n_nz <= size // 8
            and _sparse_viable(dense, size, n_ge3)):
        # one token byte per nonzero + the same ~9-byte escape patches, plus
        # a flat size/64 penalty for the extra device work (per-segment
        # compaction sorts) and per-segment side/meta transfers — sparse
        # must win clearly, not marginally. The size/8 density gate keeps
        # segment-level skew away from the 20% token caps (_sparse_caps).
        costs["sparse"] = n_nz + 9 * n_ge3 + size // 64
    mode = min(costs, key=costs.get)
    return "raw2d" if costs[mode] > size else mode


# --- sparse (zero-run token) readback -------------------------------------
#
# At K >= 17 realistic coverage leaves the folded plane ~93% zeros (Poisson
# lambda ~0.1): even the 2-bit fixed-width plane ships 0.25 B/cell while the
# occupancy entropy is ~0.4 bit/cell. The sparse mode compacts each plane
# SEGMENT on device (unstable keys-only sort of nonzero positions — no
# scatter exists on this target) and ships ONE BYTE PER NONZERO:
#
#   token t < 252:  gap g = t // 3 zeros precede the cell, value v = t % 3 + 1
#                   (v == 3 marks ">= 3": true value patched by the usual
#                   batched escape gather)
#   token >= 252:   v = t - 251; the cell's absolute in-segment position is
#                   the next entry of the segment's int32 side stream
#                   (gaps > 83 — P ~ 0.1% at lambda 0.1)
#
# Segments are self-contained (first token's gap counts from the segment
# start), so host decode parallelises per segment with no anchor tables, and
# the device sort temps stay ~1 GiB. Escape POSITIONS are compacted on
# device too, so the patch gather is dispatched before the token drain even
# starts. The host decoder (native C++) memsets the segment's two unfolded
# ranges and writes only the nonzeros — ~10x less memory traffic than the
# fixed-width unpack+unfold at lambda 0.1.

SPARSE_LONG_GAP = 83


def _sparse_min_size() -> int:
    return int(os.environ.get("PYKMER_TPU_SPARSE_MIN", str(1 << 26)))


def _sparse_seg_cells() -> int:
    # hard cap 2^28: pack_sparse_segment carries 4*pos + value in an int32
    return min(int(os.environ.get("PYKMER_TPU_SPARSE_SEG", str(1 << 28))),
               1 << 28)


# fetch grains: device slices MUST use data-independent bounds — a bound
# derived from n_nz would mint a fresh XLA slice program every run (static
# offsets in HLO), paying a compile PER SLICE inside the readback. Fetches
# round up to whole grains instead (≤ one grain of extra bytes per array).
_TOK_GRAIN = 1 << 22   # token slice grain (4 MB)
_AUX_GRAIN = 1 << 17   # side/escape slice grain (512 KB of int32)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _sparse_caps(seg_cells: int) -> Tuple[int, int]:
    """(token capacity, side/escape capacity) for one segment.

    The token cap prices the aux compaction sorts (they run over [cap]), so
    it is deliberately tight: ~20% density, vs the ~12.5% global-density gate
    in :func:`_pick_mode` — the slack absorbs composition skew between a
    plane's segments (GC-content concentrates codes in parts of the code
    space). Overflow falls back to the 2-bit plane, which is priced better
    at such densities anyway. Caps are whole multiples of the fetch grains
    (or the full segment) so every fetch slice has fixed, data-independent
    bounds."""
    cap = min(max(seg_cells // 5, 64), seg_cells)
    cap = min(_round_up(cap, _TOK_GRAIN), seg_cells)
    aux = min(max(seg_cells // 128, 64), seg_cells)
    aux = min(_round_up(aux, _AUX_GRAIN), seg_cells)
    return cap, aux


def _prefix_parts(dev: jax.Array, n: int, grain: int):
    """Device slices with FIXED bounds covering dev[:n] (whole grains)."""
    grain = min(grain, dev.shape[0])
    parts = []
    for a in range(0, n, grain):
        parts.append(jax.lax.slice(dev, (a,), (a + grain,)))
    return parts


def _assemble_prefix(parts, n: int, out: np.ndarray, offset: int = 0) -> None:
    """Copy fetched grain parts into out[offset:offset+n] (clipping the
    final grain)."""
    pos = 0
    for part in parts:
        if pos >= n:
            break
        arr = np.asarray(part)
        take = min(arr.shape[0], n - pos)
        out[offset + pos : offset + pos + take] = arr[:take]
        pos += take


def _sparse_enabled() -> bool:
    return os.environ.get("PYKMER_TPU_SPARSE", "auto") != "0"


def _sparse_viable(dense: jax.Array, size: int, n_ge3: int) -> bool:
    if not _sparse_enabled():
        return False
    if dense.ndim != 2 or size < _sparse_min_size():
        return False
    seg = _sparse_seg_cells()
    lanes = dense.shape[1]
    if seg % lanes:
        return False
    # native decoder required: the numpy fallback would walk tokens in
    # Python — fixed-width planes with the native fused unfold beat that
    try:
        from ..io.native import _HAVE_SPARSE_DECODE

        return bool(_HAVE_SPARSE_DECODE)
    except ImportError:
        return False


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def pack_sparse_segment(seg2d: jax.Array, cap: int, side_cap: int,
                        esc_cap: int):
    """Compact one [rows, lanes] uint8 segment into the sparse transfer format.

    Returns (tokens uint8[cap], side int32[side_cap], escpos int32[esc_cap],
    meta int32[3] = (n_nz, n_long, n_esc)). Only the first n_nz tokens,
    n_long side entries and n_esc escape positions are meaningful; the caller
    falls back to a fixed-width plane if any cap is exceeded (meta carries
    the true counts regardless).

    Positions compact via an unstable keys-only sort (the fast sort of the
    accumulate path): where(nz, 4*iota + clipped_value, BIG) sorted ascending
    puts the nonzeros first IN ORDER, and carrying the 2-bit clipped value
    in the key's low bits avoids a 1-byte-per-nonzero random gather
    afterwards."""
    rows, lanes = seg2d.shape
    s = rows * lanes
    flat = seg2d.reshape(-1)
    nz = flat != 0
    n_nz = nz.sum(dtype=jnp.int32)
    sentinel = jnp.int32(s)
    v8 = jnp.minimum(flat, ESCAPE2).astype(jnp.int32)
    # 4*iota + v fits int32 for segments up to 2^28 cells (enforced by the
    # segment framing); zero cells sort to the tail via 4*s
    keys = jnp.where(
        nz, (jnp.arange(s, dtype=jnp.int32) << 2) + v8, jnp.int32(4) * sentinel
    )
    sorted_keys = jax.lax.sort(keys, is_stable=False)
    sk = jax.lax.slice(sorted_keys, (0,), (cap,))
    pos = sk >> 2
    v = sk & 3
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pos[:-1]])
    gap = pos - prev - 1
    real = jnp.arange(cap, dtype=jnp.int32) < n_nz
    token = jnp.where(
        gap <= SPARSE_LONG_GAP, 3 * gap + (v - 1), 252 + (v - 1)
    )
    token = jnp.where(real, token, 0).astype(jnp.uint8)
    longmask = real & (gap > SPARSE_LONG_GAP)
    n_long = longmask.sum(dtype=jnp.int32)
    side = jax.lax.sort(
        jnp.where(longmask, pos, sentinel), is_stable=False
    )[:side_cap]
    escmask = real & (v == ESCAPE2)
    n_esc = escmask.sum(dtype=jnp.int32)
    escpos = jax.lax.sort(
        jnp.where(escmask, pos, sentinel), is_stable=False
    )[:esc_cap]
    meta = jnp.stack([n_nz, n_long, n_esc])
    return token, side, escpos, meta


@jax.jit
def _concat_metas(metas):
    """Fuse per-segment meta vectors into one array → ONE host fetch (each
    scalar fetch is a device→host round trip)."""
    return jnp.stack(metas)


def _gather_escapes(dense: jax.Array, esc_idx: np.ndarray) -> np.ndarray:
    """Batched device gather of the true values at folded indices
    ``esc_idx``. Batched after the transfers drain: per-slice gathers would
    queue behind the plane transfers and serialize the whole tail."""
    if esc_idx.shape[0] == 0:
        return np.empty(0, dtype=np.uint8)
    return _gather_batched(dense, esc_idx)


class _ChaseSink:
    """Write + hash chasing finalized regions of the unfolded plane.

    ``region_done(lo, hi)`` is called with ascending first-half cell ranges
    as they become final (unfolded + escape-patched): it streams the range
    and its mirror to disk via background writers and advances a sha256
    frontier through the first half of ``out`` — the second half completes
    in reverse region order, so it hashes as one pass in ``finish()`` (the
    only serial remainder). One sink may span multiple sub-planes (the
    K >= 17 tuple layout): planes are processed in ascending base order, so
    regions still arrive in order. Calls must come from one thread at a time
    (the per-plane chaser threads run sequentially)."""

    def __init__(self, out: np.ndarray, fd, hash_out: bool):
        import hashlib

        self.out = out
        self.fd = fd
        self.full = out.shape[0]
        self.h = hashlib.sha256() if hash_out else None
        self.writers = ThreadPoolExecutor(2) if fd is not None else None
        self._futs: list = []
        self.expected = 0

    def region_done(self, lo: int, hi: int) -> None:
        if hi <= lo:
            return
        if self.writers is not None:
            self._futs.append(
                self.writers.submit(_pwrite_all, self.fd, self.out[lo:hi], lo)
            )
            self._futs.append(self.writers.submit(
                _pwrite_all, self.fd,
                self.out[self.full - hi : self.full - lo], self.full - hi,
            ))
        if self.h is not None:
            assert lo == self.expected, (lo, self.expected)
            self.h.update(self.out[lo:hi])
            self.expected = hi

    def finish(self) -> Optional[str]:
        hex_ = None
        if self.h is not None:
            assert self.expected == self.full // 2, \
                (self.expected, self.full // 2)
            self.h.update(self.out[self.full // 2 :])
            hex_ = self.h.hexdigest()
        if self.writers is not None:
            self.writers.shutdown(wait=True)
            for f in self._futs:
                f.result()  # surface any pwrite failure (ENOSPC, EIO, ...)
        return hex_

    def abort(self) -> None:
        """Drain background writers without surfacing their results.

        Error path only: the caller is about to propagate an exception and
        close the output fd — an in-flight pwrite completing after the fd
        number is recycled would land in an unrelated file, so the pool must
        be fully drained (not cancelled) before the caller's ``with`` exits."""
        if self.writers is not None:
            self.writers.shutdown(wait=True)


def _sparse_dispatch(dense: jax.Array) -> dict:
    """Dispatch the sparse pack programs for every segment of one plane.

    Split from :func:`_stream_sparse` so a multi-plane caller can enqueue
    plane q+1's device compaction BEFORE draining plane q's tokens — the
    device then packs ahead while the host drains (the pack's device time
    would otherwise serialise with the drains)."""
    rows, lanes = dense.shape
    seg_rows = max(1, _sparse_seg_cells() // lanes)
    bounds = list(range(0, rows, seg_rows)) + [rows]
    n_segs = len(bounds) - 1
    seg_off = [bounds[i] * lanes for i in range(n_segs + 1)]
    packed = []
    for i in range(n_segs):
        c = seg_off[i + 1] - seg_off[i]
        cap, aux = _sparse_caps(c)
        packed.append(
            pack_sparse_segment(dense[bounds[i] : bounds[i + 1]], cap, aux, aux)
        )
    return {
        "packed": packed,
        "bounds": bounds,
        "seg_off": seg_off,
        "meta_dev": _concat_metas([p[3] for p in packed]),
    }


def _enqueue_sparse_transfers(packed, metas, n_segs: int):
    """Slice the three per-segment streams (tokens / int32 side / int32
    escape positions) into FIXED grain-aligned prefix parts and enqueue
    every d2h copy — aux streams first, then tokens, so the small arrays
    land early on the FIFO stream. Shared by the arena and pieces paths."""
    side_parts = [
        _prefix_parts(packed[i][1], int(metas[i][1]), _AUX_GRAIN)
        for i in range(n_segs)
    ]
    esc_parts = [
        _prefix_parts(packed[i][2], int(metas[i][2]), _AUX_GRAIN)
        for i in range(n_segs)
    ]
    tok_parts = [
        _prefix_parts(packed[i][0], int(metas[i][0]), _TOK_GRAIN)
        for i in range(n_segs)
    ]
    for plist in (*side_parts, *esc_parts, *tok_parts):
        for part in plist:
            try:
                part.copy_to_host_async()
            except AttributeError:
                break
    return side_parts, esc_parts, tok_parts


def _assemble_sparse_aux(side_parts, esc_parts, metas, n_segs: int):
    """Materialise the per-segment side streams and escape-position arrays
    from their enqueued prefix parts."""
    sides = []
    escs = []
    for i in range(n_segs):
        n_long, n_esc = int(metas[i][1]), int(metas[i][2])
        s_arr = np.empty(n_long, dtype=np.int32)
        _assemble_prefix(side_parts[i], n_long, s_arr)
        sides.append(s_arr)
        e_arr = np.empty(n_esc, dtype=np.int32)
        _assemble_prefix(esc_parts[i], n_esc, e_arr)
        escs.append(e_arr)
    return sides, escs


def _drain_sparse_tokens(tok_parts, metas, n_segs: int, threads: int):
    """Drain every token slice into pooled per-segment byte buffers (the
    buffers come from the arena pool — a malloc'd buffer would be munmapped
    on release and re-faulted on every use)."""
    from ..utils.bigmem import big_empty as _bempty

    tok_bufs = [_bempty(max(int(metas[i][0]), 1))[: int(metas[i][0])]
                for i in range(n_segs)]
    flat_jobs = []
    for i, plist in enumerate(tok_parts):
        n_nz = int(metas[i][0])
        pos = 0
        for part in plist:
            g = int(part.shape[0])
            flat_jobs.append((i, pos, min(n_nz, pos + g), part))
            pos += g

    def drain(j: int) -> None:
        i, a, b, part = flat_jobs[j]
        if b > a:
            tok_bufs[i][a:b] = np.asarray(part)[: b - a]

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(drain, range(len(flat_jobs))))
    return tok_bufs


def _stream_sparse(
    dense: jax.Array,
    kmer_len: int,
    out: np.ndarray,
    base: int,
    sink: Optional["_ChaseSink"],
    threads: int,
    slice_bytes: int,
    job: Optional[dict] = None,
    on_enqueued=None,
) -> Optional[np.ndarray]:
    """Sparse-mode readback of one folded (sub-)plane into ``out``.

    Per segment: the device compacts nonzeros into the token stream
    (:func:`pack_sparse_segment`), one fused meta fetch sizes every transfer,
    the escape-patch gather is dispatched BEFORE the token drain (positions
    came compacted from the device), tokens drain, and the
    native decoder memsets + scatters each segment's two unfolded ranges. A
    chaser walks segments in ascending order patching escapes and feeding
    ``sink`` regions, exactly like the fixed-width chase.

    Returns the folded 256-bin counts, or ``None`` when a device-side cap
    overflowed (pathological density — caller falls back to a fixed-width
    plane; nothing has been written to ``out`` in that case)."""
    import threading as _threading
    import time as _time

    from ..io.native import sparse_decode_segment_native

    full = out.shape[0]
    phase_s = {}
    _t0 = _time.monotonic()
    if job is None:
        job = _sparse_dispatch(dense)
    packed, bounds, seg_off = job["packed"], job["bounds"], job["seg_off"]
    n_segs = len(bounds) - 1
    metas = np.asarray(job["meta_dev"])
    phase_s["pack"] = _time.monotonic() - _t0
    for i in range(n_segs):
        c = seg_off[i + 1] - seg_off[i]
        cap, aux = _sparse_caps(c)
        n_nz, n_long, n_esc = (int(v) for v in metas[i])
        if n_nz > cap or n_long > aux or n_esc > aux:
            return None  # density too high for the static caps — fall back

    totals = np.zeros(256, dtype=np.int64)
    # small aux transfers first (side streams + escape positions), then
    # every token slice — all enqueued up front so the runtime streams
    # them back-to-back
    _t0 = _time.monotonic()
    side_parts, esc_parts, tok_parts = _enqueue_sparse_transfers(
        packed, metas, n_segs
    )
    phase_s["enq"] = _time.monotonic() - _t0
    if on_enqueued is not None:
        # transfers are on the FIFO stream; device work dispatched now
        # (e.g. the next plane's pack) overlaps the drain instead of
        # queueing ahead of it
        on_enqueued()
    _t0 = _time.monotonic()
    sides, escs = _assemble_sparse_aux(side_parts, esc_parts, metas,
                                       n_segs)
    phase_s["aux"] = _time.monotonic() - _t0

    # escape patch plan: plane-local folded indices, ascending across
    # segments by construction; the batched gather is dispatched NOW so
    # it runs while the token drain proceeds
    esc_local = [e.astype(np.int64) + seg_off[i] for i, e in enumerate(escs)]
    esc_idx = (np.concatenate(esc_local) if esc_local
               else np.empty(0, dtype=np.int64))
    esc_cut = np.cumsum([0] + [e.shape[0] for e in esc_local])
    patch_fut = None
    if esc_idx.shape[0]:
        gather_pool = ThreadPoolExecutor(1)

        def gather_and_place():
            vals = _gather_escapes(dense, esc_idx)
            u = (base + esc_idx).astype(np.uint64)
            rc = _rc_codes_np(u, kmer_len)
            pos = np.where(u <= rc, u, np.uint64(full - 1) - u)
            return pos, vals

        patch_fut = gather_pool.submit(gather_and_place)
        gather_pool.shutdown(wait=False)

    # token drain
    _t0 = _time.monotonic()
    tok_bufs = _drain_sparse_tokens(tok_parts, metas, n_segs,
                                    FETCH_THREADS)
    del tok_parts, packed
    phase_s["d2h"] = _time.monotonic() - _t0

    # decode workers + ascending chaser (patch + sink regions)
    _t0 = _time.monotonic()
    decoded = [_threading.Event() for _ in range(n_segs)]
    state: dict = {}
    seg_counts = [None] * n_segs

    def work(i: int) -> None:
        c = seg_off[i + 1] - seg_off[i]
        counts = sparse_decode_segment_native(
            tok_bufs[i], sides[i], out, kmer_len,
            base + seg_off[i], c,
        )
        counts[0] += c - tok_bufs[i].shape[0]
        seg_counts[i] = counts
        tok_bufs[i] = None

    def chaser() -> None:
        pos = vals = None
        try:
            for i in range(n_segs):
                decoded[i].wait()
                if state.get("aborted"):
                    return
                if patch_fut is not None:
                    if pos is None:
                        pos, vals = patch_fut.result()
                        state["vals"] = vals
                    a, b = esc_cut[i], esc_cut[i + 1]
                    if b > a:
                        out[pos[a:b]] = vals[a:b]
                if sink is not None:
                    sink.region_done(base + seg_off[i],
                                     base + seg_off[i + 1])
        except BaseException as exc:  # surfaced on the main thread
            state["error"] = exc

    chase_thread = _threading.Thread(target=chaser, daemon=True)
    chase_thread.start()

    def work_chase(i: int) -> None:
        try:
            work(i)
        finally:
            decoded[i].set()

    try:
        with ThreadPoolExecutor(min(threads, 8)) as ex:
            list(ex.map(work_chase, range(n_segs)))
    except BaseException:
        state["aborted"] = True
        for ev in decoded:
            ev.set()
        chase_thread.join()
        if sink is not None:
            sink.abort()
        raise
    chase_thread.join()
    err = state.get("error")
    if err is not None:
        if sink is not None:
            sink.abort()
        raise err
    for c in seg_counts:
        totals += c
    if patch_fut is not None:
        vals = state["vals"]
        totals[ESCAPE2] -= vals.shape[0]
        totals += np.bincount(vals, minlength=256)
    phase_s["decode"] = _time.monotonic() - _t0

    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        import sys

        print(
            "  readback[sparse/chase]: " + "  ".join(
                f"{k} {v:8.1f}s" for k, v in phase_s.items()
            ),
            file=sys.stderr,
        )
    return totals


def stream_dense_to_out(
    dense: jax.Array,
    kmer_len: int,
    out: np.ndarray,
    mode: str = "auto",
    slice_bytes: int = SLICE_BYTES,
    threads: int = FETCH_THREADS,
    fd: Optional[int] = None,
    escapes=None,
    base: int = 0,
    hash_out: bool = False,
    sink: Optional[_ChaseSink] = None,
):
    """Fetch the folded device plane and expand it straight into ``out``
    (uint8[4^K]) in two phases: (1) drain all packed slice transfers, then
    (2) unpack + escape scan + stats + unfold on all cores, and one batched
    device
    gather patches every escape cell. The folded plane is never
    materialised whole on the host. With ``fd``, the finished plane is
    bulk-pwritten before returning (callers wanting disk/hash overlap — the
    indexer — pass fd=None and run their own write thread).

    ``dense`` may also be a SUB-plane of a larger folded space (count spaces
    beyond one sub-plane are carried as tuples of 2^30-cell planes, K >= 17
    — see ops.histogram.MAX_SWEEP_CELLS): ``base`` is its first
    global folded index, and ``out`` is always the full 4^K array.

    With ``hash_out=True`` (full-plane callers only) the function also
    computes the sha256 of the finished ``out`` buffer and returns
    ``(counts, hex)``; when the packed fast path is active the write and the
    hash CHASE the unfold slice-by-slice (escape positions are pre-scanned
    from the packed bytes as each slice lands, so the patch gather is issued
    the moment the transfers drain and every slice is final the instant its
    unfold ends) instead of running as a serial whole-buffer pass after.

    A multi-sub-plane caller passes a shared ``sink`` instead of fd/hash_out
    (see :class:`_ChaseSink` / :func:`stream_dense_planes_to_out`): regions
    then chase across plane boundaries and the CALLER finishes the sink.

    Returns the exact 256-bin counts of the folded (sub-)plane (int64[256]),
    or ``(counts, sha256-hex)`` with ``hash_out``."""
    from ..formats.header import fast_counts256

    import time as _t

    size = int(np.prod(dense.shape))
    assert 2 * (base + size) <= out.shape[0] and out.dtype == np.uint8
    assert base == 0 or out.shape[0] > 2 * size  # sub-plane ⇒ larger out
    if hash_out and base > 0:
        raise ValueError("hash_out requires a full-plane readback (base == 0)")
    if base > 0 and fd is not None:
        # a sub-plane readback fills only the [lo,hi) + mirrored ranges of
        # ``out``; writes to it must route through a shared _ChaseSink
        raise ValueError(
            "fd is only valid for a full-plane readback (base == 0); "
            "sub-plane callers pass a shared sink (stream_dense_planes_to_out)"
        )
    own_sink = False
    if sink is None and (fd is not None or hash_out):
        sink = _ChaseSink(out, fd, hash_out)
        own_sink = True

    def _done(counts):
        if own_sink:
            hex_ = sink.finish()
            return (counts, hex_) if hash_out else counts
        return counts

    _t0 = _t.monotonic()
    mode = _pick_mode(dense, size, mode, escapes=escapes)
    _t_pick = _t.monotonic() - _t0

    if mode == "sparse":
        counts = _stream_sparse(dense, kmer_len, out, base, sink, threads,
                                slice_bytes)
        if counts is not None:
            return _done(counts)
        # a device-side cap overflowed (density beyond the static token
        # capacities): 2bit is the cheapest fixed width wherever sparse was
        # even a candidate (low-density planes)
        mode = "2bit"

    if mode == "raw":
        folded = fetch_dense(dense, mode="raw")
        if base == 0 and out.shape[0] == 2 * size:
            unfold_canonical(folded, kmer_len, out=out)
        else:
            unfold_range(folded, out, kmer_len, base)
        if sink is not None:
            sink.region_done(base, base + size)
        return _done(fast_counts256(folded))

    _t0 = _t.monotonic()
    if mode == "raw2d":
        packed, unpack, escape = _as2d(dense), None, None
    elif mode == "2bit":
        packed, unpack, escape = pack_2bit(dense), unpack_2bit, ESCAPE2
    elif mode == "3bit":
        packed, unpack, escape = pack_3bit(dense), unpack_3bit, ESCAPE3
    else:
        packed, unpack, escape = pack_nibbles(dense), unpack_nibbles, ESCAPE4
    try:
        packed.block_until_ready()
    except AttributeError:
        pass
    _t_pack = _t.monotonic() - _t0
    rows, row_bytes = packed.shape
    # wide-lane planes pack in their NATIVE shape (_as2d), so a packed row
    # covers the plane's own lane count of cells, not always _PACK_LANES
    assert size % rows == 0, (size, packed.shape)
    cells_per_row = size // rows
    rows_per = max(1, slice_bytes // max(row_bytes, 1))
    if rows_per >= 16:
        rows_per &= ~15
    bounds = list(range(0, rows, rows_per)) + [rows]
    n_slices = len(bounds) - 1

    full = out.shape[0]
    phase_s = {"d2h": 0.0, "cpu": 0.0}
    esc_lists: list = [None] * n_slices
    totals = np.zeros(256, dtype=np.int64)

    try:
        from ..io import native as _n

        _fused = (_n.unpack_unfold_native
                  if getattr(_n, "_HAVE_FUSED_UNFOLD", False) else None)
        _scan = (_n.scan_escapes_native
                 if getattr(_n, "_HAVE_SCAN_ESCAPES", False) else None)
    except ImportError:
        _fused = _scan = None
    width = {"2bit": 2, "3bit": 3, "packed": 4}.get(mode)
    # fine-grained chase: write + hash follow the unfold slice-by-slice.
    # Needs every slice FINAL (escapes patched) the moment its unfold ends,
    # which needs the escape positions known before the unfold starts — the
    # native packed-domain scan provides them during the drain (raw2d slices
    # have no escapes at all). Without the native scan the sink still gets
    # one coarse whole-(sub)plane region after the batched patch.
    chase = sink is not None and (
        width is None or (_scan is not None and _fused is not None)
    )

    import time as _time

    # enqueue every slice transfer up front: the runtime streams them
    # back-to-back
    _te = _time.monotonic()
    parts = [packed[bounds[i] : bounds[i + 1]] for i in range(n_slices)]
    for p in parts:
        try:
            p.copy_to_host_async()
        except AttributeError:
            break
    phase_s["enq"] = _time.monotonic() - _te

    # phase 1 — drain transfers; host-side unpack/unfold waits until they
    # have drained. (The escape pre-scan below is ~1.5 ops/byte over the
    # packed slice.)
    bufs: list = [None] * n_slices
    pre_esc: list = [None] * n_slices
    prescan = chase and width is not None
    t0 = _time.monotonic()

    def drain(i: int) -> None:
        bufs[i] = np.asarray(parts[i])
        if prescan:
            pre_esc[i] = _scan(bufs[i], width)

    with ThreadPoolExecutor(threads) as ex:
        list(ex.map(drain, range(n_slices)))
    del parts
    phase_s["d2h"] = _time.monotonic() - t0

    # escape patch plan: GLOBAL folded indices per slice (ascending by
    # construction), one batched device gather issued immediately, so it
    # runs while the unfold workers start on the early slices
    patch_fut = None
    slice_cut = None
    if prescan:
        cell_bounds = np.array(
            [bounds[i] * cells_per_row for i in range(n_slices + 1)],
            dtype=np.int64,
        )
        esc_parts = [
            (cell_bounds[i] + pre_esc[i]).astype(np.int64)
            for i in range(n_slices) if pre_esc[i].shape[0]
        ]
        esc_idx = (np.concatenate(esc_parts) if esc_parts
                   else np.empty(0, dtype=np.int64))
        if esc_idx.shape[0]:
            slice_cut = np.searchsorted(esc_idx, cell_bounds)
            gather_pool = ThreadPoolExecutor(1)

            def gather_and_place():
                vals = _gather_escapes(dense, esc_idx)
                u = (base + esc_idx).astype(np.uint64)
                rc = _rc_codes_np(u, kmer_len)
                pos = np.where(u <= rc, u, np.uint64(full - 1) - u)
                return pos, vals

            patch_fut = gather_pool.submit(gather_and_place)
            gather_pool.shutdown(wait=False)

    # phase 2 — unpack + stats + unfold on all cores; in chase mode a
    # single chaser thread walks slices in order, patches each slice's
    # escapes, streams its two finished regions to disk, and advances a
    # sha256 frontier through the first half of the plane (the second
    # half completes in reverse slice order, so it hashes as one pass
    # right after the last slice — the only serial remainder).
    t0 = _time.monotonic()

    def work(i: int) -> np.ndarray:
        buf, bufs[i] = bufs[i], None
        lo = base + bounds[i] * cells_per_row
        if _fused is not None and width is not None:
            # one fused pass: unfold + 256-bin counts + escape indices
            counts, esc_local = _fused(buf, width, out, kmer_len, lo)
            if not prescan and esc_local.shape[0]:
                esc_lists[i] = esc_local.astype(np.int64) + lo
            return counts
        folded_slice = buf.reshape(-1) if unpack is None else unpack(buf)
        if escape is not None:
            esc_local = np.flatnonzero(folded_slice == escape)
            if esc_local.shape[0]:
                esc_lists[i] = esc_local + lo
        counts = fast_counts256(folded_slice)
        unfold_range(folded_slice, out, kmer_len, lo)
        return counts

    if chase:
        import threading as _threading

        unfolded = [_threading.Event() for _ in range(n_slices)]
        patch_info: dict = {}

        def chaser() -> None:
            # any failure (notably patch_fut.result() surfacing a device
            # gather/transport error) is captured and re-raised on the
            # main thread after join — a swallowed exception here used to
            # manifest later as an unrelated KeyError/frontier assertion
            pos = vals = None
            try:
                for i in range(n_slices):
                    unfolded[i].wait()
                    if patch_info.get("aborted"):
                        return
                    if patch_fut is not None:
                        if pos is None:
                            pos, vals = patch_fut.result()
                            patch_info["vals"] = vals
                        a, b = slice_cut[i], slice_cut[i + 1]
                        if b > a:
                            out[pos[a:b]] = vals[a:b]
                    sink.region_done(base + bounds[i] * cells_per_row,
                                     base + bounds[i + 1] * cells_per_row)
            except BaseException as exc:
                patch_info["error"] = exc

        chase_thread = _threading.Thread(target=chaser, daemon=True)
        chase_thread.start()

        def work_chase(i: int) -> np.ndarray:
            try:
                return work(i)
            finally:
                unfolded[i].set()

        try:
            with ThreadPoolExecutor(min(threads, 8)) as ex:
                for c in ex.map(work_chase, range(n_slices)):
                    totals += c
        except BaseException:
            # unfold worker failed: unblock + drain the chaser and the
            # sink's writer pool BEFORE propagating — the caller's `with
            # DirectWriter` closes the fds on unwind, and a still-running
            # pwrite must not land on a recycled fd number
            patch_info["aborted"] = True
            for ev in unfolded:
                ev.set()
            chase_thread.join()
            sink.abort()
            raise
        chase_thread.join()
        chaser_err = patch_info.get("error")
        if chaser_err is not None:
            sink.abort()
            raise chaser_err
        if patch_fut is not None:
            vals = patch_info["vals"]
            totals[escape] -= vals.shape[0]
            totals += np.bincount(vals, minlength=256)
        phase_s["cpu+wh"] = _time.monotonic() - t0
    else:
        with ThreadPoolExecutor(min(threads, 8)) as ex:
            for c in ex.map(work, range(n_slices)):
                totals += c
        phase_s["cpu"] = _time.monotonic() - t0

    # one batched gather patches every escape cell (folded index u lands
    # at the canonical member of {u, M-u} in the unfolded plane). The
    # esc_lists hold GLOBAL folded indices (lo includes base); the device
    # gather needs plane-LOCAL ones. (Chase mode patched per slice above.)
    t0 = _t.monotonic()
    esc_all = [e for e in esc_lists if e is not None]
    if esc_all:
        esc_idx2 = np.concatenate(esc_all)
        vals = _gather_escapes(dense, esc_idx2 - base)
        u = esc_idx2.astype(np.uint64)
        rc = _rc_codes_np(u, kmer_len)
        pos = np.where(u <= rc, u, np.uint64(full - 1) - u)
        out[pos] = vals
        totals[escape] -= esc_idx2.shape[0]
        totals += np.bincount(vals, minlength=256)
    if sink is not None and not chase:
        # no native scan: the whole (sub-)plane becomes one coarse
        # region once the batched patch lands
        sink.region_done(base, base + size)
    phase_s["patch"] = _t.monotonic() - t0
    phase_s["pick"] = _t_pick
    phase_s["pack"] = _t_pack

    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        import sys

        print(
            f"  readback[{mode}{'/chase' if chase else ''}]: " + "  ".join(
                f"{k} {v:8.1f}s" for k, v in phase_s.items()
            ),
            file=sys.stderr,
        )
    return _done(totals)


def stream_dense_planes_to_out(
    planes,
    kmer_len: int,
    out: np.ndarray,
    mode: str = "auto",
    escapes=None,
    slice_bytes: int = SLICE_BYTES,
    threads: int = FETCH_THREADS,
    fd: Optional[int] = None,
    hash_out: bool = False,
):
    """:func:`stream_dense_to_out` over a folded plane carried as a tuple of
    contiguous sub-planes (count spaces beyond one sub-plane, K >= 17 — see
    ops.histogram.MAX_SWEEP_CELLS / index.indexer._accumulate_device).

    Each sub-plane is fetched, unfolded into its slice of the full ``out``
    array, and RELEASED before the next one's packed plane materialises, so
    peak device memory stays at one sub-plane's packing overhead — pass
    ``planes`` as a LIST you no longer reference (it is consumed in place; a
    caller-held tuple would pin every sub-plane for the whole loop).
    ``escapes`` is an optional per-plane list of pre-dispatched
    ``count_all_escapes`` results.

    With ``fd``/``hash_out``, a single :class:`_ChaseSink` spans all
    sub-planes: the `.kin` write and the output sha256 chase the unfolds
    across plane boundaries (plane q's finished regions stream to disk and
    into the hash frontier while plane q+1's slices are still in flight),
    and the return becomes ``(counts, sha256-hex)`` when ``hash_out``.

    Returns the exact 256-bin counts of the whole folded plane (int64[256])."""
    if not isinstance(planes, list):
        planes = list(planes)
    total = sum(int(np.prod(p.shape)) for p in planes)
    assert out.shape[0] == 2 * total and out.dtype == np.uint8
    sink = (_ChaseSink(out, fd, hash_out)
            if (fd is not None or hash_out) else None)
    totals = np.zeros(256, dtype=np.int64)

    # resolve each sub-plane's mode up front, but dispatch the sparse packs
    # STAGED one plane ahead: the stream is FIFO, so enqueueing every pack
    # before any drain would put plane 0's token fetches behind every
    # plane's compaction sort, idling the transfers for the whole pack
    # phase (same staging as stream_sparse_planes_pieces). Plane q+1's
    # pack is dispatched right after plane q's transfers are enqueued.
    modes = []
    for q, p in enumerate(planes):
        m = _pick_mode(p, int(np.prod(p.shape)), mode,
                       escapes=None if escapes is None else escapes[q])
        modes.append(m)
    jobs: list = [None] * len(planes)
    sparse_qs = [q for q, m in enumerate(modes) if m == "sparse"]
    if sparse_qs:
        jobs[sparse_qs[0]] = _sparse_dispatch(planes[sparse_qs[0]])

    base = 0
    for q in range(len(planes)):
        p, planes[q] = planes[q], None
        size = int(np.prod(p.shape))
        if modes[q] == "sparse":
            nxt = next((r for r in sparse_qs if r > q), None)

            def _stage_next(nxt=nxt):
                if nxt is not None and jobs[nxt] is None:
                    jobs[nxt] = _sparse_dispatch(planes[nxt])

            counts = _stream_sparse(p, kmer_len, out, base, sink, threads,
                                    slice_bytes, job=jobs[q],
                                    on_enqueued=_stage_next)
            jobs[q] = None
            if counts is None:  # cap overflow: fixed-width fallback
                counts = stream_dense_to_out(
                    p, kmer_len, out, mode="2bit",
                    slice_bytes=slice_bytes, threads=threads,
                    base=base, sink=sink,
                )
        else:
            counts = stream_dense_to_out(
                p, kmer_len, out, mode=modes[q],
                slice_bytes=slice_bytes, threads=threads,
                base=base, sink=sink,
            )
        totals += counts
        del p  # free the sub-plane's HBM before packing the next one
        base += size
    if sink is not None:
        hex_ = sink.finish()
        return (totals, hex_) if hash_out else totals
    return totals


class _PieceSink:
    """pwrite + ordered sha256 for the arena-free piece readback.

    ``piece_done(lo, hi, primary, mirror)`` takes the two unfolded buffers of
    one first-half range [lo, hi): primary belongs at file offset ``lo``,
    mirror at ``full - hi``. Calls must arrive in ascending ``lo`` order (the
    single decode worker guarantees it); the sha256 frontier advances over
    the primaries, and the second half — whose file order is the REVERSE of
    completion order — is hashed in :meth:`finish` by reading the written
    file back (O_DIRECT, ~3 GB/s; the hash itself is the serial floor).
    Buffers stay alive until their pwrites land (the futures hold the refs);
    a backpressure cap keeps at most ~8 pieces in flight."""

    def __init__(self, fd, full: int, hash_out: bool, path: Optional[str]):
        import hashlib

        assert fd is not None, "piece mode writes through a file"
        self.fd = fd
        self.full = full
        self.path = path
        self.h = hashlib.sha256() if hash_out else None
        if hash_out and not path:
            raise ValueError("hash_out in piece mode needs the file path "
                             "(second-half hash reads the file back)")
        self.writers = ThreadPoolExecutor(2)
        self._futs: list = []
        self.expected = 0

    def piece_done(self, lo: int, hi: int, primary: np.ndarray,
                   mirror: np.ndarray) -> None:
        n = hi - lo
        if n <= 0:
            return
        # closures keep the (pooled) buffers alive until the writes land
        self._futs.append(
            self.writers.submit(_pwrite_all, self.fd, primary[:n], lo)
        )
        self._futs.append(
            self.writers.submit(_pwrite_all, self.fd, mirror[:n],
                                self.full - hi)
        )
        while len(self._futs) > 16:
            self._futs.pop(0).result()
        if self.h is not None:
            assert lo == self.expected, (lo, self.expected)
            self.h.update(primary[:n])
            self.expected = hi

    def finish(self) -> Optional[str]:
        self.writers.shutdown(wait=True)
        for f in self._futs:
            f.result()
        self._futs = []
        if self.h is None:
            return None
        assert self.expected == self.full // 2, (self.expected, self.full)
        from ..io.direct import DirectReader, pread_into_mt
        from ..utils.bigmem import big_empty

        chunk = 256 << 20
        buf = big_empty(chunk)
        reader = DirectReader(self.path)
        try:
            pos = self.full // 2
            while pos < self.full:
                n = min(chunk, self.full - pos)
                got = pread_into_mt(reader, buf[:n], pos, threads=2)
                assert got == n
                self.h.update(buf[:n])
                pos += n
        finally:
            reader.close()
        return self.h.hexdigest()

    def abort(self) -> None:
        self.writers.shutdown(wait=True)


def stream_sparse_planes_pieces(
    planes,
    kmer_len: int,
    fd,
    path: str,
    escapes,
    hash_out: bool = False,
    threads: int = FETCH_THREADS,
    slice_bytes: int = SLICE_BYTES,
):
    """Arena-free readback of a multi-sub-plane folded space (K >= 17).

    Equivalent result to :func:`stream_dense_planes_to_out` with ``fd`` +
    ``hash_out``, but NO 4^K host arena exists: each segment's sparse tokens
    decode into two pooled piece buffers that are pwritten (and hashed)
    directly, so no 17 GiB arena is faulted in — this path caps host
    memory at a few piece buffers (~1.5 GB).

    Pipelining: all planes' device compactions are dispatched up front; the
    main thread walks planes fetching metas and draining token transfers
    while ONE background worker decodes finished segments in order (native
    decode releases the GIL; set PYKMER_TPU_SPARSE_OVERLAP=0 to
    serialise).

    Requires every plane to be sparse-eligible by the pre-dispatched escape
    counts; returns None if not (caller takes the arena path). Density
    beyond the static caps in one plane is still handled — that plane
    materialises via the fixed-width fetch and unfolds to pieces.

    Returns (counts int64[256], sha256-hex | None)."""
    if escapes is None or fd is None:
        return None
    # _sparse_viable only proves sparse_decode_segment exists; the pieces
    # path additionally needs the piece-decoder entry point (a stale .so
    # built before it must take the arena fallback, not die in the pool)
    from ..io.native import _HAVE_SPARSE_PIECE

    if not _HAVE_SPARSE_PIECE:
        return None
    if not isinstance(planes, list):
        planes = list(planes)
    sizes = [int(np.prod(p.shape)) for p in planes]
    full = 2 * sum(sizes)
    rows = [tuple(esc) for esc in escapes]
    if any(len(r) != 4 for r in rows):
        return None
    if any(isinstance(v, jax.Array) for r in rows for v in r):
        # ONE fused transfer: per-scalar int() fetches would each pay a
        # device→host round trip (4 scalars x 8 planes)
        rows = np.asarray(
            _concat_metas([jnp.stack(list(r)) for r in rows])
        ).tolist()
    for p, sz, vals in zip(planes, sizes, rows):
        vals = tuple(int(v) for v in vals)
        if not _sparse_viable(p, sz, vals[1]) or vals[0] > sz // 8:
            return None

    import time as _time

    from ..formats.header import fast_counts256
    from ..io.native import sparse_decode_segment_piece_native
    from ..utils.bigmem import big_empty

    overlap = os.environ.get("PYKMER_TPU_SPARSE_OVERLAP", "1") != "0"
    # STAGED dispatch, one plane ahead: d2h copies overlap compute, but the
    # stream is FIFO — dispatching ALL packs up front would put every
    # token-slice program behind every pack, idling the transfers for the
    # whole pack phase. Dispatching plane q+1's pack
    # right after plane q's transfers are enqueued lets q's copies ride out
    # while q+1 packs.
    jobs: list = [None] * len(planes)
    jobs[0] = _sparse_dispatch(planes[0])
    psink = _PieceSink(fd, full, hash_out, path)
    totals = np.zeros(256, dtype=np.int64)
    decode_pool = ThreadPoolExecutor(1)
    gather_pool = ThreadPoolExecutor(1)
    decode_futs: list = []
    patch_adjust: list = []  # (n_esc, vals-future) per plane
    phase_s = {"meta": 0.0, "drain": 0.0, "decode_wait": 0.0, "fb": 0.0}

    def decode_task(tok, side, esc_pos_seg, vals_fut, vals_cut, plane_base,
                    seg_lo, seg_len):
        primary = big_empty(seg_len)
        mirror = big_empty(seg_len)
        counts = sparse_decode_segment_piece_native(
            tok, side, primary, mirror, kmer_len, plane_base + seg_lo,
            seg_len,
        )
        counts[0] += seg_len - tok.shape[0]
        if esc_pos_seg.shape[0]:
            vals = vals_fut.result()[vals_cut[0] : vals_cut[1]]
            # int64 first: plane_base exceeds int32 from the third K=17
            # sub-plane on, and numpy would refuse the mixed add
            u = (esc_pos_seg.astype(np.int64)
                 + (plane_base + seg_lo)).astype(np.uint64)
            rc = _rc_codes_np(u, kmer_len)
            canon = u <= rc
            prim_idx = esc_pos_seg[canon]
            primary[prim_idx] = vals[canon]
            mirr_idx = seg_len - 1 - esc_pos_seg[~canon]
            mirror[mirr_idx] = vals[~canon]
        lo = plane_base + seg_lo
        psink.piece_done(lo, lo + seg_len, primary, mirror)
        return counts

    try:
        base = 0
        for q in range(len(planes)):
            p, planes[q] = planes[q], None
            job, jobs[q] = jobs[q], None
            packed = job["packed"]
            seg_off = job["seg_off"]
            n_segs = len(seg_off) - 1
            _t0 = _time.monotonic()
            metas = np.asarray(job["meta_dev"])
            phase_s["meta"] += _time.monotonic() - _t0
            overflow = False
            for i in range(n_segs):
                c = seg_off[i + 1] - seg_off[i]
                cap, aux = _sparse_caps(c)
                n_nz, n_long, n_esc = (int(v) for v in metas[i])
                if n_nz > cap or n_long > aux or n_esc > aux:
                    overflow = True
            if overflow:
                # pathological segment density: wait for sink order,
                # then materialise this plane the fixed-width way and
                # unfold it to pieces
                if q + 1 < len(planes):
                    jobs[q + 1] = _sparse_dispatch(planes[q + 1])
                _t0 = _time.monotonic()
                for f in decode_futs:
                    totals += f.result()
                decode_futs.clear()
                folded = fetch_dense(p, mode="2bit")
                totals += fast_counts256(folded)
                seg = _sparse_seg_cells()
                for lo in range(0, sizes[q], seg):
                    n = min(seg, sizes[q] - lo)
                    prim, mirr, _ = unfold_piece(
                        folded[lo : lo + n], kmer_len, base + lo
                    )
                    psink.piece_done(base + lo, base + lo + n, prim, mirr)
                del folded, p
                base += sizes[q]
                phase_s["fb"] += _time.monotonic() - _t0
                continue

            # aux + token transfers (enqueued up front, drained with the
            # main thread; the lone decode worker runs native code that
            # releases the GIL). All slices have FIXED grain-aligned
            # bounds — see _TOK_GRAIN on why data-dependent bounds would
            # compile inside the readback.
            _t0 = _time.monotonic()
            side_parts, esc_parts, tok_parts = _enqueue_sparse_transfers(
                packed, metas, n_segs
            )
            phase_s["slice"] = phase_s.get("slice", 0.0) + \
                (_time.monotonic() - _t0)
            _t0 = _time.monotonic()
            sides, escs = _assemble_sparse_aux(side_parts, esc_parts,
                                               metas, n_segs)
            phase_s["auxw"] = phase_s.get("auxw", 0.0) + \
                (_time.monotonic() - _t0)

            # per-plane escape gather, dispatched before the token drain
            # AND before the next plane's pack (a gather queued behind
            # a pack would stall the decode worker's patches)
            esc_sizes = [e.shape[0] for e in escs]
            esc_cut = np.cumsum([0] + esc_sizes)
            n_esc_plane = int(esc_cut[-1])
            if n_esc_plane:
                esc_idx = np.concatenate(
                    [e.astype(np.int64) + seg_off[i]
                     for i, e in enumerate(escs)]
                )
                vals_fut = gather_pool.submit(_gather_escapes, p, esc_idx)
                patch_adjust.append((n_esc_plane, vals_fut))
            else:
                vals_fut = None
            # next plane's compaction packs while this plane's token
            # copies drain (copies overlap compute; see the
            # staged-dispatch note above)
            if q + 1 < len(planes):
                jobs[q + 1] = _sparse_dispatch(planes[q + 1])

            _t0 = _time.monotonic()
            tok_bufs = _drain_sparse_tokens(tok_parts, metas, n_segs,
                                            threads)
            del tok_parts, packed, job
            phase_s["drain"] += _time.monotonic() - _t0

            for i in range(n_segs):
                c = seg_off[i + 1] - seg_off[i]
                fut = decode_pool.submit(
                    decode_task, tok_bufs[i], sides[i], escs[i],
                    vals_fut, (int(esc_cut[i]), int(esc_cut[i + 1])),
                    base, seg_off[i], c,
                )
                decode_futs.append(fut)
            tok_bufs = None
            if not overlap:
                _t0 = _time.monotonic()
                for f in decode_futs:
                    totals += f.result()
                decode_futs.clear()
                phase_s["decode_wait"] += _time.monotonic() - _t0
            del p
            base += sizes[q]

        _t0 = _time.monotonic()
        for f in decode_futs:
            totals += f.result()
        decode_futs.clear()
        phase_s["decode_wait"] += _time.monotonic() - _t0
        for n_esc, vals_fut in patch_adjust:
            vals = vals_fut.result()
            totals[ESCAPE2] -= n_esc
            totals += np.bincount(vals, minlength=256)
    except BaseException:
        # surface the first decode failure but never leave writers running
        # against an fd the caller is about to close
        for f in decode_futs:
            try:
                f.result()
            except BaseException:
                pass
        psink.abort()
        decode_pool.shutdown(wait=True)
        gather_pool.shutdown(wait=True)
        raise
    decode_pool.shutdown(wait=True)
    gather_pool.shutdown(wait=True)
    _t0 = _time.monotonic()
    hex_ = psink.finish()
    phase_s["finish"] = _time.monotonic() - _t0

    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        import sys

        print(
            "  readback[sparse/pieces]: " + "  ".join(
                f"{k} {v:8.1f}s" for k, v in phase_s.items()
            ),
            file=sys.stderr,
        )
    return (totals, hex_) if hash_out else (totals, None)


def _write_and_hash(fd, arr: np.ndarray) -> str:
    """Concurrent whole-buffer write + sha256 (hashlib releases the GIL on
    large updates); returns the hex digest. ``fd`` may be None (hash only).
    Fallback for readback paths that cannot chase (see stream_dense_to_out)."""
    import hashlib
    import threading

    wt = None
    if fd is not None:
        wt = threading.Thread(target=_pwrite_all, args=(fd, arr, 0))
        wt.start()
    hex_ = hashlib.sha256(arr).hexdigest()
    if wt is not None:
        wt.join()
    return hex_


def _pwrite_all(fd, arr: np.ndarray, offset: int) -> None:
    """Positional write of a contiguous uint8 array (loops on short writes).

    ``fd`` may be a raw file descriptor or an ``io.direct.DirectWriter``
    (whose O_DIRECT path skips the page cache entirely)."""
    if hasattr(fd, "pwrite"):
        fd.pwrite(arr, offset)
        return
    view = memoryview(arr)
    pos = offset
    while len(view):
        n = os.pwrite(fd, view, pos)
        view = view[n:]
        pos += n


def preload_programs(kmer_len: int, dense_shape=None) -> None:
    """Compile and load every readback device program for a K-sized folded
    plane.

    Executables compile and load lazily at first call. Long-running
    services and benchmarks call this once up front — with a zeros dummy
    plane — so the first real indexing run pays no compile or load,
    whichever pack mode the data later selects."""
    fold_size = 4**kmer_len // 2
    if dense_shape is None:
        from .histogram import dense_plane_shape

        dense_shape = dense_plane_shape(fold_size)
    try:
        # host-side warm: the per-K canonical bitmask the fused unfold indexes
        from ..io.native import canon_bits_cached

        canon_bits_cached(kmer_len)
    except ImportError:
        pass
    if int(np.prod(dense_shape)) % _PACK_LANES:
        return
    dummy = jnp.zeros(dense_shape, dtype=jnp.uint8)
    jax.block_until_ready(count_all_escapes(dummy))
    for fn in (pack_2bit, pack_3bit, pack_nibbles):
        jax.block_until_ready(fn(dummy))
    # every fixed escape-gather shape (the only ones _gather_batched emits),
    # in the index dtype _gather_batched will actually pick for this plane
    # (int64 once the plane exceeds int32 indexing, K >= 17) — warming the
    # wrong dtype would leave the first real patch paying the in-band load
    idt = (jnp.int64 if int(np.prod(dense_shape)) > np.iinfo(np.int32).max
           else jnp.int32)
    for shape in _GATHER_SHAPES:
        zi = jnp.zeros(shape, dtype=idt)
        jax.block_until_ready(_gather_cells(dummy, zi))
    del dummy


def fetch_dense(dense: jax.Array, mode: str = "auto") -> np.ndarray:
    """Fetch the device dense array to host numpy (lossless, flat uint8).

    mode: "auto" | "2bit" | "packed" (nibbles) | "raw".
    """
    size = int(np.prod(dense.shape))
    mode = _pick_mode(dense, size, mode)
    if mode == "raw":
        return fetch_array_mt(_as2d(dense)).reshape(-1) if size % _PACK_LANES == 0 \
            else np.asarray(dense).reshape(-1)
    if mode == "raw2d":
        return fetch_array_mt(_as2d(dense)).reshape(-1)
    if mode == "sparse":
        # _pick_mode can prefer the token-stream plane, but this flat-array
        # helper has no token decoder (that machinery targets the streaming
        # sinks); the 2-bit plane is the cheapest fixed-width stand-in at
        # the densities where sparse wins
        mode = "2bit"
    if mode == "2bit":
        out = unpack_2bit(fetch_array_mt(pack_2bit(dense)))
        _patch_escapes(dense, out, ESCAPE2)
    elif mode == "3bit":
        out = unpack_3bit(fetch_array_mt(pack_3bit(dense)))
        _patch_escapes(dense, out, ESCAPE3)
    elif mode == "packed":
        out = unpack_nibbles(fetch_array_mt(pack_nibbles(dense)))
        _patch_escapes(dense, out, ESCAPE4)
    else:
        raise ValueError(f"unknown readback mode {mode!r}")
    return out
