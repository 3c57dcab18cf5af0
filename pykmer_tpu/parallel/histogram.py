"""Count-space-sharded saturating histogram (the multi-chip indexing core).

Layout: counts live in the *folded* half-space ``w = min(c, 4^K-1-c)`` (see
ops.encode.fold_codes — lossless for odd K, halves device
memory/traffic/readback, and folded codes are uniformly distributed). With
S = n_shards (power of two), folded code ``w`` lives on shard ``w & (S-1)``
at local index ``w >> log2(S)`` — low-bit interleaving keeps shards
balanced. The global folded plane is the column-major interleave of the
per-shard arrays (see
:func:`interleaved_to_flat`); the host expands it to the 4^K dense array
with ops.readback.unfold_canonical.

Per step, per chip (inside shard_map over mesh ('data','shards')):
  1. encode its chunk to canonical codes (ops.encode);
  2. key-sort codes so each destination shard's codes are contiguous
     (invalid windows key past every bucket);
  3. bucket the sorted keys by destination with a fixed per-bucket capacity
     (static shapes; overflow is *detected* and surfaced, never silently
     dropped), pad with the local sentinel;
  4. ``all_to_all`` along 'shards' — each chip receives only codes it owns,
     already bucket-sorted (interconnect traffic = one code per k-mer);
  5. ``all_gather`` along 'data' so dense replicas apply every row's updates
     and stay bit-identical;
  6. saturating accumulate into the local dense shard (ops.histogram).

num_kmers contributions are psum'd over the whole mesh. All integer adds are
associative, so multi-chip results are bit-identical to single-chip runs
(tested on the virtual CPU mesh).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS, SHARD_AXIS
from ..ops.encode import canonical_codes, code_dtype, fold_codes
from ..ops.histogram import saturating_accumulate, sort_codes_fast


def interleaved_to_flat(shards: np.ndarray) -> np.ndarray:
    """[S, local] per-shard arrays → the flat folded plane [4^K / 2].

    folded code w = (local << log2(S)) | s  ⇒  flat[w] = shards[w % S, w // S]
    (unfold with ops.readback.unfold_canonical to get the 4^K dense array).
    """
    s, local = shards.shape
    return shards.T.reshape(s * local) if s == 1 else np.ascontiguousarray(
        shards.T
    ).reshape(s * local)


def flat_to_interleaved(flat: np.ndarray, n_shards: int) -> np.ndarray:
    return np.ascontiguousarray(flat.reshape(-1, n_shards).T)


def shard_batch_chunks(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_rows: int, step: int
) -> np.ndarray:
    """Host framing: rows of overlapping chunks for one sharded step.

    Returns [n_rows, chunk_windows + K - 1]; row r covers window starts
    [(step*n_rows + r) * chunk_windows, ...). Rows beyond the stream are
    invalid-padded (their windows drop on device).
    """
    span = chunk_windows + kmer_len - 1
    out = np.full((n_rows, span), 4, dtype=np.uint8)
    for r in range(n_rows):
        start = (step * n_rows + r) * chunk_windows
        if start >= max(padded.shape[0] - kmer_len + 1, 0):
            continue
        piece = padded[start : start + span]
        out[r, : piece.shape[0]] = piece
    return out


def shard_batch_chunks_packed(
    padded: np.ndarray, kmer_len: int, chunk_windows: int, n_rows: int, step: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Packed variant of :func:`shard_batch_chunks`: rows of (2-bit bases,
    validity bitmap) planes — 0.375 B/base host→device, decoded inside the
    sharded step (same scheme as the single-chip path, ops/encode)."""
    from ..ops.encode import pack_base_stream

    span = chunk_windows + kmer_len - 1
    b_span = (span + 3) // 4
    m_span = (span + 7) // 8
    bases = np.zeros((n_rows, b_span), dtype=np.uint8)
    mask = np.zeros((n_rows, m_span), dtype=np.uint8)  # 0 = all-invalid row
    n_windows = max(padded.shape[0] - kmer_len + 1, 0)
    for r in range(n_rows):
        start = (step * n_rows + r) * chunk_windows
        if start >= n_windows:
            continue
        piece = padded[start : start + span]
        if piece.shape[0] < span:
            piece = np.concatenate(
                [piece, np.full(span - piece.shape[0], 4, np.uint8)]
            )
        pb, pm = pack_base_stream(piece)
        bases[r] = pb[:b_span]
        mask[r] = pm[:m_span]
    return bases, mask


def make_sharded_accumulate(
    mesh: Mesh,
    kmer_len: int,
    chunk_windows: int,
    capacity_factor: float = 2.0,
) -> Tuple[Callable, Callable]:
    """Env-sensitive encoder resolved outside the build cache, so the
    choice is part of the cache key (ops.encode.use_packed_encoder)."""
    from ..ops.encode import use_packed_encoder

    return _make_sharded_accumulate_cached(
        mesh, kmer_len, chunk_windows, capacity_factor,
        use_packed_encoder(kmer_len, masked=True),
    )


@functools.lru_cache(maxsize=None)
def _make_sharded_accumulate_cached(
    mesh: Mesh,
    kmer_len: int,
    chunk_windows: int,
    capacity_factor: float,
    packed_encode: bool,
) -> Tuple[Callable, Callable]:
    """Build (init_fn, step_fn) for the sharded histogram.

    init_fn() → (dense [S, local] uint8 device-sharded, num_valid int64,
                 max_bucket int32) — the two scalars are carried on-device so
    the step loop never syncs (mid-stream host syncs stall the pipeline).
    step_fn(state, chunks[R*S, span]) → state'
      where R = data-axis size; after the loop, ``max_bucket`` must be
      checked against ``step_fn.capacity`` (overflow invalidates the run).
    """
    n_data = mesh.shape[DATA_AXIS]
    n_shards = mesh.shape[SHARD_AXIS]
    assert n_shards & (n_shards - 1) == 0, "n_shards must be a power of two"
    shard_bits = int(n_shards).bit_length() - 1
    data_size = 4**kmer_len
    fold_size = data_size // 2
    local_size = fold_size // n_shards
    assert local_size * n_shards == fold_size
    capacity = int(np.ceil(chunk_windows / n_shards * capacity_factor))
    capacity = min(capacity, chunk_windows)
    span = chunk_windows + kmer_len - 1
    dt = code_dtype(kmer_len)
    # local indices fit int32 once n_shards >= 8 even at K=17; beyond that
    # the local plane is indexed in int64. Keep the code dtype until after
    # the owner split to stay exact.
    local_dt = jnp.int32 if local_size <= 2**31 - 1 else jnp.int64

    from ..ops.encode import canonical_codes_packed, unpack_base_2bit_mask

    # this path is always masked; the K-slice encoder wins the masked step
    # under honest chained timing (packed_encode resolved by the uncached
    # wrapper so the env choice is part of this cache's key)

    def per_chip(dense_local, nk_in, maxb_in, bases_row, mask_row):
        # dense_local: [1, local_size]; bases_row/mask_row: the chip's
        # bit-packed chunk (see shard_batch_chunks_packed), decoded on-chip.
        if packed_encode:
            codes = canonical_codes_packed(
                bases_row[0], mask_row[0], span, kmer_len
            )
        else:
            chunk = unpack_base_2bit_mask(bases_row[0], mask_row[0], span)
            codes = fold_codes(canonical_codes(chunk, kmer_len), kmer_len)
        valid = codes < fold_size
        # chunks are < 2^31 windows, so an int32 count is exact
        num_valid = valid.sum(dtype=jnp.int32).astype(jnp.int64)

        # key: bucket-major (owner, local); invalid windows past all buckets
        owner = (codes & (n_shards - 1)).astype(jnp.int32)
        local = (codes >> shard_bits).astype(local_dt)
        key = owner.astype(dt) * local_size + local
        key = jnp.where(valid, key, fold_size)
        key = sort_codes_fast(key)

        # bucket offsets via searchsorted on the S+1 bucket boundaries
        bounds = (jnp.arange(n_shards + 1, dtype=dt)) * local_size
        offsets = jnp.searchsorted(key, bounds)  # [S+1]
        counts = offsets[1:] - offsets[:-1]
        max_bucket = counts.max()

        # gather into [S, capacity] of local indices, pad = local sentinel
        slot = jax.lax.broadcasted_iota(jnp.int32, (n_shards, capacity), 1)
        src = offsets[:-1, None] + slot
        in_bucket = slot < counts[:, None]
        src = jnp.where(in_bucket, src, 0)
        vals = key[src] - bounds[:-1, None]
        send = jnp.where(in_bucket, vals.astype(local_dt), local_size)

        # exchange: row j of `send` goes to shard j
        recv = jax.lax.all_to_all(
            send, SHARD_AXIS, split_axis=0, concat_axis=0, tiled=True
        )
        if n_data > 1:
            recv = jax.lax.all_gather(recv, DATA_AXIS, tiled=True)
        recv = recv.reshape(-1)

        new_dense, _ = saturating_accumulate(
            dense_local[0], recv, sentinel=local_size
        )
        num_valid = nk_in + jax.lax.psum(num_valid, (DATA_AXIS, SHARD_AXIS))
        max_bucket = jnp.maximum(
            maxb_in, jax.lax.pmax(max_bucket, (DATA_AXIS, SHARD_AXIS))
        ).astype(jnp.int32)
        return new_dense[None, :], num_valid, max_bucket

    from jax import shard_map

    stepped = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(SHARD_AXIS, None), P(), P(),
                  P((DATA_AXIS, SHARD_AXIS), None),
                  P((DATA_AXIS, SHARD_AXIS), None)),
        out_specs=(P(SHARD_AXIS, None), P(), P()),
        check_vma=False,
    )
    step_jit = jax.jit(stepped, donate_argnums=(0, 1, 2))

    dense_sharding = NamedSharding(mesh, P(SHARD_AXIS, None))
    chunk_sharding = NamedSharding(mesh, P((DATA_AXIS, SHARD_AXIS), None))

    def init_fn():
        return (
            jax.device_put(
                jnp.zeros((n_shards, local_size), dtype=jnp.uint8),
                dense_sharding,
            ),
            jnp.zeros((), dtype=jnp.int64),
            jnp.zeros((), dtype=jnp.int32),
        )

    def step_fn(state, packed_rows):
        dense, nk, maxb = state
        bases, mask = packed_rows
        bases = jax.device_put(bases, chunk_sharding)
        mask = jax.device_put(mask, chunk_sharding)
        return step_jit(dense, nk, maxb, bases, mask)

    step_fn.capacity = capacity
    step_fn.rows = n_data * n_shards
    step_fn.span = span
    step_fn.local_size = local_size
    step_fn.n_shards = n_shards
    # AOT surface: the underlying jit + shardings, so callers can
    # .lower(...).compile() the step at production shapes without
    # allocating the (possibly multi-GB) dense plane — used for compile
    # warmup
    step_fn.jitted = step_jit
    step_fn.dense_sharding = dense_sharding
    step_fn.chunk_sharding = chunk_sharding
    return init_fn, step_fn
