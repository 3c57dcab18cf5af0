"""Saturating dense-histogram accumulation on device.

The `.kin` array is ``min(total_count, 255)`` per canonical code — the
reference's two-stage clipping (per-flush clip at indexer.py:239 plus
saturating memmap add at indexer.py:262) composes to exactly that, so
accumulation order and batching cannot change the result (the test-suite
proves this against the flush-faithful oracle).

Algorithm per batch (all static shapes, no data-dependent control flow):
  1. sort the batch's codes (sentinels sort to the end);
  2. run-length analysis with two associative scans (run start = prefix-max of
     start indices, run end = suffix-min of next-start indices) — every
     element of a run learns its run's total count without any scatter;
  3. gather current dense values at the sorted codes, compute
     ``min(old + count, 255)``, and scatter-overwrite. Duplicates all write
     the same value, so the scatter's order among them cannot matter.

Folded count spaces beyond ``MAX_SWEEP_CELLS`` (K >= 17) are carried as a
tuple of contiguous sub-planes; each sub-plane applies an int32 localisation
of the same sorted stream (:func:`accumulate_sorted_planes`).
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MAX_VAL

# Largest sub-plane of a folded count space. Spaces beyond it (K >= 17:
# 2^33 folded cells) are carried as a tuple of MAX_SWEEP_CELLS-sized planes,
# each indexed in int32 (see localize_sorted / accumulate_sorted_planes); the
# readback streams the tuple plane by plane.
MAX_SWEEP_CELLS = 1 << 30


def sort_codes_fast(codes: jax.Array) -> jax.Array:
    """Keys-only UNSTABLE sort via an unsigned bitcast.

    Stability cannot change a keys-only sort's output, and every code domain
    here is non-negative (canonical/folded codes, sentinels), so unsigned
    order == signed order. On the GPU XLA runs this as CUB's keys-only
    radix sort (PERF.md, program A)."""
    if codes.dtype == jnp.int32 or codes.dtype == jnp.int64:
        uint_dt = jnp.uint32 if codes.dtype == jnp.int32 else jnp.uint64
        u = jax.lax.bitcast_convert_type(codes, uint_dt)
        return jax.lax.bitcast_convert_type(
            jax.lax.sort(u, is_stable=False), codes.dtype
        )
    return jax.lax.sort(codes, is_stable=False)


def saturating_accumulate(
    dense: jax.Array, codes: jax.Array, sentinel: int
) -> Tuple[jax.Array, jax.Array]:
    """Apply one batch of canonical codes to the dense uint8 array.

    dense: uint8[D]; codes: int[M] (values in [0, D] where D==sentinel marks
    dropped/padded windows). Returns (updated dense, number of valid codes).
    """
    return saturating_accumulate_sorted(dense, sort_codes_fast(codes), sentinel)


def _run_counts(sorted_codes: jax.Array) -> jax.Array:
    """Per element of a sorted stream: min(length of its run of equal
    values, 255)."""
    m = sorted_codes.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)

    is_start = jnp.concatenate(
        [jnp.ones((1,), dtype=bool), sorted_codes[1:] != sorted_codes[:-1]]
    )
    start_idx = jnp.where(is_start, idx, -1)
    run_start = jax.lax.associative_scan(jnp.maximum, start_idx)

    next_idx = jnp.where(is_start, idx, m)
    suffix_min = jax.lax.associative_scan(jnp.minimum, next_idx, reverse=True)
    run_end = jnp.concatenate([suffix_min[1:], jnp.full((1,), m, jnp.int32)])

    return jnp.minimum(run_end - run_start, MAX_VAL)


def _apply_runs(
    flat: jax.Array, idx: jax.Array, count: jax.Array, valid: jax.Array
) -> jax.Array:
    """``flat[idx] = min(flat[idx] + count, 255)`` where ``valid``.

    ``idx`` is sorted; invalid entries lie outside [0, flat.size) — negative
    ones included, so negative indices must not wrap (they would land in
    the last cells) but drop like every other out-of-range index."""
    old = flat[jnp.where(valid, idx, 0)].astype(jnp.int32)
    new = jnp.minimum(old + count, MAX_VAL).astype(jnp.uint8)
    return flat.at[idx].set(
        new, mode="drop", indices_are_sorted=True,
        wrap_negative_indices=False,
    )


def saturating_accumulate_sorted(
    dense: jax.Array, sorted_codes: jax.Array, sentinel: int
) -> Tuple[jax.Array, jax.Array]:
    """Same as :func:`saturating_accumulate` for an ALREADY-SORTED batch —
    the split device step sorts in its encode program (index.indexer), so
    the apply program must not pay a second sort."""
    valid = sorted_codes < sentinel
    dense = _apply_runs(dense, sorted_codes, _run_counts(sorted_codes), valid)
    return dense, valid.sum(dtype=jnp.int64)


def dense_plane_shape(cells: int):
    """On-device layout of a dense (sub-)plane of ``cells``: 2D
    [cells/128, 128] where it divides, which the readback's pack programs
    consume in place."""
    if cells % 128 == 0:
        return (cells // 128, 128)
    return (cells,)


def localize_sorted(sorted_codes: jax.Array, lo: int, hi: int) -> jax.Array:
    """Map globally sorted codes to a monotone int32 stream local to [lo, hi).

    Codes below ``lo`` become -1, codes at or above ``hi`` become int32 max,
    in-range codes become ``code - lo``. All three bands preserve the input's
    sorted order, so a <= 2^31-cell sub-plane of a count space that itself
    exceeds int32 indexing (K >= 17 folded planes) can apply the stream with
    int32 indices. Out-of-band casts may wrap, but every wrapped value is
    overwritten by the corresponding ``where`` arm.
    """
    assert hi - lo <= np.iinfo(np.int32).max
    local = (sorted_codes - lo).astype(jnp.int32)
    local = jnp.where(sorted_codes < lo, jnp.int32(-1), local)
    return jnp.where(
        sorted_codes >= hi, jnp.int32(np.iinfo(np.int32).max), local
    )


def accumulate_sorted_planes(planes, sorted_codes: jax.Array):
    """Apply sorted codes to a folded plane carried as a tuple of uint8
    sub-planes covering contiguous code ranges (see MAX_SWEEP_CELLS).

    ``sorted_codes`` may be int64 (K >= 17). Run lengths are taken once on
    the global stream; each sub-plane then applies the runs of its own code
    range through an int32 localisation. Codes past the last plane
    (sentinels) are ignored. Returns the updated tuple; safe to donate.
    """
    count = _run_counts(sorted_codes)
    out = []
    base = 0
    for p in planes:
        cells = p.size
        local = localize_sorted(sorted_codes, base, base + cells)
        valid = (local >= 0) & (local < cells)
        flat = _apply_runs(p.reshape(-1), local, count, valid)
        out.append(flat.reshape(p.shape))
        base += cells
    return tuple(out)


def make_accumulate_fn(data_size: int) -> Callable:
    """jit-compiled accumulate with the dense array donated (updated in place)."""

    @functools.partial(jax.jit, donate_argnums=0)
    def fn(dense: jax.Array, codes: jax.Array):
        assert dense.shape == (data_size,)
        return saturating_accumulate(dense, codes, sentinel=data_size)

    return fn


def counts256_from_dense(dense) -> "np.ndarray":
    """256-bin value histogram of the dense array (host-side numpy).

    Delegates to formats.header.fast_counts256 — np.bincount on a GiB-scale
    uint8 plane materialises an 8x int64 cast (60+ s at 4^15)."""
    from ..formats.header import fast_counts256

    return fast_counts256(np.asarray(dense).reshape(-1))
