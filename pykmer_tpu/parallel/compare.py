"""Sharded N×N comparison: per-chip matmul contingency partials + psum.

The merge engine's V·Vᵀ matmul (merge/merger.py) over cell-space shards:
each chip computes the N×N partial over its slice of the count space, one
psum over 'shards' yields the full matrix on every chip. Cell-space order
inside a shard is irrelevant (the matmul is a sum over cells), so any
host-side blocking works.
"""

from __future__ import annotations

import functools

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import SHARD_AXIS


@functools.lru_cache(maxsize=None)
def make_sharded_merge_step(mesh: Mesh, n: int) -> Callable:
    """Sharded variant of the merge engine's per-block contingency step
    (merge/merger.py:_make_block_step): the bit-packed validity planes of a
    cell-space block are sharded over the mesh's 'shards' axis, each chip
    unpacks its slice and runs the int8 V·Vᵀ matmul, one psum yields the
    block's full N×N which adds into a replicated donated int64 accumulator.

    Returns jitted ``step(acc [n,n] int64 replicated, bits [n, S, b/8/S])``.
    Bit-exact vs the single-device step: the matmul is a sum over cells and
    integer adds are associative (tested byte-identical in
    tests/test_merge.py).
    """
    n_shards = mesh.shape[SHARD_AXIS]

    def per_chip(acc, bits_local):
        # bits_local: [n, 1, bytes_per_shard] uint8 (packbits 'big' order)
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        v = ((bits_local[:, 0, :, None] >> shifts) & 1).reshape(
            n, -1
        ).astype(jnp.int8)
        partial = jnp.dot(v, v.T, preferred_element_type=jnp.int32)
        return acc + jax.lax.psum(partial, SHARD_AXIS).astype(jnp.int64)

    from jax import shard_map

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(None, None), P(None, SHARD_AXIS, None)),
        out_specs=P(None, None),
        check_vma=False,
    )
    jitted = jax.jit(fn, donate_argnums=(0,))
    bits_sharding = NamedSharding(mesh, P(None, SHARD_AXIS, None))
    acc_sharding = NamedSharding(mesh, P(None, None))

    def step(acc, bits):
        # bits: [n, block_bytes] host uint8; reshape to per-shard slices
        bits = bits.reshape(n, n_shards, -1)
        bits = jax.device_put(bits, bits_sharding)
        return jitted(acc, bits)

    step.acc_sharding = acc_sharding
    step.n_shards = n_shards
    return step


@functools.lru_cache(maxsize=None)
def make_sharded_pair_matrix(
    mesh: Mesh, n_samples: int, cells_per_shard: int,
    min_count: int, max_count: int,
) -> Callable:
    """Returns jitted fn: blocks [N, S*cells] (sharded on axis 1) → [N, N]
    shared-count matrix (replicated)."""
    n_shards = mesh.shape[SHARD_AXIS]

    def per_chip(blocks_local):
        # [N, 1, cells]
        v = (
            (blocks_local[:, 0, :] >= min_count)
            & (blocks_local[:, 0, :] <= max_count)
        ).astype(jnp.int8)
        partial = jnp.dot(v, v.T, preferred_element_type=jnp.int32)
        return jax.lax.psum(partial, SHARD_AXIS)

    from jax import shard_map

    fn = shard_map(
        per_chip,
        mesh=mesh,
        in_specs=(P(None, SHARD_AXIS, None),),
        out_specs=P(None, None),
        check_vma=False,
    )
    jitted = jax.jit(fn)
    sharding = NamedSharding(mesh, P(None, SHARD_AXIS, None))

    def pair_matrix(blocks):
        # blocks: [N, total_cells] uint8 with total = n_shards*cells_per_shard
        blocks = blocks.reshape(n_samples, n_shards, cells_per_shard)
        blocks = jax.device_put(blocks, sharding)
        return jitted(blocks)

    return pair_matrix
