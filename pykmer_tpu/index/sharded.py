"""Sharded indexing pipeline: FASTA → `.kin` over a device mesh.

The multi-chip (and multi-host data-parallel) variant of
index/indexer.py: the 4^K count space lives interleaved across the mesh's
'shards' axis, sequence chunks stream data-parallel, and each jitted step
runs encode → all_to_all exchange → saturating accumulate
(parallel/histogram). Progress checkpoints (dense shards + stream cursor)
make long builds resumable — the reference can only restart whole files
(SURVEY §5: crash-safety is tmp+rename only).

Output files are byte-identical to the single-chip pipeline (and hence the
reference): integer saturating adds are associative, so mesh shape cannot
change results (tested).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..config import IndexConfig
from ..formats import kin as kinfmt
from ..formats.header import KinHeader
from ..io.fasta import read_fasta_codes
from ..ops.encode import chunk_stream
from ..parallel.histogram import (
    interleaved_to_flat,
    flat_to_interleaved,
    make_sharded_accumulate,
    shard_batch_chunks_packed,
)
from ..parallel.mesh import make_mesh
from ..parallel import multihost
from .indexer import _load_joined_stream, PRINT_EVERY


def create_fasta_index_sharded(
    project_name: str,
    sample_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    config: Optional[IndexConfig] = None,
    mesh=None,
    n_shards: Optional[int] = None,
    n_data: int = 1,
    capacity_factor: float = 2.0,
    checkpoint_every: Optional[int] = None,
    resume: bool = True,
    verify: bool = True,
    verbose: bool = True,
) -> KinHeader:
    """Build one `.kin` index over a device mesh, resumably."""
    config = config or IndexConfig(kmer_len=kmer_len)
    if config.chunk_windows is None:
        # sharded steps route a whole chunk through an all_to_all whose
        # capacity scales with chunk_windows; keep the per-step footprint
        # bounded rather than taking the single-chip accelerator default
        import dataclasses as _dc

        config = _dc.replace(config, chunk_windows=1 << 22)
    if mesh is None:
        mesh = make_mesh(n_shards=n_shards, n_data=n_data)

    header = KinHeader(
        project_name,
        input_file=input_file,
        kmer_len=kmer_len,
        flush_every=config.flush_every,
        min_frag_size=config.min_frag_size,
        max_frag_size=config.max_frag_size,
    )
    data_size = header.data_size
    tmp = header.index_tmp_file

    ckpt = multihost.load_shard_checkpoint(tmp) if resume else None
    if ckpt is None:
        kinfmt.remove_outputs(input_file, kmer_len, overwrite)

    timer = header.timer
    stream, chromosomes, total_bp = _load_joined_stream(
        input_file, kmer_len, tail_headroom=config.chunk_windows + kmer_len
    )
    if total_bp >= PRINT_EVERY:
        timer.update(total_bp)

    init_fn, step_fn = make_sharded_accumulate(
        mesh, kmer_len, config.chunk_windows, capacity_factor=capacity_factor
    )
    if stream.shape[0] < kmer_len:
        raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
    padded, n_chunks = chunk_stream(stream, kmer_len, config.chunk_windows)
    rows = step_fn.rows
    n_steps = (n_chunks + rows - 1) // rows

    start_step = 0
    state = None
    if ckpt is not None:
        shards_np, ck = ckpt
        if (
            ck.get("kmer_len") == kmer_len
            and ck.get("chunk_windows") == config.chunk_windows
            and ck.get("rows") == rows
            and ck.get("input_size") == os.path.getsize(input_file)
            and shards_np.shape == (step_fn.n_shards, step_fn.local_size)
        ):
            start_step = int(ck["next_step"])
            import jax
            import jax.numpy as jnp

            dense0, nk0, maxb0 = init_fn()
            sharding = dense0.sharding
            del dense0, nk0, maxb0  # only the sharding is needed (a zero
            # plane held through the accumulate doubles the footprint)
            state = (
                jax.device_put(shards_np, sharding),
                jnp.asarray(int(ck["num_kmers"]), dtype=jnp.int64),
                # restore the bucket high-water mark so pre-checkpoint
                # overflow still fails the post-run capacity check
                jnp.asarray(int(ck.get("max_bucket", 0)), dtype=jnp.int32),
            )
            if verbose:
                print(f"  resuming from checkpoint at step {start_step}/{n_steps}")
        else:
            if verbose:
                print("  stale checkpoint ignored")
            multihost.clear_shard_checkpoint(tmp)
            kinfmt.remove_outputs(input_file, kmer_len, overwrite)
            ckpt = None
    if state is None:
        state = init_fn()

    from ..ops.readback import unfold_canonical

    # fully-async dispatch; num_kmers / max_bucket stay on-device and
    # are fetched only at checkpoints and at the end
    for s in range(start_step, n_steps):
        chunks = shard_batch_chunks_packed(
            padded, kmer_len, config.chunk_windows, rows, s
        )
        state = step_fn(state, chunks)
        if verbose and n_steps > 1:
            print(f"  dispatched step {s + 1}/{n_steps}")
        if checkpoint_every and (s + 1) % checkpoint_every == 0 and s + 1 < n_steps:
            multihost.save_shard_checkpoint(
                tmp, np.asarray(state[0]), next_step=s + 1,
                num_kmers=int(state[1]), max_bucket=int(state[2]),
                meta={
                    "kmer_len": kmer_len,
                    "chunk_windows": config.chunk_windows,
                    "rows": rows,
                    "input_size": os.path.getsize(input_file),
                },
            )

    dense, nk_dev, maxb_dev = state
    num_kmers = int(nk_dev)
    if int(maxb_dev) > step_fn.capacity:
        raise RuntimeError(
            f"shard bucket overflow ({int(maxb_dev)} > {step_fn.capacity}): "
            f"re-run with a larger capacity_factor (got {capacity_factor}) "
            f"or smaller chunk_windows"
        )
    if num_kmers == 0:
        raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
    if total_bp >= PRINT_EVERY:
        timer.update(total_bp)

    folded_np = interleaved_to_flat(np.asarray(dense))
    # fused tail (see index/indexer.py): expand the folded plane into a
    # hugepage RAM plane, then one streamed pwrite to the tmp file (file
    # mmaps are avoided: their page faults are slow);
    # stats from the half-size folded plane
    from ..formats.header import fast_counts256
    from ..ops.readback import _pwrite_all
    from ..utils.bigmem import big_empty

    counts = fast_counts256(folded_np).copy()
    counts[0] += folded_np.shape[0]
    out = big_empty(data_size)
    unfold_canonical(folded_np, kmer_len, out=out)
    from ..io.direct import DirectWriter

    with DirectWriter(tmp, size=data_size) as fd:
        _pwrite_all(fd, out, 0)
    del out
    header.num_kmers = int(num_kmers)
    header.chromosomes = chromosomes
    header.write_metadata(tmp, stats_counts256=counts)
    if verify:
        fresh = KinHeader(project_name, input_file=input_file, kmer_len=kmer_len)
        fresh.update_stats_from_file(tmp)
        if fresh.hist != header.hist or fresh.vals_sum != header.vals_sum:
            raise AssertionError("written .kin does not match computed stats")
    os.rename(tmp, header.index_file_root)
    multihost.clear_shard_checkpoint(tmp)
    if verbose:
        print("done")
    return header
