"""Batch indexing: many FASTA inputs in one process.

The reference's batch recipe (reference data/README.md:5-29) launches one
``indexer.py`` process per genome, so every file pays interpreter start-up;
here a fresh process additionally pays every device-program compile and
load. Indexing a directory in ONE process loads each program exactly once
and reuses the pooled host buffers, so the steady-state per-file cost is
just the pipeline itself.

Resume semantics match the reference's batch loop: files whose ``.kin`` (or
``.kin.bgz``) already exists are skipped unless ``overwrite`` is set, making
the batch resumable at file granularity (reference data/README.md:15-26).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..config import IndexConfig
from ..formats import kin as kinfmt


@dataclass
class BatchResult:
    indexed: List[str] = field(default_factory=list)
    skipped: List[str] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)  # "path: error" strings
    total_bp: int = 0
    elapsed_s: float = 0.0


def _outputs_exist(input_file: str, kmer_len: int) -> bool:
    root = kinfmt.kin_root_path(input_file, kmer_len)
    return os.path.exists(root) or os.path.exists(root + "." + kinfmt.COMP_EXT)


def _sample_name(input_file: str) -> str:
    """Default sample name: basename up to the first dot (the reference's
    batch recipe uses ``${fasta%%.*}``, reference data/README.md:10)."""
    return os.path.basename(input_file).split(".")[0]


def index_batch(
    inputs: List[str],
    kmer_len: int,
    config: Optional[IndexConfig] = None,
    overwrite: bool = False,
    bgzip: bool = False,
    verify: bool = True,
    verbose: bool = True,
    preload: bool = True,
) -> BatchResult:
    """Index every FASTA in ``inputs`` (single-chip pipeline, one process).

    Existing outputs are skipped unless ``overwrite``; a failing input is
    reported and the batch continues (the per-file tmp+rename discipline
    means a failed file leaves no partial ``.kin`` behind).
    """
    from ..config import resolve_chunk_windows
    from .indexer import create_fasta_index

    config = resolve_chunk_windows(config or IndexConfig(kmer_len=kmer_len))
    result = BatchResult()
    t0 = time.monotonic()

    todo = []
    for path in inputs:
        if not overwrite and _outputs_exist(path, kmer_len):
            result.skipped.append(path)
            if verbose:
                print(f"skip {path} (index exists)")
            continue
        todo.append(path)

    if todo and preload:
        # one up-front load of every device program the runs will dispatch
        # (only the device-accumulate strategy uses preloadable programs;
        # the host strategy's encode+sort loads on the first file)
        from ..config import accumulate_strategy, device_bytes_limit

        strategy = accumulate_strategy(
            config.accumulate, kmer_len, config.chunk_windows,
            device_bytes_limit(),
        )
        if strategy == "device":
            from ..ops.readback import preload_programs
            from .indexer import preload_index_programs

            tp = time.monotonic()
            preload_programs(kmer_len)
            preload_index_programs(kmer_len, config)
            if verbose:
                print(f"programs preloaded in {time.monotonic() - tp:.1f}s")

    for path in todo:
        sample = _sample_name(path)
        try:
            header = create_fasta_index(
                path, sample, path, kmer_len,
                overwrite=True, config=config, verify=verify,
                verbose=verbose,
            )
        except Exception as exc:  # keep the batch going
            result.failed.append(f"{path}: {exc}")
            print(f"FAILED {path}: {exc}", file=sys.stderr)
            continue
        result.indexed.append(path)
        result.total_bp += sum(c[1] for c in header.chromosomes)
        if bgzip:
            from ..io.bgzf import bgzip_kin

            bgz, gzi = bgzip_kin(header.index_file_root)
            if verbose:
                print(f"wrote {bgz} + {gzi}")

    result.elapsed_s = time.monotonic() - t0
    if verbose:
        rate = result.total_bp / result.elapsed_s if result.elapsed_s else 0.0
        print(
            f"batch done: {len(result.indexed)} indexed, "
            f"{len(result.skipped)} skipped, {len(result.failed)} failed, "
            f"{result.total_bp:,} bp in {result.elapsed_s:.1f}s "
            f"({rate:,.0f} bp/s)"
        )
    return result
