"""Typed configuration for the whole engine.

The reference scatters its knobs over module constants and argv
(reference tools.py:99-106, indexer.py:480-491, merger.py:51-59); here they are
one typed config. Defaults are value-identical so recorded metadata
(``flush_every``, ``frag_size``) and CLI behaviour match the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

DEFAULT_FLUSH_EVERY = 100_000_000
DEFAULT_MIN_FRAG_SIZE = 500_000_000
DEFAULT_MAX_FRAG_SIZE = 1_000_000_000
DEFAULT_MIN_COUNT = 1
DEFAULT_MAX_COUNT = 255
DEFAULT_BLOCK_SIZE = 100_000_000
DEFAULT_THREADS = 4
MAX_VAL = 255  # uint8 saturation ceiling (reference tools.py:217)
# window starts per device chunk: XLA:CPU compile time grows with the batch,
# so the CPU backend keeps small chunks; accelerators take the size that
# gave the most windows/s through programs A + B at both K=15 and K=17 on an
# H100 (PERF.md, "Program A | program B per chunk")
CPU_CHUNK_WINDOWS = 1 << 22
DEVICE_CHUNK_WINDOWS = 1 << 26
# device bytes per chunk window that the per-chunk steps may keep in flight:
# one K=17 chunk measured ~34 B/window above the plane (peak_bytes_in_use on
# an H100), and the K >= 17 dispatch loop lets up to five chunks stack up
STEP_BYTES_PER_WINDOW = 256


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Configuration of one indexing run (FASTA → .kin)."""

    kmer_len: int
    # host→device streaming: number of window starts per device chunk.
    # ``None`` resolves per backend at run start (resolve_chunk_windows).
    chunk_windows: Optional[int] = None
    # kmer codes buffered on device before a dense-array accumulate
    flush_every: int = DEFAULT_FLUSH_EVERY
    min_frag_size: int = DEFAULT_MIN_FRAG_SIZE
    max_frag_size: int = DEFAULT_MAX_FRAG_SIZE
    # device strategy: "auto" | "device" (device-resident dense array) |
    # "host" (host-RAM dense array for count spaces exceeding device memory);
    # "auto" resolves through accumulate_strategy
    accumulate: str = "auto"
    # final device→host fetch: "auto" prices the packed planes and the sparse
    # token stream by bytes moved; "raw"/"packed"/... force a path
    readback: str = "auto"

    def __post_init__(self) -> None:
        if self.kmer_len <= 0 or self.kmer_len % 2 == 0:
            raise ValueError(
                f"kmer_len must be a positive odd integer, got {self.kmer_len}"
            )
        if self.chunk_windows is not None and self.chunk_windows % 8:
            raise ValueError(
                f"chunk_windows must be a multiple of 8 (bit-packed upload "
                f"alignment), got {self.chunk_windows}"
            )


def resolve_chunk_windows(
    config: "IndexConfig", input_hint_bytes: Optional[int] = None
) -> "IndexConfig":
    """Replace a ``chunk_windows=None`` placeholder with the backend default
    (called once at each indexing entry point, before any framing).

    The CPU backend takes ``CPU_CHUNK_WINDOWS`` (XLA:CPU compile time grows
    with the batch); accelerators take ``DEVICE_CHUNK_WINDOWS``.
    ``input_hint_bytes`` (raw input file size, when known) clamps the
    default DOWN to the next power of two covering the input: a tiny
    fixture otherwise pads to a full chunk — >99.9% sentinels sorted and
    applied per chunk, plus a fresh device-program compile at a shape the
    input never needed. Explicit user values are honoured as-is;
    power-of-two clamping keeps the compile-cache key set small (one per
    octave, floor 2^16)."""
    if config.chunk_windows is not None:
        return config
    import jax

    cw = CPU_CHUNK_WINDOWS if jax.default_backend() == "cpu" \
        else DEVICE_CHUNK_WINDOWS
    if input_hint_bytes is not None and input_hint_bytes > 0:
        # window count <= base count <= raw byte count
        need = 1 << 16
        while need < input_hint_bytes and need < cw:
            need <<= 1
        cw = min(cw, need)
    return dataclasses.replace(config, chunk_windows=cw)


def device_bytes_limit() -> Optional[int]:
    """Memory the first local device grants this process, or ``None`` when
    the backend reports no limit (the CPU backend)."""
    import jax

    stats = jax.local_devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def accumulate_strategy(
    requested: str, kmer_len: int, chunk_windows: int,
    bytes_limit: Optional[int],
) -> str:
    """Resolve ``IndexConfig.accumulate`` for one run.

    Count spaces up to 4 GiB (K <= 15) always stay on the device. Larger
    ones (K = 17: an 8 GiB folded plane) stay there only when the device
    reports a memory limit that holds the folded plane plus the in-flight
    step working sets; a device that reports no limit is assumed to hold
    none of it, so the plane goes to host RAM."""
    if requested != "auto":
        return requested
    data_size = 4**kmer_len
    if data_size <= (4 << 30):
        return "device"
    need = data_size // 2 + STEP_BYTES_PER_WINDOW * chunk_windows
    return "device" if bytes_limit is not None and need <= bytes_limit \
        else "host"


@dataclasses.dataclass(frozen=True)
class MergeConfig:
    """Configuration of one merge run (N×.kin → .kma)."""

    min_count: int = DEFAULT_MIN_COUNT
    max_count: int = DEFAULT_MAX_COUNT
    block_size: int = DEFAULT_BLOCK_SIZE
    threads: int = DEFAULT_THREADS
    # device engine: bit-pack validity masks once per sample, AND+popcount pairs
    engine: str = "auto"  # "auto" | "device" | "stream"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape for sharded runs.

    ``shards`` range-shards the 4^K count space (low-bit interleaved for load
    balance); ``data`` is the data-parallel axis (multi-host: one group per
    host, partial histograms merged with a saturating reduce at finalize).
    """

    shards: int = 1
    data: int = 1
