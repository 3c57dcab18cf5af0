"""N×N merge: shared-kmer count matrix over a set of `.kin` indexes.

Reference behaviour being replaced (merger.py:80-210): every pair of samples
re-streams both full 4^K files through a Python masking loop in a process
pool — O(N²) full-file I/O, ~6h for 39 plant genomes (README.md:56-81).

Device design: every sample's dense array is read from disk exactly once,
in cell-space blocks. On device a block of all N samples becomes a {0,1}
validity matrix V (count within [min_count, max_count]) and one int8
matmul ``V @ V.T`` yields the entire N×N shared-count contingency for that
block — with each sample's own valid-cell total on the diagonal (V·V = V for
0/1 vectors). Host accumulates per-block int32 partials into the final uint64
matrix. File I/O (N parallel streams, gzip-decoding `.bgz` inputs) overlaps
with device compute via a double-buffered reader.

Output `.kma` + `.kma.json` match the reference formats exactly; the
reference leaves the matrix diagonal uninitialised (merger.py:136), we store
the per-sample totals' intersection with itself (== total) — downstream
zeroes the diagonal anyway (calculate_distance.py:96-97).
"""

from __future__ import annotations

import functools as _functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import MergeConfig
from ..formats import kin as kinfmt
from ..formats import kma as kmafmt
from ..formats.header import KinHeader

VALID_INPUT_EXTS = (".kin", ".kin.bgz", ".kma", ".kma.bgz")


def _validate_inputs(
    indexes: Sequence[str],
) -> Tuple[List[Dict[str, Any]], int]:
    data: List[Dict[str, Any]] = []
    kmer_len: Optional[int] = None
    for pos, kin in enumerate(indexes):
        kins = str(kin)
        if not kins.endswith(VALID_INPUT_EXTS):
            raise ValueError(f"all files must be .kin[.bgz]: {kin}")
        if not os.path.exists(kins):
            raise FileNotFoundError(f"all files must exist: {kin}")
        desc = kins[: -len(".bgz")] if kins.endswith(".bgz") else kins
        desc = f"{desc}.json"
        if not os.path.exists(desc):
            raise FileNotFoundError(
                f"all .kin[.bgz] files must have an associated .kin.json: {desc}"
            )
        header = KinHeader(kins, index_file=kins)
        if kmer_len is None:
            kmer_len = header.kmer_len
        if header.kmer_len != kmer_len:
            raise ValueError(
                f"kmer_length differs. expected {kmer_len}, got {header.kmer_len}"
            )
        data.append(
            {
                "pos": pos,
                "index_file": kins,
                "description_file": desc,
                "header": header,
            }
        )
    assert kmer_len is not None
    return data, kmer_len


def merge(
    project_name: str,
    indexes: Sequence[str],
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
    block_size: int = MergeConfig.block_size,
    threads: int = MergeConfig.threads,
    buffer_size: Optional[int] = None,
    n_shards: Optional[int] = None,
    engine: str = "auto",
    verbose: bool = True,
) -> Tuple[List[Dict[str, Any]], np.ndarray]:
    """Build `{project}.{min:03d}-{max:03d}.kma` (+ `.json`) from N indexes.

    ``buffer_size`` sets the raw-file buffer for gzip-wrapped `.bgz` streams
    (the reference's ``--buffer-size``, merger.py:67 → tools.py:300); raw
    `.kin` inputs use O_DIRECT block reads and ignore it.

    ``n_shards`` > 1 shards each block's validity planes over that many
    devices (parallel/compare.make_sharded_merge_step) — bit-identical to
    the single-device engine, replacing the reference's pair-parallel
    process pool (merger.py:137-161) at mesh scale.

    ``engine``: "device" (int8 contingency matmul), "host" (native AVX2
    bit-pack + popcount, no JAX/device involvement), or "auto" — host when
    N <= PYKMER_TPU_MERGE_HOST_MAX_N (default 8; the pair pass is O(N^2)
    bit-plane traffic, so the device engine wins at fan-in scale while small-N
    merges skip the device upload round-trip and JAX import entirely).
    """
    if not (1 <= min_count and max_count <= 255):
        raise ValueError("count bounds must satisfy 1 <= min and max <= 255")
    if block_size <= 0 or len(indexes) == 0:
        raise ValueError("need a positive block size and at least one index")
    if buffer_size is not None and buffer_size <= 0:
        raise ValueError("buffer_size must be positive")

    outfile = kmafmt.kma_path(project_name, min_count, max_count)
    if os.path.exists(project_name):
        raise ValueError(
            f"project name ({project_name}) is a file. maybe forgot to pass "
            f"project name as first argument?"
        )
    if os.path.exists(outfile):
        raise FileExistsError(f"project output file ({outfile}) already exists.")

    data, kmer_len = _validate_inputs(indexes)
    n = len(data)
    data_size = 4**kmer_len

    if engine not in ("auto", "host", "device"):
        raise ValueError(f"engine must be auto|host|device, got {engine!r}")
    if engine == "auto":
        host_max_n = int(os.environ.get("PYKMER_TPU_MERGE_HOST_MAX_N", "8"))
        engine = "host" if n <= host_max_n and not (n_shards or 0) > 1 \
            else "device"
    if engine == "host" and (n_shards or 0) > 1:
        raise ValueError("--shards requires the device engine")

    builder = (_pairwise_matrix_host if engine == "host"
               else _pairwise_matrix_device)
    shared = builder(
        [d["index_file"] for d in data],
        data_size,
        min_count,
        max_count,
        block_size=block_size,
        threads=threads,
        buffer_size=buffer_size,
        n_shards=n_shards,
        verbose=verbose,
    )

    # matrix[k,l] = (k_count, l_count, shared): totals live on the diagonal
    matrix = np.zeros((n, n, 3), dtype=np.uint64)
    totals = np.diagonal(shared).astype(np.uint64)
    matrix[:, :, 0] = totals[:, None]
    matrix[:, :, 1] = totals[None, :]
    matrix[:, :, 2] = shared.astype(np.uint64)
    # reference leaves the diagonal unwritten; we store (total, total, total)

    json_data = [
        {
            "pos": d["pos"],
            "index_file": d["index_file"],
            "description_file": d["description_file"],
            "header": d["header"].to_dict(lean=True),
        }
        for d in data
    ]
    outfile_json = f"{outfile}.json"
    if verbose:
        print(f"saving {outfile_json}")
    kmafmt.write_kma_json(outfile_json, project_name, min_count, max_count, json_data)
    if verbose:
        print(f"saving {outfile}")
    kmafmt.write_kma(outfile, matrix)
    return json_data, matrix


class _InputStreams:
    """N parallel block readers over `.kin` / `.kin.bgz` / `.gz` inputs (each
    file streamed exactly once, front to back).

    Raw `.kin` inputs read O_DIRECT into reusable pooled buffers (buffered
    reads pay this environment's slow page-cache allocation); `.bgz` inputs
    use GZI-guided random access with the covering blocks inflated in
    parallel on a shared pool (zlib drops the GIL) — one serial gzip stream
    per file was the N=39 merge's decode bottleneck (the reference carries
    the .gzi for exactly this, gzireader.py:21-37). Non-BGZF gzip inputs (no
    block structure) keep the stream fallback; a corrupt/truncated `.bgz`
    (struct.error from the header walk) falls back the same way instead of
    crashing the merge."""

    def __init__(self, paths: Sequence[str], block_size: int,
                 buffer_size: Optional[int]):
        import struct as _struct

        from ..io.bgzf import BgzfRangeReader
        from ..io.direct import DirectReader
        from ..utils.bigmem import big_empty

        self.inflate_pool = ThreadPoolExecutor(max(2, os.cpu_count() or 2))
        self.streams: List[Tuple[str, Any]] = []
        self.bufs: List[np.ndarray] = []
        ok = False
        try:
            for p in paths:
                if p.endswith("." + kinfmt.COMP_EXT):
                    try:
                        self.streams.append(
                            ("bgz", BgzfRangeReader(p, pool=self.inflate_pool))
                        )
                    except (IOError, OSError, _struct.error):
                        self.streams.append(
                            ("gz", kinfmt.open_kin_stream(
                                p, buffering=buffer_size))
                        )
                else:
                    self.streams.append(("raw", DirectReader(p)))
                self.bufs.append(big_empty(block_size))
            ok = True
        finally:
            if not ok:
                self.close()

    def read_block(self, i: int, want: int, off: int) -> np.ndarray:
        """Fill stream i's pooled buffer with cells [off, off+want)."""
        from ..io.direct import pread_into_mt

        kind, src = self.streams[i]
        blk = self.bufs[i][:want]
        if kind == "raw":
            got = pread_into_mt(src, blk, off, threads=2)
        elif kind == "bgz":
            got = src.read_into(blk, off)
        else:
            got, mv = 0, memoryview(blk)
            while got < want:
                r = src.readinto(mv[got:])
                if not r:
                    break
                got += r
        if got != want:
            raise IOError("short read while merging")
        return blk

    def close(self) -> None:
        self.inflate_pool.shutdown(wait=False)
        for _, src in self.streams:
            src.close()

    def __enter__(self) -> "_InputStreams":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _pairwise_matrix_host(
    paths: List[str],
    data_size: int,
    min_count: int,
    max_count: int,
    block_size: int,
    threads: int,
    verbose: bool,
    buffer_size: Optional[int] = None,
    n_shards: Optional[int] = None,
) -> np.ndarray:
    """Small-N engine: per block, each sample reduces to a 1-bit validity
    plane (AVX2 range-compare + movemask) and every pair accumulates one
    AND+popcount pass — the reference's three-mask block loop
    (tools.py:473-482) at memory bandwidth, with each file read ONCE.

    No JAX import anywhere on this path: a cold CLI merge of a few samples
    pays no device executable loads and no upload round-trip (the device
    engine's per-block [N, block/8] upload dominates small-N wall time).
    O(N^2) bit-plane traffic per block means the device engine takes over at
    fan-in scale (merge() picks by N)."""
    assert not (n_shards or 0) > 1
    n = len(paths)
    align = 8
    block_size = max(4 * align, min(block_size, data_size + align - 1))
    block_size = (block_size + align - 1) // align * align

    try:
        from ..io.native import (
            pack_valid_bits_native,
            popcount_and_native,
            popcount_buf_native,
        )

        def pack(blk: np.ndarray, out: np.ndarray) -> np.ndarray:
            return pack_valid_bits_native(blk, min_count, max_count, out=out)

        pop, pop_and = popcount_buf_native, popcount_and_native
    except ImportError:
        def pack(blk: np.ndarray, out: np.ndarray) -> np.ndarray:
            valid = (blk >= min_count) & (blk <= max_count)
            packed = np.packbits(valid)
            out[: packed.shape[0]] = packed
            return out[: packed.shape[0]]

        # np.bitwise_count needs numpy >= 2.0 and pyproject leaves numpy
        # unpinned; a 256-entry popcount LUT keeps the fallback portable
        popcnt = getattr(np, "bitwise_count", None)
        if popcnt is None:
            _lut = np.unpackbits(
                np.arange(256, dtype=np.uint8)[:, None], axis=1
            ).sum(axis=1).astype(np.uint8)

            def popcnt(bits: np.ndarray) -> np.ndarray:
                return _lut[bits]

        def pop(bits: np.ndarray, threads: int = 2) -> int:
            return int(popcnt(bits).sum())

        def pop_and(a: np.ndarray, b: np.ndarray, threads: int = 2) -> int:
            return int(popcnt(a & b).sum())

    acc = np.zeros((n, n), dtype=np.int64)
    bit_bufs = [np.empty(block_size // 8, dtype=np.uint8) for _ in range(n)]
    pairs = [(i, j) for i in range(n) for j in range(i, n)]
    with _InputStreams(paths, block_size, buffer_size) as streams, \
            ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        done = 0
        while done < data_size:
            want = min(block_size, data_size - done)
            nb = (want + 7) // 8
            if want % 8:
                # zero the ragged tail byte's pad bits (pack() zero-fills
                # them, but only up to the bytes it returns)
                for b in bit_bufs:
                    b[nb - 1 : nb] = 0

            def read_pack(i: int, want=want, off=done) -> np.ndarray:
                return pack(streams.read_block(i, want, off), bit_bufs[i])

            bits = list(pool.map(read_pack, range(n)))

            def count_pair(ij: Tuple[int, int]) -> int:
                i, j = ij
                if i == j:
                    return pop(bits[i], threads=1)
                return pop_and(bits[i], bits[j], threads=1)

            for (i, j), c in zip(pairs, pool.map(count_pair, pairs)):
                acc[i, j] += c
            done += want
            if verbose:
                print(
                    f"  merged {done:15,d}/{data_size:15,d} "
                    f"({done / data_size * 100.0:6.2f}%)"
                )
    assert done == data_size
    iu = np.triu_indices(n, k=1)
    acc[(iu[1], iu[0])] = acc[iu]
    return acc


@_functools.lru_cache(maxsize=None)
def _make_block_step(n: int):
    """Jitted per-block contingency matmul with an on-device accumulator,
    cached per sample count (a fresh ``jax.jit`` per merge run would
    recompile).

    The accumulator is donated and carried on device so block steps dispatch
    fully asynchronously — the readers stream the next block from disk while
    the device is still unpacking/multiplying the previous one. int64: at
    K>=17 a sample's valid-cell total can exceed int32."""
    import jax
    import jax.numpy as jnp

    def step(acc: jax.Array, bits: jax.Array) -> jax.Array:
        # bits: [n, block/8] uint8 — host-packed validity mask (8 cells per
        # byte, bitorder='big' like np.packbits). Device unpacks and runs one
        # int8 matmul V @ V.T = the block's full N×N contingency.
        shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)
        v = ((bits[:, :, None] >> shifts) & 1).reshape(n, -1).astype(jnp.int8)
        return acc + jnp.dot(
            v, v.T, preferred_element_type=jnp.int32
        ).astype(jnp.int64)

    return jax.jit(step, donate_argnums=(0,))


def _pairwise_matrix_device(
    paths: List[str],
    data_size: int,
    min_count: int,
    max_count: int,
    block_size: int,
    threads: int,
    verbose: bool,
    buffer_size: Optional[int] = None,
    n_shards: Optional[int] = None,
) -> np.ndarray:
    """Shared-count N×N matrix; each file streamed exactly once."""
    # the on-device accumulator must be true int64: per-sample totals exceed
    # int32 at K>=16 (this path does not otherwise import ops/, so it routes
    # through the package's single x64 configuration point itself)
    from .._jax_setup import ensure_x64

    ensure_x64()
    import jax
    import jax.numpy as jnp

    n = len(paths)
    if n_shards is not None and n_shards > 1:
        if len(jax.devices()) < n_shards:
            raise ValueError(
                f"--shards {n_shards}: only {len(jax.devices())} devices"
            )
        # block must split evenly into per-shard byte slices
        align = 8 * n_shards
    else:
        n_shards = None
        align = 8
    # clamp the block so the device working set stays inside a memory
    # budget: each step materialises the unpacked [n, block] int8 validity
    # plane (plus its unpack temporaries, the 8x smaller bits upload and the
    # n^2 accumulator), and with async dispatch two blocks can be in flight
    # — a large-N merge with the default 100M block would otherwise OOM the
    # device rather than degrade. The default budget is an eighth of what
    # the device grants the process; a device that reports no limit (the
    # CPU backend) is not clamped.
    from ..config import device_bytes_limit

    env_budget = os.environ.get("PYKMER_TPU_MERGE_HBM_BYTES")
    limit = device_bytes_limit()
    hbm_budget = int(env_budget) if env_budget else (
        limit // 8 if limit else None)
    max_block = block_size if hbm_budget is None else max(
        4 * align, hbm_budget // max(n, 1) // align * align)
    if block_size > max_block:
        if verbose:
            print(
                f"  clamping block_size {block_size:,} -> {max_block:,} "
                f"(N={n} unpacked planes within the {hbm_budget:,}-byte device "
                f"budget; override via PYKMER_TPU_MERGE_HBM_BYTES)"
            )
        block_size = max_block
    # pad block to a multiple of the alignment so validity bits pack evenly
    # (and split evenly across shards) with static shapes; zero-padding =
    # invalid cells
    block_size = max(4 * align, min(block_size, data_size + align - 1))
    block_size = (block_size + align - 1) // align * align

    if n_shards:
        from ..parallel.compare import make_sharded_merge_step
        from ..parallel.mesh import SHARD_AXIS
        from jax.sharding import Mesh

        mesh = Mesh(
            np.array(jax.devices()[:n_shards]).reshape(n_shards),
            (SHARD_AXIS,),
        )
        step = make_sharded_merge_step(mesh, n)
        acc = jax.device_put(
            jnp.zeros((n, n), dtype=jnp.int64), step.acc_sharding
        )
    else:
        step = _make_block_step(n)
        acc = jnp.zeros((n, n), dtype=jnp.int64)
    with _InputStreams(paths, block_size, buffer_size) as streams, \
            ThreadPoolExecutor(max_workers=max(1, threads)) as pool:
        done = 0
        while done < data_size:
            want = min(block_size, data_size - done)

            def read_one(i, want=want, off=done):
                # read + threshold + bit-pack in the reader thread: the
                # upload shrinks 8x (1 bit per cell) and packing overlaps
                # across the N streams
                blk = streams.read_block(i, want, off)
                valid = (blk >= min_count) & (blk <= max_count)
                if want < block_size:
                    valid = np.concatenate(
                        [valid, np.zeros(block_size - want, dtype=bool)]
                    )
                return np.packbits(valid)

            bits = np.stack(list(pool.map(read_one, range(n))))
            # pass the HOST array: the sharded step device_puts it with
            # the shard sharding itself — a jnp.asarray here would first
            # commit the whole block to device 0 and double the upload
            acc = step(acc, bits)
            done += want
            if verbose:
                print(
                    f"  merged {done:15,d}/{data_size:15,d} "
                    f"({done / data_size * 100.0:6.2f}%)"
                )
    assert done == data_size
    return np.asarray(acc, dtype=np.int64)


def iter_kin_cells(path: str, buffer_size: int = 1 << 16):
    """Byte-at-a-time iterator over a `.kin[.bgz]`'s cells (reference
    ``Header.__iter__``, tools.py:527-533: buffered reads of the opened
    index stream, yielding one int per cell)."""
    from ..formats import kin as kinfmt

    with kinfmt.open_kin_stream(path) as fh:
        cs = fh.read(buffer_size)
        while cs:
            yield from cs
            cs = fh.read(buffer_size)


def pair_counts_scalar(
    a_path: str,
    b_path: str,
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
) -> Tuple[int, int, int]:
    """Scalar cell-at-a-time pair counts — parity port of the reference's
    unused fallback ``Header.calculate_distance2`` (tools.py:495-512): zip
    the two cell iterators and range-test each pair. Kept for completeness
    (the reference never calls it either); every production path uses
    :func:`pair_counts_stream` or the engines in :func:`merge`.

    Deliberate deviation: the reference's zip silently TRUNCATES at the
    shorter file when the inputs disagree in size; here that raises
    ``ValueError`` (``strict=True``) — truncated counts are garbage and a
    mismatch always indicates caller error. Same-size inputs (the only
    case the reference ever produced) are value-identical."""
    a_count = b_count = s_count = 0
    for a_char, b_char in zip(
        iter_kin_cells(a_path), iter_kin_cells(b_path), strict=True
    ):
        a_valid = min_count <= a_char <= max_count
        b_valid = min_count <= b_char <= max_count
        a_count += 1 if a_valid else 0
        b_count += 1 if b_valid else 0
        s_count += 1 if a_valid and b_valid else 0
    return a_count, b_count, s_count


def pair_counts_stream(
    a_path: str,
    b_path: str,
    data_size: int,
    min_count: int = MergeConfig.min_count,
    max_count: int = MergeConfig.max_count,
    block_size: int = MergeConfig.block_size,
) -> Tuple[int, int, int]:
    """Single-pair streamed counts (reference Header.calculate_distance
    tools.py:439-493 parity; used for verification)."""
    a_count = b_count = s_count = 0
    blocks_a = kinfmt.iter_kin_blocks(a_path, data_size, block_size,
                                      reuse_buffer=True)
    blocks_b = kinfmt.iter_kin_blocks(b_path, data_size, block_size,
                                      reuse_buffer=True)
    for a_blk, b_blk in zip(blocks_a, blocks_b):
        assert a_blk.shape == b_blk.shape
        av = (a_blk >= min_count) & (a_blk <= max_count)
        bv = (b_blk >= min_count) & (b_blk <= max_count)
        a_count += int(av.sum())
        b_count += int(bv.sum())
        s_count += int((av & bv).sum())
    return a_count, b_count, s_count
