"""The indexing pipeline: FASTA → `.kin` + `.kin.json`.

Reference call stack being replaced (indexer.py:299-414): a per-base Python
loop feeding a 100M-element flush buffer and a fragment-wise memmap update.
Here the host decodes/concatenates base codes once, streams fixed-size
overlapping chunks to the device, and a single jitted step per chunk fuses
canonical-code computation with the saturating dense-array update. The dense
array lives donated on-device for the whole run ("device" strategy) or in
host RAM when the count space exceeds device memory ("host" strategy —
multi-chip runs range-shard it instead, see parallel/).

Output files are byte-identical to the reference's (atomic tmp+rename,
identical metadata JSON modulo wall-clock provenance).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np

from ..config import IndexConfig
from ..formats import kin as kinfmt
from ..formats.header import KinHeader
from ..io.fasta import FastaRecord, read_fasta_codes
from ..ops.encode import chunk_stream
from ..utils.timer import Timer

PRINT_EVERY = 25_000_000  # progress cadence in bp (reference indexer.py:45)


def _record_has_valid_window(codes: np.ndarray, kmer_len: int) -> bool:
    """True iff the record yields at least one k-mer: a run of >=K valid bases."""
    if codes.shape[0] < kmer_len:
        return False
    valid = (codes < 4).astype(np.int32)
    # longest run via cumulative-sum-reset trick
    csum = np.cumsum(valid)
    reset = np.where(valid == 0, csum, 0)
    best = csum - np.maximum.accumulate(reset)
    return bool(best.max() >= kmer_len)


def _concat_records(
    records: List[FastaRecord], kmer_len: int
) -> Tuple[np.ndarray, List[Tuple[str, int]], int]:
    """Concatenate record codes with K-1 invalid separator bases.

    Separators poison every window that would span two records, so the flat
    stream yields exactly the per-record k-mers. Returns (stream,
    chromosomes, total_bp); ``chromosomes`` lists (name, seq_len) for records
    producing at least one k-mer, in order (reference indexer.py:345-351
    omits barren records).
    """
    sep = np.full(kmer_len - 1, 4, dtype=np.uint8)
    parts: List[np.ndarray] = []
    chromosomes: List[Tuple[str, int]] = []
    total_bp = 0
    for rec in records:
        total_bp += rec.seq_len
        if parts:
            parts.append(sep)
        parts.append(rec.codes)
        if _record_has_valid_window(rec.codes, kmer_len):
            chromosomes.append((rec.name, rec.seq_len))
    stream = np.concatenate(parts) if parts else np.empty(0, dtype=np.uint8)
    return stream, chromosomes, total_bp


def _load_joined_stream(
    input_file: str,
    kmer_len: int,
    raw_out: Optional[dict] = None,
    tail_headroom: int = 0,
):
    """FASTA → (joined code stream, chromosomes, total_bp).

    Native one-pass path (decode + separator-join + valid-run detection in
    C++) with the NumPy record path as fallback — identical semantics
    (tested). When ``raw_out`` is given and the input is a plain (not
    compressed) file, ``raw_out["bytes"]`` receives the raw file buffer so
    the caller can checksum it from memory instead of re-reading the file."""
    import time as _t

    from ..io.fasta import open_input_bytes

    _t0 = _t.monotonic()
    data = open_input_bytes(input_file)
    _t1 = _t.monotonic()
    if raw_out is not None and input_file is not None \
            and not input_file.endswith((".gz", ".bgz")):
        raw_out["bytes"] = data
    result = _decode_joined_bytes(data, kmer_len, tail_headroom)
    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        import sys as _sys

        print(
            f"  decode: read {_t1 - _t0:6.1f}s  "
            f"decode {_t.monotonic() - _t1:6.1f}s",
            file=_sys.stderr,
        )
    return result


def _decode_joined_bytes(data, kmer_len: int, tail_headroom: int = 0):
    """Decode in-memory FASTA bytes to the joined code stream (native
    one-pass path with the NumPy record path as fallback)."""
    try:
        from ..io.native import fasta_decode_joined_native

        result = fasta_decode_joined_native(
            data, kmer_len, tail_headroom=tail_headroom
        )
        if result is not None:
            return result
    except ImportError:
        pass
    from ..io.fasta import decode_fasta_bytes

    return _concat_records(decode_fasta_bytes(data), kmer_len)


def _find_record_start(buf: np.ndarray, start: int, limit: int) -> Optional[int]:
    """First record start (a ``>`` preceded by ``\\n``) in [start+1, limit),
    scanning pairs whose bytes both lie in [start, limit). None if absent."""
    p = start
    win = 8 << 20
    while p < limit - 1:
        w = buf[p : min(p + win, limit)]
        hits = np.flatnonzero(w[1:] == ord(">"))
        for h in hits:
            if w[h] == ord("\n"):
                return p + int(h) + 1
        p += w.shape[0] - 1
    return None


def _segment_targets(target: int):
    """Ramped segment sizes: small first segments so the first device
    dispatch happens ~0.1 s in (a full-size first segment serialises its
    whole decode ahead of any upload — measured ~1 s of dead pipeline time),
    then full-size segments for steady-state decode efficiency."""
    for t in (target // 16, target // 8, target // 4, target // 2):
        if t >= (1 << 20):
            yield t
    while True:
        yield target


def _segment_record_bounds(buf: np.ndarray, target: int) -> List[Tuple[int, int]]:
    """Split a raw FASTA byte buffer into ~``target``-byte segments at record
    starts (a ``>`` at a line start).

    Records never span segments and k-mer windows never span records (the
    joined stream poisons inter-record windows with separators), so each
    segment can be decoded and counted independently — the basis of the
    decode/dispatch pipeline below."""
    n = buf.shape[0]
    starts = [0]
    tgt = _segment_targets(target)
    pos = next(tgt)
    while pos < n:
        found = _find_record_start(buf, pos - 1, n)
        if found is None:
            break
        starts.append(found)
        pos = found + next(tgt)
    return [(starts[i], starts[i + 1] if i + 1 < len(starts) else n)
            for i in range(len(starts))]


class _StreamingInput:
    """Background O_DIRECT read of a plain FASTA file into one pooled buffer.

    The segment pipeline chases the reader (``wait_until(pos)`` blocks until
    ``pos`` bytes are resident) and the provenance sha256 chases it too, so
    the disk read, the input hash, the decode threads, and the device uploads
    all overlap — the prior up-front whole-file read cost 0.4–4.6 s of dead
    serial time depending on disk weather. All background work runs at
    nice+10 so the h2d transport owns the cores whenever it is runnable."""

    def __init__(self, path: str, extent: int = 64 << 20):
        import threading

        from ..utils.bigmem import big_empty

        self.size = os.path.getsize(path)
        self.buf = big_empty(max(self.size, 1))[: self.size]
        self._path = path
        self._extent = extent
        self._cond = threading.Condition()
        self._filled = 0
        self._exc: Optional[BaseException] = None
        self._sha_hex: Optional[str] = None
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self._hasher = threading.Thread(target=self._hash, daemon=True)
        self._hasher.start()

    def _read(self) -> None:
        from ..io.direct import DirectReader, pread_into_mt
        from ..utils import renice_current_thread

        renice_current_thread(10)
        try:
            with DirectReader(self._path) as rd:
                pos = 0
                while pos < self.size:
                    hi = min(self.size, pos + self._extent)
                    got = pread_into_mt(
                        rd, self.buf[pos:hi], pos, threads=2, chunk=32 << 20
                    )
                    if got != hi - pos:
                        raise IOError(
                            f"{self._path}: short read at {pos} ({got} bytes)"
                        )
                    with self._cond:
                        self._filled = hi
                        self._cond.notify_all()
                    pos = hi
        except BaseException as exc:  # surfaced by wait_until
            with self._cond:
                self._exc = exc
                self._cond.notify_all()

    def _hash(self) -> None:
        import hashlib

        from ..utils import renice_current_thread

        renice_current_thread(10)
        h = hashlib.sha256()
        pos = 0
        while pos < self.size:
            hi = min(self.size, pos + (32 << 20))
            try:
                self.wait_until(hi)
            except BaseException:
                return  # reader failed; wait_until reports it to the pipeline
            h.update(self.buf[pos:hi])
            pos = hi
        self._sha_hex = h.hexdigest()

    def filled(self) -> int:
        with self._cond:
            return self._filled

    def wait_until(self, pos: int) -> None:
        with self._cond:
            while self._filled < pos and self._exc is None:
                self._cond.wait()
            if self._exc is not None and self._filled < pos:
                raise self._exc

    def input_checksum(self) -> str:
        self._hasher.join()
        if self._sha_hex is None:
            self.wait_until(self.size)  # raises the reader's error
            raise RuntimeError(f"{self._path}: input hash thread died")
        return self._sha_hex


def _iter_segments_streaming(
    stream: _StreamingInput, target: int, wait_slack: int = 8 << 20
):
    """Yield (lo, hi) record-aligned segment bounds, chasing the reader.

    ``wait_slack`` is how far past the scan point each wait asks the reader
    to fill (kept injectable so tests can force the partial-fill rescan
    branch with tiny files)."""
    size = stream.size
    lo = 0
    tgt = _segment_targets(target)
    while lo < size:
        scan_from = min(size, lo + next(tgt)) - 1
        found = None
        while found is None:
            avail = stream.filled()
            stream.wait_until(min(size, max(avail, scan_from + wait_slack)))
            avail = stream.filled()
            found = _find_record_start(stream.buf, scan_from, avail)
            if found is None:
                if avail >= size:
                    break
                # a boundary pair may straddle the fill point: rescan from it
                scan_from = max(scan_from, avail - 1)
        hi = found if found is not None else size
        yield (lo, hi)
        lo = hi


def _iter_pipelined_chunks(
    data,
    kmer_len: int,
    config: IndexConfig,
    sink: dict,
    target_segment: int = 192 << 20,
):
    """Yield packed device chunks while the NEXT segment decodes on a
    background thread — FASTA decode overlaps device upload/compute instead
    of running as a serial up-front stage. ``data`` may be bytes, an ndarray,
    or a :class:`_StreamingInput` (in which case the disk read overlaps too,
    and segment boundaries are discovered as bytes arrive — the wait happens
    on the decode worker, never the dispatch thread).

    ``sink`` receives "chromosomes" (list) and "total_bp" (int), complete
    once the generator is exhausted (i.e. after the accumulate loop)."""
    from ..io import native as _native
    from ..ops.encode import iter_chunks_packed_lazy, iter_chunks_prepacked

    if isinstance(data, _StreamingInput):
        buf = data.buf
        seg_iter = _iter_segments_streaming(data, target_segment)
    else:
        buf = data if isinstance(data, np.ndarray) else np.frombuffer(
            data, np.uint8
        )
        seg_iter = iter(_segment_record_bounds(buf, target_segment))
    headroom = config.chunk_windows + kmer_len
    packed_decode = getattr(_native, "_HAVE_PACKED_DECODE", False)

    def decode_next():
        # 2 decode threads at low priority: the dispatch thread must win the
        # cores whenever both are runnable (decode has slack, the device
        # queue does not). The packed
        # decode emits the device upload planes directly, so the dispatch
        # loop below does ZERO packing work — chunks are views.
        seg = next(seg_iter, None)  # streaming: may block for disk bytes
        if seg is None:
            return None
        lo, hi = seg
        if packed_decode:
            res = _native.fasta_decode_joined_packed_native(
                buf[lo:hi], kmer_len, threads=2, tail_headroom=headroom + 8
            )
            if res is not None:
                return ("packed", res)
        return ("codes", _native.fasta_decode_joined_native(
            buf[lo:hi], kmer_len, threads=2, tail_headroom=headroom
        ))

    sink["chromosomes"] = []
    sink["total_bp"] = 0
    # bounded producer: decode runs continuously up to 2 segments ahead of
    # dispatch (the old one-future-in-flight scheme stalled decode whenever
    # a segment finished mid-dispatch — measured ~2-3 s of gen-wait per
    # 840 Mbp run as transport bursts starved the niced decode threads)
    import queue as _queue
    import threading as _threading

    q: "_queue.Queue" = _queue.Queue(maxsize=2)
    dead = _threading.Event()  # consumer gone: unblock + stop the producer

    def _put(item) -> bool:
        while not dead.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except _queue.Full:
                pass
        return False

    def producer() -> None:
        from ..utils import renice_current_thread

        renice_current_thread(10)
        try:
            while True:
                nxt = decode_next()
                if not _put(("ok", nxt)) or nxt is None:
                    return
        except BaseException as exc:  # re-raised on the dispatch thread
            _put(("err", exc))

    prod = _threading.Thread(target=producer, daemon=True)
    prod.start()
    try:
        while True:
            status, nxt = q.get()
            if status == "err":
                raise nxt
            if nxt is None:
                prod.join()
                break
            kind, res = nxt
            if kind == "packed":
                bases, mask, n_codes, chroms, bp = res
                sink["chromosomes"].extend(chroms)
                sink["total_bp"] += bp
                if n_codes >= kmer_len:
                    yield from iter_chunks_prepacked(
                        bases, mask, n_codes, kmer_len, config.chunk_windows
                    )
                del bases, mask
            else:
                stream, chroms, bp = res
                sink["chromosomes"].extend(chroms)
                sink["total_bp"] += bp
                if stream.shape[0] >= kmer_len:
                    padded, n_chunks = chunk_stream(
                        stream, kmer_len, config.chunk_windows
                    )
                    yield from iter_chunks_packed_lazy(
                        padded, kmer_len, config.chunk_windows, n_chunks
                    )
                    del padded
                del stream
    finally:
        dead.set()  # abandoned mid-iteration: let the producer exit


def create_fasta_index(
    project_name: str,
    sample_name: str,
    input_file: str,
    kmer_len: int,
    overwrite: bool = True,
    config: Optional[IndexConfig] = None,
    verify: bool = True,
    verbose: bool = True,
) -> KinHeader:
    """Build one `.kin` index (single-host entry point).

    ``input_file`` may be ``"-"`` (or ``None``) to read the FASTA from stdin
    (reference indexer.py:104-110); outputs are then named after
    ``sample_name`` (``{sample_name}.{K:02d}.kin`` in the CWD) since there is
    no input path to derive them from.
    """
    from ..config import resolve_chunk_windows

    from_stdin = input_file is None or input_file == "-"
    hint = None
    if not from_stdin and os.path.exists(input_file):
        hint = os.path.getsize(input_file)
        if input_file.endswith((".gz", ".bgz")):
            hint *= 4  # conservative decompression ratio for base data
    config = resolve_chunk_windows(
        config or IndexConfig(kmer_len=kmer_len), input_hint_bytes=hint
    )
    assert config.kmer_len == kmer_len

    name_stem = sample_name if from_stdin else input_file
    input_file = None if from_stdin else input_file

    header = KinHeader(
        project_name,
        input_file=name_stem,
        kmer_len=kmer_len,
        flush_every=config.flush_every,
        min_frag_size=config.min_frag_size,
        max_frag_size=config.max_frag_size,
    )
    header.stream_input = from_stdin
    data_size = header.data_size
    if verbose:
        print(
            f"project_name {project_name} sample_name {sample_name} "
            f"kmer_len {kmer_len:15,d} kmer_size {data_size:15,d}"
        )

    kinfmt.remove_outputs(name_stem, kmer_len, overwrite)

    from ..utils.profiling import StageTimer

    stages = StageTimer()
    timer = header.timer

    from ..config import accumulate_strategy, device_bytes_limit

    strategy = accumulate_strategy(
        config.accumulate, kmer_len, config.chunk_windows,
        device_bytes_limit(),
    )

    have_native = True
    try:
        from ..io.native import fasta_decode_joined_native  # noqa: F401
    except ImportError:
        have_native = False

    plain = input_file is not None and not input_file.endswith((".gz", ".bgz"))
    streaming = (
        strategy == "device"
        and have_native
        and plain
        and os.path.getsize(input_file) > 0
    )

    import threading

    instream: Optional[_StreamingInput] = None
    ck_thread: Optional[threading.Thread] = None
    input_ck: dict = {}
    if streaming:
        # the reader + input-hash threads start here; decode and device
        # uploads chase them (no up-front whole-file read stage)
        with stages.stage("input read"):
            instream = _StreamingInput(input_file)
        data = instream
        pipelined = True
    else:
        raw: dict = {}
        with stages.stage("input read"):
            from ..io.fasta import open_input_bytes

            data = open_input_bytes(input_file)
        if plain or from_stdin:
            # stdin has no path to re-read: hash the in-memory bytes
            raw["bytes"] = data

        # input checksum in a background thread (hashlib releases the GIL):
        # overlaps the device accumulate + fetch phases; plain files hash the
        # buffer already in memory instead of paying a second cold disk read
        from ..utils.checksum import sha256_file

        def _hash_input() -> None:
            from ..utils import renice_current_thread

            renice_current_thread(10)  # provenance work: yield to transfers
            if "bytes" in raw:
                import hashlib as _hashlib

                input_ck["hex"] = _hashlib.sha256(raw["bytes"]).hexdigest()
                del raw["bytes"]
            else:
                input_ck["hex"] = sha256_file(header.input_file_path)

        ck_thread = threading.Thread(target=_hash_input, daemon=True)
        ck_thread.start()
        pipelined = strategy == "device" and have_native and len(data) > 0

    from ..utils.profiling import device_trace

    tmp = header.index_tmp_file
    # jax.profiler trace of the whole device pipeline when
    # PYKMER_TPU_TRACE_DIR is set (SURVEY §5: the device counterpart of the
    # reference's cProfile recipe, README.md:255-259); no-op otherwise
    with device_trace():
        if pipelined:
            # decode overlaps dispatch: segment i+1 decodes on a background
            # thread while segment i's chunks pack + upload + accumulate
            sink: dict = {}
            with stages.stage("decode + accumulate (pipelined)"):
                folded, num_kmers, escapes = _accumulate_device(
                    _iter_pipelined_chunks(data, kmer_len, config, sink),
                    kmer_len, config, data_size, verbose, stages,
                )
            chromosomes, total_bp = sink["chromosomes"], sink["total_bp"]
        else:
            with stages.stage("fasta decode + join"):
                stream, chromosomes, total_bp = _decode_joined_bytes(
                    data, kmer_len,
                    tail_headroom=config.chunk_windows + kmer_len,
                )
            if stream.shape[0] < kmer_len:
                raise ValueError(
                    f"{input_file}: no valid k-mers at K={kmer_len}"
                )
            with stages.stage("chunk framing"):
                padded, n_chunks = chunk_stream(
                    stream, kmer_len, config.chunk_windows
                )
            with stages.stage("device accumulate"):
                if strategy == "device":
                    from ..ops.encode import iter_chunks_packed_lazy

                    # folded counts stay ON DEVICE; the tail streams them out
                    folded, num_kmers, escapes = _accumulate_device(
                        iter_chunks_packed_lazy(
                            padded, kmer_len, config.chunk_windows, n_chunks
                        ),
                        kmer_len, config, data_size, verbose, stages,
                    )
                else:
                    escapes = None
                    folded, num_kmers = _accumulate_host(
                        padded, n_chunks, kmer_len, config, data_size, timer,
                        verbose,
                    )
            # the code stream is fully consumed (num_kmers sync drained the
            # dispatch queue) — release its pooled block before the output
            # plane allocates, so the pool can hand it straight back
            del padded, stream
        if num_kmers == 0:
            raise ValueError(f"{input_file}: no valid k-mers at K={kmer_len}")
        del data
        if instream is not None:
            # all input is consumed (the num_kmers sync drained dispatch) and
            # the hash thread trails the finished disk read by well under a
            # second — capture the provenance hash NOW and release the input
            # block back to the pool BEFORE the output plane allocates, so
            # the pool hands the same physical block straight back instead of
            # MAP_POPULATE-ing a fresh GiB while the input stays pinned
            input_ck["hex"] = instream.input_checksum()
            instream = None
        if verbose:
            print(f"  records {len(chromosomes):7,d} bp {total_bp:15,d}")
        if total_bp >= PRINT_EVERY:
            timer.update(total_bp)

        header.num_kmers = int(num_kmers)
        header.chromosomes = chromosomes
        with stages.stage("fetch + unfold + write"):
            # streaming tail: d2h slice transfers overlap host-side unpack +
            # escape patch + unfold into a hugepage RAM plane, with finished
            # regions pwritten to the tmp file from the same workers (disk
            # overlaps transfers; file mmaps are avoided — page faults run
            # ~3 MB/s here). 256-bin stats come from the half-size folded
            # plane (each folded pair adds its value plus exactly one
            # structural zero).
            from ..formats.header import fast_counts256
            from ..ops.readback import (
                _write_and_hash as _bulk_write_hash,
                stream_dense_to_out,
                unfold_canonical,
            )
            from ..utils.bigmem import big_empty

            from ..io.direct import DirectWriter

            import time as _t

            counts = None
            if isinstance(folded, tuple) and config.readback in ("auto",
                                                                 "sparse"):
                # K >= 17 arena-free fast path: every sub-plane sparse-
                # eligible ⇒ segments decode into pooled piece buffers that
                # are pwritten + hashed directly — no 4^K host arena to
                # fault in
                from ..ops.readback import stream_sparse_planes_pieces

                plane_list = list(folded)
                _tw = _t.monotonic()
                with DirectWriter(tmp, size=data_size) as fd:
                    res = stream_sparse_planes_pieces(
                        plane_list, kmer_len, fd, tmp, escapes,
                        hash_out=True,
                    )
                if res is not None:
                    counts, output_ck = res
                    counts = counts.copy()
                    counts[0] += data_size // 2
                    folded = None
                    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
                        import sys as _sys

                        print(f"  pieces unfold+write+hash: "
                              f"{_t.monotonic() - _tw:8.1f}s",
                              file=_sys.stderr)
                del plane_list

            if counts is None:
                _ta = _t.monotonic()
                out = big_empty(data_size)
                _tb = _t.monotonic()
                if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
                    import sys as _sys

                    print(f"  out alloc: {_tb - _ta:8.1f}s", file=_sys.stderr)
                with DirectWriter(tmp, size=data_size) as fd:
                    _tw = _t.monotonic()
                    if isinstance(folded, np.ndarray):
                        counts = fast_counts256(folded).copy()
                        unfold_canonical(folded, kmer_len, out=out)
                        output_ck = _bulk_write_hash(fd, out)
                    elif isinstance(folded, tuple):
                        # K >= 17: tuple of folded sub-planes. Hand
                        # ownership to the streamer as a list so each
                        # sub-plane's device memory frees as soon as it is
                        # unfolded. One chase sink spans all sub-planes:
                        # write + hash follow the unfolds across plane
                        # boundaries instead of a trailing serial 4^K-byte
                        # pass.
                        from ..ops.readback import stream_dense_planes_to_out

                        plane_list, folded = list(folded), None
                        counts, output_ck = stream_dense_planes_to_out(
                            plane_list, kmer_len, out, mode=config.readback,
                            escapes=escapes, fd=fd, hash_out=True,
                        )
                        counts = counts.copy()
                        del plane_list
                    else:
                        # write + sha256 CHASE the unfold slice-by-slice
                        # inside the readback (stream_dense_to_out chase
                        # mode) — no serial whole-plane write+hash pass after
                        counts, output_ck = stream_dense_to_out(
                            folded, kmer_len, out, mode=config.readback,
                            escapes=escapes, fd=fd, hash_out=True,
                        )
                        counts = counts.copy()
                    counts[0] += data_size // 2
                    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
                        import sys as _sys

                        print(f"  unfold+write+hash: "
                              f"{_t.monotonic() - _tw:8.1f}s",
                              file=_sys.stderr)
                del out
    with stages.stage("metadata"):
        if ck_thread is not None:
            ck_thread.join()
        header.write_metadata(
            tmp,
            stats_counts256=counts,
            input_checksum=input_ck.get("hex"),
            output_checksum=output_ck,
        )

    if verify:
        # reference's end-to-end invariant (indexer.py:406-407): stats derived
        # from the written file must equal the in-memory ones
        with stages.stage("verify"):
            fresh = KinHeader(project_name, input_file=name_stem, kmer_len=kmer_len)
            fresh.update_stats_from_file(tmp)
            if fresh.hist != header.hist or fresh.vals_sum != header.vals_sum:
                raise AssertionError("written .kin does not match computed stats")

    os.rename(tmp, header.index_file_root)
    if os.environ.get("PYKMER_TPU_STAGE_TIMING"):
        import sys

        print("stage timing:\n" + stages.report(), file=sys.stderr)
    if verbose:
        print("done")
    return header


def _max_sweep_cells() -> int:
    """Per-sub-plane cell budget of the folded plane (env-overridable so
    tests can force the multi-plane path at tiny K on the CPU backend)."""
    env = os.environ.get("PYKMER_TPU_MAX_SWEEP_CELLS")
    if env:
        return int(env)
    from ..ops.histogram import MAX_SWEEP_CELLS

    return MAX_SWEEP_CELLS


def _n_planes(fold_size: int) -> int:
    """Number of contiguous sub-planes the folded space splits into (1 =
    single-array fast path; >1 = tuple of sub-planes for K >= 17)."""
    mx = _max_sweep_cells()
    if fold_size <= mx:
        return 1
    if fold_size % mx != 0:
        raise ValueError(
            f"folded count space ({fold_size:,} cells) is not divisible by "
            f"the per-sub-plane budget ({mx:,}); PYKMER_TPU_MAX_SWEEP_CELLS "
            f"must be a power of 4 dividing 4^K/2 (or unset to use the default)"
        )
    return fold_size // mx


def _make_chunk_sorted_codes(kmer_len: int, span: int, masked: bool = True):
    """Resolve the encoder choice (env-sensitive) OUTSIDE the build cache
    so PYKMER_TPU_ENCODER participates in the cache key."""
    from ..ops.encode import use_packed_encoder

    return _make_chunk_sorted_codes_cached(
        kmer_len, span, masked, use_packed_encoder(kmer_len, masked)
    )


@functools.lru_cache(maxsize=None)
def _make_chunk_sorted_codes_cached(
    kmer_len: int, span: int, masked: bool, packed_encode: bool
):
    """Program A of the split per-chunk step: unpack -> encode -> fold ->
    sort (+ the k-mer counter update, carried donated on device).

    Module-level cache: one compiled executable per (K, span, masked,
    encoder) — a fresh ``jax.jit`` closure per run would recompile, because
    donated buffers' layouts bake into a new closure's cache key.

    The step is split in two programs (encode + sort | apply): the dispatch
    queue pipelines A and B back to back, and the split lets each be timed
    on its own (scripts/bench_device_step.py).

    ``masked=False`` is the all-valid variant: chunks with no Ns, record
    separators, or padding skip the validity-bitmap upload (1 bit/base)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..ops.encode import (
        canonical_codes,
        canonical_codes_packed,
        fold_codes,
        unpack_base_2bit,
        unpack_base_2bit_mask,
    )

    from ..ops.histogram import sort_codes_fast

    fold_size = 4**kmer_len // 2
    sort_dt = jnp.int32 if fold_size <= np.iinfo(np.int32).max else jnp.int64
    # Encoder choice: ops.encode.use_packed_encoder (both encoders are
    # bit-exact and tested).

    def tail(nk, codes):
        sorted_codes = sort_codes_fast(codes.astype(sort_dt))
        # chunks are < 2^31 windows, so an int32 count is exact; it is
        # promoted once into the int64 counter
        nvalid = (codes < fold_size).sum(dtype=jnp.int32)
        return sorted_codes, nk + nvalid

    if masked:

        def step(nk, bases2, maskbits):
            # chunks arrive as 2-bit bases + validity bitmap (0.375 B/base
            # of upload); the unpack fuses into the encode
            if packed_encode:
                codes = canonical_codes_packed(
                    bases2, maskbits, span, kmer_len
                )
            else:
                codes = fold_codes(
                    canonical_codes(
                        unpack_base_2bit_mask(bases2, maskbits, span),
                        kmer_len,
                    ),
                    kmer_len,
                )
            return tail(nk, codes)

    else:

        def step(nk, bases2):
            # all-valid chunk: 0.25 B/base of upload, no mask
            if packed_encode:
                codes = canonical_codes_packed(bases2, None, span, kmer_len)
            else:
                codes = fold_codes(
                    canonical_codes(unpack_base_2bit(bases2, span), kmer_len),
                    kmer_len,
                )
            return tail(nk, codes)

    return jax.jit(step, donate_argnums=(0,))


@functools.lru_cache(maxsize=None)
def _make_apply(kmer_len: int, n_planes: int = 1):
    """Program B of the split step: saturating-apply one sorted batch to the
    dense folded plane (or sub-plane tuple), with the plane donated so it
    updates in place. The sorted codes are not donated: no output has their
    shape and dtype, so their buffer could never be reused."""
    import jax
    import jax.numpy as jnp

    from ..ops.histogram import (
        accumulate_sorted_planes,
        saturating_accumulate_sorted,
    )

    fold_size = 4**kmer_len // 2

    if n_planes > 1:

        def step(dense, sorted_codes):
            # folded space beyond one sub-plane (K >= 17): dense is a TUPLE
            # of contiguous sub-planes. Second output = NON-donated readiness
            # signal: the dispatch loop blocks on the one from a few steps
            # back to bound how many in-flight step working sets can stack
            # on top of the plane tuple.
            out = accumulate_sorted_planes(dense, sorted_codes)
            return out, (sorted_codes[:1]).astype(jnp.int32)

    else:

        def step(dense, sorted_codes):
            flat = dense.reshape(-1)
            flat, _ = saturating_accumulate_sorted(
                flat, sorted_codes, sentinel=fold_size
            )
            return flat.reshape(dense.shape)

    return jax.jit(step, donate_argnums=(0,))


def preload_index_programs(kmer_len: int, config: Optional[IndexConfig] = None):
    """Compile and load both per-chunk step executables (masked +
    all-valid) up front.

    Services/benchmarks call this once (with ops.readback.preload_programs)
    so no timed run pays a compile or an executable load — notably the
    all-valid step, which only triggers on chunks without Ns/separators and
    so would otherwise load mid-pipeline."""
    import jax
    import jax.numpy as jnp

    from ..config import resolve_chunk_windows

    config = resolve_chunk_windows(config or IndexConfig(kmer_len=kmer_len))
    fold_size = 4**kmer_len // 2
    n_planes = _n_planes(fold_size)
    span = config.chunk_windows + kmer_len - 1
    step_a = _make_chunk_sorted_codes(kmer_len, span)
    step_a_av = _make_chunk_sorted_codes(kmer_len, span, masked=False)
    step_b = _make_apply(kmer_len, n_planes=n_planes)
    from ..ops.histogram import dense_plane_shape

    if n_planes > 1:
        per = fold_size // n_planes
        dense = tuple(
            jnp.zeros(dense_plane_shape(per), dtype=jnp.uint8)
            for _ in range(n_planes)
        )
    else:
        dense = jnp.zeros(dense_plane_shape(fold_size), dtype=jnp.uint8)
    nk = jnp.zeros((), dtype=jnp.int64)
    bases = jnp.zeros(((span + 3) // 4,), dtype=jnp.uint8)
    mask = jnp.zeros(((span + 7) // 8,), dtype=jnp.uint8)
    codes, nk = step_a(nk, bases, mask)
    res = step_b(dense, codes)
    dense = res[0] if n_planes > 1 else res
    codes, nk = step_a_av(nk, bases)
    res = step_b(dense, codes)
    jax.block_until_ready(res)
    del dense, nk, codes, res


def _accumulate_device(
    chunks,
    kmer_len: int,
    config: IndexConfig,
    data_size: int,
    verbose: bool,
    stages=None,
):
    import jax.numpy as jnp

    # counts accumulate in the folded half-space min(c, M-c) — half the
    # device memory, half the per-batch apply traffic, half the readback
    # bytes; returns the ON-DEVICE folded plane, which the caller streams
    # straight into the output file (see ops.encode.fold_codes,
    # ops.readback.stream_dense_to_out).
    # Folded spaces beyond one sub-plane (K >= 17) are carried as a TUPLE of
    # 2^30-cell sub-planes (ops.histogram.accumulate_sorted_planes) and
    # returned as that tuple for readback.stream_dense_planes_to_out.
    fold_size = data_size // 2
    n_planes = _n_planes(fold_size)
    # the dense array lives 2D [D/128, 128] on device, the layout the
    # readback's pack programs consume in place
    two_d = fold_size % 128 == 0
    span = config.chunk_windows + kmer_len - 1

    # fully asynchronous dispatch: the k-mer counter is carried on-device and
    # fetched once at the end — any mid-stream sync stalls the pipeline
    step_a_jit = _make_chunk_sorted_codes(kmer_len, span)
    step_a_av_jit = _make_chunk_sorted_codes(kmer_len, span, masked=False)
    step_b_jit = _make_apply(kmer_len, n_planes=n_planes)

    from ..utils.profiling import StageTimer

    stages = stages or StageTimer()
    with stages.stage("dense init"):
        from ..ops.histogram import dense_plane_shape

        if n_planes > 1:
            per = fold_size // n_planes
            dense = tuple(
                jnp.zeros(dense_plane_shape(per), dtype=jnp.uint8)
                for _ in range(n_planes)
            )
        else:
            dense = jnp.zeros(
                dense_plane_shape(fold_size) if two_d else (fold_size,),
                dtype=jnp.uint8,
            )
        nk = jnp.zeros((), dtype=jnp.int64)

    timing = bool(os.environ.get("PYKMER_TPU_STAGE_TIMING"))
    t_gen = t_h2d = t_disp = 0.0
    with stages.stage("step dispatch"):
        import collections
        import time as _t

        # n_planes > 1: rolling in-flight bound (see _make_apply)
        sigs: collections.deque = collections.deque()
        max_inflight = 4

        done_windows = 0
        it = iter(chunks)
        while True:
            _t0 = _t.monotonic()
            nxt = next(it, None)
            t_gen += _t.monotonic() - _t0
            if nxt is None:
                break
            bases2, maskbits = nxt
            _t0 = _t.monotonic()
            dev_b = jnp.asarray(bases2)
            dev_m = None if maskbits is None else jnp.asarray(maskbits)
            t_h2d += _t.monotonic() - _t0
            _t0 = _t.monotonic()
            if dev_m is None:
                codes, nk = step_a_av_jit(nk, dev_b)
            else:
                codes, nk = step_a_jit(nk, dev_b, dev_m)
            if n_planes > 1:
                dense, sig = step_b_jit(dense, codes)
                sigs.append(sig)
                if len(sigs) > max_inflight:
                    sigs.popleft().block_until_ready()
            else:
                dense = step_b_jit(dense, codes)
            t_disp += _t.monotonic() - _t0
            done_windows += config.chunk_windows
            if verbose and done_windows > config.chunk_windows:
                print(f"  dispatched windows {done_windows:15,d}")
        sigs.clear()
    if timing:
        import sys as _sys

        print(
            f"  dispatch: gen-wait {t_gen:6.1f}s  h2d {t_h2d:6.1f}s  "
            f"step {t_disp:6.1f}s",
            file=_sys.stderr,
        )
    # queue the readback's escape-count pass behind the last step BEFORE
    # draining the dispatch queue: its scalars ride back with the sync
    # instead of paying their own round trip when the readback starts
    escapes = None
    if n_planes > 1:
        from ..ops.readback import count_all_escapes

        if (fold_size // n_planes) % 256 == 0:
            escapes = [count_all_escapes(p) for p in dense]
    elif fold_size % 256 == 0 and fold_size >= (1 << 26):
        from ..ops.readback import count_all_escapes

        escapes = count_all_escapes(dense)
    with stages.stage("num_kmers sync"):
        num_kmers = int(nk)
    if timing:
        import jax
        import sys as _sys

        stats = jax.local_devices()[0].memory_stats()
        if stats:
            print(f"  device peak bytes in use: "
                  f"{stats.get('peak_bytes_in_use', 0):,}", file=_sys.stderr)
    return dense, num_kmers, escapes


def _accumulate_host(
    padded: np.ndarray,
    n_chunks: int,
    kmer_len: int,
    config: IndexConfig,
    data_size: int,
    timer: Timer,
    verbose: bool,
) -> Tuple[np.ndarray, int]:
    """Host-RAM dense array; device computes + sorts codes per chunk.

    For count spaces exceeding device memory (K=17: 17 GiB). The device
    returns sorted *folded* codes (min(c, M-c) — halves the host array to
    8.5 GiB at K=17); the host applies a saturating segment update and
    returns the folded plane for the caller to expand into the output file.
    """
    import jax.numpy as jnp

    from ..ops.encode import iter_chunks_packed_lazy

    span = config.chunk_windows + kmer_len - 1
    fold_size = data_size // 2
    encode_jit = _make_encode_sort(kmer_len, span)
    encode_av_jit = _make_encode_sort(kmer_len, span, masked=False)

    from ..utils.bigmem import big_zeros

    dense = big_zeros(fold_size)
    num_kmers = 0
    for bases2, maskbits in iter_chunks_packed_lazy(
        padded, kmer_len, config.chunk_windows, n_chunks
    ):
        sorted_codes = np.asarray(
            encode_av_jit(jnp.asarray(bases2))
            if maskbits is None
            else encode_jit(jnp.asarray(bases2), jnp.asarray(maskbits))
        )
        valid = sorted_codes[sorted_codes < fold_size]
        num_kmers += int(valid.shape[0])
        if valid.shape[0] == 0:
            continue
        uniq, counts = _unique_sorted(valid)
        old = dense[uniq].astype(np.int64)
        dense[uniq] = np.minimum(old + np.minimum(counts, 255), 255).astype(np.uint8)
    return dense, num_kmers


def _make_encode_sort(kmer_len: int, span: int, masked: bool = True):
    """Env-sensitive encoder resolved outside the cache, as above."""
    from ..ops.encode import use_packed_encoder

    return _make_encode_sort_cached(
        kmer_len, span, masked, use_packed_encoder(kmer_len, masked)
    )


@functools.lru_cache(maxsize=None)
def _make_encode_sort_cached(
    kmer_len: int, span: int, masked: bool, packed_encode: bool
):
    """Jitted encode+sort for the host strategy — cached like _make_chunk_sorted_codes."""
    import jax
    import jax.numpy as jnp

    from ..ops.encode import (
        canonical_codes,
        fold_codes,
        unpack_base_2bit,
        unpack_base_2bit_mask,
    )

    from ..ops.encode import canonical_codes_packed
    from ..ops.histogram import sort_codes_fast as fast_sort

    if masked:

        def encode_sort(bases2, maskbits):
            if packed_encode:
                codes = canonical_codes_packed(
                    bases2, maskbits, span, kmer_len
                )
            else:
                codes = fold_codes(
                    canonical_codes(
                        unpack_base_2bit_mask(bases2, maskbits, span),
                        kmer_len,
                    ),
                    kmer_len,
                )
            return fast_sort(codes)

    else:

        def encode_sort(bases2):
            if packed_encode:
                codes = canonical_codes_packed(bases2, None, span, kmer_len)
            else:
                codes = fold_codes(
                    canonical_codes(unpack_base_2bit(bases2, span), kmer_len),
                    kmer_len,
                )
            return fast_sort(codes)

    return jax.jit(encode_sort)


def _unique_sorted(sorted_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """np.unique(return_counts) specialised for an already-sorted array."""
    is_start = np.empty(sorted_vals.shape[0], dtype=bool)
    is_start[0] = True
    np.not_equal(sorted_vals[1:], sorted_vals[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    counts = np.diff(np.append(starts, sorted_vals.shape[0]))
    return sorted_vals[starts], counts
