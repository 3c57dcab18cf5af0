"""Multi-host orchestration (jax.distributed glue).

Replaces the reference's "filesystem as interconnect" model (SURVEY §2.3):
hosts join one jax.distributed job; the global mesh puts the host boundary
on the 'data' axis so chip-to-chip code exchange stays on the host's
card-to-card links and only input spraying crosses the network. Each host
feeds its own slice of the input stream (every host reads its local FASTA
portion), and the saturating-histogram semantics make the cross-host merge
exact:

    min(sum_h min(c_h, 255), 255) == min(sum_h c_h, 255)

so per-host partial dense shards combine with a saturating u16 add at
finalize (`combine_partial_dense`) — bit-identical to a single-host run
regardless of how the stream was split (proved in tests/test_parallel.py and
tests/test_multihost.py).

Checkpoint/resume: `save_shard_checkpoint` / `load_shard_checkpoint` persist
the dense shards + stream cursor so a killed K=17 multi-host build resumes
from the last flush instead of restarting (the reference can only restart
whole files, SURVEY §5).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the jax.distributed job (no-op for single-process runs).

    Arguments default to the standard JAX env vars; call before any backend
    use on every host.
    """
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def host_slice(total: int, process_id: int, num_processes: int) -> Tuple[int, int]:
    """Contiguous [start, end) slice of ``total`` work items for this host."""
    per = (total + num_processes - 1) // num_processes
    start = min(process_id * per, total)
    return start, min(start + per, total)


def _record_boundary(read_at, total: int, target: int) -> int:
    """First record start (a ``>`` preceded by ``\\n``) at or after
    ``target`` in a ``total``-byte source accessed via ``read_at(off, n)``.
    Deterministic given the content, so every host computes every boundary
    identically."""
    if target <= 0:
        return 0
    if target >= total:
        return total
    win = 8 << 20
    pos = target - 1  # a '>' AT target needs its preceding newline
    while pos < total - 1:
        buf = read_at(pos, min(win, total - pos))
        hits = np.flatnonzero(buf[1:] == ord(">"))
        for h in hits:
            if buf[h] == ord("\n"):
                return pos + int(h) + 1
        if pos + buf.shape[0] >= total:
            break
        pos += buf.shape[0] - 1
    return total


def host_byte_slice(
    path: str, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Record-aligned byte range [lo, hi) of a plain FASTA for this host.

    Boundaries are the first record start (``>`` at a line start) at or
    after ``size * pid / nproc``, found by scanning a small window of the
    raw file — every host computes every boundary with the same
    deterministic scan, so adjacent hosts always agree. Records never span
    ranges and windows never span records (the joined stream poisons
    inter-record windows), so per-host decode of just this byte range
    yields exactly this host's share of the global window set: each host
    reads O(size / nproc) instead of the whole file (VERDICT r2 #3b).
    """
    size = os.path.getsize(path)
    if num_processes <= 1:
        return 0, size
    with open(path, "rb") as fh:

        def read_at(off: int, n: int) -> np.ndarray:
            fh.seek(off)
            return np.frombuffer(fh.read(n), np.uint8)

        per = size / num_processes
        lo = _record_boundary(read_at, size, int(per * process_id))
        hi = _record_boundary(read_at, size, int(per * (process_id + 1)))
    return lo, hi


def host_byte_slice_bgzf(
    reader, process_id: int, num_processes: int
) -> Tuple[int, int]:
    """Record-aligned UNCOMPRESSED byte range of a BGZF FASTA.

    ``reader`` is an io.bgzf.BgzfRangeReader: the GZI (or header-scan)
    block index gives random access into the uncompressed stream, so
    byte-range input splitting works for `.fa.bgz` inputs too — each host
    inflates only the blocks covering its slice plus the boundary-scan
    windows, instead of the r3-era full-decode fallback. (Plain `.gz` has
    no block structure and keeps the fallback.)
    """
    total = reader.index.uncompressed_size
    if num_processes <= 1:
        return 0, total

    def read_at(off: int, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint8)
        got = reader.read_into(out, off)
        return out[:got]

    per = total / num_processes
    lo = _record_boundary(read_at, total, int(per * process_id))
    hi = _record_boundary(read_at, total, int(per * (process_id + 1)))
    return lo, hi


def allgather_small_json(obj) -> list:
    """All-gather one small JSON-serialisable object per process; returns
    the per-process list in pid order. (multihost_utils.process_allgather
    needs equal shapes, so lengths gather first, then padded payloads.)"""
    import json as _json

    import jax
    from jax.experimental import multihost_utils

    if jax.process_count() == 1:
        return [obj]
    payload = np.frombuffer(
        _json.dumps(obj).encode("utf-8"), dtype=np.uint8
    ).copy()
    lens = multihost_utils.process_allgather(
        np.asarray([payload.shape[0]], dtype=np.int64)
    ).reshape(-1)
    cap = int(lens.max())
    padded = np.zeros(cap, dtype=np.uint8)
    padded[: payload.shape[0]] = payload
    gathered = multihost_utils.process_allgather(padded)
    return [
        _json.loads(bytes(gathered[p, : int(lens[p])]).decode("utf-8"))
        for p in range(gathered.shape[0])
    ]


def make_slab_combine(gmesh):
    """jitted saturating cross-host combine of one slab, output sharded
    over ALL devices (host-major) — XLA lowers the sum + constraint to a
    reduce-scatter, so no device ever materialises the full slab in uint16
    (a replicated combine would need fold_size x u16 + u8 per device:
    24 GiB at K=17).

    Per-device peak for a slab of S cells on an (H, D) mesh:
    S/D u8 in + ~2*S/D u16 working + S/(H*D) u8 out  (~3 GiB at S=2^30,
    D=1). The multi-host indexer loops fold_size/S slabs.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    axes = tuple(gmesh.axis_names)  # ("host", "d")

    @jax.jit
    def combine(a):  # a: (H, S) sharded P("host", "d")
        s = jnp.minimum(
            jnp.sum(a.astype(jnp.uint16), axis=0), 255
        ).astype(jnp.uint8)
        return jax.lax.with_sharding_constraint(
            s, NamedSharding(gmesh, P(axes))
        )

    return combine


def combine_partials_sharded(
    partial: np.ndarray,
    slab_cells: int = 1 << 30,
) -> Optional[List[Tuple[int, np.ndarray]]]:
    """Saturating cross-host merge of per-host partial folded planes,
    returning only THIS host's owner pieces.

    Returns a list of (global_offset, cells) pairs — per slab of
    ``slab_cells``, host h owns the slab's cells [h*S/H, (h+1)*S/H), so no
    device (or host) ever materialises the whole combined plane (VERDICT r2
    #3c; device memory math in make_slab_combine). The pieces are disjoint
    and cover the plane across hosts; the sharded writer unfolds and
    pwrites each independently. Exact: uint16 psum + clip == min(sum, 255)
    for <= 257 hosts. Returns ``None`` when the plane does not split evenly
    over the global devices (tiny K) — callers fall back to the replicated
    combine, which is what a plane that small wants anyway.
    """
    import jax
    from jax.experimental import multihost_utils
    from jax.sharding import Mesh, PartitionSpec as P

    nproc = jax.process_count()
    fold_size = partial.shape[0]
    if nproc == 1:
        return [(0, partial)]
    assert nproc <= 257, "uint16 saturating combine is exact for <= 257 hosts"
    ldc = jax.local_device_count()
    step = nproc * ldc
    if fold_size % step:
        return None
    devs = np.array(jax.devices()).reshape(nproc, ldc)
    gmesh = Mesh(devs, ("host", "d"))
    combine = make_slab_combine(gmesh)
    pid = jax.process_index()

    # slabs split evenly over the (host-major) device shards
    slab = min(slab_cells, fold_size)
    slab = max(slab // step * step, step)
    pieces: List[Tuple[int, np.ndarray]] = []
    for s0 in range(0, fold_size, slab):
        s1 = min(s0 + slab, fold_size)
        cur = s1 - s0
        garr = multihost_utils.host_local_array_to_global_array(
            partial[s0:s1].reshape(1, cur), gmesh, P("host", "d")
        )
        combined = combine(garr)
        # this host's addressable shards form one contiguous flat range of
        # the slab; its offset is taken from the ACTUAL shard indices (not
        # pid arithmetic, which silently assumes jax.devices() is host-major
        # — a topology grouping device ids differently would otherwise
        # pwrite the piece at the wrong file offset)
        shards = sorted(
            combined.addressable_shards, key=lambda sh: sh.index[0].start
        )
        starts = [sh.index[0].start for sh in shards]
        lens = [int(np.prod(sh.data.shape)) for sh in shards]
        for i in range(1, len(shards)):
            assert starts[i] == starts[i - 1] + lens[i - 1], (
                "non-contiguous addressable shard ranges", starts, lens)
        piece = np.concatenate([np.asarray(sh.data) for sh in shards])
        assert piece.shape[0] == cur // nproc
        pieces.append((s0 + starts[0], piece))
    return pieces


def combine_partial_dense(parts: List[np.ndarray]) -> np.ndarray:
    """Saturating elementwise merge of per-host partial dense arrays.

    Exact because saturating adds of clipped partial counts compose to
    min(total, 255) (see module docstring); u16 intermediate is safe for up
    to 257 partials.
    """
    assert len(parts) <= 257
    acc = np.zeros_like(parts[0], dtype=np.uint16)
    for p in parts:
        assert p.dtype == np.uint8
        acc += p
    return np.minimum(acc, 255).astype(np.uint8)


# ---- shard checkpoints ------------------------------------------------------

def checkpoint_dir(index_tmp_file: str) -> str:
    return index_tmp_file + ".ckpt"


def save_shard_checkpoint(
    index_tmp_file: str,
    dense_shards: np.ndarray,
    next_step: int,
    num_kmers: int,
    meta: Optional[dict] = None,
    max_bucket: int = 0,
) -> None:
    """Atomically persist sharded progress.

    The dense plane lands in a STEP-TAGGED file (``dense.<step>.npy``) and
    the committed ``state.json`` names it: the state rename is the single
    commit point, so a crash anywhere in this function leaves the previous
    (state, dense) pair fully consistent. (The earlier two-rename scheme
    had a window where a new plane paired with an old cursor — resume
    would then replay chunks into an already-advanced plane and inflate
    every unsaturated count. r3 review finding.) Superseded dense files
    are pruned after the commit.

    ``max_bucket`` — the running exchange-bucket high-water mark — rides
    along so the post-run overflow check still sees pre-checkpoint
    overflow after a resume (dropped k-mers would otherwise pass
    verification silently).
    """
    d = checkpoint_dir(index_tmp_file)
    os.makedirs(d, exist_ok=True)
    data_name = f"dense.{next_step}.npy"
    data_path = os.path.join(d, data_name)
    with open(data_path + ".tmp", "wb") as fh:
        np.save(fh, dense_shards, allow_pickle=False)
    os.rename(data_path + ".tmp", data_path)
    state = {"next_step": next_step, "num_kmers": num_kmers,
             "dense_file": data_name, "max_bucket": int(max_bucket)}
    state.update(meta or {})
    state_path = os.path.join(d, "state.json")
    with open(state_path + ".tmp", "wt") as fh:
        json.dump(state, fh, indent=1, sort_keys=True)
    os.rename(state_path + ".tmp", state_path)
    for name in os.listdir(d):
        if name.startswith("dense.") and name.endswith(".npy") \
                and name != data_name:
            try:
                os.remove(os.path.join(d, name))
            except OSError:
                pass


def load_shard_checkpoint(
    index_tmp_file: str,
) -> Optional[Tuple[np.ndarray, dict]]:
    d = checkpoint_dir(index_tmp_file)
    state_path = os.path.join(d, "state.json")
    if not os.path.exists(state_path):
        return None
    with open(state_path) as fh:
        state = json.load(fh)
    # legacy (pre-step-tag) checkpoints named the plane dense.npy
    data_path = os.path.join(d, state.get("dense_file", "dense.npy"))
    if not os.path.exists(data_path):
        return None
    dense = np.load(data_path)
    return dense, state


def clear_shard_checkpoint(index_tmp_file: str) -> None:
    import shutil

    d = checkpoint_dir(index_tmp_file)
    if os.path.exists(d):
        shutil.rmtree(d)
