"""Per-chunk device programs, timed one by one on the first device.

The indexer's per-chunk step is two jitted programs (index/indexer.py):
  A : unpack the 2-bit bases -> canonical codes -> fold -> sort
      (``_make_chunk_sorted_codes``; masked and all-valid variants)
  B : saturating apply of the sorted codes to the folded plane
      (``_make_apply``; one plane at K <= 15, a tuple of 2^30-cell
      sub-planes at K >= 17)

Each program is timed on its own at the shipping shapes, from dispatch to
``block_until_ready``, best of a few trials after a compile-and-warm call.
One JSON line per (K, chunk windows) goes to stdout; the chunk size the
config ships is the one with the best windows/s (A masked + B).

Usage: python scripts/bench_device_step.py [K:windows ...]
       (default: 15:2^22 15:2^24 17:2^22 17:2^24 17:2^26)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

DEFAULT_CASES = ((15, 1 << 22), (15, 1 << 24),
                 (17, 1 << 22), (17, 1 << 24), (17, 1 << 26))


def best_time(fn, trials: int = 5) -> float:
    """Best-of-trials seconds of ``fn()``, which must block until its
    device work is done."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def time_programs(kmer_len: int, windows: int) -> dict:
    import jax
    import jax.numpy as jnp

    from pykmer_tpu.index.indexer import (
        _make_apply,
        _make_chunk_sorted_codes,
        _n_planes,
    )
    from pykmer_tpu.ops.encode import pack_base_stream
    from pykmer_tpu.ops.histogram import dense_plane_shape

    fold = 4**kmer_len // 2
    n_planes = _n_planes(fold)
    span = windows + kmer_len - 1
    step_a = _make_chunk_sorted_codes(kmer_len, span, masked=True)
    step_a_av = _make_chunk_sorted_codes(kmer_len, span, masked=False)
    step_b = _make_apply(kmer_len, n_planes=n_planes)

    rng = np.random.default_rng(7)
    bases2, mask = pack_base_stream(
        rng.integers(0, 4, size=span).astype(np.uint8))
    dev_b, dev_m = jnp.asarray(bases2), jnp.asarray(mask)
    per = fold // n_planes
    dense = tuple(jnp.zeros(dense_plane_shape(per), jnp.uint8)
                  for _ in range(n_planes))
    if n_planes == 1:
        dense = dense[0]
    state = {"dense": dense, "nk": jnp.zeros((), jnp.int64)}

    def run_a(masked: bool):
        if masked:
            codes, state["nk"] = step_a(state["nk"], dev_b, dev_m)
        else:
            codes, state["nk"] = step_a_av(state["nk"], dev_b)
        return jax.block_until_ready(codes)

    def run_b(codes):
        out = step_b(state["dense"], codes)
        state["dense"] = out[0] if n_planes > 1 else out
        jax.block_until_ready(state["dense"])

    t0 = time.perf_counter()
    codes = run_a(True)
    run_a(False)
    run_b(codes)
    compile_s = time.perf_counter() - t0

    a_masked = best_time(lambda: run_a(True))
    a_allvalid = best_time(lambda: run_a(False))
    codes = run_a(True)
    b = best_time(lambda: run_b(codes))
    stats = jax.local_devices()[0].memory_stats() or {}
    del state, codes
    return {
        "K": kmer_len,
        "chunk_windows": windows,
        "sub_planes": n_planes,
        "compile_and_warm_s": compile_s,
        "a_masked_ms": a_masked * 1e3,
        "a_allvalid_ms": a_allvalid * 1e3,
        "b_ms": b * 1e3,
        "windows_per_s_masked": windows / (a_masked + b),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }


def main(argv) -> int:
    import jax

    from pykmer_tpu import _jax_setup

    _jax_setup.ensure_x64()
    if jax.default_backend() == "cpu":
        print("no accelerator: device programs are timed on the card only",
              file=sys.stderr)
        return 1
    cases = DEFAULT_CASES
    if argv:
        cases = [tuple(int(x) for x in a.split(":")) for a in argv]
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    for k, w in cases:
        row = time_programs(k, w)
        row["device"] = device
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
