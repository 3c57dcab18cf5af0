#!/usr/bin/env python3
"""Smoke run of the main path on the GPU, checked byte for byte.

    python chip_smoke.py               # one card
    python chip_smoke.py --multi-gpu   # the sharded path on four cards

This process never imports JAX. It generates two genomes from fixed seeds
(``bench.make_genome``), runs each phase as a child ``python -m pykmer_tpu
...`` with ``PYKMER_TPU_STAGE_TIMING=1``, one child at a time so that one
process holds the card(s), and checks every output against a plain NumPy
reference that uses neither ``pykmer_tpu.ops`` nor JAX:

- A: repeat-rich, 840 Mbp, seed 0 (the reference's headline tomato-size run;
  its repeats saturate cells at 255 and make the readback escape-dense);
- B: uniform, 200 Mbp, seed 1.

One card: ``index`` of A and B at K=15 (each whole 4^15-byte ``.kin``
compared cell for cell, ``.kin.json`` counts and histogram checked), ``index``
of B at K=17 (the 8 GiB folded plane stays on the card; every cell at the
reference's unique canonical codes is checked, and the nonzero-cell count
must equal the number of unique codes), ``merge --engine device`` of the two
K=15 planes (the ``.kma`` triples against ``oracle_pair_counts``) and
``distance``. With ``--multi-gpu`` only the sharded phases run: ``index
--shards 4``, ``--shards 2 --data-parallel 2``, K=17 ``--shards 4`` and
``merge --shards 4 --engine device``, each against the same reference.

Every child runs with ``JAX_PLATFORMS=cuda``, so a CUDA plugin that fails to
load stops it instead of falling back to the CPU. Any failed check exits
non-zero without the result line; the last line of a passing run is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Child logs go to ``chip_smoke_data/logs/``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
# the children's environment: taken before bench's import adjusts ours
BASE_ENV = dict(os.environ)
WORK = os.path.join(REPO, "chip_smoke_data")

A_BP = 840_000_000
B_BP = 200_000_000
K_SMALL = 15
K_LARGE = 17
PLATFORM = "gpu"  # jax.default_backend() every child must report
CHILD_PLATFORMS = "cuda"  # JAX_PLATFORMS of every child
CHILD_TIMEOUT_S = 900
MIN_COUNT, MAX_COUNT = 1, 255


class SmokeFailure(RuntimeError):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def child_env() -> dict:
    env = dict(BASE_ENV)
    env["JAX_PLATFORMS"] = CHILD_PLATFORMS
    env["PYKMER_TPU_STAGE_TIMING"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, BASE_ENV.get("PYTHONPATH", "")) if p)
    return env


def run_child(label: str, args: list, timings: dict) -> str:
    """Run one child from WORK; returns its stdout, fails on a non-zero
    exit. The child's stdout and stderr go to logs/<label>.log, and its
    stage-timing lines (stderr lines indented by two spaces) are echoed."""
    os.makedirs(os.path.join(WORK, "logs"), exist_ok=True)
    t0 = time.monotonic()
    try:
        res = subprocess.run(
            [sys.executable, *args], cwd=WORK, env=child_env(),
            capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
        )
    except subprocess.TimeoutExpired as exc:
        raise SmokeFailure(f"{label}: no exit within {CHILD_TIMEOUT_S} s") \
            from exc
    wall = time.monotonic() - t0
    timings[label] = wall
    with open(os.path.join(WORK, "logs", f"{label}.log"), "w") as fh:
        fh.write(f"$ {' '.join(args)}\n--- stdout\n{res.stdout}"
                 f"--- stderr\n{res.stderr}")
    log(f"phase {label}: {wall:.2f} s wall (rc {res.returncode})")
    if res.returncode != 0:
        tail = "\n".join(res.stderr.strip().splitlines()[-15:])
        raise SmokeFailure(f"{label} exited {res.returncode}:\n{tail}")
    timing = False
    for line in res.stderr.splitlines():
        timing = timing or line.startswith("stage timing")
        if timing or line.startswith("  "):
            log(f"    {line.rstrip()}")
    return res.stdout


def pykmer(label: str, argv: list, timings: dict) -> str:
    return run_child(label, ["-m", "pykmer_tpu", *argv], timings)


# --- setup -----------------------------------------------------------------

def setup(n_devices: int, timings: dict) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if smi.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"card: {line.strip()}")

    os.makedirs(WORK, exist_ok=True)
    make = subprocess.run(["make", "-s", "-C",
                           os.path.join(REPO, "pykmer_tpu", "native")],
                          capture_output=True, text=True)
    if make.returncode != 0:
        raise SmokeFailure(f"native build failed:\n{make.stderr}")
    sys.path.insert(0, REPO)
    try:
        from pykmer_tpu.io import native  # noqa: F401  (no JAX)
    except ImportError as exc:
        raise SmokeFailure(f"native library does not load: {exc}") from exc
    log("native host library: built and loaded")

    probe = (
        "import json, sys, jax\n"
        "print(jax.devices())\n"
        f"if jax.default_backend() != {PLATFORM!r}:\n"
        "    sys.exit(f'backend is {jax.default_backend()}, not "
        f"{PLATFORM}')\n"
        "d = jax.devices()\n"
        "print(json.dumps({'platform': d[0].platform, "
        "'kind': d[0].device_kind, 'count': len(d)}))\n"
    )
    out = run_child("setup", ["-c", probe], timings)
    lines = out.strip().splitlines()
    log(f"devices: {lines[0]}")
    device = json.loads(lines[-1])
    if device["count"] < n_devices:
        raise SmokeFailure(f"needs {n_devices} devices, JAX sees "
                           f"{device['count']}")

    with open("/proc/meminfo") as fh:
        mem_kb = int(fh.readline().split()[1])
    log(f"host: {os.cpu_count()} cores, {mem_kb / 2**20:.1f} GiB RAM, "
        f"{shutil.disk_usage(WORK).free / 2**30:.1f} GiB free disk, "
        f"disk write {disk_write_mb_s():.0f} MB/s (2 GiB, fsync)")
    return device


def disk_write_mb_s(size: int = 2 << 30) -> float:
    path = os.path.join(WORK, "disk_probe.bin")
    block = b"\0" * (64 << 20)
    t0 = time.monotonic()
    with open(path, "wb") as fh:
        for _ in range(size // len(block)):
            fh.write(block)
        fh.flush()
        os.fsync(fh.fileno())
    rate = size / (time.monotonic() - t0) / 1e6
    os.remove(path)
    return rate


# --- inputs and the NumPy reference ----------------------------------------

def make_inputs(timings: dict) -> None:
    sys.path.insert(0, REPO)
    from bench import make_genome

    t0 = time.monotonic()
    for name, bp, seed, repeats in (("A", A_BP, 0, True),
                                    ("B", B_BP, 1, False)):
        make_genome(os.path.join(WORK, name), bp, seed=seed, repeats=repeats)
    timings["inputs"] = time.monotonic() - t0
    log(f"phase inputs: {timings['inputs']:.2f} s (A {A_BP:,} bp repeat-rich "
        f"seed 0, B {B_BP:,} bp uniform seed 1)")


def fasta_records(path: str):
    """Base codes (A,C,G,T -> 0..3, anything else -> 4) of each record of a
    FASTA whose '>' bytes all open header lines."""
    import numpy as np

    raw = np.fromfile(path, dtype=np.uint8)
    lut = np.full(256, 4, dtype=np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = lut[c + 32] = i
    starts = np.flatnonzero(raw == ord(">"))
    ends = list(starts[1:]) + [raw.shape[0]]
    for s, e in zip(starts, ends):
        body = raw[s:e]
        body = body[int(np.argmax(body == ord("\n"))) + 1:]
        yield lut[body[body != ord("\n")]]


def reference_codes(path: str, k: int, pool: ThreadPoolExecutor):
    """All canonical codes of a FASTA (oracle_canonical_codes_vec over
    overlapping blocks of each record, in parallel)."""
    import numpy as np

    from pykmer_tpu.oracle import oracle_canonical_codes_vec

    block = 1 << 25
    futs = []
    for seq in fasta_records(path):
        for lo in range(0, max(seq.shape[0] - k + 1, 0), block):
            futs.append(pool.submit(oracle_canonical_codes_vec,
                                    seq[lo:lo + block + k - 1], k))
    return np.concatenate([f.result() for f in futs])


def reference_plane(path: str, k: int, pool: ThreadPoolExecutor):
    """(dense min(count, 255) uint8[4^k], number of valid windows)."""
    import numpy as np

    codes = reference_codes(path, k, pool)
    counts = np.bincount(codes, minlength=4**k)
    np.minimum(counts, MAX_COUNT, out=counts)
    return counts.astype(np.uint8), int(codes.shape[0])


def reference_unique(path: str, k: int, pool: ThreadPoolExecutor):
    """(sorted unique canonical codes, their min(count, 255) as uint8,
    number of valid windows) — for planes too large to hold densely."""
    import numpy as np

    codes = reference_codes(path, k, pool)
    uniq, counts = np.unique(codes, return_counts=True)
    np.minimum(counts, MAX_COUNT, out=counts)
    return uniq, counts.astype(np.uint8), int(codes.shape[0])


def counts256(plane):
    import numpy as np

    out = np.zeros(256, dtype=np.int64)
    step = 1 << 26
    for lo in range(0, plane.shape[0], step):
        out += np.bincount(plane[lo:lo + step], minlength=256)
    return out


# --- checks ----------------------------------------------------------------

def kin_paths(name: str, k: int):
    root = os.path.join(WORK, f"{name}.{k:02d}.kin")
    return root, root + ".json"


def check_dense_kin(name: str, k: int, ref) -> None:
    """Whole .kin cell for cell, and the .kin.json counts and histogram."""
    import numpy as np

    plane, n_kmers = ref
    root, meta_path = kin_paths(name, k)
    kin = np.fromfile(root, dtype=np.uint8)
    check(kin.shape[0] == 4**k, f"{name}.{k}.kin holds 4^{k} cells")
    diff = np.flatnonzero(kin != plane)
    if diff.shape[0]:
        first = ", ".join(f"{int(i)}: {int(kin[i])} vs {int(plane[i])}"
                          for i in diff[:5])
        raise SmokeFailure(f"{name}.{k}.kin: {diff.shape[0]:,} cells differ "
                           f"from the reference (cell: kin vs ref) {first}")
    log(f"  ok: {name}.{k}.kin equals the NumPy reference in all "
        f"{4**k:,} cells ({int(np.count_nonzero(plane)):,} nonzero, "
        f"{int((plane == MAX_COUNT).sum()):,} saturated)")
    with open(meta_path) as fh:
        meta = json.load(fh)
    bc = counts256(plane)
    vals = np.arange(256, dtype=np.int64)
    check(meta["num_kmers"] == n_kmers,
          f"{name}.{k}.kin.json num_kmers {meta['num_kmers']:,}")
    check(meta["vals_sum"] == int((vals * bc).sum()),
          f"{name}.{k}.kin.json vals_sum {meta['vals_sum']:,}")
    check(meta["hist"] == [int(x) for x in bc[1:256]],
          f"{name}.{k}.kin.json histogram")


def check_sparse_kin(name: str, k: int, ref) -> None:
    """Every cell at the reference's unique codes, and the nonzero-cell
    count from the .kin.json stats against the number of unique codes."""
    import numpy as np

    uniq, clipped, n_kmers = ref
    root, meta_path = kin_paths(name, k)
    check(os.path.getsize(root) == 4**k, f"{name}.{k}.kin holds 4^{k} cells")
    kin = np.memmap(root, dtype=np.uint8, mode="r")
    got = kin[uniq]
    diff = np.flatnonzero(got != clipped)
    if diff.shape[0]:
        first = ", ".join(f"{int(uniq[i])}: {int(got[i])} vs "
                          f"{int(clipped[i])}" for i in diff[:5])
        raise SmokeFailure(f"{name}.{k}.kin: {diff.shape[0]:,} of "
                           f"{uniq.shape[0]:,} reference cells differ "
                           f"(cell: kin vs ref) {first}")
    log(f"  ok: {name}.{k}.kin equals the reference at all "
        f"{uniq.shape[0]:,} unique canonical codes")
    del kin
    with open(meta_path) as fh:
        meta = json.load(fh)
    check(meta["vals_count"] == uniq.shape[0],
          f"{name}.{k}.kin.json nonzero cells {meta['vals_count']:,} == "
          f"unique codes")
    check(meta["vals_sum"] == int(clipped.sum(dtype=np.int64)),
          f"{name}.{k}.kin.json vals_sum {meta['vals_sum']:,}")
    check(meta["num_kmers"] == n_kmers,
          f"{name}.{k}.kin.json num_kmers {meta['num_kmers']:,}")


def check_kma(project: str, plane_a, plane_b):
    """The .kma against oracle_pair_counts; returns the oracle's triple."""
    import numpy as np

    from pykmer_tpu.formats.kma import read_kma
    from pykmer_tpu.oracle import oracle_pair_counts

    a, b, shared = oracle_pair_counts(plane_a, plane_b, MIN_COUNT, MAX_COUNT)
    kma = os.path.join(WORK, f"{project}.{MIN_COUNT:03d}-{MAX_COUNT:03d}.kma")
    m = read_kma(kma)
    want = np.array([[(a, a, a), (a, b, shared)],
                     [(b, a, shared), (b, b, b)]], dtype=np.uint64)
    check(m.shape == (2, 2, 3) and np.array_equal(m, want),
          f"{os.path.basename(kma)} equals oracle_pair_counts "
          f"(valid {a:,} / {b:,}, shared {shared:,})")
    return a, b, shared


def check_distance(project: str, ab) -> None:
    import numpy as np

    a, b, shared = ab
    kma = os.path.join(WORK, f"{project}.{MIN_COUNT:03d}-{MAX_COUNT:03d}.kma")
    with np.load(f"{kma}.dist.jaccard.npz") as npz:
        dist = npz["distance"]
    want = 1.0 - shared / (a + b - shared)
    check(dist.shape == (2, 2) and np.isfinite(dist).all()
          and dist[0, 0] == 0.0 and dist[0, 1] == dist[1, 0] == want,
          f"jaccard distance {dist[0, 1]!r} parses and matches the oracle")
    outs = sorted(f for f in os.listdir(WORK)
                  if f.startswith(os.path.basename(kma) + ".dist"))
    log(f"  distance outputs: {', '.join(outs)}")


def need_disk(gib: float, what: str) -> None:
    free = shutil.disk_usage(WORK).free / 2**30
    if free < gib:
        raise SmokeFailure(f"{what} needs {gib:.0f} GiB of free disk under "
                           f"{WORK}, {free:.1f} GiB is free")


def bp_line(name: str, k: int, wall: float) -> None:
    with open(kin_paths(name, k)[1]) as fh:
        meta = json.load(fh)
    bp = sum(c[1] for c in meta["chromosomes"])
    log(f"  {name} K={k}: {bp:,} bp in {wall:.2f} s child wall = "
        f"{bp / wall:,.0f} bp/s (process start + compile included; "
        f"in-run duration {meta['creation_duration']})")


# --- the two runs ----------------------------------------------------------

def one_card(timings: dict) -> None:
    ks, kl = K_SMALL, K_LARGE
    with ThreadPoolExecutor(max(2, (os.cpu_count() or 4) // 2)) as pool, \
            ThreadPoolExecutor(3) as refs:
        # the references compute on the host while the children use the card
        ref_a = refs.submit(reference_plane, os.path.join(WORK, "A"), ks, pool)
        ref_b = refs.submit(reference_plane, os.path.join(WORK, "B"), ks, pool)
        ref_bl = refs.submit(reference_unique, os.path.join(WORK, "B"), kl,
                             pool)

        for name in ("A", "B"):
            label = f"index_{name}_k{ks}"
            pykmer(label, ["index", name, name, str(ks)], timings)
            bp_line(name, ks, timings[label])
            check_dense_kin(name, ks, (ref_a if name == "A" else ref_b)
                            .result())

        need_disk(1.2 * 4**kl / 2**30, f"the K={kl} .kin")
        label = f"index_B_k{kl}"
        pykmer(label, ["index", "B", "B", str(kl)], timings)
        bp_line("B", kl, timings[label])
        check_sparse_kin("B", kl, ref_bl.result())
        os.remove(kin_paths("B", kl)[0])

        a_kin, b_kin = kin_paths("A", ks)[0], kin_paths("B", ks)[0]
        pykmer("merge", ["merge", "proj", os.path.basename(a_kin),
                         os.path.basename(b_kin), "--engine", "device"],
               timings)
        pair = check_kma("proj", ref_a.result()[0], ref_b.result()[0])
        pykmer("distance", ["distance",
                            f"proj.{MIN_COUNT:03d}-{MAX_COUNT:03d}.kma"],
               timings)
        check_distance("proj", pair)


def four_cards(timings: dict) -> None:
    ks, kl = K_SMALL, K_LARGE
    with ThreadPoolExecutor(max(2, (os.cpu_count() or 4) // 2)) as pool, \
            ThreadPoolExecutor(3) as refs:
        ref_a = refs.submit(reference_plane, os.path.join(WORK, "A"), ks, pool)
        ref_b = refs.submit(reference_plane, os.path.join(WORK, "B"), ks, pool)
        ref_bl = refs.submit(reference_unique, os.path.join(WORK, "B"), kl,
                             pool)

        for label, extra in ((f"index_A_k{ks}_shards4", ["--shards", "4"]),
                             (f"index_A_k{ks}_shards2_dp2",
                              ["--shards", "2", "--data-parallel", "2"])):
            pykmer(label, ["index", "A", "A", str(ks), *extra], timings)
            bp_line("A", ks, timings[label])
            check_dense_kin("A", ks, ref_a.result())

        need_disk(1.2 * 4**kl / 2**30, f"the K={kl} .kin")
        label = f"index_B_k{kl}_shards4"
        pykmer(label, ["index", "B", "B", str(kl), "--shards", "4"], timings)
        bp_line("B", kl, timings[label])
        check_sparse_kin("B", kl, ref_bl.result())
        os.remove(kin_paths("B", kl)[0])

        label = f"index_B_k{ks}_shards4"
        pykmer(label, ["index", "B", "B", str(ks), "--shards", "4"], timings)
        check_dense_kin("B", ks, ref_b.result())
        a_kin, b_kin = kin_paths("A", ks)[0], kin_paths("B", ks)[0]
        pykmer("merge_shards4", ["merge", "proj4", os.path.basename(a_kin),
                                 os.path.basename(b_kin), "--shards", "4",
                                 "--engine", "device"], timings)
        check_kma("proj4", ref_a.result()[0], ref_b.result()[0])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi-gpu", action="store_true",
                        help="run only the sharded phases, on four cards")
    args = parser.parse_args(argv)
    n_devices = 4 if args.multi_gpu else 1
    timings: dict = {}
    t0 = time.monotonic()
    try:
        device = setup(n_devices, timings)
        make_inputs(timings)
        (four_cards if args.multi_gpu else one_card)(timings)
    except (SmokeFailure, OSError, ValueError) as exc:
        print(f"FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    log(f"phase times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in timings.items()))
    log(f"total wall: {time.monotonic() - t0:.2f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
