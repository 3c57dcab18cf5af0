"""Long-lived indexing/merge service: JSON-lines over stdin/stdout.

Why a daemon: device programs compile and load lazily at first dispatch.
The CLI pays that once per *process*; a service pays it once per
*lifetime*. This is the deployment
shape the pipeline was designed around (pooled host arenas, lru-cached
jitted programs keyed by shape, preload_* helpers) — the reference has no
runtime at all (every stage is a hand-launched process, README.md:19-37).

Protocol: one JSON object per line on stdin, one JSON response per line on
stdout (stderr carries logs). Commands:

  {"cmd": "ping"}                                    -> {"ok": true}
  {"cmd": "warmup", "kmer_len": 15}                  -> preload programs
  {"cmd": "index", "input": "g.fa", "sample": "s1",
   "kmer_len": 15, "bgzip": false, "verify": true}   -> index one FASTA
  {"cmd": "merge", "project": "proj",
   "indexes": ["a.15.kin", ...], "min_count": 1,
   "max_count": 255}                                 -> build the .kma
  {"cmd": "distance", "matrix_file": "proj...kma"}   -> analysis tail
  {"cmd": "shutdown"}                                -> exit 0

Responses always carry {"ok": bool, "cmd": ...}; failures add {"error"}
and the service keeps running (per-job isolation, like index-batch).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Optional, TextIO


def _handle(req: dict) -> dict:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"ok": True}
    if cmd == "warmup":
        kmer_len = int(req["kmer_len"])
        from .config import IndexConfig
        from .index.indexer import preload_index_programs
        from .ops.readback import preload_programs

        t0 = time.monotonic()
        if 4 ** kmer_len <= (4 << 30):
            preload_programs(kmer_len)
            preload_index_programs(
                kmer_len, IndexConfig(kmer_len=kmer_len)
            )
        return {"ok": True, "seconds": round(time.monotonic() - t0, 2)}
    if cmd == "index":
        from .config import IndexConfig
        from .index import create_fasta_index

        kmer_len = int(req["kmer_len"])
        cfg = IndexConfig(
            kmer_len=kmer_len,
            chunk_windows=req.get("chunk_windows"),
        )
        t0 = time.monotonic()
        header = create_fasta_index(
            req["input"], req["sample"], req["input"], kmer_len,
            overwrite=bool(req.get("overwrite", True)), config=cfg,
            verify=bool(req.get("verify", True)), verbose=False,
        )
        out = header.index_file_root
        if req.get("bgzip"):
            from .io.bgzf import bgzip_kin

            out, _ = bgzip_kin(out, keep=bool(req.get("keep_kin", True)))
        return {
            "ok": True,
            "output": str(out),
            "num_kmers": int(header.num_kmers),
            "seconds": round(time.monotonic() - t0, 2),
        }
    if cmd == "merge":
        from .merge import merge

        t0 = time.monotonic()
        kwargs = {}
        for key in ("min_count", "max_count", "block_size", "threads",
                    "n_shards"):
            if key in req:
                kwargs[key] = req[key]
        json_data, matrix = merge(
            req["project"], sorted(req["indexes"]), verbose=False, **kwargs
        )
        return {
            "ok": True,
            "samples": len(json_data),
            "seconds": round(time.monotonic() - t0, 2),
        }
    if cmd == "distance":
        from .analysis.distance import load

        t0 = time.monotonic()
        load(req["matrix_file"], names_file=req.get("names_file"))
        return {"ok": True, "seconds": round(time.monotonic() - t0, 2)}
    raise ValueError(f"unknown cmd: {cmd!r}")


def serve(stdin: Optional[TextIO] = None, stdout: Optional[TextIO] = None) -> int:
    stdin = stdin or sys.stdin
    stdout = stdout or sys.stdout
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as exc:
            print(json.dumps({"ok": False, "error": f"bad json: {exc}"}),
                  file=stdout, flush=True)
            continue
        if not isinstance(req, dict):
            # a valid-JSON non-object line (list/string/number) must not
            # crash the loop on req.get
            print(json.dumps({"ok": False,
                              "error": "request must be a JSON object"}),
                  file=stdout, flush=True)
            continue
        if req.get("cmd") == "shutdown":
            print(json.dumps({"ok": True, "cmd": "shutdown"}),
                  file=stdout, flush=True)
            return 0
        try:
            resp = _handle(req)
        except Exception as exc:  # per-job isolation: service survives
            resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        resp["cmd"] = req.get("cmd")
        print(json.dumps(resp), file=stdout, flush=True)
    return 0
