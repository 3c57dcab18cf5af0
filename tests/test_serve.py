"""JSON-lines service: full pipeline through one long-lived process."""

import json
import os
import subprocess
import sys


def test_serve_pipeline(tmp_path, rng):
    """index x2 -> merge -> distance through one `serve` process; device
    programs compile once and stay hot across jobs (per-job isolation:
    a failing command must not kill the service)."""
    from conftest import make_random_fasta

    k = 5
    fa1 = make_random_fasta(str(tmp_path / "s1.fa"), rng, n_records=2,
                            lengths=(600, 300))
    fa2 = make_random_fasta(str(tmp_path / "s2.fa"), rng, n_records=2,
                            lengths=(500, 250))
    reqs = [
        {"cmd": "ping"},
        {"cmd": "nope"},  # unknown command -> error, service survives
        {"cmd": "index", "input": fa1, "sample": "s1", "kmer_len": k},
        {"cmd": "index", "input": "/does/not/exist.fa", "sample": "x",
         "kmer_len": k},  # per-job failure isolation
        {"cmd": "index", "input": fa2, "sample": "s2", "kmer_len": k},
        {"cmd": "merge", "project": str(tmp_path / "proj"),
         "indexes": [f"{fa1}.{k:02d}.kin", f"{fa2}.{k:02d}.kin"]},
        {"cmd": "distance",
         "matrix_file": str(tmp_path / "proj.001-255.kma")},
        {"cmd": "shutdown"},
    ]
    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(
               [os.path.dirname(here), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "pykmer_tpu", "serve"],
        input="\n".join(json.dumps(r) for r in reqs) + "\n",
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    resps = [json.loads(line) for line in proc.stdout.splitlines() if line]
    assert len(resps) == len(reqs)
    by_cmd = {}
    for r in resps:
        by_cmd.setdefault(r.get("cmd"), []).append(r)
    assert by_cmd["ping"][0]["ok"] is True
    assert by_cmd["nope"][0]["ok"] is False
    idx = by_cmd["index"]
    assert idx[0]["ok"] is True and idx[0]["num_kmers"] > 0
    assert idx[1]["ok"] is False and "error" in idx[1]
    assert idx[2]["ok"] is True
    assert by_cmd["merge"][0]["ok"] is True
    assert by_cmd["merge"][0]["samples"] == 2
    assert by_cmd["distance"][0]["ok"] is True
    assert by_cmd["shutdown"][0]["ok"] is True
    # outputs on disk
    assert os.path.exists(f"{fa1}.{k:02d}.kin")
    assert os.path.exists(str(tmp_path / "proj.001-255.kma"))
    assert os.path.exists(
        str(tmp_path / "proj.001-255.kma.dist.jaccard.npz"))


def _run_lines(lines):
    """Drive serve() in-process over StringIO (no subprocess needed for
    command-loop semantics that never touch the device)."""
    import io

    from pykmer_tpu.serve import serve

    out = io.StringIO()
    rc = serve(stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    resps = [json.loads(l) for l in out.getvalue().splitlines() if l]
    return rc, resps


def test_serve_malformed_json_lines():
    """Broken JSON, valid-JSON non-objects, and blank lines must each get an
    error response (or be skipped) without killing the loop."""
    rc, resps = _run_lines([
        "{not json",            # parse error
        "[1, 2, 3]",            # valid JSON, not an object
        '"just a string"',      # valid JSON, not an object
        "42",                   # valid JSON, not an object
        "",                     # blank: skipped entirely
        '{"cmd": "ping"}',      # loop still alive
        '{"cmd": "shutdown"}',
    ])
    assert rc == 0
    assert len(resps) == 6  # blank line produces nothing
    assert [r["ok"] for r in resps] == [False] * 4 + [True, True]
    assert "bad json" in resps[0]["error"]
    assert "JSON object" in resps[1]["error"]
    assert resps[4]["cmd"] == "ping"


def test_serve_missing_fields_isolated():
    """A request missing required fields fails THAT job only."""
    rc, resps = _run_lines([
        '{"cmd": "index"}',                       # no input/sample/kmer_len
        '{"cmd": "index", "kmer_len": "seven"}',  # non-numeric kmer_len...
        '{"cmd": "merge"}',                       # no project/indexes
        '{"cmd": "distance"}',                    # no matrix_file
        '{"cmd": "warmup"}',                      # no kmer_len
        '{"cmd": "ping"}',
        '{"cmd": "shutdown"}',
    ])
    assert rc == 0
    assert len(resps) == 7
    assert [r["ok"] for r in resps[:5]] == [False] * 5
    assert all("error" in r for r in resps[:5])
    assert resps[5]["ok"] is True


def test_serve_shutdown_stops_queue():
    """Lines already queued after a shutdown request are never processed
    (shutdown is honoured between jobs; jobs themselves are serial)."""
    rc, resps = _run_lines([
        '{"cmd": "ping"}',
        '{"cmd": "shutdown"}',
        '{"cmd": "ping"}',       # must NOT run
        '{"cmd": "bogus"}',      # must NOT run
    ])
    assert rc == 0
    assert len(resps) == 2
    assert resps[1]["cmd"] == "shutdown" and resps[1]["ok"] is True


def test_serve_batched_lines_in_order():
    """A burst of queued commands is answered one response per request, in
    request order (the concurrency model: serial jobs, ordered replies)."""
    lines = ['{"cmd": "ping", "seq": %d}' % i for i in range(20)]
    rc, resps = _run_lines(lines + ['{"cmd": "shutdown"}'])
    assert rc == 0
    assert len(resps) == 21
    assert all(r["ok"] for r in resps)
    assert [r["cmd"] for r in resps[:20]] == ["ping"] * 20


def test_serve_eof_without_shutdown():
    """stdin EOF (client went away) exits cleanly without a shutdown cmd."""
    import io

    from pykmer_tpu.serve import serve

    out = io.StringIO()
    assert serve(stdin=io.StringIO('{"cmd": "ping"}\n'), stdout=out) == 0
    assert json.loads(out.getvalue().strip())["ok"] is True
