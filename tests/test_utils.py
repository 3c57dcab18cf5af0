"""Unit coverage for the small runtime utilities (utils/, __main__).

The Timer's persisted fields are reference-constrained (reference
tools.py:24-64: ``speed_ela`` -> ``creation_speed``, ``time_begin`` ->
``creation_time_start``); the profiling and compile-cache helpers are
runtime glue with no reference analog but load-bearing behavior (no-op
rules, exception transparency, where the cache lives).
"""

import datetime as real_dt
import os
import subprocess
import sys
import types

import pytest


def test_timer_rates_and_progress_line(monkeypatch):
    from pykmer_tpu.utils import timer as timer_mod

    t0 = real_dt.datetime(2026, 1, 1, 0, 0, 0)
    times = [t0, t0 + real_dt.timedelta(seconds=2),
             t0 + real_dt.timedelta(seconds=3)]

    class FakeDateTime:
        @staticmethod
        def now():
            return times.pop(0) if len(times) > 1 else times[0]

    fake = types.SimpleNamespace(datetime=FakeDateTime,
                                 timedelta=real_dt.timedelta)
    monkeypatch.setattr(timer_mod, "datetime", fake)

    t = timer_mod.Timer()  # now -> t0
    assert t.time_begin == t0  # str() of this becomes creation_time_start
    t.update(1000)  # now -> +2s
    assert t.speed_ela == 500  # cumulative: 1000 units / 2 s
    assert t.speed_recent == 500
    t.update(1600)  # now -> +3s
    assert t.speed_ela == 533  # int(1600 / 3)
    assert t.speed_recent == 600  # (1600 - 1000) / 1 s window
    line = t.progress_line()  # elapsed pinned at +3s by the fake clock
    assert "0:00:03" in line
    assert "1,600 units" in line
    assert "533/s overall" in line and "600/s recent" in line


def test_timer_zero_elapsed_is_safe():
    from pykmer_tpu.utils.timer import Timer

    t = Timer()
    t.update(0)  # sub-resolution window must not divide by zero
    assert t.speed_ela >= 0 and t.speed_recent >= 0


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands
    and the package sets no directory; unset, the cache sits at one fixed
    path inside the checkout."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, os.environ.get("PYTHONPATH", "")])
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(repo, ".jax_cache")
    if env_dir is not None:
        want = str(tmp_path / env_dir)
        env["JAX_COMPILATION_CACHE_DIR"] = want
    res = subprocess.run(
        [sys.executable, "-c",
         "import jax, os\n"
         "from pykmer_tpu import _jax_setup\n"
         "_jax_setup.ensure_x64()\n"
         "print(jax.config.jax_compilation_cache_dir)\n"
         "print(_jax_setup.compile_cache_dir(os.environ))"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    configured, set_by_package = res.stdout.split()
    assert configured == want
    assert set_by_package == ("None" if env_dir else want)


def test_stage_timer_report():
    from pykmer_tpu.utils.profiling import StageTimer

    st = StageTimer()
    with st.stage("decode"):
        pass
    with pytest.raises(ValueError):
        with st.stage("accumulate"):  # timing must survive a raising body
            raise ValueError
    names = [n for n, _ in st.stages]
    assert names == ["decode", "accumulate"]
    report = st.report()
    assert "decode" in report and "accumulate" in report
    assert report.count("%") == 2


def test_device_trace_and_annotate_noop(monkeypatch):
    from pykmer_tpu.utils.profiling import annotate, device_trace

    # an ambient PYKMER_TPU_TRACE_DIR would turn this into a real trace
    monkeypatch.delenv("PYKMER_TPU_TRACE_DIR", raising=False)
    ran = []
    with device_trace(None):  # no log dir anywhere -> plain no-op
        with annotate("span"):
            ran.append(1)
    assert ran == [1]


def test_module_entry_usage():
    """`python -m pykmer_tpu` with no args exits 2 with argparse usage."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [repo, os.environ.get("PYTHONPATH", "")])}
    res = subprocess.run(
        [sys.executable, "-m", "pykmer_tpu"],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert res.returncode == 2
    assert "usage:" in res.stderr
    assert "index" in res.stderr  # subcommands listed
