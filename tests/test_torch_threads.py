"""Background-thread crash visibility (ratelimit_tpu_torch/utils/threads.py)
against the JAX package's ratelimit_tpu/utils/threads.py.

Both modules' recorder and chaining hook run the same scenarios: a
crashed thread is logged at ERROR, handed to the callback and passed to
the previous custom hook; SystemExit stays silent; a failing callback
does not break the chain; the interpreter's default hook is not run a
second time.  Then the port's Runner installs the hook at boot.
"""

import logging
import threading

import pytest

from ratelimit_tpu.utils import threads as jax_threads
from ratelimit_tpu_torch.runner import Runner
from ratelimit_tpu_torch.settings import Settings
from ratelimit_tpu_torch.utils import threads

MODULES = (jax_threads, threads)
IDS = ["jax", "port"]


def _crash(exc, name="victim"):
    def run():
        raise exc

    t = threading.Thread(target=run, name=name)
    t.start()
    t.join(timeout=10)


@pytest.mark.parametrize("mod", MODULES, ids=IDS)
def test_recorder_records_drains_and_peeks(mod):
    rec = mod.ThreadExceptionRecorder()
    err = ValueError("x")
    rec.record("t1", err)
    assert rec.pending() == [("t1", err)]
    assert rec.pending() == [("t1", err)]  # pending does not clear
    assert rec.drain() == [("t1", err)]
    assert rec.drain() == []


@pytest.mark.parametrize("mod", MODULES, ids=IDS)
def test_hook_logs_records_and_chains(mod, monkeypatch, caplog):
    previous = []
    monkeypatch.setattr(threading, "excepthook", lambda args: previous.append(args.exc_value))
    rec = mod.ThreadExceptionRecorder()
    hook = mod.install_thread_excepthook(rec.record)
    assert threading.excepthook is hook
    err = RuntimeError("boom")
    with caplog.at_level(logging.ERROR, logger="ratelimit.threads"):
        _crash(err)
    assert rec.drain() == [("victim", err)]
    assert previous == [err]
    [log] = [r for r in caplog.records if r.name == "ratelimit.threads"]
    assert log.levelno == logging.ERROR and "victim" in log.getMessage()
    assert log.exc_info[1] is err


@pytest.mark.parametrize("mod", MODULES, ids=IDS)
def test_system_exit_is_silent(mod, monkeypatch, caplog):
    previous = []
    monkeypatch.setattr(threading, "excepthook", lambda args: previous.append(args))
    rec = mod.ThreadExceptionRecorder()
    mod.install_thread_excepthook(rec.record)
    with caplog.at_level(logging.ERROR, logger="ratelimit.threads"):
        _crash(SystemExit(0))
    assert rec.drain() == [] and previous == []
    assert not [r for r in caplog.records if r.name == "ratelimit.threads"]


@pytest.mark.parametrize("mod", MODULES, ids=IDS)
def test_failing_callback_still_chains(mod, monkeypatch, caplog):
    previous = []
    monkeypatch.setattr(threading, "excepthook", lambda args: previous.append(args.exc_value))

    def bad(name, exc):
        raise KeyError("callback")

    mod.install_thread_excepthook(bad)
    err = RuntimeError("boom")
    with caplog.at_level(logging.ERROR, logger="ratelimit.threads"):
        _crash(err)
    assert previous == [err]
    messages = [r.getMessage() for r in caplog.records if r.name == "ratelimit.threads"]
    assert any("callback failed" in m for m in messages)


@pytest.mark.parametrize("mod", MODULES, ids=IDS)
def test_default_hook_is_not_run_twice(mod, monkeypatch, capsys):
    monkeypatch.setattr(threading, "excepthook", threading.__excepthook__)
    rec = mod.ThreadExceptionRecorder()
    mod.install_thread_excepthook(rec.record, logger_name="test.threads.quiet")
    logging.getLogger("test.threads.quiet").addHandler(logging.NullHandler())
    _crash(RuntimeError("once"))
    assert len(rec.drain()) == 1
    assert "Traceback" not in capsys.readouterr().err


def test_runner_installs_the_hook_at_boot(tmp_path, monkeypatch, caplog, thread_exceptions):
    """Runner.start installs the logging hook first, chained to the
    hook before it: a crashed background thread is logged under
    ratelimit.threads and still reaches the earlier hook."""
    previous = []

    def prior(args):
        previous.append(args.exc_value)

    monkeypatch.setattr(threading, "excepthook", prior)
    settings = Settings(
        backend_type="memory",
        runtime_path=str(tmp_path),
        host="127.0.0.1",
        port=0,
        grpc_host="127.0.0.1",
        grpc_port=0,
        debug_host="127.0.0.1",
        debug_port=0,
        use_statsd=False,
        gc_tuning=False,
    )
    runner = Runner(settings, device="cpu")
    runner.start()
    try:
        assert threading.excepthook is not prior
        err = RuntimeError("dispatcher died")
        with caplog.at_level(logging.ERROR, logger="ratelimit.threads"):
            _crash(err, name="cuda-writebehind")
        assert previous == [err]
        assert any(
            r.name == "ratelimit.threads" and "cuda-writebehind" in r.getMessage()
            for r in caplog.records
        )
    finally:
        runner.stop()
        thread_exceptions.drain()
