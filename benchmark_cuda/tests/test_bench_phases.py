"""The untraced run of the engine cell measures the program as it serves
with no recorder: it attaches no launch recorder to the engine, so no
phase record is stamped and the engine takes its detached path."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("cell", ["fw_engine_4096", "gcra_engine_4096"])
def test_untraced_run_attaches_no_recorder(cell, monkeypatch):
    from ratelimit_tpu_torch.backends.engine import CounterEngine
    from ratelimit_tpu_torch.observability.launches import LaunchRecorder

    attached, stamped = [], []
    attach = CounterEngine.attach_launch_recorder
    monkeypatch.setattr(
        CounterEngine, "attach_launch_recorder",
        lambda self, recorder, *a, **kw: (attached.append(recorder),
                                          attach(self, recorder, *a, **kw)),
    )
    init = LaunchRecorder.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        record_phase = self.record_phase
        self.record_phase = lambda *f: (stamped.append(f), record_phase(*f))[1]

    monkeypatch.setattr(LaunchRecorder, "__init__", spy)
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert [r for r in attached if r is not None] == [] and stamped == []
