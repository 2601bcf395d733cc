"""The port's profiling utilities (utils/profiling.py, the counterpart of
hidegs_tpu/utils/profiling.py): a trace file that names an annotated
range, the throughput meter, the timestamped print; and the card by
default."""
import json
import re
import time

import pytest
import torch

from hidegs_tpu.utils import profiling as jprof
from hidegs_tpu_torch.utils import profiling as prof

torch.set_num_threads(1)


def test_trace_records_an_annotated_range(tmp_path):
    with prof.trace(str(tmp_path / "tr"), device="cpu") as p:
        with prof.annotate("hidegs_test_range", device="cpu"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    path = tmp_path / "tr" / prof.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "hidegs_test_range" in names
    assert any("mm" in (n or "") for n in names)
    assert any(e.key == "hidegs_test_range" for e in p.key_averages())


def test_profiling_defaults_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with prof.annotate("x"):
            pass
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with prof.trace(str(tmp_path)):
            pass


def test_throughput_meter_matches_jax(monkeypatch):
    """The same counts from the same clock readings in both packages."""
    summaries = []
    for mod in (prof, jprof):
        m = mod.ThroughputMeter(pixels_per_step=1_000_000)
        m._t0 = 100.0
        m.step(3)
        m.step()
        monkeypatch.setattr(time, "perf_counter", lambda: 102.0)
        summaries.append(m.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1] == {"steps_per_s": 2.0, "mpix_per_s": 2.0, "seconds": 2.0, "steps": 4.0}
    m = prof.ThroughputMeter(pixels_per_step=10)
    m.step(5)
    m.reset()
    assert m.summary()["steps"] == 0.0 and m.steps_per_s == 0.0


def test_timestamped_print(capsys):
    prof.timestamped_print("hello", 3)
    out = capsys.readouterr().out
    assert re.fullmatch(r"\[\d\d/\d\d \d\d:\d\d:\d\d\] hello 3\n", out), out
    jprof.timestamped_print("hello", 3)
    jout = capsys.readouterr().out
    assert len(jout) == len(out) and jout.endswith("] hello 3\n")
    assert abs(time.mktime(time.strptime(out[1:15], "%d/%m %H:%M:%S")) -
               time.mktime(time.strptime(jout[1:15], "%d/%m %H:%M:%S"))) <= 1
