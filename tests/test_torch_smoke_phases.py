"""smoke_phases.py, the per-phase timer of chip_smoke.py runs, on a stand-in
smoke script: the phase split, the removed kernel build, the stamped log
and the exit code."""

import importlib.util
import json
import os

import pytest

from torch_port_fixtures import one_torch_thread  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "smoke_phases", os.path.join(_REPO, "smoke_phases.py"))
smoke_phases = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke_phases)

_FAKE = """import sys, time
print("card, 700.00 W")
print("phase 0 ok")
time.sleep(0.2)
print("phase 1 ok")
print("phase 2 attention: ...")
time.sleep(0.2)
print("phase 2 log_mel: ...")
print("phase 10 ok")
print('{"ok": true}')
sys.exit(%d)
"""


def test_phase_seconds_split_at_each_phase_s_last_line():
    stamped = [(0.5, "card"), (1.0, "phase 0 ok"), (3.0, "phase 1 ok"),
               (4.0, "phase 2 a"), (7.5, "phase 2 b"), (8.0, "Traceback"),
               (9.0, "phase 10 ok"), (9.5, '{"ok": true}'),
               (9.6, "  phase 3 indented is no phase line")]
    assert smoke_phases.phase_seconds(stamped) == {
        "0": 1.0, "1": 2.0, "2": 4.5, "10": 1.5}
    assert smoke_phases.phase_seconds([]) == {}


@pytest.mark.parametrize("rc", [0, 1])
def test_main_times_each_checkout_from_a_clean_build(tmp_path, capsys, rc):
    checkout = tmp_path / "co"
    build = checkout / "crisperwhisper_tpu_torch" / "_build"
    build.mkdir(parents=True)
    (build / "libcw_kernels_stale.so").write_text("")
    (checkout / "chip_smoke.py").write_text(_FAKE % rc)
    logs = tmp_path / "logs"
    assert smoke_phases.main(["--log-dir", str(logs), str(checkout),
                              str(checkout)]) == rc
    assert not build.exists()
    runs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["rc"] for r in runs] == [rc, rc]
    for r in runs:
        assert list(r["phases"]) == ["0", "1", "2", "10"]
        assert r["phases"]["1"] >= 0.2 and r["phases"]["2"] >= 0.2
        assert r["seconds"] >= sum(r["phases"].values()) - 0.01
    log = (logs / "smoke_1.log").read_text().splitlines()
    assert len(log) == 7 and log[2].split(None, 1)[1] == "phase 1 ok"
