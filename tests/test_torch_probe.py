"""The port's probe ladder (crisperwhisper_tpu_torch.probe) on the CPU:
``probe_add``'s plain twin against the JAX probe kernel's body run with
``pl.pallas_call(..., interpret=True)`` (scripts/probe_pallas_compile.py
:51-57), the rung list, the refusal of the card-only rungs, and a source
that nvcc refuses named by its rung. The card-only rungs run in
tests/test_torch_gpu.py."""

import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from crisperwhisper_tpu_torch import _build, probe
from torch_port_fixtures import one_torch_thread  # noqa: F401


def test_probe_add_plain_matches_jax_probe_kernel():
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)

    def body(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    ref = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(
        (8, 128), jnp.float32), interpret=True)(jnp.asarray(x))
    before = probe.probe_add.launches
    got = probe.probe_add(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert probe.probe_add.launches == before      # no kernel on the CPU


def test_rungs_parse():
    assert probe.parse_rungs(None) == list(probe.RUNGS)
    assert probe.parse_rungs("") == list(probe.RUNGS)
    assert probe.RUNGS[:2] == ("plain", "probe_add")
    assert set(probe.RUNGS[2:]) == set(_build.SOURCES)
    assert probe.parse_rungs("plain, probe_add,dtw.cu") == [
        "plain", "probe_add", "dtw.cu"]
    with pytest.raises(ValueError, match="unknown probe rung"):
        probe.parse_rungs("plain,b1_large")
    assert probe.main(["plain,nope"]) == 2


@pytest.mark.parametrize("rung", ["plain", "probe_add"])
def test_cpu_refuses_card_rungs(rung, capsys):
    with pytest.raises(ValueError, match="runs on the card only"):
        probe.run_rung(rung, device="cpu")
    assert probe.probe(rung, device="cpu") is False
    assert f"PROBE {rung}: FAIL" in capsys.readouterr().out


def test_refused_source_is_named_by_its_rung(tmp_path, monkeypatch, capsys):
    """A stand-in nvcc that refuses every source: the rung fails with an
    error naming the source, and the ladder's exit code is 1."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 3\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match=r"nvcc failed on log_mel\.cu "
                                           r"\(exit code 3\)"):
        probe.run_rung("log_mel.cu")
    assert probe.main(["dtw.cu"]) == 1
    out = capsys.readouterr().out
    assert "PROBE dtw.cu: FAIL" in out and "nvcc failed on dtw.cu" in out


def test_launcher_guards_only_another_device_and_raises_on_errors(
        monkeypatch):
    """``_build.launcher``, the path of the probe and ring-write wrappers:
    the entry gets its arguments and then the current stream's raw handle
    of the tensors' device; a device guard is entered only when that
    device is not the current one; an error code raises with the
    wrapper's name and CUDA's text. A stand-in replaces the card."""
    import types
    calls = []

    class Guard:
        def __init__(self, index):
            calls.append(("guard", index))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            calls.append(("unguard",))

    def entry(*args):
        calls.append(args)
        return args[0]

    monkeypatch.setattr(_build, "_cuda_api",
                        lambda: (lambda: 0, lambda i: 1000 + i))
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(_build, "kernels", lambda: types.SimpleNamespace(
        lib=types.SimpleNamespace(
            cw_probe_add=entry,
            cw_error_string=lambda err: b"an illegal memory access")))
    _build.launcher.cache_clear()
    try:
        launch = _build.launcher("cw_probe_add")
        assert _build.launcher("cw_probe_add") is launch
        launch(0, 0, 11, 12)
        assert calls == [(0, 11, 12, 1000)]
        launch(1, 0, 13)
        assert calls[1:] == [("guard", 1), (0, 13, 1001), ("unguard",)]
        with pytest.raises(RuntimeError, match=r"probe_add: kernel launch "
                           r"failed \(700: an illegal memory access\)"):
            launch(0, 700)
        assert _build.current_stream(3) == 1003
    finally:
        _build.launcher.cache_clear()
