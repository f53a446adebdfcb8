"""The Operations commands of ``python -m circuitmap_torch`` (``doctor``,
``hw-smoke``, ``warm-cache``) and their shared probe core, on the CPU.

The probe core (``utils/probes.py``) is held against the JAX package's
on the same commands. ``doctor`` and ``hw-smoke`` are run as a user runs
them on this machine, which has no GPU: the accelerator check and the
``tunnel`` probe must FAIL (neither passes by running on the CPU), and
with the GPU probe skipped and ``--device cpu`` the doctor passes.
The two Measurement commands that need the original implementation are
listed and exit 2.
"""

import json
import sys
from pathlib import Path

import pytest
import torch

from circuitmap_tpu.utils.probes import run_probe_cmd as jax_run_probe_cmd
from circuitmap_torch.__main__ import _GROUPS, main
from circuitmap_torch.utils import native
from circuitmap_torch.utils.probes import run_probe_cmd

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("code,timeout", [
    ("print('hello')", 30),
    ("import time; time.sleep(30)", 1),
    ("import sys; print('partial'); sys.stderr.write('boom\\n'); "
     "sys.exit(3)", 30),
    ("raise SystemExit('x' * 1000)", 30),
], ids=["ok", "timeout", "fails", "long-tail"])
def test_run_probe_cmd_matches_jax(code, timeout):
    cmd = [sys.executable, "-c", code]
    assert run_probe_cmd(cmd, timeout) == jax_run_probe_cmd(cmd, timeout)


def test_run_probe_cmd_runs_in_cwd(tmp_path):
    cmd = [sys.executable, "-c", "import os; print(os.getcwd())"]
    out, err = run_probe_cmd(cmd, 30, cwd=str(tmp_path))
    assert err is None and out.strip() == str(tmp_path)


def test_doctor_passes_on_the_cpu_without_the_gpu_probe(tmp_path, capsys):
    path = tmp_path / "doctor.json"
    rc = main(["doctor", "--skip-accelerator", "--device", "cpu",
               "--json", str(path)])
    out = capsys.readouterr().out
    assert rc == 0, out
    checks = json.loads(path.read_text())
    assert list(checks) == ["versions", "host", "native-lib", "host-lib",
                            "demixer-zoo", "compile-cache", "cpu-fallback",
                            "accelerator"]
    assert checks["cpu-fallback"]["status"] == "PASS"
    assert checks["host-lib"]["status"] == "PASS"
    assert checks["host-lib"]["library"].startswith("libcircuitmap_host_")
    assert checks["accelerator"]["status"] == "SKIP"
    assert checks["versions"]["torch"] == torch.__version__
    assert {"built", "nvcc", "library"} <= set(checks["native-lib"])
    for name in checks:
        assert any(line.split()[1] == name for line in out.splitlines()
                   if line[:4] in ("PASS", "WARN", "FAIL", "SKIP")), name
    assert "doctor: 8 checks in" in out


def test_doctor_fails_the_host_library_check_without_gxx(tmp_path,
                                                         monkeypatch):
    """No library for this source and no g++ to build one: FAIL, with
    the hint, whatever the device."""
    from circuitmap_torch.scripts import doctor

    monkeypatch.setattr(native, "COMPILER", str(tmp_path / "no-g++"))
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CIRCUITMAP_TORCH_BUILD_DIR", str(tmp_path / "b"))
    status, detail = doctor.check_host_lib()
    assert status == "FAIL" and detail["built"] is False
    assert "did not run" in detail["error"]
    assert "install g++" in detail["hint"]


def test_doctor_fails_the_accelerator_check_without_a_gpu(no_cuda, capsys):
    rc = main(["doctor", "--device", "cpu", "--timeout", "60",
               "--json", "-"])
    out = capsys.readouterr().out
    assert rc == 1
    checks = json.loads(out[out.index("{"):])
    assert checks["accelerator"]["status"] == "FAIL"
    assert "torch.cuda.is_available() is False" in checks["accelerator"][
        "error"]
    assert [n for n, c in checks.items() if c["status"] == "FAIL"] == [
        "accelerator"]


def test_hw_smoke_fails_the_tunnel_and_skips_the_rest(no_cuda, tmp_path,
                                                      capsys):
    record = tmp_path / "smoke.json"
    assert main(["hw-smoke", "--json", str(record)]) == 1
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("[")]
    assert lines[0].startswith("[FAIL] tunnel")
    assert [ln.split()[1] for ln in lines[1:]] == [
        "entry", "kernels", "bench", "fit_many"]
    assert all(ln.startswith("[SKIP]") for ln in lines[1:])
    data = json.loads(record.read_text())
    assert data["ok"] is False
    assert [p["status"] for p in data["probes"]] == ["FAIL"] + ["SKIP"] * 4


def test_hw_smoke_refuses_the_cpu_device(capsys):
    assert main(["hw-smoke", "--device", "cpu", "--skip",
                 "entry,kernels,bench,fit_many"]) == 1
    out = capsys.readouterr().out
    assert "not a CUDA GPU" in out and "[SKIP] entry" in out


def test_hw_smoke_writes_no_record_by_default(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    main(["hw-smoke", "--skip", "tunnel,entry,kernels,bench,fit_many"])
    assert list(tmp_path.iterdir()) == []
    assert capsys.readouterr().out.count("(requested)") == 5


def test_warm_cache_runs_a_small_shape_on_the_cpu(tmp_path, capsys,
                                                  monkeypatch):
    # --cache-dir sets the build directory for the rest of the process;
    # the worker's later tests (and their subprocesses) keep the usual one
    monkeypatch.setenv("CIRCUITMAP_TORCH_BUILD_DIR", str(tmp_path / "build"))
    main(["warm-cache", "--shape", "30x300", "--iters", "5", "--demixer",
          str(REPO / "demixers" / "nwd_ie_ChroME2f_int4d2qat.npz"),
          "--transfer-dtype", "int4d2", "--device", "cpu", "--cache-dir",
          str(tmp_path / "build")])
    out = capsys.readouterr().out
    assert "warmed N=30 K=300 in" in out
    last = [ln for ln in out.splitlines() if ln.startswith("warm-cache")]
    assert last and last[0].startswith("warm-cache done: 1 shape(s) in")
    assert f"cache={tmp_path / 'build'}" in last[0]
    assert "host library ready in" in out and "(built)" in out
    assert [p.name for p in (tmp_path / "build").glob("*.so")] == [
        native.library_path().name]


@pytest.mark.parametrize("command", ["reference-baseline", "parity-vr"])
def test_commands_that_need_the_original_exit_2(command, capsys):
    assert main([command]) == 2
    err = capsys.readouterr().err
    assert "not ported (needs the original implementation" in err


def test_the_listing_has_every_jax_command_in_its_group(capsys):
    from circuitmap_tpu.__main__ import _GROUPS as JAX_GROUPS

    assert main([]) == 0
    out = capsys.readouterr().out
    want = [(title, [name for name, *_ in rows]) for title, rows in JAX_GROUPS]
    got = [(title, [name for name, *_ in rows]) for title, rows in _GROUPS]
    assert got == want
    assert sum(len(rows) for _, rows in want) == 28
    for line in ("  reference-baseline", "  parity-vr"):
        row = next(ln for ln in out.splitlines() if ln.startswith(line))
        assert "not ported (needs the original implementation)" in row
