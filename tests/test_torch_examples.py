"""The port's examples (``repro_torch.examples``, the reference's
``examples/`` on torch tensors) run end to end as subprocesses on the CPU,
each in its own working directory, on the reference's smoke or small
flags; every run also proves it imported neither JAX nor the reference."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "src"

# runs the example as ``python -m`` would (an escaping exception exits 1),
# then fails if the run imported JAX or the reference package
_RUNNER = (
    "import runpy, sys, traceback; name = sys.argv[1]; "
    "sys.argv = sys.argv[1:]; code = 0\n"
    "try:\n"
    "    runpy.run_module(name, run_name='__main__', alter_sys=True)\n"
    "except SystemExit as e:\n"
    "    code = e.code or 0\n"
    "except BaseException:\n"
    "    traceback.print_exc()\n"
    "    code = 1\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'repro'))\n"
    "print('IMPORTED', bad, flush=True)\n"
    "sys.exit(3 if bad else code)\n")


def _run(name, *args, cwd, ok=True):
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "HOME": str(cwd), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, f"repro_torch.examples.{name}",
         *args, "--device", "cpu"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    text = out.stdout + out.stderr
    assert "IMPORTED []" in out.stdout, text
    assert (out.returncode == 0) == ok, text
    return out.stdout


def test_quickstart_crashes_then_resumes(tmp_path):
    first = _run("quickstart", cwd=tmp_path)
    assert "simulating a crash at iteration 55" in first
    second = _run("quickstart", cwd=tmp_path)
    assert "restarted from iteration 50 (checkpoint v-5)" in second
    assert "dataArr=[100. 100. 100. 100. 100.]" in second
    # the reference's loop in float32: state = sin(state + dbl), 100 times
    state, dbl = np.zeros((4, 4), np.float32), 0.0
    for _ in range(100):
        dbl += 0.5
        state = np.sin(state + np.float32(dbl))
    norm = float(re.search(r"\|state\|=(-?[\d.]+)", second).group(1))
    assert abs(norm - float(state.sum())) < 2e-4
    assert (tmp_path / "craft-quickstart" / "myCP").is_dir()


def test_nested_checkpoints_crash_then_resume_inside_outer_1(tmp_path):
    first = _run("nested_checkpoints", cwd=tmp_path)
    assert "simulated crash at outer=1, inner=15" in first
    second = _run("nested_checkpoints", cwd=tmp_path)
    assert "resumed inner loop at l2=10 (outer 1)" in second
    assert "result=[60. 60. 60. 60.]" in second


def test_lanczos_crash_then_rerun_resumes_at_40(tmp_path):
    _run("lanczos_aft", "--fail-at", "45", cwd=tmp_path, ok=False)
    second = _run("lanczos_aft", cwd=tmp_path)
    m = re.search(r"min eigenvalue ≈ (-[\d.]+) \(100 iterations, .*"
                  r"restarted_at=40\)", second)
    assert m, second
    # the uninterrupted run's answer, in this process
    from repro_torch.apps.lanczos import GrapheneConfig, run_lanczos

    clean = run_lanczos(GrapheneConfig(nx=128, ny=128, disorder=0.3),
                        n_iter=100, device="cpu")
    assert m.group(1) == f"{clean.eigenvalue:.6f}"


def test_lanczos_aft_members_agree(tmp_path):
    out = _run("lanczos_aft", "--aft", "--nx", "64", cwd=tmp_path)
    members = re.findall(r"member (\d): eig=(-[\d.]+) .*resumed_from=(\d+)",
                         out)
    assert sorted(m[0] for m in members) == ["0", "1"], out
    assert len({m[1] for m in members}) == 1
    assert {m[2] for m in members} == {"40"}


def test_train_with_failures_smoke_recovers(tmp_path):
    out = _run("train_with_failures", "--smoke", "--inject-failure",
               cwd=tmp_path)
    assert "recovered and finished: step 30" in out
