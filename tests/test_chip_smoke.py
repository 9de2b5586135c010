"""The parts of chip_smoke.py that need no GPU: the contract line, the
exit code of a failed phase, and the refusal to run without a GPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]


def test_result_line_format():
    line = chip_smoke.result_line(True, "gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert "\n" not in line
    assert json.loads(chip_smoke.result_line(False, "gpu", "x", 4)) == {
        "ok": False, "device": {"platform": "gpu", "kind": "x", "count": 4},
    }


def test_failed_phase_is_recorded(capsys):
    phases = chip_smoke.Phases()
    phases.run("good", lambda: True)
    phases.run("bad", lambda: False)
    phases.run("raises", lambda: 1 / 0)
    assert phases.failed == ["bad", "raises"]
    assert not phases.ok
    out = capsys.readouterr()
    assert "ZeroDivisionError" in out.err


@pytest.mark.parametrize("value,tol,expected", [
    (1e-4, 1e-3, True), (1e-3, 1e-3, True), (2e-3, 1e-3, False),
    (float("nan"), 1e-3, False),
])
def test_check(value, tol, expected):
    assert chip_smoke.check("x", value, tol) is expected


def test_main_exits_nonzero_when_a_phase_fails(monkeypatch):
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: True)
    monkeypatch.setattr(chip_smoke, "phase_ngd", lambda ctx: False)
    monkeypatch.setattr(chip_smoke, "phase_planner", lambda: True)
    monkeypatch.setattr(chip_smoke, "phase_chain_kernel", lambda: True)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "card, 1 W")
    assert chip_smoke.main([]) == 1


@pytest.mark.parametrize("args,ran", [
    ([], ["2", "3", "4", "5"]),
    (["--timings"], ["6"]),
])
def test_main_runs_the_phases_of_its_mode(monkeypatch, capsys, args, ran):
    import jax

    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "card, 1 W")
    monkeypatch.setattr(chip_smoke, "phase_device", lambda: True)

    def phase(name):
        def run(*ctx):
            calls.append(name)
            if ctx:
                ctx[0]["ngd"] = None
            return True
        return run

    for name, fn in (("2", "phase_ngd"), ("3", "phase_prox"),
                     ("4", "phase_planner"), ("5", "phase_chain_kernel"),
                     ("6", "phase_timings")):
        monkeypatch.setattr(chip_smoke, fn, phase(name))
    assert chip_smoke.main(args) == 0
    assert calls == ran
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["ok"] is True


def test_modes_are_exclusive():
    with pytest.raises(SystemExit):
        chip_smoke.main(["--timings", "--four-cards"])


def test_compile_all_compiles_every_variant():
    """Phase 6 compiles its variants concurrently; each comes back
    compiled, with its arguments, and runs like the jitted function."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp

    x = jnp.arange(4.0)
    variants = {"double": (jax.jit(lambda v: 2 * v), (x,)),
                "square": (jax.jit(lambda v: v * v), (x,))}
    with ThreadPoolExecutor(2) as pool:
        done = {k: f.result()
                for k, f in chip_smoke._compile_all(pool, variants).items()}
    for name, (fn, args) in variants.items():
        compiled, cargs = done[name]
        assert cargs is args
        assert jnp.array_equal(compiled(*cargs), fn(*args))


@pytest.mark.parametrize("args", [[], ["--four-cards"], ["--timings"]])
def test_refuses_without_gpu(args):
    """No GPU: a non-zero exit and no result line."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args],
        capture_output=True, text=True, timeout=300,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
