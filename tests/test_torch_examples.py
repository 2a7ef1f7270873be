"""Smoke-run every script of examples_torch/ so that none can rot.

Each script runs with EIGENPINNS_SMOKE=1 (the JAX example's own
miniature sizes) and `--platform cpu`, in a subprocess with a fresh
working directory (relative outputs such as outputs/bunny_model.vtu land
there) and a 120 s limit. Importing jax, flax, optax or eigenpinns_tpu
raises in that process, and none of them may be in `sys.modules` when
the script ends. The four scripts that read a mesh fall back to the
stand-in surface when the file is absent, and say so.
"""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = sorted(p for p in (REPO / "examples_torch").glob("*.py")
                 if p.name != "common.py")
MESH_SCRIPTS = {"bunny_pipeline", "deflation_bunny", "eikonal_coil"}
BLOCKED = ("jax", "jaxlib", "flax", "optax", "eigenpinns_tpu")

RUNNER = f"""
import os, runpy, sys

BLOCKED = {BLOCKED!r}


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)


sys.meta_path.insert(0, Block())
script = sys.argv[1]
sys.argv = sys.argv[1:]
sys.path.insert(0, os.path.dirname(script))
runpy.run_path(script, run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
if bad:
    raise SystemExit("imported " + ", ".join(bad))
"""


def test_every_jax_example_has_a_port():
    assert ({p.name for p in (REPO / "examples").glob("*.py")}
            == {p.name for p in SCRIPTS})


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.stem)
def test_example_smoke(script, tmp_path):
    env = dict(os.environ, EIGENPINNS_SMOKE="1", OMP_NUM_THREADS="2")
    env.pop("EIGENPINNS_PLATFORM", None)
    proc = subprocess.run(
        [sys.executable, "-c", RUNNER, str(script), "--platform", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, (
        f"{script.name} failed\n--- stdout ---\n{proc.stdout[-3000:]}"
        f"\n--- stderr ---\n{proc.stderr[-3000:]}")
    if script.stem in MESH_SCRIPTS:
        assert "stand-in" in proc.stdout


def test_example_needs_a_card_without_platform(tmp_path, monkeypatch):
    """Without --platform the scripts ask for the card; where torch sees
    none, they fail before any work."""
    env = dict(os.environ)
    env.pop("EIGENPINNS_PLATFORM", None)
    code = ("import torch; torch.cuda.is_available = lambda: False; "
            "import runpy, sys; sys.argv = [sys.argv[1]]; "
            "sys.path.insert(0, sys.argv[0].rsplit('/', 1)[0]); "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    script = REPO / "examples_torch" / "schrodinger_well.py"
    proc = subprocess.run([sys.executable, "-c", code, str(script)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
