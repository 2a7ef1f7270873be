"""The port stands alone and covers the JAX package's public surface.

  * importing every module of `eigenpinns_torch`, `examples_torch/common`,
    `chip_smoke` and `graft_entry_torch` in a fresh process leaves no
    jax, flax, optax or eigenpinns_tpu module in `sys.modules`;
  * no file of `eigenpinns_torch/`, `examples_torch/` or `chip_smoke.py`
    names one of them in an import statement;
  * every public top-level function and class of each `eigenpinns_tpu`
    file has a namesake in the port's file of the same path, except the
    names the port leaves out on purpose: the TPU workarounds, the pytree state
    classes, the flax and scan helpers that have a torch counterpart of
    another name, the Pallas entry points and their references
    (`*_cuda` / `*_plain` in the port), and the profiling helpers that
    the port's spans and counters replace.
"""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent
FOREIGN = ("jax", "jaxlib", "flax", "optax", "eigenpinns_tpu")

NOT_PORTED = {
    "__init__.py": {"warmup_transfer_async"},   # a TPU workaround
    "models/mlp.py": {"small_init"},    # MLP(small_output_init=True)
    "sampling/samplers.py": {"fps_jax"},          # fps_device
    "train/loop.py": {"run_scan_loop"},           # run_chunked_loop
    "train/optim.py": {"adam_plateau"},           # AdamPlateau
    "solvers/deflation.py": {"ModeState"},        # pytree states
    "solvers/direct.py": {"DirectState"},
    "solvers/eikonal_driver.py": {"EikState"},
    "solvers/multigrid.py": {"MGState"},
    "solvers/schrodinger_driver.py": {"SchrState"},
    "solvers/transfer.py": {"TLState"},
    "solvers/upscale.py": {"UpscaleState"},
    "sparse/banded.py": {"banded_spmm_pallas", "banded_spmm_reference",
                         "banded_spmm_gram_pallas",
                         "banded_spmm_gram_reference"},
    "sparse/bsr.py": {"bsr_spmm_pallas", "bsr_spmm_pallas_grouped",
                      "bsr_spmm_reference"},
    "sparse/rolling.py": {"rolling_spmm_pallas", "rolling_spmm_reference",
                          "rolling_spmm_gram_pallas",
                          "rolling_spmm_gram_reference"},
    # Read by nothing: `span` and `count` are the port's in-program tracing.
    "utils/profiling.py": {"PhaseTimer", "annotate"},
}


def _top_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def test_port_has_every_public_name():
    jax_root, port_root = REPO / "eigenpinns_tpu", REPO / "eigenpinns_torch"
    missing = {}
    for jp in sorted(jax_root.rglob("*.py")):
        rel = jp.relative_to(jax_root).as_posix()
        tp = port_root / rel
        have = _top_names(tp) if tp.exists() else set()
        lost = sorted(_top_names(jp) - have - NOT_PORTED.get(rel, set()))
        if lost:
            missing[rel] = lost
    assert not missing, missing
    # The leave-out list names only what the JAX package still has.
    for rel, names in NOT_PORTED.items():
        assert names <= _top_names(jax_root / rel), rel


def _sources():
    yield REPO / "chip_smoke.py"
    for root in ("eigenpinns_torch", "examples_torch"):
        yield from sorted((REPO / root).rglob("*.py"))


def test_no_source_imports_jax():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {m}"
                    for m in mods if m.split(".")[0] in FOREIGN]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / "examples_torch")!r})
import eigenpinns_torch
names = [m.name for m in pkgutil.walk_packages(
    eigenpinns_torch.__path__, "eigenpinns_torch.")]
for name in names + ["common", "chip_smoke", "graft_entry_torch"]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FOREIGN!r})
print(len(names), bad)
raise SystemExit(1 if bad or len(names) < 60 else 0)
"""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
