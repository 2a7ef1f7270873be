"""The port's CLI under torchrun: `mesh_shape` trains node-sharded over
the ranks of a process group, one process per rank.

On perturbed_icosphere(3) through the mesh path (decimated levels, FEM K
and consistent M, so the sharded loss takes a non-diagonal M through
the halo-banded SpMM), 4 modes, levels [32, 64] + the mesh, 60 epochs
with the corrector's ramp cut to the run (ROADMAP F25) and a 50-iteration
polish: `python -m torch.distributed.run --nproc_per_node 4 -m
eigenpinns_torch.main --platform cpu` (4 gloo ranks) against the
single-process CLI.

  * eigenvalues (modes 1+, from the run summary both print) rel 1e-4;
  * the loss history over the first 53 epochs, the window ROADMAP F24
    allows (the sharded loss sums in another order, and the training
    parts chaotically from there at the bench widths), rel 1e-2;
  * exactly one VTU is written (rank 0's), the same points and fields as
    the single-process run's;
  * a mesh_shape whose product differs from the world size raises, and
    one of more than 1 rank outside torchrun names torchrun.

The same run against the JAX package's trainer with `mesh_shape=[4]`
over 4 devices of the virtual CPU mesh (what JAX's CLI runs for it), on
the same .obj and overrides, both hierarchies built on the numpy host
path. The ranks start from JAX's flax parameters, train on JAX's node
features (the coarsest level's residual column is fp32 round-off, see
tests/test_torch_multigrid.py) and polish with JAX's guard vectors,
handed to the CLI by a launcher that sets those three seams and calls
`cli`: eigenvalues (modes 1+) rel 1e-4 and the loss over the same F24
window rel 1e-2.
"""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from eigenpinns_torch.geometry import save_obj
from eigenpinns_torch.io import read_vtu
from eigenpinns_torch.main import cli
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = ["n_modes=4", "hierarchy=[32,64]", "hidden_layers=[16,16]",
       "epochs=60", "scan_chunk=20", "scale_ramp_epochs=60",
       "polish_iters=50", "log_every=1", "verbose=True",
       "sampler_type=graph_coarsening",
       "edge_computation_type=connectivity_based", "operator_format=auto",
       "diagnostics_viz="]
F24_WINDOW = 53

# Runs the CLI from JAX's initial parameters, node features and polish
# guard vectors (a torch.save'd dict, argv[1]); argv[2:] are cli's.
SEEDED_CLI = """\
import sys

import torch

from eigenpinns_torch.geometry import native
from eigenpinns_torch.main import cli
from eigenpinns_torch.solvers.multigrid import MultigridTrainer

seed = torch.load(sys.argv[1])
native.available = lambda: False
train = MultigridTrainer.train
MultigridTrainer._build_features = lambda self, *a: seed["feats"].clone()
MultigridTrainer.train = lambda self, h, **kw: train(
    self, h, init_params=seed["init"], guard_block=seed["guard"], **kw)
cli(sys.argv[2:])
"""


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("EIGENPINNS_PLATFORM", None)
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    losses = [float(m) for m in re.findall(r"Epoch +\d+: Loss=([-\d.e+]+)",
                                           out.stdout)]
    summary = json.loads(out.stdout.split("Run summary: ")[1].splitlines()[0])
    return np.asarray(losses), summary


def test_cli_under_torchrun_matches_one_process(tmp_path):
    save_obj(str(tmp_path / "m.obj"), perturbed_icosphere(3))
    (tmp_path / "one").mkdir()
    (tmp_path / "four").mkdir()
    base = ["-m", "eigenpinns_torch.main", "--platform", "cpu",
            "--override", f"mesh_file={tmp_path / 'm.obj'}", *RUN]
    loss1, s1 = _run([*base, "vtu_file=out.vtu"], tmp_path / "one")
    loss4, s4 = _run(["-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node", "4", *base, "mesh_shape=[4]",
                      "vtu_file=out.vtu"], tmp_path / "four")
    assert (s1["world_size"], s4["world_size"]) == (1, 4)
    assert len(loss1) == len(loss4) == 60
    rel = np.abs(loss4 - loss1) / np.abs(loss1)
    assert rel[:F24_WINDOW].max() < 1e-2, rel
    lam1, lam4 = np.asarray(s1["eigenvalues"]), np.asarray(s4["eigenvalues"])
    assert np.abs(lam4[1:] - lam1[1:]).max() / np.abs(lam1[1:]).max() < 1e-4
    assert sorted(os.listdir(tmp_path / "four")) == ["out.vtu"]
    pts1, _, f1 = read_vtu(str(tmp_path / "one" / "out.vtu"))
    pts4, _, f4 = read_vtu(str(tmp_path / "four" / "out.vtu"))
    np.testing.assert_array_equal(pts1, pts4)
    assert list(f1) == list(f4) == ["v0", "v1", "v2", "v3"]


def _jax_mesh_run(obj, overrides):
    """JAX's CLI pipeline (`eigenpinns_tpu/main.py::main`) up to the
    trained result, on the numpy host path; returns the result and the
    seams the port's ranks start from."""
    import jax
    import jax.numpy as jnp
    from eigenpinns_tpu.configs import Config as JConfig
    from eigenpinns_tpu.geometry import load_mesh as j_load_mesh
    from eigenpinns_tpu.geometry import native as j_native
    from eigenpinns_tpu.models import make_corrector as j_make_corrector
    from eigenpinns_tpu.sampling import build_hierarchy as j_build
    from eigenpinns_tpu.solvers.multigrid import MultigridTrainer as JTrainer
    from eigenpinns_tpu.sparse import neighbor_mean_operator as j_nm_op

    from eigenpinns_torch.models import from_flax_params, make_corrector

    kv = {}
    for item in overrides:
        key, _, value = item.partition("=")
        try:
            kv[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            kv[key] = value
    cfg = JConfig().override(mesh_file=obj, **kv)
    seen = {}
    build_features = JTrainer._build_features

    def recording(self, *args):
        seen["feats"] = build_features(self, *args)
        return seen["feats"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        mp.setattr(JTrainer, "_build_features", recording)
        h = j_build(j_load_mesh(obj, normalize=True), cfg.hierarchy,
                    n_modes=cfg.n_modes, sampler_type=cfg.sampler_type,
                    edge_computation_type=cfg.edge_computation_type,
                    k_neighbors=cfg.k_neighbors,
                    prolongation_neighbors=cfg.prolongation_neighbors,
                    pc_neighbors=cfg.pc_neighbors,
                    coarse_solver=cfg.coarse_solver, seed=cfg.seed,
                    operator_format=cfg.operator_format)
        res = JTrainer(cfg).train(h)
    feats = np.asarray(seen["feats"])
    edges = JTrainer(cfg)._concat_edges(h)
    params = j_make_corrector("simple", cfg.hidden_layers, cfg.n_modes).init(
        jax.random.PRNGKey(cfg.seed), jnp.zeros(feats.shape),
        j_nm_op(edges, feats.shape[0]))
    init = from_flax_params(
        make_corrector("simple", feats.shape[1], cfg.hidden_layers,
                       cfg.n_modes),
        jax.tree_util.tree_map(np.asarray, params)).state_dict()
    guard = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(cfg.seed + 7),
        (h.actual_hierarchy[-1], cfg.polish_guard), jnp.float32)))
    seams = {"feats": torch.from_numpy(feats.copy()), "guard": guard,
             "init": {k: v.clone() for k, v in init.items()}}
    return res, seams


def test_cli_under_torchrun_matches_jax_mesh_shape(tmp_path):
    obj = str(tmp_path / "m.obj")
    save_obj(obj, perturbed_icosphere(3))
    overrides = [*RUN, "mesh_shape=[4]"]
    jres, seams = _jax_mesh_run(obj, overrides)
    torch.save(seams, tmp_path / "seams.pt")
    (tmp_path / "seeded_cli.py").write_text(SEEDED_CLI)
    (tmp_path / "four").mkdir()
    loss4, s4 = _run(["-m", "torch.distributed.run", "--standalone",
                      "--nproc_per_node", "4", str(tmp_path / "seeded_cli.py"),
                      str(tmp_path / "seams.pt"), "--platform", "cpu",
                      "--override", f"mesh_file={obj}", *overrides,
                      "vtu_file=out.vtu"], tmp_path / "four")
    jloss = np.asarray(jres.history["loss"])
    assert s4["world_size"] == 4
    assert len(loss4) == len(jloss) == 60
    rel = np.abs(loss4 - jloss) / np.abs(jloss)
    assert rel[:F24_WINDOW].max() < 1e-2, rel
    lam4, jlam = np.asarray(s4["eigenvalues"]), np.asarray(jres.eigenvalues)
    assert np.abs(lam4[1:] - jlam[1:]).max() / np.abs(jlam[1:]).max() < 1e-4
    assert sorted(os.listdir(tmp_path / "four")) == ["out.vtu"]


def test_cli_mesh_shape_must_match_the_launch(tmp_path, monkeypatch):
    obj = str(tmp_path / "m.obj")
    save_obj(obj, perturbed_icosphere(2))
    args = ["--platform", "cpu", "--override", f"mesh_file={obj}",
            f"vtu_file={tmp_path / 'x.vtu'}", *RUN]
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        cli([*args, "mesh_shape=[2]"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("LOCAL_RANK", "0")
    for shape in ("[2]", "[]", "[2, 2]"):
        with pytest.raises(ValueError, match="torchrun"):
            cli([*args, f"mesh_shape={shape}"])
    assert not os.path.exists(tmp_path / "x.vtu")


def test_cli_one_rank_mesh_outside_torchrun(tmp_path, monkeypatch, capsys):
    """mesh_shape [1] outside torchrun runs the sharded trainer on a
    one-rank group of its own, and leaves no group behind."""
    import torch.distributed as dist

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    obj = str(tmp_path / "m.obj")
    save_obj(obj, perturbed_icosphere(2))
    cli(["--platform", "cpu", "--override", f"mesh_file={obj}",
         f"vtu_file={tmp_path / 'x.vtu'}", *RUN, "epochs=4",
         "polish_iters=0", "mesh_shape=[1]"])
    summary = json.loads(capsys.readouterr().out.split("Run summary: ")[1]
                         .splitlines()[0])
    assert summary["world_size"] == 1 and summary["epochs_run"] == 4
    assert np.isfinite(summary["eigenvalues"]).all()
    assert not dist.is_initialized()
    assert os.path.exists(tmp_path / "x.vtu")
