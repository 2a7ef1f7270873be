"""The port's CLI layer against the JAX package (CPU, small).

  * The sectioned-YAML reader returns what `yaml.safe_load` returns on
    files of the reference's subset, PyYAML's YAML 1.1 readings included,
    and raises ValueError naming the line on anything outside it;
    `Config.from_yaml` equals the JAX package's on such a file.
  * A VTU written by either package reads back the same through the
    other's reader.
  * `comprehensive_diagnostics` gives the JAX package's numbers to 1e-10
    and writes its png.
  * Both packages' `cli` on one .obj at tiny settings export VTUs with
    the same points and fields, whose vectors' Rayleigh quotients agree
    to 1e-4 between the packages and to 1e-3 with eigsh; the port's `cli`
    without `--platform` on a machine without a card raises.
"""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from eigenpinns_tpu.configs import Config as JConfig
from eigenpinns_tpu.diagnostics import (
    comprehensive_diagnostics as j_diagnostics,
)
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh
from eigenpinns_tpu.io import read_vtu as j_read_vtu
from eigenpinns_tpu.io import save_eigenfunctions as j_save_eigenfunctions
from eigenpinns_tpu.io import write_vtu as j_write_vtu
from eigenpinns_tpu.main import cli as j_cli
from eigenpinns_torch.configs import Config
from eigenpinns_torch.configs.yaml_reader import loads
from eigenpinns_torch.diagnostics import comprehensive_diagnostics
from eigenpinns_torch.geometry import (
    assemble_stiffness_mass,
    load_mesh,
    save_obj,
)
from eigenpinns_torch.io import read_vtu, save_eigenfunctions, write_vtu
from eigenpinns_torch.main import cli
from eigenpinns_torch.solvers import eigsh_smallest
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

torch.set_num_threads(2)

# The reference's parameters.yml layout, every value form it uses.
REFERENCE_LIKE = """\
config:
  mesh_file: "./resources/bunny.obj"
  coarse_mesh_files: ["./resources/coarse_1.obj", './resources/coarse_2.obj']
  diagnostics_viz: ./outputs/diagnostics.png
  vtu_file: "./outputs/bunny_model.vtu"
  verbose: False
  do_extensive_visuals: false

sampler:
  sampler_type: 'farthest_point'   # or voxel_downsampling
  edge_computation_type: knn_based

utils:
  normalization_eps: 1.0e-9
  prolongation_neighbors: 21
  knn_graph_neighbors: 21

correctorGNN:
  model_type: simple
  hidden_layers: [256, 256, 256, 256, 256, 256]
  dropout: 0.0

multigridGNN:
  epochs: 10000
  learning_rate: 0.001
  corrector_scale: 10.0
  weight_residual: 1000.0
  weight_orthogonal: 10.0
  weight_projection: 0.0
  weight_trace: 0.0
  w_order: 0.0
  w_eigen: 0.0
  gradient_clipping: 10.0
  weight_decay: 0.00001
  log_every: 1000

runner:
  n_modes: 64
  hierarchy:
    - 256
    - 512
    - 1024
  k_neighbors: 21
"""

# Every construct and YAML 1.1 quirk of the subset.
QUIRKS = """\
# a comment line
plain:
  word: hello world   # trailing comment
  hash_inside: a#b
  url: http://example.org/x
  colon_inside: a:b
  dash_start: -x
  question: ?x
  dotted: ./outputs/x.png
quoted:
  single: 'it''s # not a comment'
  double: "a # not a comment, 'single' inside"
  empty_single: ''
  empty_double: ""
  looks_int: '12'
  looks_bool: "yes"
  tight: 'x'# comment right after the quote
numbers:
  int: 42
  negative: -7
  plus: +3
  zero: 0
  not_octal: 08
  float: 0.001
  exp_dot: 1.0e-3
  exp_plus: 1.5E+2
  no_dot_exp: 1e-3
  unsigned_exp: 1.0e3
  trailing_dot: 1.
  leading_dot: .5
  inf: .inf
  neg_inf: -.Inf
  nan: .NaN
bools:
  t: true
  T: True
  TT: TRUE
  f: false
  y: yes
  n: No
  on_: On
  off_: OFF
  not_bool_y: y
  not_bool_mixed: tRue
nulls:
  tilde: ~
  word: null
  Word: Null
  empty:
  spaces:    # only a comment
lists:
  flow: [256, 512, 1024]
  mixed: [1, 2.5, yes, ~, 'a, b', "c", d e]
  nested: [[1, 2], [], [3]]
  trailing_comma: [1, 2,]
  empty: []
  spaced: [ ]
  tight_comment: [1,2]#c
  block_same_indent:
  - 1
  - [2, 3]
  - 'x'
  -
  block_deeper:
      - 1e-3
      - 0.5
2: int key
yes: bool key
top_scalar: 5
"""


def _same(a, b) -> bool:
    """Equality with NaN equal to NaN, types included."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(_same(a[k], b[k]) for k in a))
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@pytest.mark.parametrize("text", [REFERENCE_LIKE, QUIRKS,
                                  QUIRKS.replace("\n", "\r\n"),
                                  "\ufeff" + REFERENCE_LIKE,
                                  "", "# nothing but a comment\n\n",
                                  "  indented:\n    a: 1\n  b: [2]\n"],
                         ids=["reference", "quirks", "crlf", "bom", "empty",
                              "comments", "indented"])
def test_yaml_reader_equals_safe_load(text):
    ours, ref = loads(text), yaml.safe_load(text)
    assert _same(ours, ref), (ours, ref)


def test_yaml_reader_quirks_read_as_pyyaml_reads_them():
    doc = loads(QUIRKS)
    n = doc["numbers"]
    assert n["no_dot_exp"] == "1e-3" and n["unsigned_exp"] == "1.0e3"
    assert n["exp_dot"] == 1.0e-3 and n["trailing_dot"] == 1.0
    assert n["neg_inf"] == -math.inf and n["not_octal"] == "08"
    assert doc["bools"]["y"] is True and doc["bools"]["off_"] is False
    assert doc["bools"]["not_bool_y"] == "y"
    assert doc["lists"]["block_deeper"] == ["1e-3", 0.5]
    assert doc[2] == "int key" and doc[True] == "bool key"


OUTSIDE = {
    "flow_mapping": ("a:\n  b: {c: 1}\n", 2),
    "anchor": ("a:\n  b: &x 1\n", 2),
    "alias": ("a:\n  b: *x\n", 2),
    "tag": ("a:\n  b: !!str 1\n", 2),
    "block_scalar": ("a:\n  b: |\n    text\n", 2),
    "folded_scalar": ("a:\n  b: >\n    text\n", 2),
    "multi_line_plain": ("a:\n  b: one\n    two\n", 3),
    "multi_line_quoted": ("a:\n  b: 'one\n    two'\n", 2),
    "multi_line_flow": ("a:\n  b: [1,\n    2]\n", 2),
    "complex_key": ("? a\n: 1\n", 1),
    "merge_key": ("a:\n  <<: 1\n", 2),
    "timestamp": ("a:\n  b: 2001-12-14\n", 2),
    "value_tag": ("a:\n  b: =\n", 2),
    "second_document": ("a: 1\n---\nb: 2\n", 2),
    "document_end": ("a: 1\n...\n", 2),
    "directive": ("%YAML 1.1\n---\na: 1\n", 1),
    "tab_indent": ("a:\n\tb: 1\n", 2),
    "tab_in_value": ("a:\n  b: x\ty\n", 2),
    "mapping_in_value": ("a:\n  b: c: d\n", 2),
    "mapping_in_list": ("a:\n  - b: 1\n", 2),
    "nested_block_list": ("a:\n  - - 1\n", 2),
    "block_under_item": ("a:\n  -\n    b\n", 3),
    "top_level_list": ("- 1\n- 2\n", 1),
    "bare_scalar_line": ("a:\n  just words\n", 2),
    "no_space_after_colon": ("a:\n  b:1\n", 2),
    "bad_dedent": ("a:\n    b: 1\n  c: 2\n", 3),
    "bad_indent": ("a: 1\n  b: 2\n", 2),
    "unterminated_quote": ("a:\n  b: 'x\n", 2),
    "unterminated_flow": ("a: [1, 2\n", 1),
    "empty_flow_item": ("a: [1, , 2]\n", 1),
    "text_after_flow": ("a: [1] x\n", 1),
    "text_after_quote": ("a: 'x' y\n", 1),
    "bad_escape": ('a: "\\q"\n', 1),
    "reserved_char": ("a: @x\n", 1),
    "list_in_mapping": ("a: 1\n- 2\n", 2),
    "nested_below_section": ("a:\n  b:\n    c: 1\n", 3),
    "quoted_key": ("a:\n  'b': 1\n", 2),
    "document_start": ("---\na: 1\n", 1),
    "known_escape": ('a:\n  b: "tab\\there"\n', 2),
    "octal_int": ("a:\n  b: 017\n", 2),
    "hex_int": ("a:\n  b: 0x1F\n", 2),
    "binary_int": ("a:\n  b: 0b101\n", 2),
    "underscore_int": ("a:\n  b: 1_000\n", 2),
    "base60_int": ("a:\n  b: 1:30\n", 2),
    "underscore_float": ("a:\n  b: 1_2.3_4\n", 2),
    "base60_float": ("a:\n  b: 1:30.5\n", 2),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_yaml_reader_raises_outside_the_subset(name):
    text, line = OUTSIDE[name]
    with pytest.raises(ValueError, match=f"line {line}:"):
        loads(text)


def test_config_from_yaml_equals_jax_and_never_imports_yaml(tmp_path,
                                                            monkeypatch):
    path = tmp_path / "parameters.yml"
    path.write_text(REFERENCE_LIKE)
    monkeypatch.setitem(__import__("sys").modules, "yaml", None)
    cfg = Config.from_yaml(str(path))
    monkeypatch.undo()
    assert cfg == Config(**vars(JConfig.from_yaml(str(path))))
    assert cfg.weight_decay == 1e-5 and cfg.hierarchy == [256, 512, 1024]
    assert cfg.override(n_modes=3).n_modes == 3
    path.write_text("runner:\n  n_modes: 5\n  bogus: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        Config.from_yaml(str(path))


# ---- VTU and diagnostics -------------------------------------------------

@pytest.fixture(scope="module")
def mesh():
    return perturbed_icosphere(2)


def test_vtu_cross_reads(mesh, tmp_path):
    rng = np.random.default_rng(0)
    U = rng.standard_normal((mesh.n_verts, 3))
    data = {"u": U[:, 0], "w": U[:, 1].astype(np.float32)}
    write_vtu(str(tmp_path / "t.vtu"), mesh.verts, mesh.faces, data)
    j_write_vtu(str(tmp_path / "j.vtu"), mesh.verts, mesh.faces, data)
    save_eigenfunctions(str(tmp_path / "te.vtu"), mesh, U, 2)
    j_save_eigenfunctions(str(tmp_path / "je.vtu"),
                          JTriMesh(mesh.verts, mesh.faces), U, 2)
    for ours, theirs in (("t", "j"), ("te", "je")):
        for reader in (read_vtu, j_read_vtu):
            a = reader(str(tmp_path / f"{ours}.vtu"))
            b = reader(str(tmp_path / f"{theirs}.vtu"))
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert list(a[2]) == list(b[2])
            for name in a[2]:
                np.testing.assert_array_equal(a[2][name], b[2][name])
    pts, tris, fields = j_read_vtu(str(tmp_path / "te.vtu"))
    assert list(fields) == ["v0", "v1"] and pts.shape == mesh.verts.shape
    np.testing.assert_array_equal(fields["v1"], U[:, 1])
    np.testing.assert_array_equal(tris, mesh.faces)


def test_diagnostics_equal_jax(mesh, tmp_path):
    K, M = assemble_stiffness_mass(mesh)
    vals, vecs = eigsh_smallest(K, M, 6)
    rng = np.random.default_rng(1)
    # Exact modes, shuffled, sign-flipped and perturbed.
    U = (vecs[:, [1, 0, 3, 2, 5, 4]] * np.array([1, -1, 1, -1, 1, 1])
         + 1e-3 * rng.standard_normal(vecs.shape))
    png = tmp_path / "d" / "diag.png"
    rep = comprehensive_diagnostics(U, K, M, n_modes=6, plot_path=str(png),
                                    verbose=False)
    jrep = j_diagnostics(U, K, M, n_modes=6, verbose=False)
    for field in ("lambda_exact", "lambda_pred", "abs_errors", "rel_errors",
                  "cosine_similarity", "subspace_error", "orthonormality"):
        np.testing.assert_allclose(getattr(rep, field), getattr(jrep, field),
                                   rtol=1e-10, atol=1e-10)
    assert rep.summary() == jrep.summary()
    assert rep.cosine_similarity.min() > 0.99
    assert png.stat().st_size > 0


# ---- the CLI of both packages --------------------------------------------

TINY = ["n_modes=4", "hierarchy=[32,64]", "hidden_layers=[16,16]",
        "epochs=30", "scan_chunk=10", "polish_iters=50", "log_every=0"]


def _rayleigh(vtu, K, M, k):
    _, _, fields = read_vtu(vtu)
    U = np.stack([fields[f"v{i}"] for i in range(k)], axis=1)
    return (np.sum(U * (K @ U), axis=0) / np.sum(U * (M @ U), axis=0))


@pytest.mark.parametrize("route", ["graph_coarsening", "farthest_point"])
def test_both_clis_agree(tmp_path, route):
    """One .obj through both packages' CLI; the port's reads its config
    from a sectioned YAML file, the JAX package's from overrides."""
    m = perturbed_icosphere(3)
    obj = str(tmp_path / "m.obj")
    save_obj(obj, m)
    extra = ([f"sampler_type={route}",
              "edge_computation_type=connectivity_based",
              "operator_format=auto"]
             if route == "graph_coarsening" else [])
    (tmp_path / "p.yml").write_text(
        f"config:\n  mesh_file: '{obj}'\n  diagnostics_viz: ''\n"
        f"runner:\n  n_modes: 4\n  hierarchy: [32, 64]\n")
    cli(["--platform", "cpu", "--config", str(tmp_path / "p.yml"),
         "--override", f"vtu_file={tmp_path / 't.vtu'}", *TINY[2:], *extra])
    j_cli(["--override", f"mesh_file={obj}", "diagnostics_viz=",
           f"vtu_file={tmp_path / 'j.vtu'}", *TINY, *extra])
    pts, tris, fields = read_vtu(str(tmp_path / "t.vtu"))
    jpts, jtris, jfields = read_vtu(str(tmp_path / "j.vtu"))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(tris, jtris)
    assert list(fields) == list(jfields) == ["v0", "v1", "v2", "v3"]
    # The exports are in the input mesh's vertex order: their Rayleigh
    # quotients on the normalized mesh's operators are the eigenvalues.
    K, M = assemble_stiffness_mass(load_mesh(obj))
    if route == "farthest_point":
        from eigenpinns_torch.geometry import point_cloud_laplacian

        K, M = point_cloud_laplacian(load_mesh(obj).verts, n_neighbors=30)
    lam = _rayleigh(str(tmp_path / "t.vtu"), K, M, 4)
    jlam = _rayleigh(str(tmp_path / "j.vtu"), K, M, 4)
    vals, _ = eigsh_smallest(K, M, 4)
    np.testing.assert_allclose(lam[1:], jlam[1:], rtol=1e-4)
    np.testing.assert_allclose(lam[1:], vals[1:], rtol=1e-3)
    assert abs(lam[0]) < 1e-5


def test_cli_without_platform_needs_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.delenv("EIGENPINNS_PLATFORM", raising=False)
    obj = str(tmp_path / "m.obj")
    save_obj(obj, perturbed_icosphere(1))
    with pytest.raises(RuntimeError, match="cuda"):
        cli(["--override", f"mesh_file={obj}", *TINY])
    monkeypatch.setenv("EIGENPINNS_PLATFORM", "gpu")
    with pytest.raises(RuntimeError, match="cuda"):
        cli(["--override", f"mesh_file={obj}", *TINY])
    with pytest.raises(SystemExit):
        cli(["--platform", "tpu", "--override", f"mesh_file={obj}"])
    assert not os.path.exists(tmp_path / "outputs")


def test_module_entry_point_runs_without_jax_or_yaml(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    save_obj(str(tmp_path / "m.obj"), perturbed_icosphere(2))
    (tmp_path / "p.yml").write_text(
        "config:\n  mesh_file: m.obj\n  vtu_file: out/m.vtu\n"
        "  diagnostics_viz: ''\nrunner:\n  n_modes: 3\n"
        "  hierarchy: [24, 64]\n")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['eigenpinns-torch', '--config', 'p.yml', '--platform',"
        " 'cpu', '--override', 'hidden_layers=[8]', 'epochs=4',"
        " 'scan_chunk=2', 'polish_iters=20']\n"
        "runpy.run_module('eigenpinns_torch.main', run_name='__main__')\n"
        "bad = [m for m in ('jax', 'yaml', 'eigenpinns_tpu')"
        " if m in sys.modules]\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "COMPREHENSIVE DIAGNOSTICS" in out.stdout
    _, _, fields = read_vtu(str(tmp_path / "out" / "m.vtu"))
    assert list(fields) == ["v0", "v1", "v2"]
