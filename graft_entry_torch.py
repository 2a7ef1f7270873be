"""Entry points of the PyTorch port (`eigenpinns_torch`), beside the JAX
package's `__graft_entry__.py`.

  * `entry(device="cuda")` returns (fn, example_args): one forward + loss
    evaluation of the flagship corrector model (physics features ->
    SimpleCorrector -> composite eigen loss) on a small synthetic problem.
  * `dryrun_multichip(n)` runs the six legs of the JAX dryrun on `n`
    ranks (`eigenpinns_torch.parallel.spawn`; gloo on the CPU by
    default): the data-parallel step, the halo ring + psum'd Gram, the
    2-axis mesh, the sharded joint trainer, sharded LOBPCG and the
    sharded multigrid pipeline. Each leg prints a start and an end line
    (rank 0) and runs under a watchdog.

    python3 graft_entry_torch.py          # entry() on the CPU + dryrun(8)

Imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np


def _synthetic_problem(n=256, seed=0):
    """Small sphere-cloud eigenproblem, built on the host: (X, L, M)."""
    from eigenpinns_torch.geometry import point_cloud_laplacian

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=12)
    return X.astype(np.float32), L, M


def entry(device="cuda"):
    """(fn, example_args): fn(feats, U_base) -> the composite loss of one
    corrector forward, its parameters built from a fixed seed."""
    import torch

    from eigenpinns_torch.losses import (
        gram_orthogonality,
        rayleigh_and_residual,
    )
    from eigenpinns_torch.models import make_corrector
    from eigenpinns_torch.sampling.knn import knn_graph
    from eigenpinns_torch.sparse import as_operator, neighbor_mean_operator

    n, k = 256, 8
    X, L, M = _synthetic_problem(n)
    K_op, M_op = as_operator(L, device=device), as_operator(M, device=device)
    graph = neighbor_mean_operator(knn_graph(X, 8), n, device=device)
    gen = torch.Generator("cpu").manual_seed(0)
    feats = torch.cat([torch.as_tensor(X), torch.ones((n, 5)),
                       torch.randn((n, k), generator=gen)], dim=1).to(device)
    U_base = (0.1 * torch.randn((n, k), generator=gen)).to(device)
    model = make_corrector("simple", feats.shape[1], [64, 64], k).to(device)
    model.reset_parameters(torch.Generator(device).manual_seed(2))

    def fn(feats, U_base):
        U = U_base + model(feats, graph)
        lam, res = rayleigh_and_residual(U, K_op, M_op)
        return (1000.0 * res + 10.0 * gram_orthogonality(U, M_op)
                + lam.mean())

    return fn, (feats, U_base)


class _Leg:
    """Start/end line and a SIGALRM watchdog for one dryrun leg, so a
    wedged leg fails loudly and the output names the leg it was in."""

    BUDGET_S = 300

    def __init__(self, idx, total, name, verbose):
        self.idx, self.total, self.name = idx, total, name
        self.verbose = verbose

    def _say(self, text):
        if self.verbose:
            print(f"[dryrun] leg {self.idx}/{self.total}: {self.name} "
                  f"{text}", flush=True)

    def __enter__(self):
        import signal
        import time

        self._say("...")
        self.t0 = time.time()
        self._prev = None
        if hasattr(signal, "SIGALRM"):
            def _on_alarm(signum, frame):
                raise TimeoutError(
                    f"dryrun leg {self.idx} ({self.name}) exceeded "
                    f"{self.BUDGET_S}s budget")
            self._prev = signal.signal(signal.SIGALRM, _on_alarm)
            signal.alarm(self.BUDGET_S)
        return self

    def __exit__(self, exc_type, exc, tb):
        import signal
        import time

        if self._prev is not None:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, self._prev)
        status = "OK" if exc_type is None else f"FAILED ({exc_type.__name__})"
        self._say(f"{status} in {time.time() - self.t0:.1f}s")
        return False


def _dryrun_rank(device_type: str) -> dict:
    """The six legs on this rank of the spawned group."""
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from eigenpinns_torch.losses import (
        gram_orthogonality,
        rayleigh_and_residual,
        zero_mean,
    )
    from eigenpinns_torch.models import JointEigenNet
    from eigenpinns_torch.parallel import (
        ShardedOperator,
        all_gather_spmm,
        gather_rows,
        halo_spmm,
        make_dp_train_step,
        make_mesh,
        pad_to_multiple,
        psum,
        psum_gram,
        shard_array,
    )
    from eigenpinns_torch.sparse import FunctionOperator, SparseELL
    from eigenpinns_torch.train.optim import Adam

    n_devices = dist.get_world_size()
    verbose = dist.get_rank() == 0
    out = {}

    with _Leg(1, 6, "data-parallel train step (psum'd reductions)",
              verbose):
        mesh = make_mesh(n_devices, device_type=device_type)
        dev = mesh.device
        k = 4
        X, K, M = _synthetic_problem(n=8 * ((200 + n_devices - 1) // 8) or 8)
        Xp, n_orig = pad_to_multiple(X, n_devices)
        n_pad = Xp.shape[0]
        if n_pad != n_orig:   # identity on the padding
            K = sp.block_diag([K, sp.eye(n_pad - n_orig)]).tocsr()
            M = sp.block_diag([M, sp.eye(n_pad - n_orig)]).tocsr()

        def sharded_op(A):
            op = ShardedOperator.from_ell(
                SparseELL.from_scipy(A, device="cpu"), n_devices)
            d = shard_array(np.asarray(A.diagonal(), np.float32), mesh,
                            "data")
            return FunctionOperator(
                all_gather_spmm(op, mesh), d,
                reduce=lambda x: psum(x, mesh), n=n_pad)

        Kp, Mp = sharded_op(K), sharded_op(M)
        model = JointEigenNet(3, (32, 32), k).to(dev)
        model.reset_parameters(torch.Generator(dev).manual_seed(0))
        opt = Adam(model.parameters(), lambda t: 1e-3)

        def loss_fn(batch):
            U = model(batch)
            lam, res = rayleigh_and_residual(U, Kp, Mp)
            return (1000.0 * res + 10.0 * gram_orthogonality(U, Mp)
                    + lam.mean() + 0.1 * zero_mean(U, Mp))

        step = make_dp_train_step(loss_fn, opt, mesh)
        loss = float(step(shard_array(Xp, mesh, "data")))
        assert np.isfinite(loss), f"non-finite loss {loss}"
        out["dp_loss"] = loss

    with _Leg(2, 6, "halo-ring SpMM (ring exchange) + psum Gram", verbose):
        n_band = 16 * n_devices
        off = np.full(n_band - 1, -0.5)
        Kb = sp.diags([off, np.full(n_band, 2.0), off], [-1, 0, 1]).tocsr()
        op2 = ShardedOperator.from_ell(SparseELL.from_scipy(Kb,
                                                            device="cpu"),
                                       n_devices)
        U2 = np.random.default_rng(1).normal(size=(n_band, k)).astype(
            np.float32)
        u2 = shard_array(U2, mesh, "data")
        y = halo_spmm(op2, mesh)(u2)
        G = psum_gram(mesh)(u2, u2)
        full = gather_rows(y, mesh).cpu().numpy()
        ref = Kb @ U2.astype(np.float64)
        assert np.abs(full[:n_band] - ref).max() < 1e-4
        assert np.abs(G.cpu().numpy() - U2.T @ U2).max() < 1e-3

    with _Leg(3, 6, "2-axis (data x model) product mesh", verbose):
        # The ring and the Gram psum address only their named axis: the
        # operands are replicated along the second axis.
        if n_devices >= 4 and n_devices % 2 == 0:
            mesh2 = make_mesh(n_devices, axis_names=("data", "model"),
                              shape=(n_devices // 2, 2),
                              device_type=device_type)
            op2b = ShardedOperator.from_ell(
                SparseELL.from_scipy(Kb, device="cpu"), n_devices // 2)
            u2b = shard_array(U2, mesh2, "data")
            y2 = gather_rows(halo_spmm(op2b, mesh2, axis="data")(u2b),
                             mesh2)
            G2 = psum_gram(mesh2, axis="data")(u2b, u2b)
            assert np.abs(y2.cpu().numpy()[:n_band] - ref).max() < 1e-4
            assert np.abs(G2.cpu().numpy() - U2.T @ U2).max() < 1e-3
        elif verbose:
            print("[dryrun]   (skipped: needs even n_devices >= 4)",
                  flush=True)

    with _Leg(4, 6, "sharded production joint trainer", verbose):
        from eigenpinns_torch.geometry import point_cloud_laplacian
        from eigenpinns_torch.solvers import train_joint_sharded

        rng = np.random.default_rng(7)
        Xc = rng.normal(size=(600, 3))
        Xc /= np.linalg.norm(Xc, axis=1, keepdims=True)
        Lc, Mc = point_cloud_laplacian(Xc, n_neighbors=12)
        res = train_joint_sharded(
            Lc, Mc, Xc, n_modes=4, mesh=mesh, hidden=(16, 16), epochs=3,
            scan_chunk=3, lr_start=1e-3, lr_end=1e-3, w_res=1.0,
            w_orth=10.0)
        assert np.isfinite(res.history["loss"]).all()
        assert np.isfinite(res.eigenvalues).all()
        out["trainer_loss"] = float(res.history["loss"][-1])

    with _Leg(5, 6, "node-sharded LOBPCG solver", verbose):
        from eigenpinns_torch.solvers import lobpcg_sharded

        vals_s, vecs_s, _ = lobpcg_sharded(Lc, Mc, k=3, mesh=mesh, X=Xc,
                                           max_iter=25, tol=1e-5)
        assert np.isfinite(vals_s).all() and np.isfinite(vecs_s).all()
        assert abs(vals_s[0]) < 1.0, vals_s      # rigid-body mode ~ 0
        out["lobpcg"] = vals_s

    with _Leg(6, 6, "sharded multigrid production pipeline", verbose):
        from eigenpinns_torch.configs import Config
        from eigenpinns_torch.geometry.mesh import TriMesh
        from eigenpinns_torch.sampling import build_hierarchy
        from eigenpinns_torch.solvers import MultigridTrainer

        g = 10
        xs, ys = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
        verts = np.stack([xs.ravel(), ys.ravel(),
                          0.05 * np.sin(6 * xs.ravel())], axis=1)
        quads = (np.arange(g * g).reshape(g, g))[:-1, :-1].ravel()
        faces = np.concatenate([
            np.stack([quads, quads + 1, quads + g], axis=1),
            np.stack([quads + 1, quads + g + 1, quads + g], axis=1)])
        h = build_hierarchy(TriMesh(verts, faces), [40, g * g], n_modes=3,
                            sampler_type="farthest_point", pc_neighbors=10,
                            device=dev)
        cfg = Config(n_modes=3, hierarchy=[40, g * g],
                     hidden_layers=[16, 16], epochs=4, scan_chunk=2,
                     scale_ramp_epochs=4, log_every=0,
                     plateau_patience=10_000, weight_projection=0.1,
                     polish_iters=0)
        mg = MultigridTrainer(cfg).train(h, mesh=mesh)
        assert np.isfinite(mg.history["loss"]).all()
        assert np.isfinite(mg.eigenvalues).all()
        out["multigrid_loss"] = float(mg.history["loss"][-1])
    return out


def dryrun_multichip(n_devices: int, backend: str = "gloo",
                     device: str = "cpu") -> dict:
    """The six legs on `n_devices` spawned ranks (`backend`, `device` as
    `parallel.spawn` takes them); returns rank 0's figures and prints
    them."""
    from eigenpinns_torch.parallel import spawn

    print(f"[dryrun] spawning {n_devices} {backend} ranks on {device}",
          flush=True)
    out = spawn(_dryrun_rank, n_devices, backend=backend, device=device,
                args=("cpu" if device == "cpu" else "cuda",))[0]
    print(f"dryrun_multichip({n_devices}): OK, dp loss={out['dp_loss']:.4f},"
          f" halo-spmm + psum-gram verified, sharded production trainer "
          f"loss={out['trainer_loss']:.4f}, sharded LOBPCG "
          f"lam[:3]={np.round(out['lobpcg'], 3)}, sharded MULTIGRID loss="
          f"{out['multigrid_loss']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    fn, args = entry(device="cpu")
    print("entry() check: loss =", float(fn(*args).detach()))
    dryrun_multichip(8)
