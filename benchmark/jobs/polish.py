"""The job `polish`: the published guarded LOBPCG polish (`lobpcg`) from
the start that one training job made in set-up, run after run, each with
its own guard columns seeded by (seed, run index). Each run's lowest
n_modes eigenpairs are judged in float64: their scaled residual, their
M-orthonormality, and their eigenvalues against the lowest of (K, M)."""

from __future__ import annotations

import collections
import contextlib
import os

import numpy as np
import torch

import harness
import reference

WARM_POLISH_ITERS = 10
BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Jobs:
    """Polishes of one trained start."""

    kind = "polish"

    def __init__(self, cfg, op, M, Xp, perm, seed, device):
        self.cfg, self.M, self.seed, self.device = cfg, M, seed, device
        self.perm = perm
        # The training job that makes the start.
        self.train = harness.load_jobs("train", BENCH_DIR).Jobs(
            cfg, op, M, Xp, perm, seed, device)
        self.op = op.with_precision("highest") if hasattr(
            op, "with_precision") else op
        self.n = Xp.shape[0]
        self.start = None

    def x0(self, stream) -> torch.Tensor:
        guard = self.cfg["polish"]["guard"]
        gen = torch.Generator(self.device).manual_seed(
            harness.job_seed(self.seed, *stream))
        G = torch.randn((self.n, guard), generator=gen, device=self.device)
        return torch.cat([self.start, G], dim=1)

    def warm(self) -> None:
        from eigenpinns_torch.solvers import lobpcg

        res = self.train._train(("start",))
        self.start = torch.as_tensor(res.eigenvectors, dtype=torch.float32,
                                     device=self.device)
        lobpcg(self.op, self.M, self.x0(("warm",)),
               max_iter=WARM_POLISH_ITERS, tol=0.0).iterations.item()

    def job(self, j: int) -> dict:
        from eigenpinns_torch.solvers import lobpcg

        p = self.cfg["polish"]
        pol = lobpcg(self.op, self.M, self.x0(("polish", j)),
                     max_iter=p["max_iter"], tol=p["tol"])
        return {"j": j, "iterations": int(pol.iterations),
                "lam": pol.eigenvalues, "V": pol.eigenvectors}

    def release(self, records: list) -> None:
        """Moves the answers to the host; frees the port's state."""
        for rec in records:
            rec["lam"] = rec["lam"].double().cpu().numpy()
            rec["V"] = rec["V"].cpu().numpy()
        self.op = self.M = self.train = self.start = None
        harness.free(self.device)

    def judge(self, records, inp) -> tuple:
        """({number: worst value}, [numbers per run]): each run's lowest
        n_modes eigenpairs, its rows mapped back through the port's
        ordering, by `reference.eigen_judge`, and their eigenvalues'
        `reference.eigenvalue_gap` to the lowest n_modes of (K, M) (made
        once a checkout and kept beside the inputs)."""
        k = self.cfg["train"]["n_modes"]
        lam_ref = inp.cached(
            f"lowest{k}",
            lambda: {"lam": reference.lowest_eigenvalues(inp.K, inp.m, k)},
            reference.__file__)["lam"]
        worst = collections.defaultdict(float)
        per_run = []
        for rec in records:
            order = np.argsort(rec["lam"])[:k]
            V = np.empty((inp.K.shape[0], k))
            V[self.perm] = rec["V"][:, order]
            nums = reference.eigen_judge(rec["lam"][order], V, inp.K, inp.m)
            nums["eig_gap"] = reference.eigenvalue_gap(rec["lam"], lam_ref)
            for key, v in nums.items():
                worst[key] = max(worst[key], v)
            per_run.append(nums)
        return dict(worst), per_run

    @staticmethod
    def work(records: list) -> dict:
        return {"jobs": len(records),
                "iterations": sum(r["iterations"] for r in records)}


# ---- the readings that set the limits (control.py) ------------------------

@contextlib.contextmanager
def tf32():
    """float32 products on the tensor cores in TF32, for the duration."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def readings(spec, seed, inp, device, root, controls: bool,
             n_jobs: int = 1) -> dict:
    """`n_jobs` polishes of the program judged as a run judges them; with
    `controls`, one more with TF32 on (the control: the port turns TF32
    off for its float32 products), and the fault of an answer altered
    where it is produced: the first polish's pairs without its lowest."""
    jobs, _, _ = harness.setup(spec, seed, inp, device, root)
    records = [jobs.job(j) for j in range(n_jobs)]
    if controls:
        with tf32():
            records.append(jobs.job(n_jobs))
    jobs.release(records)
    if controls:
        first = records[0]
        keep = np.argsort(first["lam"])[1:]
        records.append({**first, "lam": first["lam"][keep],
                        "V": first["V"][:, keep]})
    per_run = jobs.judge(records, inp)[1]
    out = {"program": {key: max(r[key] for r in per_run[:n_jobs])
                       for key in per_run[0]},
           "program_jobs": per_run[:n_jobs]}
    if controls:
        out["tf32"], out["lowest_dropped"] = per_run[n_jobs:]
    return out
