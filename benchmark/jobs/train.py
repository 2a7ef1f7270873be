"""The job `train`: a whole published training job (`train_joint`) from a
fresh network and optimizer seeded by (seed, job index), judged by its
first steps against the plain reference's from the same parameters."""

from __future__ import annotations

import collections

import numpy as np
import torch

import harness
import reference


class FirstSteps:
    """Reads, from the timed path, what the reference follows: the first
    gradient as the optimizer gets it and the parameters after three
    updates. A global forward pre-hook on the joint eigen-network finds
    its parameters; hooks after gradient accumulation copy the first
    gradients; the network's fourth forward (step 3's, before step 3's
    update) copies the parameters. Every hook is removed once it has
    read."""

    def __init__(self):
        self.grad: dict = {}
        self.params: dict = {}
        self.calls = 0
        self._handles: list = []
        self._global = torch.nn.modules.module.register_module_forward_pre_hook(
            self._forward)

    def _forward(self, module, args):
        if type(module).__name__ != "JointEigenNet":
            return
        named = dict(module.named_parameters())
        if self.calls == 0:
            for name, p in named.items():
                self._handles.append(p.register_post_accumulate_grad_hook(
                    lambda p, name=name: self._grad(name, p)))
        elif self.calls == reference.REF_STEPS:
            self.params = {name: p.detach().clone()
                           for name, p in named.items()}
            self.close()
        self.calls += 1

    def _grad(self, name, p):
        if name not in self.grad:
            self.grad[name] = p.grad.detach().clone()
        if len(self.grad) == len(self._handles):
            for h in self._handles:
                h.remove()
            self._handles = []

    def close(self) -> None:
        self._global.remove()
        for h in self._handles:
            h.remove()
        self._handles = []


class Jobs:
    """Whole published training jobs, each from a fresh network and
    optimizer seeded by (seed, job index)."""

    kind = "train"

    def __init__(self, cfg, op, M, Xp, perm, seed, device):
        self.cfg, self.op, self.M, self.Xp = cfg, op, M, Xp
        self.perm, self.seed, self.device = perm, seed, device
        self.dims = [3, *cfg["train"]["hidden"], cfg["train"]["n_modes"]]
        self.probe = None

    def _train(self, stream, **over):
        from eigenpinns_torch.solvers import train_joint

        params = harness.init_params(self.seed, stream, self.dims,
                                     self.device)
        return train_joint(self.op, self.M, self.Xp, device=self.device,
                           init_params=params, **{**self.cfg["train"],
                                                  **over})

    def warm(self) -> None:
        chunk = self.cfg["train"]["scan_chunk"]
        self._train(("warm",), epochs=chunk)

    def job(self, j: int) -> dict:
        if j == 0:
            self.probe = FirstSteps()
        res = self._train(("train", j))
        if j == 0:
            self.probe.close()
        return {"j": j, "steps": res.epochs_run,
                "history": {key: np.asarray(v[:reference.REF_STEPS],
                                            dtype=np.float64)
                            for key, v in res.history.items()}}

    def release(self, records: list) -> None:
        """Keeps what the judge reads, on the host; frees the port's state."""
        p = self.probe
        self.first = None if p is None else (
            {key: v.cpu() for key, v in p.grad.items()},
            {key: v.cpu() for key, v in p.params.items()})
        self.op = self.M = self.probe = None
        harness.free(self.device)

    def judge(self, records, inp) -> tuple:
        """({number: worst value}, [numbers per job]) against the
        reference's first steps from the same parameters."""
        cfg, device = self.cfg["train"], self.device
        worst = collections.defaultdict(float)
        per_job = []
        for rec in records:
            params = harness.init_params(self.seed, ("train", rec["j"]),
                                         self.dims, device)
            ref = reference.train_steps(harness.reference_leaves(params),
                                        inp.X, inp.K, inp.m, cfg, device)
            nums = term_gaps(rec["history"], ref["history"])
            if rec["j"] == 0:
                grad, after = self.first
                nums.update(first_step_gaps(
                    {harness.leaf_of(key, params): v
                     for key, v in grad.items()},
                    {harness.leaf_of(key, params): v - params[key].cpu()
                     for key, v in after.items()}, ref))
            for key, v in nums.items():
                worst[key] = max(worst[key], v)
            per_job.append(nums)
        return dict(worst), per_job

    @staticmethod
    def work(records: list) -> dict:
        return {"jobs": len(records),
                "steps": sum(r["steps"] for r in records)}


TERM_GAPS = {"loss": "loss_gap", "res": "res_gap", "lam_mean": "lam_gap"}


def term_gaps(program: dict, ref: dict) -> dict:
    """For the loss, its residual term and its mean lambda, the largest
    relative gap over the reference's steps. (The orthogonality term is
    nearly all of the loss: its gap is the loss's.)"""
    gaps = {}
    for key, name in TERM_GAPS.items():
        want = np.asarray(ref[key])
        got = program.get(key)
        if got is None or len(got) < len(want):
            gaps[name] = float("inf")
            continue
        gaps[name] = harness.nan_to_inf(
            np.max(np.abs(got[:len(want)] - want) / np.abs(want)))
    return gaps


def leaf_gaps(program: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |‖program‖ - ‖reference‖| over the larger of the
    reference leaf's norm and the median leaf's; `keep` names the leaves
    that count."""
    ref_norms = {key: float(v.double().norm()) for key, v in ref.items()}
    median = float(np.median(list(ref_norms.values())))
    worst = 0.0
    for key, r in ref_norms.items():
        if keep is not None and key not in keep:
            continue
        if key not in program:
            return float("inf")
        p = float(program[key].double().norm())
        worst = max(worst, harness.nan_to_inf(
            abs(p - r) / max(r, median, 1e-300)))
    return worst


def first_step_gaps(grad: dict, change: dict, ref: dict) -> dict:
    """grad_gap (the first gradient) and change_gap (the parameters'
    change over the reference's steps), by the worst leaf; `grad` and
    `change` keyed by the reference's leaf names. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change: Adam moves them by round-off alone."""
    g_norms = {key: float(v.double().norm()) for key, v in ref["grad"].items()}
    floor = 1e-3 * float(np.median(list(g_norms.values())))
    moved = {key for key, v in g_norms.items() if v >= floor}
    return {"grad_gap": leaf_gaps(grad, ref["grad"]),
            "change_gap": leaf_gaps(change, ref["change"], keep=moved)}


# ---- the readings that set the limits (control.py) ------------------------

def reference_readings(alt: dict, ref: dict) -> dict:
    """The numbers of a reference run `alt` read against `ref`."""
    nums = term_gaps(alt["history"], ref["history"])
    nums.update(first_step_gaps(alt["grad"], alt["change"], ref))
    return nums


def readings(spec, seed, inp, device, root, controls: bool,
             n_jobs: int = 1) -> dict:
    """`n_jobs` jobs of the program judged as a run judges them; with
    `controls`, from the same jobs' parameters, the float8 reference (the
    control), each fault of `reference.FAULTS` planted in the reference,
    and the reference with the configuration's bf16 rounding (the witness
    of what that rounding does to the loss), each job read against the
    float32 reference and the worst over the jobs kept."""
    jobs, _, _ = harness.setup(spec, seed, inp, device, root)
    records = [jobs.job(j) for j in range(n_jobs)]
    jobs.release(records)
    worst, per_job = jobs.judge(records, inp)
    out = {"program": worst, "program_jobs": per_job}
    if controls:
        cfg = spec["config"]["train"]
        alts = {"fp8": {"quant": reference.fp8},
                **{fault: {"fault": fault} for fault in reference.FAULTS},
                "bf16_witness": {"quant": reference.bf16}}
        read = {name: [] for name in alts}
        for j in range(n_jobs):
            leaves = harness.reference_leaves(harness.init_params(
                seed, ("train", j), jobs.dims, device))
            ref = reference.train_steps(leaves, inp.X, inp.K, inp.m, cfg,
                                        device)
            for name, kw in alts.items():
                read[name].append(reference_readings(reference.train_steps(
                    leaves, inp.X, inp.K, inp.m, cfg, device, **kw), ref))
        out.update({name: {key: max(r[key] for r in rows)
                           for key in rows[0]}
                    for name, rows in read.items()})
    return out
