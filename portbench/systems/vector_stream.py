"""Three float32 vectors w, v, u of the configuration's length and a
pool of α made from the seed, for a program of the form
r = (w − α v)ᵀ u (`AXPYDOT_SPEC`).

The check: each call's r against the float64 value of the same
arithmetic, |r − r_ref| / sqrt(Σ (z_i u_i)²) (`reference.axpydot_errors`),
the largest over every call of the run against `limits.r_err_max`. The
control (`use_control`) puts the reference, the dot's operands rounded
to TF32, in the program's place for the whole of a run.
"""
from __future__ import annotations

import torch

from portbench import reference, work


def build(run) -> None:
    n = int(run.config["n"])
    t = run.traffic
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    w, v, u = torch.randn(3, n, generator=gen, device=run.device)
    low, high = float(t["alpha_low"]), float(t["alpha_high"])
    alpha = torch.rand(int(t["alpha_pool"]), generator=gen,
                       device=run.device).mul_(high - low).add_(low)
    run.inputs.update(w=w, v=v, u=u, alpha=alpha, neg_alpha=-alpha)


def call_inputs(run, i: int) -> dict:
    """The program's inputs of call i: the vectors and the pool's α."""
    x = run.inputs
    neg = x["neg_alpha"]
    return {"neg_alpha": neg[i % neg.shape[0]], "w": x["w"], "v": x["v"],
            "u": x["u"]}


def _alphas(run, idx: list) -> torch.Tensor:
    alpha = run.inputs["alpha"]
    at = torch.tensor(idx, device=alpha.device) % alpha.shape[0]
    return alpha[at]


def check(run) -> list:
    limit = float(run.config["limits"]["r_err_max"])
    pairs = [a for w in run.windows.values() for a in w.answers]
    if not pairs:
        return [("r_err_max", float("inf"), limit)]
    r = torch.stack([t.reshape(()) for _, t in pairs])
    x = run.inputs
    sums = reference.axpydot_sums(x["w"], x["v"], x["u"])
    errs = reference.axpydot_errors(sums, _alphas(run, [i for i, _ in pairs]),
                                    r)
    return [("r_err_max", float(errs.max()), limit)]


def control_answer(inputs: dict) -> torch.Tensor:
    """The control's r for one call: the reference with z = w − α v in
    float32 and the dot's operands rounded to TF32."""
    alpha = -inputs["neg_alpha"].reshape(1)
    return reference.axpydot_tf32(inputs["w"], inputs["v"], inputs["u"],
                                  alpha)[0]


def replace_answers(alter, setattr_=setattr) -> None:
    """Make every `Executable.run` of the process return
    `alter(answer, inputs)` in place of its answer (through `setattr_`,
    which a test gives as its monkeypatch)."""
    from repro_torch.blas.executable import Executable

    run_program = Executable.run

    def altered(self, **inputs):
        out = run_program(self, **inputs)
        key = next(iter(out))
        out[key] = alter(out[key], inputs)
        return out
    setattr_(Executable, "run", altered)


def use_control(setattr_=setattr) -> None:
    """The control in the program's place: each call's answer is the
    control's (`control_answer`), judged by `check` as the program's."""
    replace_answers(lambda out, inputs: control_answer(inputs), setattr_)


def least_seconds(run, window):
    peak = run.peak
    if peak is None or not window.calls:
        return None
    nbytes, flops = work.axpydot_call(int(run.config["n"]))
    return window.calls * work.least_seconds(nbytes, flops, peak)
