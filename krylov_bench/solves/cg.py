"""CG: the port's public ``cg``, its plain reference, and its control (the
reference in bfloat16, one precision below the configuration's float32)."""

import torch

from krylov_bench.reference import krylov


def stops_on_tolerance(kwargs) -> bool:
    return float(kwargs.get("reltol", 0.0)) > 0


def port(its, op, Pl, b, kwargs):
    """(x, live steps) of the timed call."""
    x, history = its.cg(op, b, Pl=Pl, log=True, **kwargs)
    return x, int(history.iters)


def reference(A, M, b, kwargs, dtype=torch.float64, maxiter=None):
    if maxiter is None:
        maxiter = kwargs.get("maxiter")
    return krylov.cg(A, b.to(dtype), M, reltol=float(kwargs.get("reltol", 0.0)),
                     maxiter=maxiter)


def control(its, op, Pl, b, kwargs, A, M_bf16, maxiter):
    """The reference in bfloat16 in the program's place; a solve that stops
    on tolerance gives up after ``maxiter`` steps."""
    return reference(A, M_bf16, b, kwargs, torch.bfloat16,
                     maxiter=kwargs.get("maxiter", maxiter))
