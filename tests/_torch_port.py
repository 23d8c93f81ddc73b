"""Helpers shared by the tests that hold the PyTorch port
(``iterativesolvers_tpu_torch``) against the JAX package on the CPU.

Operators of the JAX package are taken apart into numpy arrays and rebuilt
in the port with ``utils/convert.py`` on ``device="cpu"``; results come back
as numpy arrays for comparison.
"""

import numpy as np
import torch

from iterativesolvers_tpu_torch.utils import convert

CPU = "cpu"


def to_torch(a):
    """A copy of a numpy / JAX array as a CPU tensor of its dtype."""
    return convert.host_tensor(np.asarray(a))


def to_numpy(t):
    """A tensor as a numpy array (bfloat16 as f32)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def port_dia(A):
    """The port's DIAMatrix on the CPU with the values of the JAX ``A``."""
    return convert.dia_from_arrays([np.asarray(d) for d in A.diags],
                                   A.offsets, A.shape, device=CPU)


def port_stencil(St):
    """The port's StencilOperator on the CPU with the data of the JAX ``St``."""
    return convert.stencil_from_arrays(
        St.n, np.asarray(St.center), St.terms,
        [np.asarray(c) for c in St.coeffs], np.asarray(St.center).dtype,
        device=CPU)


def rel(a, b):
    """||a - b|| / ||b|| of two arrays, in f64 (complex128 for complex)."""
    dt = np.result_type(np.asarray(a).dtype, np.asarray(b).dtype, np.float64)
    a = np.asarray(a, dtype=dt)
    b = np.asarray(b, dtype=dt)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
