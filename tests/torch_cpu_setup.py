"""CPU set-up shared by the port's test files (`tests/test_torch_*.py`).

torch's CPU exp, log, tanh and the like go through MKL's vector math
library. The first such call in a process, when two intra-op threads make
it at once, can return wrong values for the worker thread's share of the
tensor (off by about 1.5e-4 relative; every later call is right): in 5 of
400 fresh processes that ran JAX first, against 0 of 400 that first made
one single-threaded call of each function, as `two_threads` does
(`python tests/probe_cpu_exp.py`). It showed as rare failures of the K3
and K4 parity tests at their 1e-4 and 1e-5 tolerances.
"""
import torch

_VECTOR_MATH = (torch.exp, torch.expm1, torch.log, torch.log1p, torch.tanh, torch.sigmoid,
                torch.sin, torch.cos, torch.sqrt, torch.erf)


def two_threads() -> None:
    """Call each vector-math function once on one thread, then run torch's
    CPU ops on two intra-op threads."""
    torch.set_num_threads(1)
    z = torch.full((1 << 16,), 0.5)
    for fn in _VECTOR_MATH:
        fn(z)
    torch.set_num_threads(2)
