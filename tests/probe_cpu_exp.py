"""Probe of torch's first multi-threaded CPU exp after JAX ran.

    JAX_PLATFORMS=cpu python tests/probe_cpu_exp.py [--procs 400] [--jobs 6]

Starts --procs fresh processes in each of two arms, alternating: "cold"
takes two intra-op threads directly, "warm" through
`torch_cpu_setup.two_threads`. Each process runs a JAX computation, then one
torch.exp over 2**20 float32 values on two threads (in the cold arm the
process's first vector-math call), and counts the values more than 1e-6
(relative) away from float64's exp. Prints, per arm, the processes with any
such value. Not collected by pytest.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor


def child(arm: str) -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_cpu_setup import two_threads

    if arm == "warm":
        two_threads()
    else:
        torch.set_num_threads(2)
    x = jnp.asarray(np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32))
    float(jax.jit(lambda a: jnp.exp(a).sum() + (a @ a).sum())(x))
    float(jax.grad(lambda a: jnp.sum(jnp.exp(a) * a))(x).sum())
    a = torch.from_numpy(np.random.default_rng(1).uniform(-20, 5, 1 << 20).astype(np.float32))
    got = torch.exp(a).double()  # before float64's exp, which would warm the library
    ref = torch.exp(a.double())
    bad = int(((got - ref).abs() / ref > 1e-6).sum())
    print(bad)
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=400)
    ap.add_argument("--jobs", type=int, default=6)
    ap.add_argument("--child", choices=("cold", "warm"))
    args = ap.parse_args()
    if args.child:
        return child(args.child)
    arms = [arm for _ in range(args.procs) for arm in ("cold", "warm")]

    def run(arm):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", arm],
                            capture_output=True, timeout=300).returncode
        return arm, rc

    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(run, arms))
    for arm in ("cold", "warm"):
        rcs = [rc for a, rc in results if a == arm]
        print(f"{arm}: {sum(rc == 1 for rc in rcs)} of {len(rcs)} processes had a wrong exp value; "
              f"{sum(rc not in (0, 1) for rc in rcs)} did not finish", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
