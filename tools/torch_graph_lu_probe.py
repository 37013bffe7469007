#!/usr/bin/env python3
"""Which batched linear solves of the implicit vertical diffusion a CUDA
graph can capture, on one card.

    python3 tools/torch_graph_lu_probe.py

Each backend and candidate runs in a process of its own: a failed capture
can leave MAGMA unusable in its process.

For the systems ``build_implicit_vdiff`` assembles (I + ts W^-1 S, batched
over columns, at the TC's 1,200 x 24 and the shower's 2,304 x 32), each
candidate call is run eagerly, then captured in a torch.cuda.CUDAGraph and
replayed: it prints whether the capture succeeded, the replay against the
eager call (bitwise, max rel), the call against a float64 numpy solve, and
the eager and replayed ms a call (CUDA events over 50 calls).
"""

import contextlib
import sys

import numpy as np
import torch


@contextlib.contextmanager
def backend(name):
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library(name)
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


def systems(ncols, nz, nrhs, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(nz, nz))
    wq = 0.5 + rng.random(nz)
    k = 10.0 * rng.random((ncols, nz))
    s = np.einsum("mi,cm,mj->cij", d, wq * k, d)
    m = np.eye(nz) + 2.0 * (1.0 / wq)[None, :, None] * s
    rhs = rng.normal(size=(ncols, nz, nrhs))
    ref = np.linalg.solve(m, rhs)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return t(m), t(rhs), ref, t(wq)


def timed(fn, n=50):
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


CANDIDATES = ("solve_ex", "lu_factor_ex+lu_solve", "inv_ex@rhs", "cholesky_ex(Wm)+cholesky_solve")
RUNS = (("cusolver", "solve_ex"), ("cusolver", "lu_factor_ex+lu_solve"),
        ("cusolver", "inv_ex@rhs"), ("default", "cholesky_ex(Wm)+cholesky_solve"),
        ("cusolver", "cholesky_ex(Wm)+cholesky_solve"), ("default", "solve_ex"))


def one(be, name):
    for ncols, nz in ((1200, 24), (2304, 32)):
        for dtype in (torch.float32, torch.float64):
            m, rhs, ref, wq = systems(ncols, nz, 7, dtype)
            a_spd = m * wq[None, :, None]  # W m = W + ts S, symmetric
            fn = {
                "solve_ex": lambda: torch.linalg.solve_ex(m, rhs)[0],
                "lu_factor_ex+lu_solve": lambda: torch.linalg.lu_solve(
                    *torch.linalg.lu_factor_ex(m)[:2], rhs),
                "inv_ex@rhs": lambda: torch.linalg.inv_ex(m)[0] @ rhs,
                "cholesky_ex(Wm)+cholesky_solve": lambda: torch.cholesky_solve(
                    rhs * wq[None, :, None], torch.linalg.cholesky_ex(a_spd)[0]),
            }[name]
            label = f"{ncols}x{nz} {str(dtype)[6:]} {be:8s} {name}"
            ctx = contextlib.nullcontext() if be == "default" else backend(be)
            with ctx:
                eager = fn()
                ms = timed(fn)
                box = {}
                s = torch.cuda.Stream()
                s.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(s):
                    box["x"] = fn()
                torch.cuda.current_stream().wait_stream(s)
                g = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(g):
                        box["x"] = fn()
                except Exception as e:  # report it; the process ends here
                    print(f"{label}: FAILED {type(e).__name__}: "
                          f"{str(e).splitlines()[0][:150]}", flush=True)
                    return
            g.replay()
            torch.cuda.synchronize()
            gms = timed(g.replay)
            rel = float((box["x"] - eager).abs().max() / eager.abs().max())
            err = float(np.abs(eager.double().cpu().numpy() - ref).max() / np.abs(ref).max())
            print(f"{label}: captured; replay vs eager bitwise {torch.equal(box['x'], eager)} "
                  f"rel {rel:.2e}; eager vs f64 numpy {err:.2e}; eager {ms:.4f} ms, replay "
                  f"{gms:.4f} ms", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if len(sys.argv) == 3:
        one(*sys.argv[1:])
        return 0
    import subprocess

    for be, name in RUNS:
        subprocess.run([sys.executable, __file__, be, name], check=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
