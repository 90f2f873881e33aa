"""Host wall of the 2048² Cheb-PCG solve, to compare checkouts on one card.

The solve is ``chip_smoke.py``'s cheb-pcg phase: Bratu at λ = 5 from the
flagship's u₀, f32 Krylov CG, df32 acceptance residual, ``chebyshev(16,
lo_frac=1/300)`` built once (one K4 call per CG iteration).  Run on a
machine with a CUDA card:

    python newtonkrylov_tpu_torch/benchmarks/cheb_wall.py [ROOT ...]

Each ROOT (default: the checkout that holds this file) is the root of a
checkout of the repository; its package runs in a process of its own, which
builds its kernels, solves once cold and then ``WARM`` times warm, each solve
timed on the host clock up to ``torch.cuda.synchronize()``.  Give two roots
as A B B A so that drift on the machine falls on both.  One line per solve,
then one JSON object: per root, the walls, the median warm wall, the
outer/inner counts and the K4 calls of a solve.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 2048
LAM = 5.0
WARM = 3


def _child(root: str) -> dict:
    """Solve WARM + 1 times with the package of checkout ``root``."""
    sys.path.insert(0, root)
    import torch

    import newtonkrylov_tpu_torch as nkt
    from newtonkrylov_tpu_torch.kernels import stencil2d as k
    from newtonkrylov_tpu_torch.precond import chebyshev
    from newtonkrylov_tpu_torch.problems import bratu2d

    if not torch.cuda.is_available():
        raise SystemExit("cheb_wall: no CUDA device")
    p = bratu2d.default_config(N, lam=LAM)
    u0 = bratu2d.initial_guess(N, dtype=torch.float32, device="cuda")
    walls, counts = [], set()
    for run in range(WARM + 1):
        k.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = nkt.newton_krylov_jit(
            bratu2d.residual_scaled, u0.to(torch.float64), p, algo="cg",
            tol_rel=1e-8, krylov_dtype=torch.float32,
            residual_df=bratu2d.residual_scaled_df, max_niter=20,
            M=chebyshev(16, lo_frac=1 / 300), precond_refresh="once")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if not bool(info.solved):
            raise AssertionError(f"cheb_wall: {root}: solve did not converge")
        counts.add((int(info.stats.outer_iterations),
                    int(info.stats.inner_iterations),
                    k.LAUNCHES["chebyshev_apply"]))
        print(f"[cheb_wall] {root} {'cold' if run == 0 else 'warm'}: "
              f"{walls[-1]:.3f} s, outer/inner/K4 calls {sorted(counts)[-1]}",
              file=sys.stderr, flush=True)
    if len(counts) != 1:
        raise AssertionError(f"cheb_wall: {root}: counts differ between solves")
    return {"root": root, "walls_s": walls,
            "median_warm_s": statistics.median(walls[1:]),
            "outer_inner_k4": list(counts.pop())}


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(_child(argv[1])), flush=True)
        return 0
    roots = argv or [str(Path(__file__).resolve().parents[2])]
    runs = []
    for root in roots:
        out = subprocess.run([sys.executable, __file__, "--child",
                              str(Path(root).resolve())],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
    print(json.dumps({"n": N, "warm": WARM, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
