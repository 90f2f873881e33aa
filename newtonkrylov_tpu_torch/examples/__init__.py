"""The example gallery, ported: one module per program of the JAX
package's ``examples/`` directory, with the same name (``bratu_2d_tpu.py``
becomes :mod:`.bratu_2d_cuda`).

Each module has ``main(device="cuda", plot=False, **size) -> dict``: it
prints the JAX example's lines in the same format and returns what they
report (``solved``, the outer and inner counts, ‖F‖, errors and the named
quantities).  Run one as::

    python -m newtonkrylov_tpu_torch.examples.<name> [--device cpu] [--plot]

The card is the default device; ``--device cpu`` asks for the CPU, and
asking for the card without CUDA raises.  ``--plot`` saves the example's
figure into ``newtonkrylov_tpu_torch/examples/out/`` and is the only thing
that imports matplotlib.  The size keywords default to the JAX example's
sizes; a smaller one cuts a march's depth or a grid for a quick run.

:mod:`.sharded_bratu` needs a process group: ``torchrun --nproc-per-node W
-m newtonkrylov_tpu_torch.examples.sharded_bratu``, or
``utils.distributed.run_processes(sharded_bratu.rank_main, W, ...)``;
alone it runs a group of one.
"""

NAMES = (
    "simple_2d",
    "spring_implicit",
    "heat_1d",
    "heat_1d_dg",
    "heat_2d",
    "bratu_1d",
    "bvp_kelley",
    "continuation_bratu",
    "ptc_globalization",
    "convdiff_2d",
    "bratu_2d_cuda",
    "sharded_bratu",
)
