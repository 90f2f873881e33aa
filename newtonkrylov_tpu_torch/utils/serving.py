"""Ahead-of-time export of solves for serving.

Counterpart of ``newtonkrylov_tpu/utils/serving.py``.  A configured solve
(or a whole time march) is captured by :func:`torch.export.export` into one
program, written to disk, and run later in another process without the
Python that configured it.  The whole Newton–Krylov loop is inside the
program: under export the drivers' loops are ``while_loop``\\ s and the
residual's J·v a traced graph (:mod:`~newtonkrylov_tpu_torch.exportable`).
What exports: :func:`~newtonkrylov_tpu_torch.newton.newton_krylov_jit`,
:func:`~newtonkrylov_tpu_torch.continuation.pseudo_transient` and
:func:`~newtonkrylov_tpu_torch.timestep.integrate_scan` with every Krylov
method the JAX package exports — the drivers' default GMRES (restarted or
full, CGS2, MGS, ``reorthogonalize``, ``ortho_block``), FGMRES, plain and
pipelined CG, BiCGStab and CGLS (its ``Jᵀ`` a traced VJP graph) — the
precision modes, the df32 acceptance and its floor estimate, and
preconditioners built once (``precond_refresh="once"``) whose apply is
tensor ops, such as ``fft_poisson``; a factory rebuilt inside the loop
(``pseudo_transient``'s, every step) must make no tensor from host data.
Each Krylov loop is a ``while_loop`` over its live body (GMRES: the
Arnoldi step, with the rotations, the MGS sweep, the chunked projection
and the back-substitution as nested ``while_loop``\\ s over the step
count), so the loaded program equals the live solve bit for bit.  The
host-stepped :func:`~newtonkrylov_tpu_torch.newton.newton_krylov` raises
under export; nothing falls back.

The program is the eager graph of ATen ops and the port's custom ops (the
hand-written kernels K1 and K2 stay ops, not their plain versions): no
``torch.compile`` and no AOTInductor, whose generated code contracts
multiply-adds and so breaks df32's error-free sums.  A loaded program
needs ``import newtonkrylov_tpu_torch`` first, which registers those
custom ops (and builds the kernels at their first launch), as the JAX
package's artifact needs its PJRT plugin.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import torch

__all__ = ["export_solver", "save_exported", "load_exported"]


class _Solve(torch.nn.Module):
    """A module whose forward calls ``fn``: what ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_solver(fn: Callable, example_args: Sequence[Any]):
    """Export ``fn(*example_args)`` (a whole solve) as one
    ``torch.export.ExportedProgram``.

    ``fn`` takes and returns tensors (trees of them), e.g. ``lambda u0:
    newton_krylov_jit(F, u0, p, algo="cg", ...)[0]``; ``example_args`` fix
    the input shapes, dtypes and devices.  Non-strict export: ``fn`` runs as
    Python on fake tensors, with the drivers' loops captured as
    ``while_loop``\\ s.  A path with no exported form raises.

    Dynamo traces each loop body, the nested loops (Newton, CG) through
    one wrapper; automatic dynamic shapes are off while the solve exports,
    so every body is traced with the solve's static shapes."""
    import torch._dynamo

    with torch._dynamo.config.patch(automatic_dynamic_shapes=False):
        return torch.export.export(_Solve(fn), tuple(example_args),
                                   strict=False)


def save_exported(exported, path: str) -> str:
    """Write an ExportedProgram to ``path`` (creating its directory);
    returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)
    return path


class Loaded:
    """A loaded solve: ``.call(*args)`` runs it (the JAX package's name).
    ``program`` is the ``ExportedProgram``."""

    def __init__(self, program):
        self.program = program
        self._module = program.module()

    def call(self, *args):
        return self._module(*args)


def load_exported(path: str) -> Loaded:
    """Load a solve written by :func:`save_exported`; call it via
    ``.call(*args)``.  ``import newtonkrylov_tpu_torch`` first: it
    registers the custom ops the program calls."""
    return Loaded(torch.export.load(path))
