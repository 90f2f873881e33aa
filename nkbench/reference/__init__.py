"""Plain references that judge the program's answers.

Each module here is named by a configuration's ``"reference"`` key and
works out, in float64 and with plain PyTorch alone, what it needs from the
inputs the benchmark made.  It imports nothing of the program under test,
and takes nothing the program made: the program's outputs reach it only to
be judged.  Each gives, with ``problem`` the configuration's
``"problem"`` and ``recipe`` its ``"recipe"``:

* ``initial_guess(problem, n, device, block=None)``: the starting state
  its source states, float64 on ``device`` (``block``, a pair of slices:
  that block of it);
* ``judge(u, u0, problem, recipe)``: a returned state ``u`` of a solve
  from ``u0`` against the tolerance the configuration states, as
  ``{"res": ..., "tol": ..., "res_ratio": ...}``.
"""
