"""Plain references that judge the program's answers.

Each module here is named by a configuration's ``"reference"`` key and
works out, in float64 and with plain PyTorch alone, what it needs from the
inputs the benchmark made.  It imports nothing of the program under test,
and takes nothing the program made: the program's outputs reach it only to
be judged.
"""
