"""The port's walkthroughs and their runners.

``walkthrough_*.md`` carry the JAX package's walkthroughs (``docs/``) with
the code in torch; :mod:`.run_walkthroughs` executes their code blocks and
:mod:`.build_notebooks` turns them into executed notebooks under
``notebooks/``.  :mod:`.sharded_ranks` holds the sharded walkthrough's
per-rank code, which spawned ranks import by name.
"""
