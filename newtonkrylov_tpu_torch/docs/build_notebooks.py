"""Convert every port walkthrough into an EXECUTED Jupyter notebook (the
port's copy of ``docs/build_notebooks.py``).

Each ``walkthrough_*.md`` is split into markdown and code cells, executed
with a real kernel (nbclient) after a preamble cell that sets ``DEVICE``
(``--device``: the card, ``cuda``, by default) and ``FIGDIR``, and written
with its outputs and inline figures to ``notebooks/`` beside this file, or
to the directory in ``NK_NB_OUT`` (tests build into a temporary directory,
so a test run never rewrites the committed notebooks: cell ids are random).
The notebooks are generated: edit the walkthrough, not the ``.ipynb``.

Usage::

    python -m newtonkrylov_tpu_torch.docs.build_notebooks [--device cpu] [name ...]
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

from newtonkrylov_tpu_torch.docs.run_walkthroughs import DOCS, ROOT, paths

FENCE = re.compile(r"```python\n(.*?)```", re.DOTALL)


def out_dir() -> str:
    return os.environ.get("NK_NB_OUT") or os.path.join(DOCS, "notebooks")


def _notebookify(code: str) -> str:
    """Figures display inline in a notebook: drop the two headless-only
    lines (the Agg backend, closing the figure); the rest is verbatim."""
    keep = [line for line in code.splitlines()
            if not line.strip().startswith(("matplotlib.use(", "plt.close("))]
    return "\n".join(keep)


def md_to_cells(src: str) -> list:
    import nbformat

    cells, pos = [], 0
    for m in FENCE.finditer(src):
        prose = src[pos:m.start()].strip()
        if prose:
            cells.append(nbformat.v4.new_markdown_cell(prose))
        cells.append(nbformat.v4.new_code_cell(_notebookify(m.group(1).rstrip())))
        pos = m.end()
    tail = src[pos:].strip()
    if tail:
        cells.append(nbformat.v4.new_markdown_cell(tail))
    return cells


def build(path: str, device: str = "cuda") -> str:
    import nbformat
    from nbclient import NotebookClient

    name = os.path.basename(path).replace("walkthrough_", "").replace(".md", "")
    nb = nbformat.v4.new_notebook()
    # a path relative to the kernel's directory, not this machine's: the
    # committed notebook must re-run elsewhere
    preamble = (
        "import os\n"
        f"DEVICE = {device!r}  # 'cuda' (the card) or 'cpu'\n"
        "FIGDIR = os.path.join(os.getcwd(), '_figs')\n"
        "os.makedirs(FIGDIR, exist_ok=True)\n"
        "%matplotlib inline\n"
    )
    nb.cells = [nbformat.v4.new_code_cell(preamble)] + md_to_cells(
        open(path, encoding="utf-8").read())
    nb.metadata["kernelspec"] = {
        "name": "python3", "display_name": "Python 3", "language": "python"}
    nb.metadata["language_info"] = {"name": "python"}
    NotebookClient(nb, timeout=900, kernel_name="python3",
                   resources={"metadata": {"path": ROOT}}).execute()
    out = out_dir()
    os.makedirs(out, exist_ok=True)
    out_path = os.path.join(out, f"{name}.ipynb")
    nbformat.write(nb, out_path)
    n_out = sum(1 for c in nb.cells if c.cell_type == "code" and c.get("outputs"))
    print(f"== {name}: {len(nb.cells)} cells, {n_out} with outputs -> {out_path}")
    return out_path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("names", nargs="*")
    args = ap.parse_args(argv)
    found = paths(args.names)
    if not found:
        raise SystemExit("no walkthroughs matched")
    if len(found) == 1:
        build(found[0], args.device)
        return
    # one process per notebook, as the walkthrough runner
    for p in found:
        subprocess.run([sys.executable, "-m",
                        "newtonkrylov_tpu_torch.docs.build_notebooks",
                        "--device", args.device, os.path.basename(p)],
                       check=True, cwd=ROOT)


if __name__ == "__main__":
    main()
