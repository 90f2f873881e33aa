"""The port's documentation site renders strictly on the CPU.

``newtonkrylov_tpu_torch/docs/build_docs.py`` (the port's counterpart of
``docs/build_docs.py``) must render every page, autodoc every module of the
package, resolve every ``[@key]`` against the port's ``refs.bib`` and find
no dead internal link; ``--strict`` turns any of those into a failure.
"""

import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import newtonkrylov_tpu_torch as pkg
from newtonkrylov_tpu_torch.docs import build_docs

ROOT = Path(__file__).resolve().parents[1]


def test_site_builds_strict(tmp_path):
    out = tmp_path / "site"
    proc = subprocess.run(
        [sys.executable, "-m", "newtonkrylov_tpu_torch.docs.build_docs",
         "--strict", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pages = {p.name for p in out.glob("*.html")}
    assert pages == {f"{stem}.html" for _, stem, _ in build_docs.PAGES}

    lc = json.loads((out / "linkcheck.json").read_text())
    assert lc["problems"] == []
    assert lc["external_links"], "external-link inventory empty"
    modules = ["newtonkrylov_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(pkg.__path__,
                                              "newtonkrylov_tpu_torch."))
    assert lc["autodoc_modules"] == modules
    ref = (out / "reference.html").read_text()
    for name in modules:
        assert f"<code>{name}</code>" in ref, f"autodoc lost {name}"
    for symbol in ("newton_krylov_jit", "JacobianOperator", "chebyshev_apply",
                   "make_chain_solve", "floor_estimate", "run_lane"):
        assert symbol in ref, f"autodoc lost {symbol}"

    refs = (out / "references.html").read_text()
    for key in ("Kelley2003", "Kelley2022", "Kan2022", "MontoisonOrban2023"):
        assert f'id="{key}"' in refs, f"missing reference entry {key}"
    parity = (out / "parity.html").read_text()
    assert 'href="references.html#Kelley2022"' in parity
    design = (out / "design.html").read_text()
    for key in ("Dekker1971", "Hida2001", "EisenstatWalker1996"):
        assert f'href="references.html#{key}"' in design
    assert 'href="#the-dst-engines-and-the-4096-edge"' in design
    assert (out / "_figures").is_dir() and (out / "notebooks").is_dir()


def test_strict_fails_on_unknown_citation_and_dead_link(tmp_path, monkeypatch):
    page = tmp_path / "bad.md"
    page.write_text("# Bad\n\nSee [@NoSuchKey] and [gone](missing.html).\n")
    monkeypatch.setattr(build_docs, "PAGES", [(page, "bad", "Bad")])
    monkeypatch.setattr(build_docs, "autodoc_modules",
                        lambda: ["newtonkrylov_tpu_torch"])
    assert build_docs.build(tmp_path / "site", strict=True) == 1
    problems = json.loads((tmp_path / "site" / "linkcheck.json").read_text())[
        "problems"]
    assert any("NoSuchKey" in p for p in problems)
    assert any("missing.html" in p for p in problems)
    assert build_docs.build(tmp_path / "site2", strict=False) == 0


def test_strict_fails_on_a_module_that_does_not_import(tmp_path, monkeypatch):
    monkeypatch.setattr(build_docs, "PAGES",
                        [("__autodoc__", "reference", "API reference")])
    monkeypatch.setattr(build_docs, "autodoc_modules",
                        lambda: ["newtonkrylov_tpu_torch",
                                 "newtonkrylov_tpu_torch.no_such_module"])
    assert build_docs.build(tmp_path / "site", strict=True) == 1


def test_bib_is_the_jax_packages():
    """The port keeps its own copy of the citation database: the JAX
    package's entries, field for field."""
    assert build_docs.parse_bib(build_docs.DOCS / "refs.bib") == (
        build_docs.parse_bib(ROOT / "docs" / "refs.bib"))
