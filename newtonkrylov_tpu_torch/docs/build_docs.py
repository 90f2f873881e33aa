"""Render the port's documentation site: pages, API reference, citations.

The port's counterpart of ``docs/build_docs.py`` (the reference builds its
site with Documenter.jl: rendered pages, API docs from docstrings, a
citation database and a link check).  Self-contained on the standard
library, ``markdown`` and ``pygments``; the CPU is enough, and the card's
machine, which has no ``markdown``, never runs it.

* pages: the repository's README as the home page, the port's API map
  (``api.md``), decision guide (``preconditioners.md``), parity account
  (``parity.md``), design account (``design.md``) and walkthroughs, all
  beside this file;
* the API reference: the public names of every module of
  ``newtonkrylov_tpu_torch``, from their docstrings (imported live, so the
  page cannot drift from the code);
* citations ``[@key]`` resolved against the port's own ``refs.bib``;
* internal links, anchors and images checked; external links inventoried
  into ``linkcheck.json``, never fetched.

Usage::

    python -m newtonkrylov_tpu_torch.docs.build_docs [--out DIR] [--strict]

The default output directory, ``_site/`` beside this file, is git-ignored.
``--strict`` exits non-zero on an unknown citation key, a dead internal
link or image, or a module that does not import.
"""

from __future__ import annotations

import argparse
import html
import importlib
import inspect
import json
import pkgutil
import re
import shutil
import sys
from pathlib import Path

DOCS = Path(__file__).resolve().parent
PKG = DOCS.parent
ROOT = PKG.parent
PACKAGE = "newtonkrylov_tpu_torch"

PAGES = [
    # (source, output stem, nav title)
    (ROOT / "README.md", "index", "Home"),
    (DOCS / "api.md", "api", "API map"),
    ("__autodoc__", "reference", "API reference"),
    (DOCS / "preconditioners.md", "preconditioners", "Choosing a preconditioner"),
    (DOCS / "parity.md", "parity", "Reference parity"),
    (DOCS / "design.md", "design", "Design notes (on the H100)"),
    (DOCS / "walkthrough_heat2d.md", "walkthrough_heat2d", "Heat 2-D walkthrough"),
    (DOCS / "walkthrough_heat1d_dg.md", "walkthrough_heat1d_dg", "Heat 1-D DG walkthrough"),
    (DOCS / "walkthrough_sharded.md", "walkthrough_sharded", "Sharded-solve walkthrough"),
    (DOCS / "walkthrough_precision.md", "walkthrough_precision",
     "Precision walkthrough (df32 + the floor)"),
    (DOCS / "walkthrough_diagnostics.md", "walkthrough_diagnostics",
     "Diagnostics & globalization walkthrough"),
    ("__bibliography__", "references", "References"),
]

STYLE = """
body { font-family: -apple-system, "Segoe UI", Roboto, Helvetica, sans-serif;
       margin: 0; color: #1a1a1a; line-height: 1.55; }
.layout { display: flex; min-height: 100vh; }
nav { width: 230px; flex-shrink: 0; background: #f6f8fa;
      border-right: 1px solid #d8dee4; padding: 1.2rem 0.9rem; }
nav h1 { font-size: 1.02rem; margin: 0 0 0.8rem; }
nav a { display: block; color: #0550ae; text-decoration: none;
        padding: 0.18rem 0.4rem; border-radius: 5px; font-size: 0.92rem; }
nav a.current, nav a:hover { background: #e3ecf7; }
main { max-width: 58rem; padding: 1.6rem 2.4rem 4rem; min-width: 0; }
main h1, main h2, main h3 { line-height: 1.25; }
main h2 { border-bottom: 1px solid #e3e8ee; padding-bottom: 0.25rem; }
code, pre { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
            font-size: 0.9em; }
pre { background: #f6f8fa; padding: 0.8rem 1rem; overflow-x: auto;
      border-radius: 7px; border: 1px solid #e3e8ee; }
code { background: #f0f2f5; padding: 0.08em 0.3em; border-radius: 4px; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 0.8rem 0; display: block;
        overflow-x: auto; }
th, td { border: 1px solid #d8dee4; padding: 0.3rem 0.65rem;
         font-size: 0.92rem; }
th { background: #f6f8fa; }
.docitem { border: 1px solid #e3e8ee; border-radius: 8px;
           margin: 0.9rem 0; }
.docitem > .sig { background: #f6f8fa; padding: 0.45rem 0.8rem;
                  border-radius: 8px 8px 0 0; font-family: ui-monospace,
                  SFMono-Regular, Menlo, monospace; font-size: 0.88rem;
                  overflow-x: auto; white-space: pre-wrap; }
.docitem > .doc { padding: 0.15rem 0.9rem; }
.refentry { margin: 0.7rem 0; }
.refkey { color: #57606a; font-size: 0.85rem; }
blockquote { border-left: 3px solid #d8dee4; margin-left: 0;
             padding-left: 1rem; color: #57606a; }
"""

CITE_RE = re.compile(r"\[@([A-Za-z][\w:-]*)\]")


def autodoc_modules() -> list:
    """Every module of the package, by name, the package itself first."""
    import newtonkrylov_tpu_torch as pkg

    return [PACKAGE] + sorted(m.name for m in pkgutil.walk_packages(
        pkg.__path__, PACKAGE + "."))


def parse_bib(path: Path) -> dict:
    """Minimal BibTeX parser: enough for ``refs.bib`` (field = {...},)."""
    entries = {}
    text = path.read_text()
    for m in re.finditer(r"@(\w+)\s*\{\s*([^,\s]+)\s*,(.*?)\n\}", text, re.S):
        kind, key, body = m.group(1).lower(), m.group(2), m.group(3)
        fields = {"__kind__": kind}
        for fm in re.finditer(r"(\w+)\s*=\s*\{((?:[^{}]|\{[^{}]*\})*)\}", body):
            fields[fm.group(1).lower()] = re.sub(
                r"\s+", " ", fm.group(2).replace("{", "").replace("}", "")
            ).replace("--", "–").strip()
        entries[key] = fields
    return entries


def format_ref(key: str, e: dict) -> str:
    authors = e.get("author", "?").replace(" and ", "; ")
    bits = [f"<strong>{html.escape(authors)}</strong>",
            html.escape(e.get("title", "?")) + "."]
    venue = e.get("journal") or e.get("booktitle") or e.get("publisher", "")
    if venue:
        tail = html.escape(venue)
        if e.get("volume"):
            tail += f" {html.escape(e['volume'])}"
            if e.get("number"):
                tail += f"({html.escape(e['number'])})"
        if e.get("pages"):
            tail += f":{html.escape(e['pages'])}"
        bits.append(f"<em>{tail}</em>,")
    if e.get("year"):
        bits.append(html.escape(e["year"]) + ".")
    if e.get("doi"):
        doi = html.escape(e["doi"])
        bits.append(f'<a href="https://doi.org/{doi}">doi:{doi}</a>')
    return (f'<div class="refentry" id="{key}">{" ".join(bits)} '
            f'<span class="refkey">[{key}]</span></div>')


def autodoc_markdown(modules: list) -> tuple:
    """(the API reference page, the modules that failed to import): the
    public names of each module (``__all__``, else every name without a
    leading underscore) defined there, each with its signature and the
    first paragraph of its docstring."""
    out = ["# API reference", "",
           "Generated from the docstrings of every module of "
           f"`{PACKAGE}` by `newtonkrylov_tpu_torch/docs/build_docs.py`.", ""]
    failures = []
    for name in modules:
        try:
            mod = importlib.import_module(name)
        except Exception as exc:  # noqa: BLE001 — reported, strict fails
            failures.append(f"{name}: {type(exc).__name__}: {exc}")
            continue
        out.append(f"## `{name}`\n")
        mdoc = inspect.getdoc(mod)
        if mdoc:
            out.append(mdoc.split("\n\n")[0] + "\n")
        public = getattr(mod, "__all__", None)
        if public is None:
            public = [n for n in vars(mod) if not n.startswith("_")]
        for attr in public:
            obj = getattr(mod, attr, None)
            if obj is None or inspect.ismodule(obj):
                continue
            # documented where it is defined (the package re-exports aside)
            if getattr(obj, "__module__", name) != name and name != PACKAGE:
                continue
            if not (inspect.isclass(obj) or callable(obj)):
                continue
            try:
                sig = str(inspect.signature(obj))
            except (TypeError, ValueError):
                sig = ""
            doc = inspect.getdoc(obj) or ""
            first = doc.split("\n\n")[0] if doc else "(undocumented)"
            out.append('<div class="docitem" markdown="1">')
            out.append(f'<div class="sig">{html.escape(attr + sig)}</div>')
            out.append(f'<div class="doc" markdown="1">\n\n{first}\n\n</div>')
            out.append("</div>\n")
    return "\n".join(out), failures


def bibliography_markdown(bib: dict) -> str:
    out = ["# References", "",
           "The port's citation database (`newtonkrylov_tpu_torch/docs/"
           "refs.bib`, a copy of the JAX package's).", ""]
    for key, e in bib.items():
        out.append(format_ref(key, e))
        out.append("")
    return "\n".join(out)


def _copy_assets(out_dir: Path) -> None:
    """The walkthroughs' figures and executed notebooks ship with the site."""
    for sub, pattern in (("_figures", "*.png"), ("notebooks", "*.ipynb")):
        src = DOCS / sub
        if src.is_dir():
            dst = out_dir / sub
            dst.mkdir(exist_ok=True)
            for f in sorted(src.glob(pattern)):
                shutil.copy2(f, dst / f.name)


def _check_links(out_dir: Path, rendered: dict, problems: list) -> set:
    """Internal targets must exist; external links are inventoried."""
    ext_links = set()
    for stem, body in rendered.items():
        for src in re.findall(r'<img[^>]*\ssrc="([^"]+)"', body):
            if src.startswith(("http://", "https://")):
                ext_links.add(src)
            elif not (out_dir / src).exists():
                problems.append(f"{stem}: missing image {src}")
        for href in re.findall(r'href="([^"]+)"', body):
            if href.startswith(("http://", "https://")):
                ext_links.add(href)
            elif href.startswith("#"):
                if f'id="{href[1:]}"' not in body:
                    problems.append(f"{stem}: dangling anchor {href}")
            else:
                target = href.split("#")[0]
                if target.endswith(".html"):
                    if target[:-5] not in rendered:
                        problems.append(f"{stem}: dangling internal link {href}")
                elif target and not any((base / target).exists()
                                        for base in (ROOT, PKG, DOCS)):
                    problems.append(f"{stem}: dangling file link {href}")
    return ext_links


def build(out_dir: Path, strict: bool) -> int:
    import markdown

    out_dir.mkdir(parents=True, exist_ok=True)
    bib = parse_bib(DOCS / "refs.bib")
    problems = []
    rendered = {}
    md = markdown.Markdown(
        extensions=["tables", "fenced_code", "codehilite", "toc", "md_in_html"],
        extension_configs={"codehilite": {"guess_lang": False,
                                          "noclasses": True}},
    )
    nav_items = [(stem, title) for _, stem, title in PAGES]
    modules = autodoc_modules()
    for src, stem, title in PAGES:
        if src == "__autodoc__":
            text, failures = autodoc_markdown(modules)
            problems += [f"autodoc: {f}" for f in failures]
        elif src == "__bibliography__":
            text = bibliography_markdown(bib)
        elif Path(src).exists():
            text = Path(src).read_text()
        else:
            problems.append(f"missing page source: {src}")
            continue

        def cite(m: re.Match, stem=stem) -> str:
            key = m.group(1)
            if key not in bib:
                problems.append(f"{stem}: unknown citation key [@{key}]")
                return m.group(0)
            e = bib[key]
            label = e.get("author", key).split(",")[0].split(" and ")[0]
            return (f'<a href="references.html#{key}">'
                    f'[{html.escape(label)} {e.get("year", "")}]</a>')

        text = CITE_RE.sub(cite, text)
        md.reset()
        body = md.convert(text)
        rendered[stem] = body
        nav = "\n".join(
            f'<a href="{s}.html"{" class=current" if s == stem else ""}>'
            f'{html.escape(t)}</a>' for s, t in nav_items)
        (out_dir / f"{stem}.html").write_text(f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{html.escape(title)} · {PACKAGE}</title>
<style>{STYLE}</style></head>
<body><div class="layout">
<nav><h1>{PACKAGE}</h1>{nav}</nav>
<main>{body}</main>
</div></body></html>""")

    _copy_assets(out_dir)
    ext_links = _check_links(out_dir, rendered, problems)
    (out_dir / "linkcheck.json").write_text(json.dumps(
        {"external_links": sorted(ext_links),
         "checked": "syntax and inventory; external links are not fetched",
         "autodoc_modules": modules,
         "problems": problems}, indent=2))
    print(f"rendered {len(rendered)} pages -> {out_dir}")
    print(f"autodoc: {len(modules)} modules; citations: {len(bib)} entries; "
          f"external links inventoried: {len(ext_links)}")
    if problems:
        print("PROBLEMS:", *problems, sep="\n  ")
        return 1 if strict else 0
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DOCS / "_site"))
    ap.add_argument("--strict", action="store_true")
    a = ap.parse_args(argv)
    return build(Path(a.out), a.strict)


if __name__ == "__main__":
    sys.exit(main())
