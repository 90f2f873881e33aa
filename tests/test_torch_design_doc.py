"""The port's design account, ``newtonkrylov_tpu_torch/docs/design.md``.

It answers the JAX package's ``docs/design.md`` heading for heading with
the card's numbers.  Checked here on the CPU: every ``##``/``###`` heading
of the JAX account has a row in the page's correspondence table that
points at a section of the page or says why it does not apply; every
paragraph that states a time, a rate or a memory size names where it was
measured (a path of ``chip_smoke.py`` or a section of ``PERF.md``) and no
such paragraph speaks of the TPU; and the page names the card and its
power limit.  The strict site build (``tests/test_torch_docs_site.py``)
renders it.
"""

import re
from pathlib import Path

import pytest
from markdown.extensions.toc import slugify

ROOT = Path(__file__).resolve().parents[1]
JAX_DOC = ROOT / "docs" / "design.md"
PORT_DOC = ROOT / "newtonkrylov_tpu_torch" / "docs" / "design.md"

# a number with a unit of time, rate or memory size
MEASURE = re.compile(
    r"(?<![\w.])\d[\d,.]*\s?(?:ms|µs|us|ns|s|KiB|MiB|GiB|MB|GB|TB/s|GB/s|"
    r"TFLOP/s|GFLOP/s|T/s)(?![\w/])")
SOURCE = re.compile(r"chip_smoke\.py|PERF\.md`? §\d")
TPU_WORDS = re.compile(r"\b(?:v5e|TPU|MXU|VMEM)\b")
CARD = "NVIDIA H100 80GB HBM3"  # a name, not a memory size


def _headings(text, levels=("## ", "### ")):
    return [line.split(" ", 1)[1].strip() for line in text.splitlines()
            if line.startswith(levels)]


def _table(text):
    """The correspondence table: (JAX heading, the page's answer) rows."""
    body = text.split("## Correspondence with the JAX account", 1)[1]
    rows = []
    for line in body.splitlines():
        if line.startswith("## "):
            break
        if line.startswith("| ") and not line.startswith("| JAX account"):
            cells = [c.strip() for c in line.strip().strip("|").split(" | ")]
            rows.append((cells[0], cells[1]))
    return rows


def _blocks(text):
    """Blank-line separated blocks, a table read with the paragraph that
    introduces it, code fences dropped."""
    text = re.sub(r"```.*?```", "", text, flags=re.S)
    blocks, intro = [], ""
    for block in re.split(r"\n\s*\n", text):
        if block.lstrip().startswith("|"):
            blocks.append(intro + "\n" + block)
        else:
            blocks.append(block)
            intro = block
    return blocks


@pytest.fixture(scope="module")
def port():
    return PORT_DOC.read_text()


def test_every_jax_heading_has_an_answer(port):
    jax_headings = _headings(JAX_DOC.read_text())
    assert len(jax_headings) >= 24
    rows = dict(_table(port))
    assert list(rows) == jax_headings, "table rows differ from the JAX headings"
    anchors = {slugify(h, "-") for h in _headings(port, ("# ", "## ", "### "))}
    for heading, answer in rows.items():
        links = re.findall(r"\]\(#([\w-]+)\)", answer)
        if links:
            assert all(a in anchors for a in links), (heading, links)
        else:
            reason = answer.removeprefix("Does not apply:").strip()
            assert answer.startswith("Does not apply:") and len(reason) > 40, (
                heading, answer)


def test_measurements_name_their_run_and_no_tpu_time(port):
    measured = 0
    for block in _blocks(port.replace(CARD, "the card")):
        if not MEASURE.search(block):
            continue
        measured += 1
        assert SOURCE.search(block), (
            f"a measurement without its run: {block[:200]!r}")
        assert not TPU_WORDS.search(block), (
            f"a time beside the TPU: {block[:200]!r}")
    assert measured >= 10


def test_names_the_card_and_its_power_limit(port):
    assert CARD in port
    assert re.search(r"\d+\.\d\d W power\s+limit", port)


def test_lint_catches_a_tpu_time_and_an_unsourced_one():
    assert MEASURE.search("an apply took 1.084 ms") and TPU_WORDS.search(
        "on the v5e")
    assert not MEASURE.search("6 / 7 outers in 2 passes at 2048²")
    bad = "The apply ran 8.87 ms.\n\n| a | b |\n|---|---|\n| 1 | 2 |\n"
    assert not any(SOURCE.search(b) for b in _blocks(bad) if MEASURE.search(b))
    assert SOURCE.search("(`PERF.md` §5)") and SOURCE.search("PERF.md §6")
