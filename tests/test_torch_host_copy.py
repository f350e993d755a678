"""The port's host half, `xevd_tpu_torch/host/`, is a copy of the JAX-free
modules of `xevd_tpu` (same relative paths).  Each copy must equal its
original line for line outside the module docstring, except for the lines
that docstring lists as edited (indented by four spaces after a line
ending in "Edited lines" ...).  Drift between the two -- a fix made in one
and not the other -- fails here."""
import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
HOST = REPO / "xevd_tpu_torch" / "host"
COPIES = sorted(p.relative_to(HOST).as_posix() for p in HOST.rglob("*.py"))


def _split(path):
    """(docstring lines, the other lines) of a module."""
    text = path.read_text()
    lines = text.splitlines()
    body = ast.parse(text).body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        a, b = body[0].lineno - 1, body[0].end_lineno
        return lines[a:b], lines[:a] + lines[b:]
    return [], lines


def _edited(doc_lines):
    """The lines a copy's docstring lists under its "Edited lines" note."""
    out, on = set(), False
    for line in doc_lines:
        if "Edited lines" in line:
            on = True
            continue
        if on and line.startswith("    ") and line.strip():
            out.add(line.strip())
        elif on:
            on = False
    return out


def test_host_copy_is_the_jax_free_closure():
    """The copies that the port's decoder needs, and only modules of the
    JAX-free host half: none of the device modules is copied."""
    assert {"__init__.py", "decoder.py", "native.py", "ops/ref_numpy.py",
            "ops/wavefront.py", "ops/alf.py", "ops/addb_common.py",
            "utils/yuv.py"} <= set(COPIES)
    assert not [c for c in COPIES if c.split("/")[-1].startswith("jax_")
                or c in ("app.py", "ops/pipeline.py")
                or c.startswith("parallel/")]


@pytest.mark.parametrize("rel", COPIES)
def test_host_copy_equals_original(rel):
    copy_doc, copy = _split(HOST / rel)
    _, orig = _split(REPO / "xevd_tpu" / rel)
    allowed = _edited(copy_doc)
    assert len(copy) == len(orig), f"{rel}: {len(copy)} != {len(orig)} lines"
    drift = [(i, a, b) for i, (a, b) in enumerate(zip(copy, orig))
             if a != b and a.strip() not in allowed]
    assert not drift, f"{rel}: unlisted edits {drift[:3]}"
    used = {a.strip() for a, b in zip(copy, orig) if a != b}
    assert used == allowed, f"{rel}: listed but not edited {allowed - used}"
