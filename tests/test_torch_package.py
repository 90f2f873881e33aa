"""The port's package surface against the JAX package's: the last symbols
of ROADMAP Queue 1 item 2 (``tree_ones_like``, ``spaces.default_space``,
``__version__``), and a clean compile of every module of the port."""

import importlib
import pathlib
import py_compile
import warnings

import jax.numpy as jnp
import numpy as np
import torch

import newtonkrylov_tpu as nk
import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu import spaces as jspaces
from newtonkrylov_tpu import tree as jtree
from newtonkrylov_tpu_torch import spaces as tspaces
from newtonkrylov_tpu_torch import tree as ttree

PORT = pathlib.Path(nkt.__file__).parent


def test_version_matches_jax_package():
    assert nkt.__version__ == nk.__version__ == "0.1.0"


def test_tree_ones_like_matches_jax():
    """A tensor and a tuple state: ones of each leaf's shape and dtype."""
    a = np.arange(6.0).reshape(2, 3)
    b = np.arange(4, dtype=np.float32)
    want = jtree.tree_ones_like((jnp.asarray(a), jnp.asarray(b)))
    got = ttree.tree_ones_like((torch.tensor(a), torch.tensor(b)))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, str(w.dtype))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert "tree_ones_like" in ttree.__all__ and "tree_ones_like" in jtree.__all__


def test_default_space_matches_jax():
    """Both return a Euclidean space; its dot is the plain one."""
    assert isinstance(jspaces.default_space(), jspaces.EuclideanSpace)
    s = tspaces.default_space()
    assert isinstance(s, tspaces.EuclideanSpace)
    assert "default_space" in tspaces.__all__ and "default_space" in jspaces.__all__
    x = np.linspace(0.0, 1.0, 7)
    assert float(s.dot(torch.tensor(x), torch.tensor(x))) == float(
        jspaces.default_space().dot(jnp.asarray(x), jnp.asarray(x)))


def test_every_module_compiles_without_syntax_warnings(tmp_path):
    """A fresh compile of each source file (not a cached .pyc) with
    SyntaxWarning an error: an invalid escape in a docstring cannot come
    back.  Then every module imports."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 40
    with warnings.catch_warnings():
        warnings.simplefilter("error", SyntaxWarning)
        for i, f in enumerate(files):
            py_compile.compile(str(f), cfile=str(tmp_path / f"{i}.pyc"),
                               doraise=True)
    for f in files:
        rel = f.relative_to(PORT.parent).with_suffix("")
        name = ".".join(rel.parts)
        if name.endswith(".__init__"):
            name = name[: -len(".__init__")]
        importlib.import_module(name)
