"""The port's march checkpoints (oracle: tests/test_utils.py): the file
format both packages share, ``latest_checkpoint``, ``integrate``'s
``checkpoint_dir``/``checkpoint_every``/``resume``, and snapshots written by
one package loaded by the other."""

import os

import jax.numpy as jnp
import numpy as np
import torch

import newtonkrylov_tpu_torch as nkt
from newtonkrylov_tpu.utils import checkpointing as jck
from newtonkrylov_tpu_torch.problems import spring as ts
from newtonkrylov_tpu_torch.utils import checkpointing as tck
from newtonkrylov_tpu_torch.utils import convert as cv

F64 = torch.float64


def test_checkpoint_roundtrip(tmp_path):
    """A tuple state (and a dict state, leaves by sorted key) with its time,
    step and metadata, restored bit for bit onto the template's dtype; the
    write goes through a temporary file renamed into place."""
    u = (torch.arange(4.0, dtype=F64), torch.ones((2, 2), dtype=torch.float32))
    path = tck.save_checkpoint(str(tmp_path / "march_10"),
                               tck.MarchCheckpoint(u=u, t=1.5, step=10, extra={"dt": 0.1}))
    assert path.endswith("march_10.npz") and sorted(os.listdir(tmp_path)) == ["march_10.npz"]
    ck = tck.load_checkpoint(path, u)
    assert isinstance(ck.u, tuple)
    for a, b in zip(ck.u, u):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert ck.t == 1.5 and ck.step == 10 and ck.extra["dt"] == 0.1

    d = {"b": torch.ones((2, 2), dtype=F64), "a": torch.arange(3.0, dtype=F64)}
    path = tck.save_checkpoint(str(tmp_path / "dict_1"), tck.MarchCheckpoint(d, 0.0, 1, {}))
    with np.load(path) as z:  # the JAX package's leaf order
        assert np.array_equal(z["leaf_0"], d["a"].numpy())
    back = tck.load_checkpoint(path, d)
    assert torch.equal(back.u["a"], d["a"]) and torch.equal(back.u["b"], d["b"])


def test_latest_checkpoint(tmp_path):
    u = torch.zeros(3, dtype=F64)
    for k in (5, 20, 10):
        tck.save_checkpoint(str(tmp_path / f"march_{k}"), tck.MarchCheckpoint(u, 0.0, k, {}))
    assert tck.latest_checkpoint(str(tmp_path)).endswith("march_20.npz")
    assert tck.latest_checkpoint(str(tmp_path / "missing")) is None
    assert tck.latest_checkpoint(str(tmp_path), prefix="other_") is None


def test_integrate_checkpoint_resume(tmp_path):
    """March 5 steps with checkpoints every 5; resuming from ``march_5``
    runs only the remaining 5 steps and ends on the uninterrupted march's
    state bit for bit (test_utils.py::test_integrate_checkpoint_resume)."""
    p = ts.default_config()
    u0 = ts.initial_condition(device="cpu")
    full = nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 1.0)
    nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 0.5,
                  checkpoint_dir=str(tmp_path), checkpoint_every=5)
    assert os.path.exists(tmp_path / "march_5.npz")
    resumed = nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 1.0,
                            checkpoint_dir=str(tmp_path), resume=True)
    assert torch.equal(resumed.u, full.u)
    assert len(resumed.outer_iterations) == 5
    np.testing.assert_allclose(resumed.ts.numpy(), full.ts.numpy()[5:], rtol=1e-15)
    # no snapshot yet: resume starts from u0
    fresh = nkt.integrate("midpoint", ts.rhs, u0, p, 0.1, 0.3,
                          checkpoint_dir=str(tmp_path / "empty"), resume=True)
    assert len(fresh.outer_iterations) == 3


def test_snapshots_cross_packages(tmp_path):
    """A snapshot the JAX package wrote loads in the port onto the
    template's device and dtype (its ``_treedef`` string is ignored), and one
    the port wrote loads in the JAX package."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5))
    path = jck.save_checkpoint(str(tmp_path / "march_7"),
                               jck.MarchCheckpoint(u=jnp.asarray(a), t=0.7, step=7,
                                                   extra={"dt": 0.1, "tag": "heat"}))
    tmpl = torch.zeros((4, 5), dtype=torch.float32)
    ck = tck.load_checkpoint(path, tmpl)
    assert ck.u.dtype == torch.float32 and ck.u.device == tmpl.device
    assert torch.equal(ck.u, torch.tensor(a).float())
    assert (ck.t, ck.step, ck.extra["dt"], ck.extra["tag"]) == (0.7, 7, 0.1, "heat")
    ck64 = tck.load_checkpoint(path, torch.zeros((4, 5), dtype=F64))
    assert torch.equal(ck64.u, torch.tensor(a))
    conv = cv.march_checkpoint(jck.load_checkpoint(path, jnp.zeros((4, 5))), device="cpu")
    assert torch.equal(conv.u, ck64.u) and conv.step == 7

    u = (torch.tensor(a), torch.tensor(a[0]))
    path = tck.save_checkpoint(str(tmp_path / "march_8"),
                               tck.MarchCheckpoint(u=u, t=0.8, step=8, extra={"dt": 0.1}))
    back = jck.load_checkpoint(path, (jnp.zeros((4, 5)), jnp.zeros(5)))
    np.testing.assert_array_equal(np.asarray(back.u[0]), a)
    np.testing.assert_array_equal(np.asarray(back.u[1]), a[0])
    assert back.t == 0.8 and back.step == 8 and back.extra["dt"] == 0.1
