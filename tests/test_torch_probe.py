"""The port's chained-step cost probe K6 against the JAX package's
``_chain_call`` (``benchmarks/kernel_probe.py``), run here in Pallas
interpret mode.

The variants are taken straight from the JAX file: its ``main()`` runs with
``N = 16`` and ``time_variant`` replaced by a recorder, so each
``(name, step_builder, kw)`` it would time is captured, and its ``pl`` is
bound to a namespace whose ``pallas_call`` interprets.  Nothing of the JAX
package is changed.  On the CPU :func:`chain_call` runs its plain version,
so these tests hold the plain version (and the op around it) against the
Pallas kernel: float32 within 4 ulp of max|ref|, since XLA:CPU contracts
multiply-adds (ROADMAP.md Queue 3 item 6).  The CUDA kernel itself is held
against the plain version, bit for bit, on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from newtonkrylov_tpu_torch.benchmarks import kernel_probe as tprobe
from newtonkrylov_tpu_torch.kernels import probe as kp

ROOT = Path(__file__).resolve().parents[1]
N = 16


def _load_jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_probe", ROOT / "benchmarks" / "kernel_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_variants():
    """{name: (step_builder, v, w, kw)} recorded from the JAX probe's main()
    at N = 16, with an interpreting pallas_call."""
    mod = _load_jax_probe()
    recorded = {}

    def record(name, step_builder, v, w, **kw):
        recorded[name] = (step_builder, v, w, kw)
        return 1.0

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "N", N)
        mp.setattr(mod, "time_variant", record)
        mp.setattr(mod, "pl", types.SimpleNamespace(
            pallas_call=functools.partial(pl.pallas_call, interpret=True),
            BlockSpec=pl.BlockSpec))
        mod.main()
        yield mod, recorded


def test_variant_table_matches_jax_probe(jax_variants):
    """The port's probe times the JAX probe's 20 variants, in its order,
    under its names and with its keyword arguments."""
    _, recorded = jax_variants
    assert list(recorded) == [name for name, _, _ in tprobe.VARIANTS]
    for name, _, kw in tprobe.VARIANTS:
        assert recorded[name][3] == kw, name


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _muls_literal(v, nops, steps):
    """numpy's evaluation of the JAX probe's multiply chain as written."""
    x = v.copy()
    for _ in range(steps):
        for i in range(nops):
            x = x * np.float32(0.999 + 1e-4 * i)
    return x


@pytest.mark.parametrize("name", [name for name, _, _ in tprobe.VARIANTS])
def test_chain_call_matches_pallas(jax_variants, name):
    """Every variant at n = 16 ((24, 128) f32), k = 1, 7, 8: on the probe's
    own inputs and on random arrays (ghosts and apron nonzero, so every
    wrap-around and the mask are exercised).  f32 within 4 ulp of max|ref|;
    the multiply chains are equal bit for bit to numpy's evaluation of the
    probe's expression and within nops·steps ulp of the interpreter, which
    folds the constant chain (ROADMAP.md Queue 3 item 9): each side rounds
    nops·steps times."""
    mod, recorded = jax_variants
    builder, v0, w0, kw = recorded[name]
    step = dict((n_, s) for n_, s, _ in tprobe.VARIANTS)[name]
    assert v0.shape == (N + 8, 128) and v0.dtype == np.float32
    f = jax.jit(lambda a, b, k: mod._chain_call(builder, a, b, k, **kw))
    cases = [(np.asarray(v0), np.asarray(w0)),
             (_rand(v0.shape, 1), np.abs(_rand(v0.shape, 2)) + 0.1)]
    for v, w in cases:
        for k in (1, 7, 8):
            ref = np.asarray(f(v, w, k))
            got = kp.chain_call(step, torch.tensor(v), torch.tensor(w), k, **kw)
            assert got.dtype == torch.float32
            ulps = 4
            if step.startswith("muls"):
                nops, steps = int(step[4:]), kp.steps_run(k, **kw)
                np.testing.assert_array_equal(got.numpy(), _muls_literal(v, nops, steps))
                ulps = max(ulps, nops * steps)
            scale = float(np.abs(ref).max())
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=ulps * np.finfo(np.float32).eps * scale,
                                       err_msg=f"{name} k={k}")


@pytest.mark.parametrize("kw,expected", [({}, 7), ({"pingpong": True}, 6),
                                         ({"pingpong": True, "unroll": 2}, 4),
                                         ({"pingpong": True, "unroll": 4}, 0)])
def test_step_counts(kw, expected):
    """Carry runs k steps; ping-pong 2·unroll·⌊k/(2·unroll)⌋, as the JAX
    body loop does (k = 7)."""
    assert kp.steps_run(7, **kw) == expected
    v = torch.ones((N + 8, 128), dtype=torch.float32)
    got = kp.chain_call(kp.muls(2), v, v, 7, **kw)
    c0, c1 = (np.float32(0.999), np.float32(0.999 + 1e-4))
    want = np.float32(1.0)
    for _ in range(expected):
        want = want * c0 * c1
    assert float(got[0, 0]) == float(want)


def test_chain_call_rejects_bad_inputs():
    v = torch.zeros((N + 8, 128), dtype=torch.float32)
    with pytest.raises(ValueError, match="float32"):
        kp.chain_call(kp.OPT_BUILD, v.double(), v.double(), 2)
    with pytest.raises(ValueError, match="unknown probe step"):
        kp.chain_call("muls3", v, v, 2)
    with pytest.raises(ValueError, match="unknown probe step"):
        kp.muls(3)
    with pytest.raises(ValueError, match="shape"):
        kp.chain_call(kp.OPT_BUILD, v, v[:-1], 2)
    with pytest.raises(ValueError, match="unroll"):
        kp.chain_call(kp.OPT_BUILD, v, v, 2, pingpong=True, unroll=0)
    with pytest.raises(ValueError, match="CUDA|device"):
        kp.chain_call(kp.OPT_BUILD, v.to("meta"), v.to("meta"), 2)


def test_no_launch_counted_on_cpu():
    kp.reset_launch_counts()
    v = torch.ones((N + 8, 128), dtype=torch.float32)
    kp.chain_call(kp.CUR_BUILD, v, v, 3)
    assert kp.LAUNCHES == {"chain_call": 0}


def test_probe_main_needs_a_card(monkeypatch, capsys):
    """The measuring script fails, printing no result, without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprobe.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cost_model_arithmetic(monkeypatch, capsys):
    """The cost-model block from given µs per step (no card needed)."""
    us = {name: 1.0 for name, _, _ in tprobe.VARIANTS}
    us.update({"mul x4": 2.0, "mul x8": 4.0, "mul x2 pingpong": 5.0,
               "roll sublane x1 (+mul)": 3.0, "roll sublane x4 (+mul)": 6.0,
               "stencil hoisted+fused": 9.0, "stencil hoisted pingpong": 4.0})
    timings = {k: tprobe.Timing(v, None, None) for k, v in us.items()}
    monkeypatch.setattr(tprobe, "card", lambda: "card")
    model = tprobe.cost_model(timings)
    assert model["per_mul_us"] == 0.5
    assert model["row_shift_us"] == 1.0
    assert model["copy_sync_stencil_us"] == 5.0
    assert model["copy_sync_row_us"] == 2.0
    assert model["memory_step_us"][2] == 4.0
    assert "--- cost model ---" in capsys.readouterr().out
