"""The port's ``solve_df32_check`` and ``cheb_probe`` on the CPU at 32².

Both are measuring programs of the card; here they run with
``device="cpu"`` at a small size to hold what they gate and count: the converged DST solve solved to the
tolerance the driver accepted at (its f64 true residual), the per-outer
differencing's inner counts, and every preconditioner lane of
``cheb_probe`` solved with its preconditioner applied once a CG iteration
and once an outer.
"""


from newtonkrylov_tpu_torch.benchmarks import cheb_probe, solve_df32_check


def test_solve_df32_check_runs():
    out = solve_df32_check.run(32, "cpu", log=lambda *a: None)
    assert out["solved"] and 0 < out["true_res"] <= out["tol"]
    assert out["true_rel"] < 1e-8
    assert out["no_precond_itmax1"]["inner_per_outer"] == 1.0
    assert out["dst_ew"]["inner_per_outer"] >= 0.0


def test_cheb_probe_lanes_run():
    recs = cheb_probe.run((32,), "cpu", reps=1, log=lambda *a: None)
    assert [r["lane"] for r in recs] == [
        "plain", "DST-PCG", "two-grid(4)", "two-grid(8)", "two-grid(16)",
        "cheb(16)-CG"]
    assert all(r["solved"] and r["n"] == 32 for r in recs)
    assert recs[0]["applies"] == 0
    assert all(r["applies"] == r["inner"] + r["outer"] for r in recs[1:])
    assert all(r["k4_launches"] == 0 for r in recs)  # plain versions here
