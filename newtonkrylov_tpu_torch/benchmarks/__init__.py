"""Measuring and evidence programs of the port, run with ``python -m``.

Each runs on the card unless given ``--device cpu``:

* :mod:`.kernel_probe` — the chained-step cost probe (K6), counterpart of
  the JAX probe ``benchmarks/kernel_probe.py``; :mod:`.cheb_wall` — the
  Cheb-PCG wall of two checkouts on one card;
* :mod:`.chain_solve` — the chained-solve protocol of the JAX bench lanes
  (the marginal wall of a solve), which the others import;
* :mod:`.xl8192`, :mod:`.floor_probe`, :mod:`.solve_profile`,
  :mod:`.solve_df32_check`, :mod:`.cheb_probe` — the large-side lanes, the
  df32 floor, the per-phase cost of a flagship outer, the df32 path's cost
  and the preconditioner lanes, counterparts of the JAX scripts of the same
  names;
* :mod:`.dst_precision_probe` — the DST products' precision (the full-f32
  products and the single bf16 pass) against the flagship's counts and
  wall, counterpart of the JAX script of the same name;
* :mod:`.run_configs`, :mod:`.bvp_adjudicate` — the BASELINE configurations
  and the BVP recipe's adjudication, whose CPU f64 records
  (``baseline_configs.json``, ``bvp_adjudication.json``) live beside them.
"""
