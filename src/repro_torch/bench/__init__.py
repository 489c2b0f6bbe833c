"""The paper-figure harness of the port (figs. 4-7, table 3, the
profile-guided cost model, the crossing-cost decomposition) and the static
analysis sweep (:mod:`repro_torch.bench.analyze`).

    python -m repro_torch.bench.run [--device cpu] [--scale test|bench]
    python -m repro_torch.bench.analyze --all --strict
"""
