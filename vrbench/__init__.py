"""The benchmark of volren_tpu_torch: one cell a run, driven by
BENCHMARK.json (``python3 -m vrbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``)."""
