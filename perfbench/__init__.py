"""The benchmark of tpubloom_torch: ``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
