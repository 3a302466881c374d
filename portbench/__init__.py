"""The benchmark of ``interspeech_ser_tpu_torch`` on one NVIDIA H100.

One cell a run: ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout. Everything that
belongs to a configuration, a traffic mix or a per-layer metric is a file of
its own, found by the name ``BENCHMARK.json`` gives it (README.md).
"""
