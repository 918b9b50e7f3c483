"""The benchmark of ``jafpro_tpu_torch`` on an NVIDIA H100
(``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; cells, metrics and bounds in ``BENCHMARK.json``)."""
