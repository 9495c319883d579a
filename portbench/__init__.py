"""The benchmark of ``annsearch_tpu_torch`` on NVIDIA H100 cards.

``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` (from the root of a checkout)
once and prints its result as the last line of standard output. The
harness (``cell``, ``run``), the data (``data``), the arithmetic
(``stats``, ``roofline``, ``trace``), the comparison (``check``) and the
plain reference (``reference``) are the benchmark's own; from the program
it takes the facade's functions, its launch counters and its kernels'
names.
"""
