"""The benchmark of vid2vid_tpu_torch on the H100: `python3 -m
portbench.run` (one run of one cell of BENCHMARK.json), with its
configurations, traffic mixes, drivers, metric readers, frozen plain
reference, seeded inputs and the arithmetic that judges the runs."""
