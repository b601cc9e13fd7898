"""The benchmark of cartpoleplusplus_tpu_torch, the PyTorch and CUDA port:
`python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json once on one H100."""
