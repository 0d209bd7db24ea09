"""portbench: the benchmark of gs360x_torch, the PyTorch and CUDA port, on
an NVIDIA H100. ``python3 portbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell (``BENCHMARK.json``)."""
