"""The benchmark of the PyTorch and CUDA port (``pointslot_torch``).

``python -m slotbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; README.md says how the pieces are found.
"""
