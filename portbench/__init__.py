"""The benchmark of the PyTorch and CUDA port (`repro_torch`) on one card.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of the root's `BENCHMARK.json` and prints its result line.
"""
