"""The benchmark of the PyTorch/CUDA port (`pg2024_dprt_tpu_torch`).

`python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once and prints its result line;
`python3 -m portbench.control` reads a cell's control; the CPU tests are
`python -m pytest portbench/tests`. Configurations, scene kinds, traffic
mixes, cells' limits and metric readers are files under `configs/`,
`kinds/`, `traffic/`, `workloads/` and `metrics/`, found by the names in
`BENCHMARK.json` (manifest.py).
"""
