"""The benchmark of the PyTorch/CUDA port (`repro_torch`): one cell a run
(`python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>`), every cell, configuration, traffic mix and per-layer metric found
by its name in `BENCHMARK.json` and in files of its own under `bench/`."""
