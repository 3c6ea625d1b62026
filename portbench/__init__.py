"""The benchmark of diffusion_torch on an NVIDIA GPU. `python3
portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of BENCHMARK.json once; README.md says how to add one."""
