"""The benchmark of the PyTorch and CUDA port (`gat_pytorch_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once and prints one JSON line. Everything a
cell needs is found by name: its configuration, traffic mix and per-layer
metrics are files of their own (README.md). Nothing here imports JAX or
the JAX package; the plain reference under `reference/` imports nothing of
the port either.
"""
