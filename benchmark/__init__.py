"""The benchmark of the PyTorch and CUDA port (``minipath_tpu_torch``).

Run one cell once with ``python3 benchmark/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` from the repository's root; README.md says
what each file holds.
"""
