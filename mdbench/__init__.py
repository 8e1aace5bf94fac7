"""The benchmark of movedepth_tpu_torch on an NVIDIA H100 (see README.md).

Run one cell with ``python3 mdbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``."""
