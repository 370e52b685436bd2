"""The port's benchmark: `python3 cardbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>` from the root of a checkout."""
