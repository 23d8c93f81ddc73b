"""``solve_ms.device_paced``: ``solve_ms`` again, in the cells whose device
sets the pace (idle ~5%).  Their runs agree within 1%, while a host-paced
cell's swing by 10-20% with the host's speed; one bound a metric would
leave these cells a bound set by the others' noise."""

from krylov_bench.harness import BENCH_DIR, load_module

read = load_module(BENCH_DIR / "metrics" / "solve_ms.py").read
