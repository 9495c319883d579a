"""``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``."""

import time

_T_START = time.perf_counter()

if __name__ == "__main__":
    from portbench.run import main

    raise SystemExit(main(t_start=_T_START))
