"""``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""

import sys

from portbench.bench import main

if __name__ == "__main__":
    sys.exit(main())
